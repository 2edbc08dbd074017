// Kernel K: the fused blockwise 8-bit 1-state optimizer step (momentum,
// rmsprop, adagrad, lion).
//
// Replaces bitsandbytes_sycl_tpu/ops/optim8.py `_kernel1` (called through
// `optim8_blockwise_fused`, pl.pallas_call at :312) with the dynamic codec.
//
// Per element of an (nb, bs) row, with the step's scalars sc = (b1, b2,
// eps, lr, weight_decay, gnorm_scale, is_step1):
//   g = g * gnorm_scale, 0 where not finite; s = dec_signed(code) * absmax
//   g = g + p * weight_decay                       (coupled decay)
//   momentum: s' = is_step1 ? g : s * b1 + g;       p' = p - lr * s'
//   rmsprop:  s' = s * b1 + ((1 - b1) * g) * g;     p' = p - (lr * g) / (sqrt(s') + eps)
//   adagrad:  s' = s + g * g;                       p' = p - (lr * g) / (sqrt(s') + eps)
//   lion:     p' = p - lr * sign(s * b1 + (1 - b1) * g);  s' = s * b2 + (1 - b2) * g
// where g was not finite p and s stay; then the state requantizes with its
// block's fresh absmax (sign fix, or stochastic rounding on u). Every
// operation rounds where ops/optim8._kernel1_plain's does, so the results
// equal it bit for bit.
//
// Bound on the H100: memory, 14 bytes a parameter (g and p read, p written,
// one code read and written) over 3.35 TB/s.
//
// Design: kernel J's, with one state: a block of 256 threads per
// quantization block, the signed decode table in shared memory, the update
// in registers, one block max-reduction, then the arithmetic encode.
#include "dynamic8.cuh"

namespace {

enum Op { kMomentum = 0, kRmsprop = 1, kAdagrad = 2, kLion = 3 };

template <int kOp>
__global__ void __launch_bounds__(dyn8::kThreads)
optim8_1state_kernel(const float* __restrict__ sc, const float* __restrict__ g,
                     const float* __restrict__ p, const uint8_t* __restrict__ s1,
                     const float* __restrict__ am1, const float* __restrict__ u,
                     float* __restrict__ po, uint8_t* __restrict__ s1o, float* __restrict__ am1o,
                     const float* __restrict__ tables, int bs, dyn8::Consts consts) {
  using namespace dyn8;
  __shared__ float tbl[256];
  __shared__ float red[32];
  for (int i = threadIdx.x; i < 256; i += kThreads) tbl[i] = tables[i];
  __syncthreads();
  const float b1 = sc[0], b2 = sc[1], eps = sc[2], lr = sc[3], wd = sc[4], gscale = sc[5],
              is_step1 = sc[6];
  const float omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
  const size_t row0 = (size_t)blockIdx.x * bs;
  const float a1 = am1[blockIdx.x];
  const int per = (bs + kThreads - 1) / kThreads;
  float n1[kMaxPer];
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (k >= per || e >= bs) continue;
    const size_t i = row0 + e;
    float gv = __fmul_rn(g[i], gscale);
    const bool fin = isfinite(gv);
    gv = fin ? gv : 0.0f;
    const float pv = p[i];
    const float v1 = __fmul_rn(tbl[s1[i]], a1);
    gv = __fadd_rn(gv, __fmul_rn(pv, wd));
    float m, np;
    if (kOp == kMomentum) {
      m = is_step1 > 0.0f ? gv : __fadd_rn(__fmul_rn(v1, b1), gv);
      np = __fsub_rn(pv, __fmul_rn(lr, m));
    } else if (kOp == kRmsprop) {
      m = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(__fmul_rn(omb1, gv), gv));
      np = __fsub_rn(pv, __fdiv_rn(__fmul_rn(lr, gv), __fadd_rn(__fsqrt_rn(m), eps)));
    } else if (kOp == kAdagrad) {
      m = __fadd_rn(v1, __fmul_rn(gv, gv));
      np = __fsub_rn(pv, __fdiv_rn(__fmul_rn(lr, gv), __fadd_rn(__fsqrt_rn(m), eps)));
    } else {
      const float d = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(omb1, gv));
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      np = __fsub_rn(pv, __fmul_rn(lr, sgn));
      m = __fadd_rn(__fmul_rn(v1, b2), __fmul_rn(omb2, gv));
    }
    if (!fin) {
      np = pv;
      m = v1;
    }
    po[i] = np;
    n1[k] = m;
  }
  requant<true, true>(n1, per, bs, row0, u, false, consts.v, tbl, red, s1o, am1o);
}

}  // namespace

// op: 0 momentum, 1 rmsprop, 2 adagrad, 3 lion. Rows (nb, bs), bs <= 2048:
// g, p f32; s1 uint8; am1 (nb,) f32; sc (8,) f32 on the device; u (nb, bs)
// f32 or null. Outputs po, s1o, am1o. tables: (512,) f32 on the device (the
// signed map first); consts: 23 floats on the host.
extern "C" int optim8_1state(int op, const float* sc, const float* g, const float* p,
                             const uint8_t* s1, const float* am1, const float* u, float* po,
                             uint8_t* s1o, float* am1o, const float* tables, const float* consts,
                             int nb, int bs, void* stream) {
  if (nb <= 0 || bs <= 0 || bs > dyn8::kThreads * dyn8::kMaxPer || op < 0 || op > 3)
    return (int)cudaErrorInvalidValue;
  dyn8::Consts c;
  memcpy(c.v, consts, sizeof(c.v));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BNB_K(OP) \
  optim8_1state_kernel<OP><<<nb, dyn8::kThreads, 0, st>>>(sc, g, p, s1, am1, u, po, s1o, am1o, tables, bs, c)
  switch (op) {
    case kMomentum: BNB_K(kMomentum); break;
    case kRmsprop: BNB_K(kRmsprop); break;
    case kAdagrad: BNB_K(kAdagrad); break;
    default: BNB_K(kLion); break;
  }
#undef BNB_K
  return (int)cudaGetLastError();
}
