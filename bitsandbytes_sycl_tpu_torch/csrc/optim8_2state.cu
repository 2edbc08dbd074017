// Kernel J: the fused blockwise 8-bit 2-state optimizer step (adam, lamb).
//
// Replaces bitsandbytes_sycl_tpu/ops/optim8.py `_kernel2` (called through
// `optim8_blockwise_fused`, pl.pallas_call at :312) with the dynamic codec.
//
// Per element of an (nb, bs) row, with the step's scalars sc = (b1, b2,
// eps * c2, step_size, decay, gnorm_scale):
//   g  = g * gnorm_scale, 0 where not finite
//   s1 = dec_signed(code1) * absmax1,  s2 = dec_unsigned(code2) * absmax2
//   n1 = s1 * b1 + (1 - b1) * g,       n2 = s2 * b2 + ((1 - b2) * g) * g
//   p' = (p + step_size * (n1 / (sqrt(n2) + eps * c2))) * decay
// and where g was not finite p, s1 and s2 stay; then each state requantizes
// with its block's fresh absmax (state1 with the sign fix, or both with
// stochastic rounding on the uniforms u). Every operation rounds where the
// plain version's does (no FMA contraction), so p, the codes and the absmax
// equal ops/optim8._kernel2_plain bit for bit.
//
// Bound on the H100: memory. It reads g and p (4 bytes each) and two codes
// and writes p and two codes: 16 bytes a parameter (the absmax, 8 bytes a
// block, is noise); the floor is those bytes over 3.35 TB/s.
//
// Design: one block of 256 threads per 2048-element quantization block
// (the Pallas kernel takes 32 rows a grid step for its VMEM); element t + k
// * 256 of the row is thread t's k-th value, so every load and store of a
// warp is contiguous. Both decode tables sit in shared memory, the update
// stays in registers, and the two block max-reductions feed the encode.
#include "dynamic8.cuh"

namespace {

__global__ void __launch_bounds__(dyn8::kThreads)
optim8_2state_kernel(const float* __restrict__ sc, const float* __restrict__ g,
                     const float* __restrict__ p, const uint8_t* __restrict__ s1,
                     const float* __restrict__ am1, const uint8_t* __restrict__ s2,
                     const float* __restrict__ am2, const float* __restrict__ u,
                     float* __restrict__ po, uint8_t* __restrict__ s1o, float* __restrict__ am1o,
                     uint8_t* __restrict__ s2o, float* __restrict__ am2o,
                     const float* __restrict__ tables, int bs, dyn8::Consts consts) {
  using namespace dyn8;
  __shared__ float tbl[512];  // signed map, then unsigned
  __shared__ float red[32];
  for (int i = threadIdx.x; i < 512; i += kThreads) tbl[i] = tables[i];
  __syncthreads();
  const float b1 = sc[0], b2 = sc[1], eps_c2 = sc[2], step_size = sc[3], decay = sc[4],
              gscale = sc[5];
  const float omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
  const size_t row0 = (size_t)blockIdx.x * bs;
  const float a1 = am1[blockIdx.x], a2 = am2[blockIdx.x];
  const int per = (bs + kThreads - 1) / kThreads;
  float n1[kMaxPer], n2[kMaxPer];
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
    const float v2 = __fmul_rn(tbl[256 + s2[i]], a2);
    float m1 = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(omb1, gv));
    float m2 = __fadd_rn(__fmul_rn(v2, b2), __fmul_rn(__fmul_rn(omb2, gv), gv));
    float np = __fadd_rn(pv, __fmul_rn(step_size, __fdiv_rn(m1, __fadd_rn(__fsqrt_rn(m2), eps_c2))));
    np = __fmul_rn(np, decay);
    if (!fin) {
      np = pv;
      m1 = v1;
      m2 = v2;
    }
    po[i] = np;
    n1[k] = m1;
    n2[k] = m2;
  }
  requant<true, true>(n1, per, bs, row0, u, false, consts.v, tbl, red, s1o, am1o);
  requant<false, false>(n2, per, bs, row0, u, true, consts.v, tbl + 256, red, s2o, am2o);
}

}  // namespace

// Rows (nb, bs), bs <= 2048: g, p f32; s1, s2 uint8; am1, am2 (nb,) f32;
// sc (8,) f32 on the device; u (nb, bs) f32 or null. Outputs po, s1o, am1o,
// s2o, am2o. tables: (512,) f32 on the device; consts: 23 floats on the host.
extern "C" int optim8_2state(const float* sc, const float* g, const float* p, const uint8_t* s1,
                             const float* am1, const uint8_t* s2, const float* am2, const float* u,
                             float* po, uint8_t* s1o, float* am1o, uint8_t* s2o, float* am2o,
                             const float* tables, const float* consts, int nb, int bs,
                             void* stream) {
  if (nb <= 0 || bs <= 0 || bs > dyn8::kThreads * dyn8::kMaxPer) return (int)cudaErrorInvalidValue;
  dyn8::Consts c;
  memcpy(c.v, consts, sizeof(c.v));
  optim8_2state_kernel<<<nb, dyn8::kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      sc, g, p, s1, am1, s2, am2, u, po, s1o, am1o, s2o, am2o, tables, bs, c);
  return (int)cudaGetLastError();
}
