// Kernel K: the fused blockwise 8-bit 1-state optimizer step (momentum,
// rmsprop, adagrad, lion), one launch over every 8-bit leaf of an optimizer
// step, in place.
//
// Replaces bitsandbytes_sycl_tpu/ops/optim8.py `_kernel1` (called through
// `optim8_blockwise_fused`, pl.pallas_call at :312) with the dynamic codec.
//
// Per element, with the leaf's row of scalars sc = (b1, b2, eps, lr,
// weight_decay, gnorm_scale, is_step1):
//   g = g * gnorm_scale, 0 where not finite; s = dec_signed(code) * absmax
//   g = g + p * weight_decay                       (coupled decay)
//   momentum: s' = is_step1 ? g : s * b1 + g;       p' = p - lr * s'
//   rmsprop:  s' = s * b1 + ((1 - b1) * g) * g;     p' = p - (lr * g) / (sqrt(s') + eps)
//   adagrad:  s' = s + g * g;                       p' = p - (lr * g) / (sqrt(s') + eps)
//   lion:     p' = p - lr * sign(s * b1 + (1 - b1) * g);  s' = s * b2 + (1 - b2) * g
// where g was not finite p and s stay; then the state requantizes with its
// block's fresh absmax (sign fix, or stochastic rounding on u). p is stored
// as p' or as p + (p' - p), and a ragged last block reads as the JAX
// package pads it, as in kernel J (optim8_2state.cu). Every operation
// rounds where ops/optim8._grouped_plain's does, so the results equal it
// bit for bit.
//
// Bound on the H100: memory, 14 bytes a parameter (g and p read, p written,
// one code read and written) over 3.35 TB/s.
//
// Design: kernel J's with one state: the persistent grid of contiguous
// block runs walking the leaf table with an L2 prefetch of the next block,
// 8 consecutive elements a thread (16-byte accesses of g and p, an 8-byte
// access of the codes), one block max-reduction a block, the encode by
// exponent bits with the codec table in shared memory (dynamic8.cuh).
#include "dynamic8.cuh"

namespace {

using namespace dyn8;

enum Op { kMomentum = 0, kRmsprop = 1, kAdagrad = 2, kLion = 3 };

template <int kOp, bool kStoch>
__global__ void __launch_bounds__(kThreads, kMinCtas)
optim8_1state_kernel(const Leaf* __restrict__ leaves, int nleaves, const float* __restrict__ scalars,
                     const float* __restrict__ table, long long total, int bs, int delta) {
  __shared__ __align__(16) float tab[kTableWords];
  __shared__ int red[2][kWarps];
  stage_table(table, tab);
  Walk w{leaves, nleaves};
  float b1 = 0, b2 = 0, eps = 0, lr = 0, wd = 0, gscale = 0, is_step1 = 0, omb1 = 0, omb2 = 0;
  int parity = 0;
  long long lo, hi;
  block_range(total, lo, hi);
  for (long long b = lo; b < hi; ++b, parity ^= 1) {
    if (w.advance(b, bs)) {
      const float* sc = scalars + w.cur.row * 8;
      b1 = sc[0], b2 = sc[1], eps = sc[2], lr = sc[3], wd = sc[4], gscale = sc[5], is_step1 = sc[6];
      omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
    }
    const long long lb = b - w.cur.first;
    if (b + 1 < hi) w.prefetch_next(lb, bs);
    const Span s = span(lb, bs, w);
    const float a1 = BNB_OPT_LOADF(w.cur.am1, lb);
    float gv[kPer], pv[kPer], uv[kPer];
    int c1[kPer];
    BNB_OPT_LOAD8(w.cur.g, s, 0.0f, gv);
    BNB_OPT_LOAD8(w.cur.p, s, 0.0f, pv);
    BNB_OPT_LOADC(w.cur.s1, s, 127, c1);
    if (kStoch) BNB_OPT_LOAD8(w.cur.u, s, 0.0f, uv);
#if defined(BNB_PROBE_NO_MATH)
#pragma unroll
    for (int k = 0; k < kPer; ++k) pv[k] = pv[k] + gv[k];
    BNB_OPT_STORE8(w.cur.p, s, pv);
    BNB_OPT_STOREC(w.cur.s1, s, c1);
    if (threadIdx.x == 0) BNB_OPT_STOREF(w.cur.am1, lb, a1);
#else
    float n[1][kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float v1 = __fmul_rn(tab[kDecS + c1[k]], a1);
#if defined(BNB_PROBE_NO_UPDATE)
      float np = pv[k], m = v1;
#else
      float g = __fmul_rn(gv[k], gscale);
      const bool fin = isfinite(g);
      g = fin ? g : 0.0f;
      const float p = pv[k];
      g = __fadd_rn(g, __fmul_rn(p, wd));
      float m, np;
      if (kOp == kMomentum) {
        m = is_step1 > 0.0f ? g : __fadd_rn(__fmul_rn(v1, b1), g);
        np = __fsub_rn(p, __fmul_rn(lr, m));
      } else if (kOp == kRmsprop) {
        m = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(__fmul_rn(omb1, g), g));
        np = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(m), eps)));
      } else if (kOp == kAdagrad) {
        m = __fadd_rn(v1, __fmul_rn(g, g));
        np = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, g), __fadd_rn(__fsqrt_rn(m), eps)));
      } else {
        const float d = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(omb1, g));
        const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
        np = __fsub_rn(p, __fmul_rn(lr, sgn));
        m = __fadd_rn(__fmul_rn(v1, b2), __fmul_rn(omb2, g));
      }
      if (!fin) {
        np = p;
        m = v1;
      }
#endif
      pv[k] = delta ? __fadd_rn(pv[k], __fsub_rn(np, pv[k])) : np;
      n[0][k] = m;
    }
    BNB_OPT_STORE8(w.cur.p, s, pv);
    float m[1];
    block_absmax<1>(n, s.inb, red[parity], m);
    if (threadIdx.x == 0) BNB_OPT_STOREF(w.cur.am1, lb, m[0]);
    requant8<true, true, kStoch>(n[0], m[0], uv, tab, c1);
    BNB_OPT_STOREC(w.cur.s1, s, c1);
#endif
  }
}

template <int kOp>
void launch(bool stochastic, int grid, cudaStream_t st, const Leaf* lv, int nleaves,
            const float* scalars, const float* table, long long total, int bs, int delta) {
  if (stochastic) {
    optim8_1state_kernel<kOp, true><<<grid, kThreads, 0, st>>>(lv, nleaves, scalars, table, total,
                                                               bs, delta);
  } else {
    optim8_1state_kernel<kOp, false><<<grid, kThreads, 0, st>>>(lv, nleaves, scalars, table, total,
                                                                bs, delta);
  }
}

}  // namespace

// op: 0 momentum, 1 rmsprop, 2 adagrad, 3 lion; the other arguments as for
// optim8_2state (optim8_2state.cu), each leaf's s2 and am2 null.
extern "C" int optim8_1state(int op, const void* leaves, int nleaves, const float* scalars,
                             const float* table, long long total, int bs, int grid, int delta,
                             int stochastic, void* stream) {
  if (nleaves <= 0 || total <= 0 || grid <= 0 || bs <= 0 || bs > dyn8::kMaxBlock || op < 0 ||
      op > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dyn8::Leaf* lv = reinterpret_cast<const dyn8::Leaf*>(leaves);
  switch (op) {
    case kMomentum: launch<kMomentum>(stochastic, grid, st, lv, nleaves, scalars, table, total, bs, delta); break;
    case kRmsprop: launch<kRmsprop>(stochastic, grid, st, lv, nleaves, scalars, table, total, bs, delta); break;
    case kAdagrad: launch<kAdagrad>(stochastic, grid, st, lv, nleaves, scalars, table, total, bs, delta); break;
    default: launch<kLion>(stochastic, grid, st, lv, nleaves, scalars, table, total, bs, delta); break;
  }
  return (int)cudaGetLastError();
}
