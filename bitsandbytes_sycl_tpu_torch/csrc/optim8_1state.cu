// Kernel K: the fused blockwise 8-bit 1-state optimizer step (momentum,
// rmsprop, adagrad, lion), one launch over every 8-bit leaf of an optimizer
// step, in place.
//
// Replaces bitsandbytes_sycl_tpu/ops/optim8.py `_kernel1` (called through
// `optim8_blockwise_fused`, pl.pallas_call at :312), with either codec (the
// dynamic map or any 256-entry table, dynamic8.cuh) and any blocksize.
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
// package's kernel route pads it, as in kernel J (optim8_2state.cu). Every
// operation rounds where ops/optim8._grouped_plain's does, so the results
// equal it bit for bit. Blocks past kMaxBlock take kernel J's two-pass
// body; pass 2 reads p again (the coupled weight decay), which pass 1
// never writes.
//
// Bound on the H100: memory, 14 bytes a parameter (g and p read, p written,
// one code read and written) over 3.35 TB/s.
//
// Design: kernel J's with one state: the persistent grid of contiguous
// block runs walking the leaf table with an L2 prefetch of the next block,
// 8 consecutive elements a thread (16-byte accesses of g and p, an 8-byte
// access of the codes), one block max-reduction a block, the encode by
// exponent bits with the codec table in shared memory (dynamic8.cuh), or the
// LUT codec's binary search.
#include "dynamic8.cuh"

namespace {

using namespace dyn8;

enum Op { kMomentum = 0, kRmsprop = 1, kAdagrad = 2, kLion = 3 };

// kPass and kLut as in kernel J (optim8_2state.cu).
template <int kOp, int kPass, bool kStoch, bool kLut>
__global__ void __launch_bounds__(kThreads, kMinCtas)
optim8_1state_kernel(const Leaf* __restrict__ leaves, int nleaves, const float* __restrict__ scalars,
                     const float* __restrict__ table, long long total, int bs, int delta,
                     int* __restrict__ scratch) {
  constexpr int kWords = kLut ? kLutWords : kTableWords;
  __shared__ __align__(16) float tab[kWords];
  __shared__ int red[2][kWarps];
  stage_table(table, tab, kWords);
  Walk w{leaves, nleaves};
  float b1 = 0, b2 = 0, eps = 0, lr = 0, wd = 0, gscale = 0, is_step1 = 0, omb1 = 0, omb2 = 0;
  int parity = 0;
  const int cpb = kPass == 0 ? 1 : (bs + kMaxBlock - 1) / kMaxBlock;  // chunks a block
  long long lo, hi;
  block_range(total * cpb, lo, hi);
  for (long long c = lo; c < hi; ++c, parity ^= 1) {
    const long long b = kPass == 0 ? c : c / cpb;
    const int off = kPass == 0 ? 0 : (int)(c - b * cpb) * kMaxBlock;
    if (w.advance(b, bs)) {
      const float* sc = scalars + w.cur.row * 8;
      b1 = sc[0], b2 = sc[1], eps = sc[2], lr = sc[3], wd = sc[4], gscale = sc[5], is_step1 = sc[6];
      omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
    }
    const long long lb = b - w.cur.first;
    if (kPass == 0 && b + 1 < hi) w.prefetch_next(lb, bs);
    const Span s = span(lb, bs, w, off);
    int* slot = scratch + b * kScratchWords;
    const float a1 = kPass == 2 ? __int_as_float(slot[2]) : BNB_OPT_LOADF(w.cur.am1, lb);
    float gv[kPer], pv[kPer], uv[kPer];
    int c1[kPer];
    BNB_OPT_LOAD8(w.cur.g, s, 0.0f, gv);
    BNB_OPT_LOAD8(w.cur.p, s, 0.0f, pv);
    BNB_OPT_LOADC(w.cur.s1, s, 127, c1);
    if (kStoch && kPass != 1) BNB_OPT_LOAD8(w.cur.u, s, 0.0f, uv);
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
      const float v1 = __fmul_rn(kLut ? tab[c1[k]] : tab[kDecS + c1[k]], a1);
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
    float m[1];
    if (kPass == 1) {  // fold the chunk's maximum into the block's slot, write nothing else
      block_absmax<1>(n, s.inb, red[parity], m);
      if (threadIdx.x == 0) {
        atomicMax(slot, __float_as_int(m[0]));
        if (off == 0) slot[2] = __float_as_int(a1);
      }
      continue;
    }
    BNB_OPT_STORE8(w.cur.p, s, pv);
    if (kPass == 0) {
      block_absmax<1>(n, s.inb, red[parity], m);
    } else {
      m[0] = __int_as_float(slot[0]);
    }
    if (threadIdx.x == 0 && off == 0) BNB_OPT_STOREF(w.cur.am1, lb, m[0]);
    if (kLut) {
      lut_requant8<true>(n[0], m[0], tab, c1);
    } else {
      requant8<true, true, kStoch>(n[0], m[0], uv, tab, c1);
    }
    BNB_OPT_STOREC(w.cur.s1, s, c1);
#endif
  }
}

template <int kOp, int kPass>
void launch(bool stochastic, bool lut, int grid, cudaStream_t st, const Leaf* lv, int nleaves,
            const float* scalars, const float* table, long long total, int bs, int delta,
            int* scratch) {
  if (lut) {
    optim8_1state_kernel<kOp, kPass, false, true><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  } else if (stochastic) {
    optim8_1state_kernel<kOp, kPass, true, false><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  } else {
    optim8_1state_kernel<kOp, kPass, false, false><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  }
}

// The launches of one op: the one-pass body, or the two passes (scratch
// zeroed first).
template <int kOp>
int launch_op(bool stochastic, bool lut, int grid, cudaStream_t st, const Leaf* lv, int nleaves,
              const float* scalars, const float* table, long long total, int bs, int delta,
              int* scratch) {
  if (bs <= kMaxBlock) {
    launch<kOp, 0>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs, delta, scratch);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(scratch, 0, total * kScratchWords * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  launch<kOp, 1>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs, delta, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch<kOp, 2>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs, delta, scratch);
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 momentum, 1 rmsprop, 2 adagrad, 3 lion; the other arguments as for
// optim8_2state (optim8_2state.cu), each leaf's s2 and am2 null, table the
// dynamic maps or one LUT codec.
extern "C" int optim8_1state(int op, const void* leaves, int nleaves, const float* scalars,
                             const float* table, long long total, int bs, int grid, int delta,
                             int stochastic, int lut, int* scratch, void* stream) {
  if (nleaves <= 0 || total <= 0 || grid <= 0 || bs <= 0 || op < 0 || op > 3 ||
      (lut && stochastic) || (bs > dyn8::kMaxBlock && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dyn8::Leaf* lv = reinterpret_cast<const dyn8::Leaf*>(leaves);
  switch (op) {
    case kMomentum:
      return launch_op<kMomentum>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                  delta, scratch);
    case kRmsprop:
      return launch_op<kRmsprop>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                 delta, scratch);
    case kAdagrad:
      return launch_op<kAdagrad>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                 delta, scratch);
    default:
      return launch_op<kLion>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                              delta, scratch);
  }
}
