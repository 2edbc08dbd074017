// Kernel J: the fused blockwise 8-bit 2-state optimizer step (adam, lamb),
// one launch over every 8-bit leaf of an optimizer step, in place.
//
// Replaces bitsandbytes_sycl_tpu/ops/optim8.py `_kernel2` (called through
// `optim8_blockwise_fused`, pl.pallas_call at :312), with either codec: the
// dynamic maps, or any 256-entry table per state (the LUT codec of
// `_LutCodec` :115, dynamic8.cuh lut_requant8), and any blocksize.
//
// Per element, with the leaf's row of scalars sc = (b1, b2, eps * c2,
// step_size, decay, gnorm_scale):
//   g  = g * gnorm_scale, 0 where not finite
//   s1 = dec_signed(code1) * absmax1,  s2 = dec_unsigned(code2) * absmax2
//   n1 = s1 * b1 + (1 - b1) * g,       n2 = s2 * b2 + ((1 - b2) * g) * g
//   p' = (p + step_size * (n1 / (sqrt(n2) + eps * c2))) * decay
// and where g was not finite p, s1 and s2 stay; then each state requantizes
// with its block's fresh absmax (state1 with the sign fix, or both with
// stochastic rounding on the leaf's uniforms u). p is stored as p' (the
// functional API's new p) or as p + (p' - p) (the optimizer's update, as
// optax.apply_updates adds it). Every operation rounds where the plain
// version's does (no FMA contraction), so p, the codes and the absmax equal
// ops/optim8._grouped_plain bit for bit. Past a leaf's n, the ragged last
// block reads g = p = 0, code1 127 and code2 0, as the JAX package's kernel
// route pads it: those entries enter the block's absmax (0 under the
// dynamic maps, the tables' entries under the LUT codec, NaN where the old
// absmax is not finite) and are never stored.
//
// Bound on the H100: memory. It reads g and p (4 bytes each) and two codes
// and writes p and two codes: 16 bytes a parameter (the absmax, 8 bytes a
// block, is noise); the floor is those bytes over 3.35 TB/s. At about 150
// instructions a parameter it is close to instruction-bound as well, so
// the design spends few: a persistent grid (kMinCtas CTAs of 256 threads a
// SM) splits the global block index into one contiguous run per CTA, so the
// codec table and the leaf row load once per CTA and leaf, not per
// 2048-element block, and one thread has L2 prefetch the next block's rows
// (cp.async.bulk) while the block computes; a thread owns 8
// consecutive elements (two 16-byte loads of g and of p, one 8-byte load
// of each state's codes, the same stores); both block maxima share one
// barrier; the encode finds its decade by the exponent bits and multiplies
// by n / 0.9 rounded once (dynamic8.cuh). A block's reads all happen before
// its barrier and its absmax writes after it, so the update runs in place.
// The LUT codec stages its tables and their bucket indexes in place of the
// dynamic one and encodes by the bucketed rank (dynamic8.cuh lut_ranks8: a
// byte of the index, then 1-5 independent compares for the usual maps,
// where the binary search of the first LUT body made 8 dependent loads).
//
// Blocks larger than kMaxBlock (the global-max update, block_wise=False)
// take the two-pass body (kPass 1 and 2, dynamic8.cuh): a block's absmax is
// a reduction across CTAs. Pass 1 computes the new states, keeps each
// thread's maxima over the CTA's run of chunks of a block, and folds them
// into the block's scratch slots once a block and CTA (one block reduction
// and one atomic max, not one a chunk); pass 2 recomputes them from
// the same inputs (nothing was written), encodes with the block's maxima
// and writes p, the codes and the absmax (it reads the old absmax from the
// scratch, so writing the new one in place races with no reader, and each
// chunk reads and writes only its own elements, in either order). Pass 1
// reads g and the codes but not p (the states do not depend on it): 6
// bytes a parameter, and pass 2 the bound's 16, so the body moves 22 bytes
// for the bound's 16 and cannot pass 73% of the bound. Pass 1, a light
// streaming reduction, runs 4 CTAs an SM on a grid a third larger than the
// plan's (3 an SM), for more loads in flight. Pass 2 walks each CTA's
// chunks in the reverse of pass 1's order, so its first chunks are the
// ones pass 1 read last, still in the 50 MB L2.
#include "dynamic8.cuh"

namespace {

using namespace dyn8;

// pass 1 keeps fewer values live: 4 CTAs an SM, and a grid a third larger
constexpr int kP1Ctas = 4;

// kPass 0: the one-pass body (bs <= kMaxBlock); 1 and 2: the two passes
// over kMaxBlock chunks of larger blocks. kLut: the LUT codec (never with
// kStoch).
template <int kPass, bool kStoch, bool kLut>
__global__ void __launch_bounds__(kThreads, kPass == 1 ? kP1Ctas : kMinCtas)
optim8_2state_kernel(const Leaf* __restrict__ leaves, int nleaves, const float* __restrict__ scalars,
                     const float* __restrict__ table, long long total, int bs, int delta,
                     int* __restrict__ scratch) {
  constexpr int kWords = kLut ? 2 * kLutWords : kTableWords;
  __shared__ __align__(16) float tab[kWords];
  __shared__ int red[2][2 * kWarps];
  stage_table(table, tab, kWords);
  Walk w{leaves, nleaves};
  float b1 = 0, b2 = 0, eps_c2 = 0, step_size = 0, decay = 0, gscale = 0, omb1 = 0, omb2 = 0;
  int parity = 0;
  int run[2] = {0, 0}, rp = 0;  // pass 1: the thread's maxima over the run's chunks of a block
  const int cpb = kPass == 0 ? 1 : (bs + kMaxBlock - 1) / kMaxBlock;  // chunks a block
  long long lo, hi;
  block_range(total * cpb, lo, hi);
  for (long long i = 0; i < hi - lo; ++i, parity ^= 1) {
    const long long c = kPass == 2 ? hi - 1 - i : lo + i;  // pass 2 backwards
    const long long b = kPass == 0 ? c : c / cpb;
    const int off = kPass == 0 ? 0 : (int)(c - b * cpb) * kMaxBlock;
    if (kPass == 2 ? w.retreat(b, bs) : w.advance(b, bs)) {
      const float* sc = scalars + w.cur.row * 8;
      b1 = sc[0], b2 = sc[1], eps_c2 = sc[2], step_size = sc[3], decay = sc[4], gscale = sc[5];
      omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
    }
    const long long lb = b - w.cur.first;
    if (kPass == 0 && b + 1 < hi) w.prefetch_next(lb, bs);
    const Span s = span(lb, bs, w, off);
    int* slot = scratch + b * kScratchWords;
    const float a1 = kPass == 2 ? __int_as_float(slot[2]) : BNB_OPT_LOADF(w.cur.am1, lb);
    const float a2 = kPass == 2 ? __int_as_float(slot[3]) : BNB_OPT_LOADF(w.cur.am2, lb);
    float gv[kPer], pv[kPer], uv[kPer];
    int c1[kPer], c2[kPer];
    BNB_OPT_LOAD8(w.cur.g, s, 0.0f, gv);
    if (kPass != 1) {
      BNB_OPT_LOAD8(w.cur.p, s, 0.0f, pv);
    } else {  // the states' maxima do not depend on p
#pragma unroll
      for (int k = 0; k < kPer; ++k) pv[k] = 0.0f;
    }
    BNB_OPT_LOADC(w.cur.s1, s, 127, c1);
    BNB_OPT_LOADC(w.cur.s2, s, 0, c2);
    if (kStoch && kPass != 1) BNB_OPT_LOAD8(w.cur.u, s, 0.0f, uv);
#if defined(BNB_PROBE_NO_MATH)
#pragma unroll
    for (int k = 0; k < kPer; ++k) pv[k] = pv[k] + gv[k];
    BNB_OPT_STORE8(w.cur.p, s, pv);
    BNB_OPT_STOREC(w.cur.s1, s, c1);
    BNB_OPT_STOREC(w.cur.s2, s, c2);
    if (threadIdx.x == 0) {
      BNB_OPT_STOREF(w.cur.am1, lb, a1);
      BNB_OPT_STOREF(w.cur.am2, lb, a2);
    }
#else
    float n[2][kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float v1 = __fmul_rn(kLut ? tab[c1[k]] : tab[kDecS + c1[k]], a1);
      const float v2 = __fmul_rn(kLut ? tab[kLutWords + c2[k]] : tab[kDecU + c2[k]], a2);
#if defined(BNB_PROBE_NO_UPDATE)
      float np = pv[k], m1 = v1, m2 = v2;
#else
      float g = __fmul_rn(gv[k], gscale);
      const bool fin = isfinite(g);
      g = fin ? g : 0.0f;
      float m1 = __fadd_rn(__fmul_rn(v1, b1), __fmul_rn(omb1, g));
      float m2 = __fadd_rn(__fmul_rn(v2, b2), __fmul_rn(__fmul_rn(omb2, g), g));
      float np = __fadd_rn(pv[k], __fmul_rn(step_size,
                                            __fdiv_rn(m1, __fadd_rn(__fsqrt_rn(m2), eps_c2))));
      np = __fmul_rn(np, decay);
      if (!fin) {
        np = pv[k];
        m1 = v1;
        m2 = v2;
      }
#endif
      pv[k] = delta ? __fadd_rn(pv[k], __fsub_rn(np, pv[k])) : np;
      n[0][k] = m1;
      n[1][k] = m2;
    }
    float m[2];
    if (kPass == 1) {  // fold the chunk's maxima into the thread's, write nothing else
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (k < s.inb) run[t] = max(run[t], abs_bits(n[t][k]));
      if (threadIdx.x == 0 && off == 0) {
        slot[2] = __float_as_int(a1);
        slot[3] = __float_as_int(a2);
      }
      if (i + 1 == hi - lo || off + kMaxBlock >= bs) {  // the block's last chunk in this run:
        block_max_bits<2>(run, red[rp], m);              // one reduction and one atomic max
        rp ^= 1;
        if (threadIdx.x == 0) {
          atomicMax(slot, __float_as_int(m[0]));
          atomicMax(slot + 1, __float_as_int(m[1]));
        }
        run[0] = run[1] = 0;
      }
      continue;
    }
    BNB_OPT_STORE8(w.cur.p, s, pv);
    if (kPass == 0) {
      block_absmax<2>(n, s.inb, red[parity], m);
    } else {
      m[0] = __int_as_float(slot[0]);
      m[1] = __int_as_float(slot[1]);
    }
    if (threadIdx.x == 0 && off == 0) {
      BNB_OPT_STOREF(w.cur.am1, lb, m[0]);
      BNB_OPT_STOREF(w.cur.am2, lb, m[1]);
    }
    if (kLut) {
      lut_requant8<true>(n[0], m[0], tab, c1);
      lut_requant8<false>(n[1], m[1], tab + kLutWords, c2);
    } else if (kStoch) {
      requant8<true, true, true>(n[0], m[0], uv, tab, c1);
#pragma unroll
      for (int k = 0; k < kPer; ++k) uv[k] = scramble(uv[k]);
      requant8<false, false, true>(n[1], m[1], uv, tab, c2);
    } else {
      requant8<true, true, false>(n[0], m[0], uv, tab, c1);
      requant8<false, false, false>(n[1], m[1], uv, tab, c2);
    }
    BNB_OPT_STOREC(w.cur.s1, s, c1);
    BNB_OPT_STOREC(w.cur.s2, s, c2);
#endif
  }
}

template <int kPass>
void launch(bool stochastic, bool lut, int grid, cudaStream_t st, const Leaf* lv, int nleaves,
            const float* scalars, const float* table, long long total, int bs, int delta,
            int* scratch) {
  if (lut) {
    optim8_2state_kernel<kPass, false, true><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  } else if (stochastic) {
    optim8_2state_kernel<kPass, true, false><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  } else {
    optim8_2state_kernel<kPass, false, false><<<grid, kThreads, 0, st>>>(
        lv, nleaves, scalars, table, total, bs, delta, scratch);
  }
}

// The edge-by-edge encode against the kernels' one on every f32 bit
// pattern, both maps: counts the patterns whose codes differ.
__global__ void encode_sweep_kernel(const float* __restrict__ table, const float* __restrict__ consts,
                                    unsigned long long* __restrict__ mismatches) {
  __shared__ __align__(16) float tab[kTableWords];
  __shared__ float c[32];
  stage_table(table, tab);
  if (threadIdx.x < 23) c[threadIdx.x] = consts[threadIdx.x];
  __syncthreads();
  unsigned long long bad_s = 0, bad_u = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (1ULL << 32); i += stride) {
    const float x = __uint_as_float((uint32_t)i);
    bad_s += encode<true>(x, tab) != encode_cascade<true>(x, c);
    bad_u += encode<false>(x, tab) != encode_cascade<false>(x, c);
  }
  if (bad_s) atomicAdd(mismatches, bad_s);
  if (bad_u) atomicAdd(mismatches + 1, bad_u);
}

// The bucketed rank against the binary search on every f32 bit pattern,
// for each of the two LUT codecs in `table` (ops/optim8.lut_words of two
// tables): counts the patterns whose ranks differ.
__global__ void lut_rank_sweep_kernel(const float* __restrict__ table,
                                      unsigned long long* __restrict__ mismatches) {
  __shared__ __align__(16) float tab[2 * kLutWords];
  stage_table(table, tab, 2 * kLutWords);
  unsigned long long bad[2] = {0, 0};
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x * kPer;
  for (unsigned long long i = ((unsigned long long)blockIdx.x * blockDim.x + threadIdx.x) * kPer;
       i < (1ULL << 32); i += stride) {
    float x[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) x[k] = __uint_as_float((uint32_t)(i + k));
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      int r[kPer];
      lut_ranks8(x, tab + t * kLutWords, r);
#pragma unroll
      for (int k = 0; k < kPer; ++k) bad[t] += r[k] != lut_rank_search(x[k], tab + t * kLutWords);
    }
  }
  if (bad[0]) atomicAdd(mismatches, bad[0]);
  if (bad[1]) atomicAdd(mismatches + 1, bad[1]);
}

}  // namespace

// One launch over a leaf table (two past kMaxBlock): leaves (nleaves rows of
// dyn8::Leaf) and scalars ((R, 8) f32) on the device, total = the leaves'
// blocks, bs the blocksize, grid the persistent CTAs (ops/optim8.leaf_plan).
// delta: 1 stores p as p + (new_p - p), 0 as new_p; stochastic: every leaf
// has u. lut 0: table is ops/dynamic8.kernel_table on the device; lut 1: the
// two states' LUT codecs (ops/optim8.lut_words), never with stochastic.
// scratch: total * kScratchWords int32 on the device where bs > kMaxBlock
// (zeroed here), else unused.
extern "C" int optim8_2state(const void* leaves, int nleaves, const float* scalars,
                             const float* table, long long total, int bs, int grid, int delta,
                             int stochastic, int lut, int* scratch, void* stream) {
  if (nleaves <= 0 || total <= 0 || grid <= 0 || bs <= 0 || (lut && stochastic) ||
      (bs > dyn8::kMaxBlock && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dyn8::Leaf* lv = reinterpret_cast<const dyn8::Leaf*>(leaves);
  if (bs <= dyn8::kMaxBlock) {
    launch<0>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs, delta, scratch);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaMemsetAsync(scratch, 0, total * dyn8::kScratchWords * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  launch<1>(stochastic, lut, grid * kP1Ctas / dyn8::kMinCtas, st, lv, nleaves, scalars, table, total,
            bs, delta, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#ifndef BNB_PROBE_PASS1_ONLY  // chip_smoke.py --probe optim: the first pass's time alone
  launch<2>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs, delta, scratch);
#endif
  return (int)cudaGetLastError();
}

// mismatches: 2 zeroed u64 on the device (signed map, unsigned map);
// consts: ops/dynamic8.encode_consts on the device.
extern "C" int dyn8_encode_sweep(const float* table, const float* consts,
                                 unsigned long long* mismatches, void* stream) {
  encode_sweep_kernel<<<132 * 8, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(table, consts,
                                                                                 mismatches);
  return (int)cudaGetLastError();
}

// mismatches: 2 zeroed u64 on the device (one per codec); table: two LUT
// codecs' words (ops/optim8.lut_words) on the device.
extern "C" int lut_rank_sweep(const float* table, unsigned long long* mismatches, void* stream) {
  lut_rank_sweep_kernel<<<132 * 8, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(table,
                                                                                   mismatches);
  return (int)cudaGetLastError();
}
