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
// equal it bit for bit.
//
// Bound on the H100: memory, 14 bytes a parameter (g and p read, p written,
// one code read and written) over 3.35 TB/s.
//
// Design, blocks of up to kMaxBlock: kernel J's one-pass body with one
// state: the persistent grid of contiguous block runs walking the leaf
// table with an L2 prefetch of the next block, 8 consecutive elements a
// thread (16-byte accesses of g and p, an 8-byte access of the codes), one
// block max-reduction a block, the encode by exponent bits with the codec
// table in shared memory (dynamic8.cuh), or the LUT codec's bucketed rank.
//
// Larger blocks up to the resident capacity (ops/optim8.resident_max:
// 903,552 elements under the dynamic maps, 845,696 under a LUT codec; the
// global-max update, block_wise=False, takes one block a leaf), in a table
// of enough of them (ops/optim8.optim8_route), take the resident body: a
// cluster of up to 16 CTAs (one an SM, 512 threads) owns one block at a
// time, each CTA a slice of per_cta elements. The new p does not depend on
// the block's new absmax, only the codes do, so a sweep reads g, p and the
// codes once, writes p at once and holds the new states in the CTA's
// shared memory (up to 225 KB); each CTA's maximum goes to every CTA of
// the cluster through distributed shared memory (an integer max of bit
// patterns, so the order does not matter and a NaN wins), one cluster
// barrier, and the next sweep encodes the held states and writes their
// codes while it reads and updates the cluster's next block in their
// place. A block moves the bound's 14 bytes a parameter, in one launch,
// with no scratch. Every read of a block's old codes and absmax comes
// before its cluster barrier, rank 0 writes the new absmax after it; the
// exchange slots alternate between two rows by block, so a fast CTA's
// next maximum never meets a slow CTA's read of this one. Its leaf rows
// are walked as slices (pointers from the slice's first element), not as
// a copy of the leaf walk per block in flight, which keeps the sweep's
// registers few.
//
// Blocks past that, and tables of few blocks, take the two-pass body over
// kMaxBlock chunks of blocks: pass 1 folds each chunk's maximum into its
// block's slot (a reduction and an atomic max a chunk), pass 2 recomputes
// the update and encodes with the block's maximum. Pass 1 reads p at every
// weight decay: at weight_decay 0 an infinite p still makes g + p * 0 NaN,
// which enters the block's maximum.
#include "dynamic8.cuh"
#include "wgmma.cuh"

namespace {

using namespace dyn8;

enum Op { kMomentum = 0, kRmsprop = 1, kAdagrad = 2, kLion = 3 };

// the resident body: 512 threads, one CTA an SM, clusters of up to 16;
// dynamic shared memory: the held states (per_cta f32), the codec table,
// two rows of the warps' maxima, two rows of the cluster's CTA maxima
// (ops/optim8.RESIDENT_*)
constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;
constexpr int kResChunk = kResThreads * kPer;  // elements a sweep step covers
constexpr int kMaxCluster = 16;
constexpr int kResSmemMax = 225 * 1024;
constexpr int kResSlotBytes = (2 * kResWarps + 2 * kMaxCluster) * 4;

// one leaf row of the step's scalars
struct Scalars1 {
  float b1 = 0, b2 = 0, eps = 0, lr = 0, wd = 0, gscale = 0, is_step1 = 0, omb1 = 0, omb2 = 0;

  __device__ __forceinline__ void load(const float* sc) {
    b1 = sc[0], b2 = sc[1], eps = sc[2], lr = sc[3], wd = sc[4], gscale = sc[5], is_step1 = sc[6];
    omb1 = __fsub_rn(1.0f, b1), omb2 = __fsub_rn(1.0f, b2);
  }
};

// The new state m and new p' of one element from its g, p and decoded old
// state v1 (the same roundings as ops/optim8._kernel1_plain).
template <int kOp>
__device__ __forceinline__ void step1(float gv, float p, float v1, const Scalars1& sc, float& m,
                                      float& np) {
#if defined(BNB_PROBE_NO_UPDATE)
  np = p, m = v1;
#else
  float g = __fmul_rn(gv, sc.gscale);
  const bool fin = isfinite(g);
  g = fin ? g : 0.0f;
  g = __fadd_rn(g, __fmul_rn(p, sc.wd));
  if (kOp == kMomentum) {
    m = sc.is_step1 > 0.0f ? g : __fadd_rn(__fmul_rn(v1, sc.b1), g);
    np = __fsub_rn(p, __fmul_rn(sc.lr, m));
  } else if (kOp == kRmsprop) {
    m = __fadd_rn(__fmul_rn(v1, sc.b1), __fmul_rn(__fmul_rn(sc.omb1, g), g));
    np = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, g), __fadd_rn(__fsqrt_rn(m), sc.eps)));
  } else if (kOp == kAdagrad) {
    m = __fadd_rn(v1, __fmul_rn(g, g));
    np = __fsub_rn(p, __fdiv_rn(__fmul_rn(sc.lr, g), __fadd_rn(__fsqrt_rn(m), sc.eps)));
  } else {
    const float d = __fadd_rn(__fmul_rn(v1, sc.b1), __fmul_rn(sc.omb1, g));
    const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    np = __fsub_rn(p, __fmul_rn(sc.lr, sgn));
    m = __fadd_rn(__fmul_rn(v1, sc.b2), __fmul_rn(sc.omb2, g));
  }
  if (!fin) {
    np = p;
    m = v1;
  }
#endif
}

__device__ __forceinline__ float stored_p(float p, float np, int delta) {
  return delta ? __fadd_rn(p, __fsub_rn(np, p)) : np;
}

// kPass 0: the one-pass body (bs <= kMaxBlock); 1 and 2: the two passes
// over kMaxBlock chunks of larger blocks off the resident route. kLut: the
// LUT codec (never with kStoch).
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
  Scalars1 sc;
  int parity = 0;
  const int cpb = kPass == 0 ? 1 : (bs + kMaxBlock - 1) / kMaxBlock;  // chunks a block
  long long lo, hi;
  block_range(total * cpb, lo, hi);
  for (long long c = lo; c < hi; ++c, parity ^= 1) {
    const long long b = kPass == 0 ? c : c / cpb;
    const int off = kPass == 0 ? 0 : (int)(c - b * cpb) * kMaxBlock;
    if (w.advance(b, bs)) sc.load(scalars + w.cur.row * 8);
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
      float np;
      step1<kOp>(gv[k], pv[k], v1, sc, n[0][k], np);
      pv[k] = stored_p(pv[k], np, delta);
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

// A block's slice as the resident body's sweeps walk it: the leaf's rows
// from the slice's first element, and how many of the slice's lim elements
// (those of the block) lie in the leaf; past that the ragged block's tail
// reads as the JAX package pads it.
struct Slice {
  const float* g;
  float* p;
  uint8_t* s1;
  const float* u;
  int inleaf;
  bool aligned;
};

__device__ __forceinline__ Slice slice_of(const Walk& w, long long lb, int bs, int base, int lim) {
  const long long start = lb * bs + base;
  return Slice{w.cur.g + start, w.cur.p + start, w.cur.s1 + start,
               w.cur.u == nullptr ? nullptr : w.cur.u + start,
               (int)max(0LL, min((long long)lim, w.cur.n - start)), w.aligned};
}

// elements e .. e + 7 of a slice (e < lim)
__device__ __forceinline__ Span slice_span(int e, int lim, const Slice& s) {
  Span sp;
  sp.i0 = e;
  sp.inb = min(kPer, lim - e);
  sp.inl = max(0, min(sp.inb, s.inleaf - e));
  sp.vec = sp.inl == kPer && s.aligned;
  return sp;
}

// One sweep of the resident body over the CTA's slice, 8 elements a
// thread a step (element e of the slice): kEncode encodes block e's held
// states with its maximum amax and writes its codes; kUpdate reads block
// n's g, p and codes, writes p and holds its new states in place of block
// e's (the same thread, the same words), folding their abs bits into x.
// Both at once overlap the next block's loads with this block's encode.
template <int kOp, bool kStoch, bool kLut, bool kEncode, bool kUpdate>
__device__ __forceinline__ void res_sweep(const Slice& se, float amax, const Slice& sn, float a1,
                                          const Scalars1& sc, int delta, int lim, float* held,
                                          const float* tab, int& x) {
  for (int e = (int)threadIdx.x * kPer; e < lim; e += kResChunk) {
    float gv[kPer], pv[kPer];
    int c1[kPer];
    const Span s = slice_span(e, lim, sn);
    if (kUpdate) {
      BNB_OPT_LOAD8(sn.g, s, 0.0f, gv);
      BNB_OPT_LOAD8(sn.p, s, 0.0f, pv);
      BNB_OPT_LOADC(sn.s1, s, 127, c1);
    }
    if (kEncode) {
      const Span t = slice_span(e, lim, se);
      float uv[kPer];
      if (kStoch) BNB_OPT_LOAD8(se.u, t, 0.0f, uv);
      const float4 lo4 = reinterpret_cast<const float4*>(held + e)[0];
      const float4 hi4 = reinterpret_cast<const float4*>(held + e)[1];
      const float v[kPer] = {lo4.x, lo4.y, lo4.z, lo4.w, hi4.x, hi4.y, hi4.z, hi4.w};
      int ce[kPer];
      if (kLut) {
        lut_requant8<true>(v, amax, tab, ce);
      } else {
        requant8<true, true, kStoch>(v, amax, uv, tab, ce);
      }
      BNB_OPT_STOREC(se.s1, t, ce);
    }
    if (kUpdate) {
      float m[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float v1 = __fmul_rn(kLut ? tab[c1[k]] : tab[kDecS + c1[k]], a1);
        float np;
        step1<kOp>(gv[k], pv[k], v1, sc, m[k], np);
        pv[k] = stored_p(pv[k], np, delta);
        if (k < s.inb) x = max(x, abs_bits(m[k]));
      }
      BNB_OPT_STORE8(sn.p, s, pv);
      reinterpret_cast<float4*>(held + e)[0] = make_float4(m[0], m[1], m[2], m[3]);
      reinterpret_cast<float4*>(held + e)[1] = make_float4(m[4], m[5], m[6], m[7]);
    }
  }
}

// The resident body (blocks of kMaxBlock + 1 to the resident capacity): a
// cluster of ncl CTAs per block, each holding per_cta elements of it; a
// persistent grid of clusters, each a contiguous run of the leaf table's
// blocks. Per block: the exchange of the CTAs' maxima and one cluster
// barrier, then one sweep that encodes this block and updates the next.
template <int kOp, bool kStoch, bool kLut>
__global__ void __launch_bounds__(kResThreads, 1)
optim8_1state_resident(const Leaf* __restrict__ leaves, int nleaves, const float* __restrict__ scalars,
                       const float* __restrict__ table, long long total, int bs, int delta, int ncl,
                       int per_cta) {
  constexpr int kWords = kLut ? kLutWords : kTableWords;
  extern __shared__ __align__(16) float smem[];
  float* held = smem;                                    // the slice's new states
  float* tab = smem + per_cta;                           // per_cta % 8 == 0: 16-byte aligned
  int* red = reinterpret_cast<int*>(tab + kWords);       // [2][kResWarps]
  int* slots = red + 2 * kResWarps;                      // [2][kMaxCluster]
  stage_table<kResThreads>(table, tab, kWords);
#if !defined(BNB_PROBE_NO_EXCHANGE) && !defined(BNB_PROBE_SWEEP1_ONLY)
  cluster_sync();  // every CTA of the cluster exists before a peer writes its slots
#endif
  const int rank = (int)cluster_rank();
  const int base = rank * per_cta;            // the slice's first element in a block
  const int lim = min(per_cta, bs - base);    // the slice's elements of a block
  const long long nclusters = gridDim.x / ncl, cid = blockIdx.x / ncl;
  const long long lo = total * cid / nclusters, hi = total * (cid + 1) / nclusters;
  Walk w{leaves, nleaves};
  Scalars1 sc;
  Slice cur{};
  float* am = nullptr;  // the current block's absmax
  int x = 0, parity = 0;
  if (lo < hi) {  // block lo's update
    w.advance(lo, bs);
    sc.load(scalars + w.cur.row * 8);
    cur = slice_of(w, lo - w.cur.first, bs, base, lim);
    am = w.cur.am1 + (lo - w.cur.first);
    res_sweep<kOp, kStoch, kLut, false, true>(cur, 0.0f, cur, BNB_OPT_LOADF(am, 0), sc, delta, lim,
                                               held, tab, x);
  }
  for (long long b = lo; b < hi; ++b, parity ^= 1) {
    // the block's maximum: the CTA's, then every CTA's through each CTA's
    // row of slots (an integer max of abs bit patterns, in any order)
    int xs[1] = {x};
    float mx[1];
    block_max_bits<1, kResWarps>(xs, red + parity * kResWarps, mx);
#if defined(BNB_PROBE_NO_EXCHANGE) || defined(BNB_PROBE_SWEEP1_ONLY)
    const float amax = mx[0];
#else
    int* row = slots + parity * kMaxCluster;
    if ((int)threadIdx.x < ncl)
      st_peer_u32(peer_addr(row + rank, threadIdx.x), (uint32_t)__float_as_int(mx[0]));
    cluster_sync();
    int y = row[0];
    for (int r = 1; r < ncl; ++r) y = max(y, row[r]);
    const float amax = __int_as_float(y);
#endif
    if (rank == 0 && threadIdx.x == 0) BNB_OPT_STOREF(am, 0, amax);
    x = 0;
    if (b + 1 < hi) {  // encode this block, update the next
      if (w.advance(b + 1, bs)) sc.load(scalars + w.cur.row * 8);
      const Slice next = slice_of(w, b + 1 - w.cur.first, bs, base, lim);
      am = w.cur.am1 + (b + 1 - w.cur.first);
#if defined(BNB_PROBE_SWEEP1_ONLY)  // the updates alone: no codes written
      res_sweep<kOp, kStoch, kLut, false, true>(cur, amax, next, BNB_OPT_LOADF(am, 0), sc, delta,
                                                 lim, held, tab, x);
#else
      res_sweep<kOp, kStoch, kLut, true, true>(cur, amax, next, BNB_OPT_LOADF(am, 0), sc, delta,
                                                lim, held, tab, x);
#endif
      cur = next;
    } else {
#if !defined(BNB_PROBE_SWEEP1_ONLY)
      res_sweep<kOp, kStoch, kLut, true, false>(cur, amax, cur, 0.0f, sc, delta, lim, held, tab, x);
#endif
    }
  }
#if !defined(BNB_PROBE_NO_EXCHANGE) && !defined(BNB_PROBE_SWEEP1_ONLY)
  cluster_sync();  // no CTA leaves while a peer may still write its slots
#endif
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

// The resident body's attributes, set once a device: the largest dynamic
// shared memory, and clusters past the portable 8 CTAs.
template <auto kernel>
cudaError_t allow_resident_once() {
  static cudaError_t done[64];
  static bool set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!set[dev]) {
    done[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kResSmemMax);
    if (done[dev] == cudaSuccess)
      done[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    set[dev] = true;
  }
  return done[dev];
}

// cudaOccupancyMaxActiveClusters of a body at (clusters of ncl, smem bytes),
// asked once a device and shape.
template <auto kernel>
cudaError_t active_clusters(int ncl, int smem, cudaLaunchConfig_t& cfg, int& n) {
  struct Entry {
    int dev, ncl, smem, n;
  };
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].ncl == ncl && cache[i].smem == smem) {
      n = cache[i].n;
      return cudaSuccess;
    }
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e == cudaSuccess && used < 64) cache[used++] = Entry{dev, ncl, smem, n};
  return e;
}

template <int kOp, bool kStoch, bool kLut>
int launch_resident(int grid, cudaStream_t st, const Leaf* lv, int nleaves, const float* scalars,
                    const float* table, long long total, int bs, int delta, int ncl, int per_cta,
                    int smem) {
  auto kernel = optim8_1state_resident<kOp, kStoch, kLut>;
  cudaError_t e = allow_resident_once<optim8_1state_resident<kOp, kStoch, kLut>>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid / ncl * ncl, 1, 1);
  cfg.blockDim = dim3(kResThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  e = active_clusters<optim8_1state_resident<kOp, kStoch, kLut>>(ncl, smem, cfg, fit);
  if (e != cudaSuccess) return (int)e;
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;  // no cluster fits: raise, no fallback
  cfg.gridDim.x = min(grid / ncl, fit) * ncl;  // a persistent grid: every cluster resident
  e = cudaLaunchKernelEx(&cfg, kernel, lv, nleaves, scalars, table, total, bs, delta, ncl, per_cta);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launches of one op on the plan's route: the resident body (ncl > 0),
// the one-pass body, or the two passes (scratch zeroed first).
template <int kOp>
int launch_op(bool stochastic, bool lut, int grid, cudaStream_t st, const Leaf* lv, int nleaves,
              const float* scalars, const float* table, long long total, int bs, int delta,
              int ncl, int per_cta, int smem, int* scratch) {
  if (ncl > 0) {
    if (lut)
      return launch_resident<kOp, false, true>(grid, st, lv, nleaves, scalars, table, total, bs,
                                               delta, ncl, per_cta, smem);
    if (stochastic)
      return launch_resident<kOp, true, false>(grid, st, lv, nleaves, scalars, table, total, bs,
                                               delta, ncl, per_cta, smem);
    return launch_resident<kOp, false, false>(grid, st, lv, nleaves, scalars, table, total, bs,
                                              delta, ncl, per_cta, smem);
  }
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
// dynamic maps or one LUT codec. The route is ops/optim8.leaf_plan's:
// ncl > 0 takes the resident body (bs past kMaxBlock) with clusters of ncl
// CTAs, per_cta elements and smem bytes of dynamic shared memory a CTA, and
// at most grid / ncl clusters (fewer where fewer fit the card at once); no
// scratch. ncl == 0: the one-pass body, or past kMaxBlock the two passes
// with total * kScratchWords int32 of scratch.
extern "C" int optim8_1state(int op, const void* leaves, int nleaves, const float* scalars,
                             const float* table, long long total, int bs, int grid, int delta,
                             int stochastic, int lut, int ncl, int per_cta, int smem, int* scratch,
                             void* stream) {
  const int words = lut ? dyn8::kLutWords : dyn8::kTableWords;
  if (nleaves <= 0 || total <= 0 || grid <= 0 || bs <= 0 || op < 0 || op > 3 ||
      (lut && stochastic) || ncl < 0 || ncl > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  if (ncl > 0 && (bs <= dyn8::kMaxBlock || grid < ncl || per_cta <= 0 || per_cta % dyn8::kPer ||
                  (long long)per_cta * ncl < bs ||
                  smem != 4 * per_cta + 4 * words + kResSlotBytes || smem > kResSmemMax))
    return (int)cudaErrorInvalidValue;
  if (ncl == 0 && bs > dyn8::kMaxBlock && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dyn8::Leaf* lv = reinterpret_cast<const dyn8::Leaf*>(leaves);
  switch (op) {
    case kMomentum:
      return launch_op<kMomentum>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                  delta, ncl, per_cta, smem, scratch);
    case kRmsprop:
      return launch_op<kRmsprop>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                 delta, ncl, per_cta, smem, scratch);
    case kAdagrad:
      return launch_op<kAdagrad>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                                 delta, ncl, per_cta, smem, scratch);
    default:
      return launch_op<kLion>(stochastic, lut, grid, st, lv, nleaves, scalars, table, total, bs,
                              delta, ncl, per_cta, smem, scratch);
  }
}
