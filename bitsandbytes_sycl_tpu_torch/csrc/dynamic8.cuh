// The 8-bit dynamic-map codec and the leaf walk of the optimizer kernels J
// (optim8_2state.cu) and K (optim8_1state.cu): the arithmetic of
// ops/dynamic8.py, operation by operation, with the rounding intrinsics
// (__fmul_rn, __fsub_rn, __fdiv_rn) so that nvcc cannot contract a product
// and a sum into an FMA: the codes must equal the plain PyTorch version's
// bit for bit.
//
// Every CTA copies the codec table (ops/dynamic8.kernel_table, 1058 f32
// words) into shared memory once: the two 256-entry decode tables, then,
// per map, the decade search by exponent bits (binade_table: edges below
// the binade and the one edge inside it) and the in-decade grid factors
// (decade_table: 10^(6-i) and n / 0.9 rounded once), then the top edges.
// Encode is then one table row by the exponent field, one compare, one row
// by decade and ceil(y) - 1 on the uniform in-decade grid, y = (a *
// 10^(6-i) - 0.1) * (n / 0.9): the same index and the same roundings as
// the edge-by-edge encode with a division per element (encode_cascade,
// kept for the card's exhaustive check over every f32).
//
// The LUT codec (ops/optim8.LutCodec, any 256-entry table) takes the
// place of that table with kLutWords words per state (ops/optim8.lut_words):
// the decode table, the f32 midpoints between the table's sorted distinct
// values padded with +inf to 256, the rank -> code bytes, n_neg, top, the
// largest bucket occupancy, and a bucket index: one byte per value of the
// top kLutBucketBits bits of an f32's order-preserving key (-0.0 keyed as
// +0.0), the count of midpoints in lower buckets (ops/optim8._bucket_index).
// Encode takes x's bucket, that least rank, and adds the few midpoints
// from it on (the largest occupancy, 1-5 for the usual maps) that lie
// below x: rank = #{mids < x}, NaN at rank 0, as the 8-step binary search
// (lut_rank_search, kept for the card's exhaustive check) finds it, with
// independent loads from neighbouring words instead of a chain of 8
// dependent ones; then state1's sign fix in rank space, then the code
// byte. Decode is one shared-memory load.
//
// The step's leaves come as a table of Leaf rows (ops/optim8.py builds it
// on the host each step and copies it with one asynchronous copy). A
// persistent grid splits the global block index into one contiguous run per
// CTA; each CTA keeps its current leaf, steps forward through the table as
// its blocks advance, and has L2 fetch its next block while it computes.
// A block larger than kMaxBlock is walked as chunks of kMaxBlock elements,
// a CTA step each, in two launches (the two-pass body of the kernels): the
// first folds each chunk's state maxima into its block's slots of a scratch
// (an atomic max of bit patterns) and keeps the block's old absmax there;
// the second recomputes the update from the unchanged inputs, encodes with
// the block's maximum and writes p, the codes and the absmax. The walk
// goes either way through the leaf table (kernel J's second pass runs its
// chunks backwards). Kernel K's resident body (optim8_1state.cu) walks it
// by cluster instead, a block at a time.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dyn8 {

constexpr int kThreads = 256;             // one CTA works on one quantization block at a time
constexpr int kPer = 8;                   // consecutive elements of the block a thread owns
constexpr int kMaxBlock = kThreads * kPer;  // the one-pass body: blocksize <= 2048
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 3;               // CTAs per SM the registers must allow

// word offsets in the codec table (ops/dynamic8.KERNEL_TABLE_PARTS)
constexpr int kDecS = 0, kDecU = 256, kBinS = 512, kBinU = 770, kDecadeS = 1028, kDecadeU = 1042,
              kTopS = 1056, kTopU = 1057, kTableWords = 1058;
constexpr unsigned kNanBinade = 128;
// word offsets of one LUT codec (ops/optim8.LUT_WORDS, LUT_BUCKET_BITS)
constexpr int kLutBucketBits = 14;
constexpr int kLutMids = 256, kLutCode = 512, kLutNNeg = 576, kLutTop = 577, kLutMost = 578,
              kLutIndex = 580, kLutWords = kLutIndex + (1 << kLutBucketBits) / 4;

// One row of the leaf table (ops/optim8.LEAF_WORDS int64 words). A 1-state
// leaf has s2 = am2 = null; u is null unless rounding is stochastic.
struct Leaf {
  const float* g;
  float* p;
  uint8_t* s1;
  float* am1;
  uint8_t* s2;
  float* am2;
  const float* u;
  long long n;      // elements
  long long first;  // first global block
  long long row;    // row of the step's (R, 8) scalars
};
static_assert(sizeof(Leaf) == 80, "Leaf must match ops/optim8.LEAF_WORDS");

__device__ __forceinline__ float exp2i(int i) { return __int_as_float((i + 127) << 23); }

// The block max of |state| as the max of the bit patterns: for non-negative
// floats their int32 order is the float order, and a NaN (above +inf) wins,
// as torch.amax propagates it (every NaN the card makes has the same bits).
__device__ __forceinline__ int abs_bits(float v) { return __float_as_int(fabsf(v)); }

// ops/dynamic8.dynamic_encode for one value; tab is the shared codec table.
template <bool kSigned>
__device__ __forceinline__ int encode(float x, const float* tab) {
  const float2* bin = reinterpret_cast<const float2*>(tab + (kSigned ? kBinS : kBinU));
  const float2* dec = reinterpret_cast<const float2*>(tab + (kSigned ? kDecadeS : kDecadeU));
  float a = kSigned ? fabsf(x) : (x > 0.0f || x != x ? x : 0.0f);
  a = (a < 1.0f || a != a) ? a : 1.0f;  // jnp.minimum: NaN stays NaN
  const float2 be = bin[min((__float_as_uint(a) >> 23) & 0xffu, kNanBinade)];
  const int cnt = __float_as_int(be.x) + (a > be.y ? 1 : 0);
  const int i = cnt > 0 ? cnt - 1 : 0;
  const float2 dc = dec[i];
  // the grid in integers: y lies in about [0, n] (it is small and exact),
  // so ceil(y) by one rounding-up conversion gives encode_cascade's
  // float min(max(ceil(y) - 1, 0), n - 1) and base + j exactly
  const int n = kSigned ? 1 << i : 2 << i;
  const int base = kSigned ? n : n - 1;
  const float y = __fmul_rn(__fsub_rn(__fmul_rn(a, dc.x), 0.1f), dc.y);
  int r = base + min(max(__float2int_ru(y) - 1, 0), n - 1);
  if (cnt == 0) r = 0;
  if (a > tab[kSigned ? kTopS : kTopU]) r = kSigned ? 128 : 255;
  if (kSigned) return x < 0.0f ? 127 - min(r, 127) : 127 + r;
  return r;
}

// The edge-by-edge encode (7 compares, one IEEE division per value), the
// reference of the exhaustive check. c: ops/dynamic8.encode_consts.
template <bool kSigned>
__device__ __forceinline__ int encode_cascade(float x, const float* c) {
  const float* edges = kSigned ? c : c + 8;
  const float* inv_scale = c + 16;
  float a = kSigned ? fabsf(x) : (x > 0.0f || x != x ? x : 0.0f);
  a = (a < 1.0f || a != a) ? a : 1.0f;
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < 7; ++e) cnt += edges[e] < a ? 1 : 0;
  const int i = cnt > 0 ? cnt - 1 : 0;
  const float n = kSigned ? exp2i(i) : exp2i(i + 1);
  const float base = kSigned ? n : __fsub_rn(n, 1.0f);
  const float y = __fmul_rn(__fsub_rn(__fmul_rn(a, inv_scale[i]), 0.1f), __fdiv_rn(n, 0.9f));
  const float j = fminf(fmaxf(ceilf(y) - 1.0f, 0.0f), __fsub_rn(n, 1.0f));
  int r = (int)__fadd_rn(base, j);
  if (cnt == 0) r = 0;
  if (a > edges[7]) r = kSigned ? 128 : 255;
  if (kSigned) return x < 0.0f ? 127 - min(r, 127) : 127 + r;
  return r;
}

// State1's sign preservation (ops/optim8._apply_sign_fix, n_neg 127, top 255).
__device__ __forceinline__ int sign_fix(int r, float normed) {
  const bool mism = (r < 127) != (bool)signbit(normed);
  const int step = normed > 0.0f ? 1 : -1;
  return mism ? min(max(r + step, 0), 255) : r;
}

// ops/optim8.LutCodec.rank by binary search: #{mids < x} over the
// midpoints padded with +inf to 256 (a monotone predicate, so 8 halving
// steps find it; NaN compares false everywhere and stays at rank 0). The
// reference of the card's exhaustive check of lut_ranks8.
__device__ __forceinline__ int lut_rank_search(float x, const float* lut) {
  const float* mids = lut + kLutMids;
  int r = 0;
#pragma unroll
  for (int s = 128; s > 0; s >>= 1) r += x > mids[r + s - 1] ? s : 0;
  return r;
}

// The same rank of 8 values at once through the bucket index
// (ops/optim8.lut_bucket_rank): midpoints of lower buckets lie below x,
// those of higher buckets and the +inf padding (mids[255] is always
// padding) do not. The scan runs over the candidates, each step one
// independent load for every value, so the 8 values' loads overlap.
__device__ __forceinline__ void lut_ranks8(const float (&x)[kPer], const float* lut,
                                           int (&r)[kPer]) {
  const float* mids = lut + kLutMids;
  const uint8_t* index = reinterpret_cast<const uint8_t*>(lut + kLutIndex);
  int lo[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    uint32_t u = __float_as_uint(x[k]);
    u = (u & 0x7fffffffu) ? u : 0u;  // -0.0 keyed as +0.0
    const uint32_t key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    lo[k] = index[key >> (32 - kLutBucketBits)];
    r[k] = lo[k];
  }
  const int most = __float_as_int(lut[kLutMost]);
  for (int j = 0; j < most; ++j) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) r[k] += mids[min(lo[k] + j, 255)] < x[k] ? 1 : 0;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) r[k] = x[k] != x[k] ? 0 : r[k];
}

// Requantize one state of the thread's 8 values through a LUT codec with
// the block's absmax m (state1: the sign fix in rank space).
template <bool kSignFix>
__device__ __forceinline__ void lut_requant8(const float (&v)[kPer], float m, const float* lut,
                                             int (&c)[kPer]) {
  const float inv = m > 0.0f ? __fdiv_rn(1.0f, m) : 0.0f;
  const uint8_t* code = reinterpret_cast<const uint8_t*>(lut + kLutCode);
  const int n_neg = __float_as_int(lut[kLutNNeg]), top = __float_as_int(lut[kLutTop]);
  float normed[kPer];
  int r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) normed[k] = __fmul_rn(v[k], inv);
  lut_ranks8(normed, lut, r);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (kSignFix) {
      const bool mism = (r[k] < n_neg) != (bool)signbit(normed[k]);
      r[k] = mism ? min(max(r[k] + (normed[k] > 0.0f ? 1 : -1), 0), top) : r[k];
    }
    c[k] = code[r[k]];
  }
}

// ops/dynamic8.stochastic_adjust: step to the bracketing neighbour with
// probability |x - v_c| / |v_n - v_c|; dec is the map's decode table.
__device__ __forceinline__ int stochastic(int c, float x, float u, const float* dec) {
  const float vc = dec[c];
  const int c2 = min(max(c + (x > vc ? 1 : -1), 0), 255);
  const float denom = __fsub_rn(dec[c2], vc);
  float prob = denom != 0.0f ? __fdiv_rn(__fsub_rn(x, vc), denom) : 0.0f;
  prob = fminf(fmaxf(prob, 0.0f), 1.0f);
  return u < prob ? c2 : c;
}

// state2's noise: the golden-ratio scramble of state1's uniforms.
__device__ __forceinline__ float scramble(float u) {
  return fmodf(__fadd_rn(__fmul_rn(u, 0.6180339887f), 0.3819660113f), 1.0f);
}

// The CTA's share of the step's blocks: a contiguous run, so it crosses few
// leaf boundaries and its next block usually follows its current one.
__device__ __forceinline__ void block_range(long long total, long long& lo, long long& hi) {
  lo = total * blockIdx.x / gridDim.x;
  hi = total * (blockIdx.x + 1) / gridDim.x;
}

// Ask L2 for `bytes` at p (16-byte aligned, a multiple of 16) without
// waiting: the next block's rows arrive while this one computes.
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
#if !defined(BNB_PROBE_NO_COPY)
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p), "r"(bytes) : "memory");
#endif
}

// The CTA's place in the leaf table: the leaf holding global block b, for
// b that only grows (advance) or, kernel J's second pass, only shrinks
// (retreat). Every thread walks alike (the table is read through L1, the
// same row by all).
struct Walk {
  const Leaf* leaves;
  int nleaves;
  int l = -1;
  long long next = 0;  // first block of leaf l + 1
  Leaf cur;
  bool aligned = false;  // 16-byte g, p, u and 8-byte code rows: vector accesses

  __device__ __forceinline__ bool advance(long long b, int bs) {
    if (b < next) return false;
    while (l + 1 < nleaves && leaves[l + 1].first <= b) ++l;
    load(bs);
    return true;
  }

  // the same for b that only shrinks (after a first call that walks
  // forwards): back to the last leaf starting at or before b
  __device__ __forceinline__ bool retreat(long long b, int bs) {
    if (l < 0) return advance(b, bs);
    if (b >= cur.first) return false;
    while (l > 0 && leaves[l].first > b) --l;
    load(bs);
    return true;
  }

  __device__ __forceinline__ void load(int bs) {
    cur = leaves[l];
    next = l + 1 < nleaves ? leaves[l + 1].first : (1LL << 62);
    const uintptr_t a16 = (uintptr_t)cur.g | (uintptr_t)cur.p | (uintptr_t)cur.u;
    const uintptr_t a8 = (uintptr_t)cur.s1 | (uintptr_t)cur.s2;
    aligned = (a16 & 15) == 0 && (a8 & 7) == 0 && bs % kPer == 0;
  }

  // Thread 0 prefetches block lb + 1 of the current leaf into L2 when it
  // lies whole in the leaf and every row of the leaf is 16-byte aligned.
  __device__ __forceinline__ void prefetch_next(long long lb, int bs) const {
    const long long e = (lb + 1) * bs;
    if (threadIdx.x != 0 || e + bs > cur.n || bs % 16 != 0 || !aligned ||
        (((uintptr_t)cur.s1 | (uintptr_t)cur.s2) & 15) != 0)
      return;
    prefetch_l2(cur.g + e, bs * 4);
    prefetch_l2(cur.p + e, bs * 4);
    prefetch_l2(cur.s1 + e, bs);
    if (cur.s2 != nullptr) prefetch_l2(cur.s2 + e, bs);
    if (cur.u != nullptr) prefetch_l2(cur.u + e, bs * 4);
  }
};

// A thread's share of one block: elements [e0, e0 + 8) of the block lie in
// it up to `inb` (the rest belong to no block), in the leaf up to `inl`
// (between inl and inb: the ragged tail, read as the JAX package pads it).
struct Span {
  long long i0;  // index in the leaf of the thread's first element
  int inb, inl;
  bool vec;      // all 8 in the leaf, vector accesses allowed
};

// off: the chunk's first element in the block (0 unless the block is
// larger than kMaxBlock)
__device__ __forceinline__ Span span(long long lb, int bs, const Walk& w, int off = 0) {
  Span s;
  const int e0 = off + threadIdx.x * kPer;
  s.i0 = lb * bs + e0;
  s.inb = e0 < bs ? min(kPer, bs - e0) : 0;
  const long long left = w.cur.n - s.i0;
  s.inl = left <= 0 ? 0 : (int)min((long long)s.inb, left);
  s.vec = s.inl == kPer && w.aligned;
  return s;
}

// 8 floats of x from i0 (fill past inl)
__device__ __forceinline__ void load8(const float* x, const Span& s, float fill, float (&v)[kPer]) {
  if (s.vec) {
    const float4 a = *reinterpret_cast<const float4*>(x + s.i0);
    const float4 b = *reinterpret_cast<const float4*>(x + s.i0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = k < s.inl ? x[s.i0 + k] : fill;
  }
}

__device__ __forceinline__ void store8(float* x, const Span& s, const float (&v)[kPer]) {
  if (s.vec) {
    *reinterpret_cast<float4*>(x + s.i0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(x + s.i0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < s.inl) x[s.i0 + k] = v[k];
  }
}

// 8 codes from i0 (fill past inl), one byte each in c
__device__ __forceinline__ void load_codes(const uint8_t* x, const Span& s, int fill, int (&c)[kPer]) {
  if (s.vec) {
    const uint2 w = *reinterpret_cast<const uint2*>(x + s.i0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = (w.x >> (8 * k)) & 0xff;
      c[k + 4] = (w.y >> (8 * k)) & 0xff;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) c[k] = k < s.inl ? x[s.i0 + k] : fill;
  }
}

__device__ __forceinline__ void store_codes(uint8_t* x, const Span& s, const int (&c)[kPer]) {
  if (s.vec) {
    uint2 w;
    w.x = (uint32_t)c[0] | ((uint32_t)c[1] << 8) | ((uint32_t)c[2] << 16) | ((uint32_t)c[3] << 24);
    w.y = (uint32_t)c[4] | ((uint32_t)c[5] << 8) | ((uint32_t)c[6] << 16) | ((uint32_t)c[7] << 24);
    *reinterpret_cast<uint2*>(x + s.i0) = w;
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < s.inl) x[s.i0 + k] = (uint8_t)c[k];
  }
}

// The block max of per-thread maxima x (abs_bits patterns) for kN states
// at once: warp shuffles, then one shared row per warp. Consecutive
// reductions must use the two halves of `red` in turn, so a fast warp's
// next write never meets a slow warp's read of this reduction's row.
// kNWarps: the CTA's warps (kernel K's resident body runs 16).
template <int kN, int kNWarps = kWarps>
__device__ __forceinline__ void block_max_bits(int (&x)[kN], int* red, float (&m)[kN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < kN; ++s) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x[s] = max(x[s], __shfl_xor_sync(0xffffffffu, x[s], o));
    if (lane == 0) red[s * kNWarps + warp] = x[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    int y = red[s * kNWarps];
#pragma unroll
    for (int w = 1; w < kNWarps; ++w) y = max(y, red[s * kNWarps + w]);
    m[s] = __int_as_float(y);
  }
}

// The block max of |v| over the elements that lie in the block, for kN
// states at once; `red` alternates between two halves by block parity.
template <int kN>
__device__ __forceinline__ void block_absmax(const float (&v)[kN][kPer], int inb, int* red,
                                             float (&m)[kN]) {
  int x[kN];
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    x[s] = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (k < inb) x[s] = max(x[s], abs_bits(v[s][k]));
  }
  block_max_bits<kN>(x, red, m);
}

// Requantize one state of the thread's 8 values with the block's absmax m
// (state1: sign fix, or stochastic rounding on u).
template <bool kSigned, bool kSignFix, bool kStoch>
__device__ __forceinline__ void requant8(const float (&v)[kPer], float m, const float (&u)[kPer],
                                         const float* tab, int (&c)[kPer]) {
  const float inv = m > 0.0f ? __fdiv_rn(1.0f, m) : 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float normed = __fmul_rn(v[k], inv);
    int code = encode<kSigned>(normed, tab);
    if (kStoch) {
      code = stochastic(code, normed, u[k], tab + (kSigned ? kDecS : kDecU));
    } else if (kSignFix) {
      code = sign_fix(code, normed);
    }
    c[k] = code;
  }
}

// Copy the codec table (the dynamic maps' kTableWords, or the LUT codecs'
// words) into shared memory (once per CTA), 16 bytes a load (both are
// 16-byte aligned) and the tail word by word; kStride: the CTA's threads.
template <int kStride = kThreads>
__device__ __forceinline__ void stage_table(const float* __restrict__ table, float* tab,
                                            int words = kTableWords) {
  const int w4 = words / 4;
  for (int k = threadIdx.x; k < w4; k += kStride) {
    reinterpret_cast<float4*>(tab)[k] = __ldg(reinterpret_cast<const float4*>(table) + k);
  }
  for (int k = 4 * w4 + threadIdx.x; k < words; k += kStride) tab[k] = table[k];
  __syncthreads();
}

// The two-pass body's scratch: per block the two states' maxima (int bits,
// zeroed before the first pass) and their old absmax (float bits).
constexpr int kScratchWords = 4;

}  // namespace dyn8

// Probe switches (chip_smoke.py --probe optim builds variants with them;
// such a build computes wrong results): BNB_PROBE_NO_COPY makes the values
// from the index instead of loading them and stores only under a test that
// never holds, BNB_PROBE_NO_MATH replaces the update, reduction and encode
// by a copy (p + g, the codes and absmax as read), BNB_PROBE_NO_UPDATE
// replaces the update alone (the states requantize as decoded).
#if defined(BNB_PROBE_NO_COPY)
#define BNB_OPT_LOAD8(x, s, fill, v)                                                      \
  do {                                                                                   \
    _Pragma("unroll") for (int k_ = 0; k_ < dyn8::kPer; ++k_) v[k_] =                    \
        (float)((int)((s).i0 + k_) & 1023) * 1e-5f - 0.005f + (fill);                    \
  } while (0)
#define BNB_OPT_LOADC(x, s, fill, c)                                                      \
  do {                                                                                   \
    _Pragma("unroll") for (int k_ = 0; k_ < dyn8::kPer; ++k_) c[k_] =                    \
        (int)(((s).i0 + k_) * 37 + (fill)) & 255;                                        \
  } while (0)
#define BNB_OPT_STORE8(x, s, v) \
  do { if (__float_as_uint(v[0] + v[7]) == 0x7f812345u) dyn8::store8(x, s, v); } while (0)
#define BNB_OPT_STOREC(x, s, c) \
  do { if ((c[0] ^ c[7]) == 0x1234) dyn8::store_codes(x, s, c); } while (0)
#define BNB_OPT_LOADF(x, i) 1e-3f
#define BNB_OPT_STOREF(x, i, v) \
  do { if (__float_as_uint(v) == 0x7f812345u) (x)[i] = (v); } while (0)
#else
#define BNB_OPT_LOAD8(x, s, fill, v) dyn8::load8(x, s, fill, v)
#define BNB_OPT_LOADC(x, s, fill, c) dyn8::load_codes(x, s, fill, c)
#define BNB_OPT_STORE8(x, s, v) dyn8::store8(x, s, v)
#define BNB_OPT_STOREC(x, s, c) dyn8::store_codes(x, s, c)
#define BNB_OPT_LOADF(x, i) (x)[i]
#define BNB_OPT_STOREF(x, i, v) (x)[i] = (v)
#endif
