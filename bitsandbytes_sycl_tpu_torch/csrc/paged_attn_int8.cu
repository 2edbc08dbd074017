// Kernel D: single-token decode attention over the paged int8 KV pool.
//
// Replaces bitsandbytes_sycl_tpu/ops/paged_attention.py `_paged_attn_kernel`
// (called through `_paged_attn_call`) for int8 pages and for int4 (kv4)
// pages.
//
// Computes, for batch row b, kv head hk and its `rep` q heads, over pool
// layer li (pages (L, NP, Hkv, P, D) int8 token-major, scales (L, NP, Hkv, P)
// f32) reached through page_table[b, j]:
//   score = (q . k_i8) * k_scale * scale (+ ALiBi slope * (pos - qpos)),
//   softcapped, masked to pos < len[b] (and pos >= qpos + 1 - window), with
//   qpos = len (new_kv given) or len - 1; online softmax page by page; V
//   weighted by v_scale / 127; the new_kv token folded in last as one more
//   exact online-softmax step. len == 0 without new_kv gives zeros.
//
// kv4 pages (kv_bits=4): (L, NP, Hkv, P/2, D) uint8, byte row r holding
// token 2r in the high nibble and 2r + 1 in the low one, sign-magnitude
// codes on the +-7 grid (|c| + 8 [c < 0]); the per-token scales are stored
// in parity-grouped column order (token t at column (t % 2) P/2 + t / 2).
// Both bodies walk logical tokens as for int8 pages: token t reads byte row
// t / 2 and its nibble by t's parity, and its scale at its column, so the
// mask, window, softcap and ALiBi see logical positions (the Pallas kernel
// instead scores in column order and maps each column back to its token).
// K's factor is scale = sm / 7 (the wrapper's), V's 1 / 7. The new token
// comes on the same +-7 grid, as int8 values.
//
// Bound on the H100: memory. Each used page's K and V bytes (2 * P * D per
// kv head, P * D with kv4) and scales are read once; a page costs ~4 flops
// per byte (8 with kv4). What
// bounds this body now is each CTA's own instruction chain per page (byte
// permutes, FMAs, shuffles: PERF.md, `chip_smoke.py --probe attention`).
//
// Two bodies; the wrapper picks one (`ops/paged_attention.paged_plan`).
//
// Split body (`paged_split_kernel`, D = 128 or 256, rep * D <= 512, P a
// multiple of 128): flash-decoding. The grid is (kv head, batch row, split)
// and split z takes the pages [z u / nsplit, (z + 1) u / nsplit) of the
// row's u = max(ceil(len / P), 1) used pages, read from the lengths on the
// card: every CTA of a row gets an equal share, however long the row. The
// plan sets `nsplit` from the SMs that one CTA per (row, kv head) would
// leave idle, capped by the page-table width or the engine's `pages_hint`,
// never from the lengths, which would need a host sync. A CTA with no
// pages (u < nsplit) loads nothing and writes an empty partial (m = -1e30,
// l = 0, acc = 0).
// One thread brings each page-head's K and V (P * D contiguous bytes each)
// and its two scale rows into a 2-slot ring by bulk asynchronous copies on
// an mbarrier, so the next page streams in while this one is scored. Eight
// warps each take 16 tokens of every 128 (the new token's score is
// computed at the start, beside the page loads): 8 lanes read one K row in
// 16-byte pieces (4 rows per warp load, contiguous, no bank conflict)
// against the q pieces each lane keeps in registers for all rep heads, and
// reduce with 3 shuffles; each warp keeps its own online softmax (m, l
// warp-uniform) and its lanes own 16 (or 32) output columns of every rep
// head, reading V rows in 16-byte pieces too. The options are whole-chunk
// passes, not a test per token. Masked tokens get weight 0, so a fully
// masked range keeps l = 0 and acc = 0 whatever its m. int8 becomes f32 by
// a byte permute into 2^23's mantissa and one add, not the quarter-rate
// conversion; a kv4 piece is 16 nibbles of one parity (the lanes of a token
// group all take the same parity, so the group's shift is uniform), turned
// into offset bytes by a few word-wide operations and then into floats the
// same way. The warps merge in shared memory in a fixed order; each split
// writes its (m, l, acc) to an f32 scratch, then takes a ticket (a fence,
// then atomicAdd on a per-(b, hk) counter): the last CTA of the row merges
// the partials in split order (so the output repeats bit for bit), folds in
// new_kv, writes the output and sets the counter back to 0. No second
// kernel: a decode step launches D once per layer, as before.
//
// SIMT body (`paged_kernel`, the shapes the split body does not take): one
// block per (kv head, batch row), D threads, walking the row's used pages
// in series. Scores: a thread per token; softmax reductions across the
// block; P.V: a thread per output element.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

// the four nibbles at bits [shift, shift + 4) of w's bytes, sign-magnitude
// codes (|c| + 8 [c < 0]), as exact floats: each byte becomes 128 + c
// (128 + |c|, less 2 |c| where the sign bit is set; no byte carries into
// the next), then i8x4_to_f32's mantissa trick
__device__ __forceinline__ void nib4x4_to_f32(uint32_t w, int shift, float* f) {
  const uint32_t n = (w >> shift) & 0x0F0F0F0Fu;
  const uint32_t s8 = n & 0x08080808u;
  const uint32_t m = n & 0x07070707u;
  const uint32_t neg = m & (s8 - (s8 >> 3));
  const uint32_t t = 0x80808080u + m - (neg << 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __int_as_float(__byte_perm(t, 0x4B000000u, 0x7650u | k)) - 8388736.0f;
  }
}

// 16 bytes (one 16-byte load) of a K or V row as 16 floats: int8 values, or
// with kv4 the nibbles of one parity (shift 4: the even token)
template <bool kKv4>
__device__ __forceinline__ void row16_to_f32(uint4 w, int shift, float* f) {
  if (kKv4) {
    nib4x4_to_f32(w.x, shift, f);
    nib4x4_to_f32(w.y, shift, f + 4);
    nib4x4_to_f32(w.z, shift, f + 8);
    nib4x4_to_f32(w.w, shift, f + 12);
  } else {
    i8x16_to_f32(w, f);
  }
}

// token t's byte row, and its scale's column, in a page of P tokens
template <bool kKv4>
__device__ __forceinline__ int kv_row(int t) { return kKv4 ? t >> 1 : t; }
template <bool kKv4>
__device__ __forceinline__ int kv_col(int t, int P) { return kKv4 ? (t & 1) * (P / 2) + (t >> 1) : t; }

// one K or V element: an int8 value, or token t's nibble of a kv4 byte
template <bool kKv4>
__device__ __forceinline__ float kv_val(int8_t b, int t) {
  if (!kKv4) return (float)b;
  const int c = ((uint8_t)b >> ((t & 1) ? 0 : 4)) & 15;
  return (float)((c & 8) ? -(c & 7) : (c & 7));
}

template <int kRep, bool kKv4>
__global__ void paged_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kp,
                             const float* __restrict__ ks, const int8_t* __restrict__ vp,
                             const float* __restrict__ vs, const int* __restrict__ page_table,
                             const int* __restrict__ lens, const float* __restrict__ alibi,
                             const int8_t* __restrict__ kn, const float* __restrict__ ksn,
                             const int8_t* __restrict__ vn, const float* __restrict__ vsn,
                             void* out, int li, int NP, int Hkv, int D, int P, int MAXP,
                             int window, float scale, float softcap) {
  constexpr int rep = kRep;
  extern __shared__ float smem[];
  float* qs = smem;              // [rep][D]
  float* sc = qs + rep * D;      // [rep][P]
  float* red = sc + rep * P;     // [32]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t qbase = ((size_t)b * Hkv + hk) * rep * D;
  for (int i = tid; i < rep * D; i += nt) qs[i] = ld_f(q, qbase + i, q_bf16);

  const int len = lens[b];
  const bool has_new = kn != nullptr;
  const int qpos = has_new ? len : len - 1;
  const int used = min(max((len + P - 1) / P, 1), MAXP);
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float vfac = kKv4 ? 1.0f / 7.0f : 1.0f / 127.0f;
  const int rows = kKv4 ? P / 2 : P;  // byte rows of a page

  float m[kRep], l[kRep], acc[kRep];
  for (int r = 0; r < kRep; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
    acc[r] = 0.0f;
  }
  __syncthreads();

  for (int j = 0; j < used; ++j) {
    const int pid = page_table[(size_t)b * MAXP + j];
    const size_t page = ((size_t)li * NP + pid) * Hkv + hk;
    const int8_t* K = kp + page * rows * D;
    const int8_t* V = vp + page * rows * D;
    const float* KS = ks + page * P;
    const float* VS = vs + page * P;
    for (int t = tid; t < P; t += nt) {
      float dot[kRep];
      for (int r = 0; r < kRep; ++r) dot[r] = 0.0f;
      const int4* kr = reinterpret_cast<const int4*>(K + (size_t)kv_row<kKv4>(t) * D);
      for (int d16 = 0; d16 < D / 16; ++d16) {
        const int4 raw = __ldg(kr + d16);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float kv = kv_val<kKv4>(kb[i], t);
          for (int r = 0; r < rep; ++r) dot[r] = fmaf(qs[r * D + d16 * 16 + i], kv, dot[r]);
        }
      }
      const int pos = j * P + t;
      const float kscale = KS[kv_col<kKv4>(t, P)] * scale;
      const bool valid = pos < len && (window <= 0 || pos >= qpos + 1 - window);
      for (int r = 0; r < rep; ++r) {
        float s = dot[r] * kscale;
        if (alibi != nullptr) s = s + alibi[hk * rep + r] * (float)(pos - qpos);
        if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
        sc[r * P + t] = valid ? s : -1e30f;
      }
    }
    __syncthreads();
    for (int r = 0; r < rep; ++r) {
      float mx = -1e30f;
      for (int t = tid; t < P; t += nt) mx = fmaxf(mx, sc[r * P + t]);
      const float m_new = fmaxf(m[r], block_reduce<true>(mx, red));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
      for (int t = tid; t < P; t += nt) {
        const float w = expf(sc[r * P + t] - m_new);
        sum += w;
        sc[r * P + t] = w * (VS[kv_col<kKv4>(t, P)] * vfac);
      }
      l[r] = l[r] * alpha + block_reduce<false>(sum, red);
      m[r] = m_new;
      acc[r] *= alpha;
    }
    __syncthreads();
    for (int d = tid; d < D; d += nt) {
#pragma unroll 8
      for (int t = 0; t < P; ++t) {
        const float v = kv_val<kKv4>(V[(size_t)kv_row<kKv4>(t) * D + d], t);
        for (int r = 0; r < rep; ++r) acc[r] = fmaf(sc[r * P + t], v, acc[r]);
      }
    }
    __syncthreads();
  }

  // tid == d (blockDim.x == D): each thread finishes its output element
  const int d = tid;
  for (int r = 0; r < rep; ++r) {
    float o;
    if (has_new) {
      const size_t nb = (size_t)b * Hkv + hk;
      const float part = qs[r * D + d] * (float)kn[nb * D + d];
      float sn = block_reduce<false>(part, red) * (ksn[nb] * scale);
      if (softcap > 0.0f) sn = softcap * tanhf(sn * inv_cap);
      const float m2 = fmaxf(m[r], sn);
      const float alpha = expf(m[r] - m2);
      const float w_new = expf(sn - m2);
      const float l2 = l[r] * alpha + w_new;
      const float wv_new = w_new * (vsn[nb] * vfac);
      o = (acc[r] * alpha + wv_new * (float)vn[nb * D + d]) / l2;
    } else {
      o = acc[r] * (len > 0 ? 1.0f / l[r] : 0.0f);
    }
    st_f(out, qbase + (size_t)r * D + d, o, q_bf16);
  }
}

// ---------------------------------------------------------------------------
// split body
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kChunk = 128;                       // tokens per softmax update
constexpr int kWarpIt = kChunk / (4 * kSplitWarps);  // 4-token steps per warp and chunk

__host__ __device__ constexpr size_t split_stage_bytes(int P, int D, bool kv4) {
  return 2 * (size_t)(kv4 ? P / 2 : P) * D + 8 * (size_t)P;  // K, V, k scales, v scales
}

__host__ __device__ constexpr size_t split_smem_bytes(int P, int D, int rep, bool kv4) {
  // alignment slack, 2 ring slots, the warps' (m, l, acc)
  return 1024 + 2 * split_stage_bytes(P, D, kv4) + 4 * (size_t)kSplitWarps * rep * (D + 2);
}

template <int kRep, int kPc, bool kKv4>  // kPc: 16-byte pieces of a row per lane, D / 128
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kp,
                   const float* __restrict__ ks, const int8_t* __restrict__ vp,
                   const float* __restrict__ vs, const int* __restrict__ page_table,
                   const int* __restrict__ lens, const float* __restrict__ alibi,
                   const int8_t* __restrict__ kn, const float* __restrict__ ksn,
                   const int8_t* __restrict__ vn, const float* __restrict__ vsn, void* out,
                   float* __restrict__ part, int* __restrict__ tickets, int li, int NP, int Hkv,
                   int P, int MAXP, int window, float scale, float softcap) {
  constexpr int D = 128 * kPc, kW = kSplitWarps;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const size_t stage = split_stage_bytes(P, D, kKv4);
  const int rows = kKv4 ? P / 2 : P;  // byte rows of a page
  float* red_m = reinterpret_cast<float*>(smem + 2 * stage);  // [kW][kRep]
  float* red_l = red_m + kW * kRep;                           // [kW][kRep]
  float* red_acc = red_l + kW * kRep;                         // [kW][kRep][D]
  __shared__ __align__(8) uint64_t full[2];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 3, c = lane & 7;  // token group of the warp, 16-byte piece
  const int hk = blockIdx.x, b = blockIdx.y, z = blockIdx.z, nsplit = gridDim.z;
  const size_t pair = (size_t)b * Hkv + hk;
  const size_t qbase = pair * kRep * D;
  const int len = lens[b];
  const bool has_new = kn != nullptr;
  const int qpos = has_new ? len : len - 1;
  const int used = min(max((len + P - 1) / P, 1), MAXP);
  // this split's share of the row's used pages: the splits of a row take
  // equal shares whatever its length, so no CTA idles beside a long one
  const int j0 = z * used / nsplit, npages = (z + 1) * used / nsplit - j0;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float vfac = kKv4 ? 1.0f / 7.0f : 1.0f / 127.0f;
  // kv4: the nibble of this lane's token parity (t0 and 4 it are even, so
  // a token's parity is its group's)
  const int shift = (g & 1) ? 0 : 4;

  float qr[kRep][kPc][16];
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int p = 0; p < kPc; ++p)
#pragma unroll
      for (int i = 0; i < 16; ++i) qr[r][p][i] = ld_f(q, qbase + r * D + (c + 8 * p) * 16 + i, q_bf16);
  // the new token's score for each rep head, in every lane (its loads
  // overlap the page loads; only the CTA that finishes the row uses it),
  // and this thread's new V values
  constexpr int kElems = kRep * D, kPer = (kElems + kSplitThreads - 1) / kSplitThreads;
  float sn[kRep], vnf[kPer];
  float vsn_s = 0.0f;
  if (has_new) {
    float dn[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) dn[r] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPc; ++p) {
      float kf[16];
      i8x16_to_f32(*reinterpret_cast<const uint4*>(kn + pair * D + (c + 8 * p) * 16), kf);
#pragma unroll
      for (int r = 0; r < kRep; ++r)
#pragma unroll
        for (int e = 0; e < 16; ++e) dn[r] = fmaf(qr[r][p][e], kf[e], dn[r]);
    }
    const float ks_new = ksn[pair] * scale;
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float v = dn[r];
      v += __shfl_xor_sync(BNB_FULL_MASK, v, 1);
      v += __shfl_xor_sync(BNB_FULL_MASK, v, 2);
      v += __shfl_xor_sync(BNB_FULL_MASK, v, 4);
      v = v * ks_new;
      if (softcap > 0.0f) v = softcap * tanhf(v * inv_cap);
      sn[r] = v;
    }
    vsn_s = vsn[pair] * vfac;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kSplitThreads;
      vnf[k] = e < kElems ? (float)vn[pair * D + e % D] : 0.0f;
    }
  }
  float m[kRep], l[kRep], acc[kRep][kPc][16], slope[kRep];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    slope[r] = alibi != nullptr ? alibi[hk * kRep + r] : 0.0f;
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPc; ++p)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[r][p][i] = 0.0f;
  }

  // one thread: page i of this split (K, V, both scale rows) into slot i % 2
  auto load = [&](int i) {
    const int pid = page_table[(size_t)b * MAXP + j0 + i];
    const size_t page = ((size_t)li * NP + pid) * Hkv + hk;
    uint8_t* dst = smem + (i & 1) * stage;
    uint64_t* bar = &full[i & 1];
    mbar_expect_tx(bar, (uint32_t)stage);
    bulk_load(dst, kp + page * rows * D, (uint32_t)(rows * D), bar);
    bulk_load(dst + (size_t)rows * D, vp + page * rows * D, (uint32_t)(rows * D), bar);
    bulk_load(dst + 2 * (size_t)rows * D, ks + page * P, (uint32_t)(4 * P), bar);
    bulk_load(dst + 2 * (size_t)rows * D + 4 * P, vs + page * P, (uint32_t)(4 * P), bar);
  };

  if (npages > 0) {
    if (tid == 0) {
      mbar_init(&full[0], 1);
      mbar_init(&full[1], 1);
      mbar_init_fence();
      load(0);
      if (npages > 1) load(1);
    }
    __syncthreads();
  }
  for (int i = 0; i < npages; ++i) {
    mbar_wait(&full[i & 1], (i >> 1) & 1);
    const uint8_t* K = smem + (i & 1) * stage;
    const uint8_t* V = K + (size_t)rows * D;
    const float* KS = reinterpret_cast<const float*>(K + 2 * (size_t)rows * D);
    const float* VS = KS + P;
    const int pos0 = (j0 + i) * P;
    for (int t0 = warp * (kChunk / kW); t0 < P; t0 += kChunk) {
      float sc[kWarpIt][kRep];
      bool ok[kWarpIt];
#pragma unroll
      for (int it = 0; it < kWarpIt; ++it) {
        const int t = t0 + 4 * it + g;
        float dot[kRep][2];  // two chains per head for instruction-level parallelism
#pragma unroll
        for (int r = 0; r < kRep; ++r) dot[r][0] = dot[r][1] = 0.0f;
#ifndef BNB_PROBE_NO_MATH  // chip_smoke.py --probe: scores and P.V switched off
#pragma unroll
        for (int p = 0; p < kPc; ++p) {
          float kf[16];
          row16_to_f32<kKv4>(
              *reinterpret_cast<const uint4*>(K + (size_t)kv_row<kKv4>(t) * D + (c + 8 * p) * 16),
              shift, kf);
#pragma unroll
          for (int r = 0; r < kRep; ++r)
#pragma unroll
            for (int e = 0; e < 16; ++e) dot[r][e & 1] = fmaf(qr[r][p][e], kf[e], dot[r][e & 1]);
        }
#endif
        const int pos = pos0 + t;
        const float kscale = KS[kv_col<kKv4>(t, P)] * scale;
        ok[it] = pos < len && (window <= 0 || pos >= qpos + 1 - window);
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          float v = dot[r][0] + dot[r][1];
          v += __shfl_xor_sync(BNB_FULL_MASK, v, 1);
          v += __shfl_xor_sync(BNB_FULL_MASK, v, 2);
          v += __shfl_xor_sync(BNB_FULL_MASK, v, 4);
          sc[it][r] = v * kscale;
        }
      }
      // the options as whole-chunk passes (not a branch per token)
      if (alibi != nullptr) {
#pragma unroll
        for (int it = 0; it < kWarpIt; ++it)
#pragma unroll
          for (int r = 0; r < kRep; ++r)
            sc[it][r] += slope[r] * (float)(pos0 + t0 + 4 * it + g - qpos);
      }
      if (softcap > 0.0f) {
#pragma unroll
        for (int it = 0; it < kWarpIt; ++it)
#pragma unroll
          for (int r = 0; r < kRep; ++r) sc[it][r] = softcap * tanhf(sc[it][r] * inv_cap);
      }
#pragma unroll
      for (int it = 0; it < kWarpIt; ++it)
#pragma unroll
        for (int r = 0; r < kRep; ++r) sc[it][r] = ok[it] ? sc[it][r] : -1e30f;
      // the warp's online softmax step over its tokens of the chunk; lanes
      // of one token group hold equal scores, so sums run over the groups only
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        float mx = sc[0][r];
#pragma unroll
        for (int it = 1; it < kWarpIt; ++it) mx = fmaxf(mx, sc[it][r]);
        mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 16));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int it = 0; it < kWarpIt; ++it) {
          const float w = ok[it] ? expf(sc[it][r] - m_new) : 0.0f;
          sum += w;
          sc[it][r] = w * (VS[kv_col<kKv4>(t0 + 4 * it + g, P)] * vfac);
        }
        sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 8);
        sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 16);
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int p = 0; p < kPc; ++p)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[r][p][e] *= alpha;
      }
#ifndef BNB_PROBE_NO_MATH
#pragma unroll
      for (int it = 0; it < kWarpIt; ++it) {
        const int t = t0 + 4 * it + g;
#pragma unroll
        for (int p = 0; p < kPc; ++p) {
          float vf[16];
          row16_to_f32<kKv4>(
              *reinterpret_cast<const uint4*>(V + (size_t)kv_row<kKv4>(t) * D + (c + 8 * p) * 16),
              shift, vf);
#pragma unroll
          for (int r = 0; r < kRep; ++r)
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[r][p][e] = fmaf(sc[it][r], vf[e], acc[r][p][e]);
        }
      }
#endif
    }
    __syncthreads();  // every warp is done with slot i & 1
    if (tid == 0 && i + 2 < npages) load(i + 2);
  }

  // the warp's four token groups, then the warps in order
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int p = 0; p < kPc; ++p)
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        float v = acc[r][p][e];
        v += __shfl_xor_sync(BNB_FULL_MASK, v, 8);
        v += __shfl_xor_sync(BNB_FULL_MASK, v, 16);
        if (g == 0) red_acc[(warp * kRep + r) * D + (c + 8 * p) * 16 + e] = v;
      }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      red_m[warp * kRep + r] = m[r];
      red_l[warp * kRep + r] = l[r];
    }
  }
  __syncthreads();
  // this CTA's (M, L, A) of element e = r * D + d: kept in red_acc[0][e]
  // (A), red_m[r] and red_l[r] (M, L) once every thread has read the warps'
  float* part_ml = part;                                     // [pairs][nsplit][kRep][2]
  float* part_acc = part + (size_t)gridDim.x * gridDim.y * nsplit * kRep * 2;  // [..][kRep][D]
  float Mv[kPer], Lv[kPer], Av[kPer];
#pragma unroll
  for (int k = 0; k < (kElems + kSplitThreads - 1) / kSplitThreads; ++k) {
    const int e = tid + k * kSplitThreads;
    if (e >= kElems) break;
    const int r = e / D;
    float M = red_m[r];
#pragma unroll
    for (int w = 1; w < kW; ++w) M = fmaxf(M, red_m[w * kRep + r]);
    float Ls = 0.0f, As = 0.0f;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const float f = expf(red_m[w * kRep + r] - M);
      Ls += red_l[w * kRep + r] * f;
      As += red_acc[w * kElems + e] * f;
    }
    Mv[k] = M;
    Lv[k] = Ls;
    Av[k] = As;
  }
  if (nsplit > 1) {
    const size_t slot = pair * nsplit + z;
#pragma unroll
    for (int k = 0; k < (kElems + kSplitThreads - 1) / kSplitThreads; ++k) {
      const int e = tid + k * kSplitThreads;
      if (e >= kElems) break;
      part_acc[slot * kElems + e] = Av[k];
      if (e % D == 0) {
        part_ml[(slot * kRep + e / D) * 2] = Mv[k];
        part_ml[(slot * kRep + e / D) * 2 + 1] = Lv[k];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(&tickets[pair], 1);
      s_last = ticket == nsplit - 1;
      if (s_last) tickets[pair] = 0;  // no other CTA of this launch takes it again
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the last CTA: every split's partial, merged in split order
#pragma unroll
    for (int k = 0; k < (kElems + kSplitThreads - 1) / kSplitThreads; ++k) {
      const int e = tid + k * kSplitThreads;
      if (e >= kElems) break;
      const int r = e / D;
      float M = -1e30f;
      for (int s2 = 0; s2 < nsplit; ++s2) M = fmaxf(M, __ldcg(part_ml + ((pair * nsplit + s2) * kRep + r) * 2));
      float Ls = 0.0f, As = 0.0f;
      for (int s2 = 0; s2 < nsplit; ++s2) {
        const size_t sl = pair * nsplit + s2;
        const float f = expf(__ldcg(part_ml + (sl * kRep + r) * 2) - M);
        Ls += __ldcg(part_ml + (sl * kRep + r) * 2 + 1) * f;
        As += __ldcg(part_acc + sl * kElems + e) * f;
      }
      Mv[k] = M;
      Lv[k] = Ls;
      Av[k] = As;
    }
  }
#pragma unroll
  for (int k = 0; k < (kElems + kSplitThreads - 1) / kSplitThreads; ++k) {
    const int e = tid + k * kSplitThreads;
    if (e >= kElems) break;
    const int r = e / D;
    float o;
    if (has_new) {
      float snr = sn[0];
#pragma unroll
      for (int rr = 1; rr < kRep; ++rr) snr = r == rr ? sn[rr] : snr;
      const float m2 = fmaxf(Mv[k], snr);
      const float alpha = expf(Mv[k] - m2);
      const float w_new = expf(snr - m2);
      const float l2 = Lv[k] * alpha + w_new;
      const float wv_new = w_new * vsn_s;
      o = (Av[k] * alpha + wv_new * vnf[k]) / l2;
    } else {
      o = Av[k] * (len > 0 ? 1.0f / Lv[k] : 0.0f);
    }
    st_f(out, qbase + e, o, q_bf16);
  }
}

template <int kRep, int kPc, bool kKv4>
int launch_split(dim3 grid, cudaStream_t st, size_t shmem, const void* q, int q_bf16,
                 const int8_t* kp, const float* ks, const int8_t* vp, const float* vs,
                 const int* pt, const int* ln, const float* al, const int8_t* kn,
                 const float* ksn, const int8_t* vn, const float* vsn, void* out, float* part,
                 int* tickets, int li, int NP, int Hkv, int P, int MAXP, int window,
                 float scale, float softcap) {
  auto kernel = paged_split_kernel<kRep, kPc, kKv4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kSplitThreads, shmem, st>>>(q, q_bf16, kp, ks, vp, vs, pt, ln, al, kn, ksn, vn,
                                            vsn, out, part, tickets, li, NP, Hkv, P, MAXP,
                                            window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, Hkv, rep, D) f32/bf16; kp, vp (L, NP, Hkv, P, D) int8, or
// with kv4 (L, NP, Hkv, P/2, D) uint8 nibble pairs; ks, vs (L, NP, Hkv, P)
// f32 (kv4: in parity-grouped column order); page_table (B, MAXP) int32;
// lens (B) int32; alibi (Hkv * rep) f32 or null; kn, vn (B, Hkv, D) int8
// and ksn, vsn (B, Hkv) f32, all four null or all four given. window <= 0:
// none; softcap <= 0: none.
extern "C" int paged_attn_int8(const void* q, const void* kp, const void* ks, const void* vp,
                               const void* vs, const void* page_table, const void* lens,
                               const void* alibi, const void* kn, const void* ksn, const void* vn,
                               const void* vsn, void* out, int li, int L, int NP, int B, int Hkv,
                               int rep, int D, int P, int MAXP, int window, int has_new,
                               int q_bf16, int kv4, float scale, float softcap, void* stream) {
  if (li < 0 || li >= L || (rep != 1 && rep != 2 && rep != 4 && rep != 8) || D % 32 ||
      D > 1024 || P <= 0 || MAXP <= 0 || (kv4 && P % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t shmem = ((size_t)rep * D + (size_t)rep * P + 32) * sizeof(float);
  dim3 grid(Hkv, B);
  auto* kp8 = reinterpret_cast<const int8_t*>(kp);
  auto* vp8 = reinterpret_cast<const int8_t*>(vp);
  auto* ksf = reinterpret_cast<const float*>(ks);
  auto* vsf = reinterpret_cast<const float*>(vs);
  auto* pt = reinterpret_cast<const int*>(page_table);
  auto* ln = reinterpret_cast<const int*>(lens);
  auto* al = reinterpret_cast<const float*>(alibi);
  auto* kn8 = has_new ? reinterpret_cast<const int8_t*>(kn) : nullptr;
  auto* ksnf = reinterpret_cast<const float*>(ksn);
  auto* vn8 = reinterpret_cast<const int8_t*>(vn);
  auto* vsnf = reinterpret_cast<const float*>(vsn);
#define BNB_PAGED_LAUNCH(R, KV4)                                                             \
  paged_kernel<R, KV4><<<grid, D, shmem, st>>>(q, q_bf16, kp8, ksf, vp8, vsf, pt, ln, al, kn8, \
                                               ksnf, vn8, vsnf, out, li, NP, Hkv, D, P, MAXP, \
                                               window, scale, softcap)
  if (kv4) {
    switch (rep) {
      case 1: BNB_PAGED_LAUNCH(1, true); break;
      case 2: BNB_PAGED_LAUNCH(2, true); break;
      case 4: BNB_PAGED_LAUNCH(4, true); break;
      default: BNB_PAGED_LAUNCH(8, true); break;
    }
  } else {
    switch (rep) {
      case 1: BNB_PAGED_LAUNCH(1, false); break;
      case 2: BNB_PAGED_LAUNCH(2, false); break;
      case 4: BNB_PAGED_LAUNCH(4, false); break;
      default: BNB_PAGED_LAUNCH(8, false); break;
    }
  }
#undef BNB_PAGED_LAUNCH
  return (int)cudaGetLastError();
}

// The split body. Arguments as paged_attn_int8's, plus: part, an f32 scratch
// of B * Hkv * nsplit * rep * (D + 2) floats (unused when nsplit == 1);
// tickets, B * Hkv int32 counters, all 0 (left at 0); nsplit <= MAXP
// splits, split z of a row taking its used pages [z u / nsplit,
// (z + 1) u / nsplit), u = min(max(ceil(len / P), 1), MAXP). D 128 or
// 256, rep 1, 2 or 4 with rep * D <= 512, P a multiple of 128; kn 16-byte
// aligned.
extern "C" int paged_attn_int8_split(const void* q, const void* kp, const void* ks, const void* vp,
                                     const void* vs, const void* page_table, const void* lens,
                                     const void* alibi, const void* kn, const void* ksn,
                                     const void* vn, const void* vsn, void* out, void* part,
                                     void* tickets, int li, int L, int NP, int B, int Hkv, int rep,
                                     int D, int P, int MAXP, int nsplit, int window,
                                     int has_new, int q_bf16, int kv4, float scale,
                                     float softcap, void* stream) {
  const size_t shmem = split_smem_bytes(P, D, rep, kv4 != 0);
  if (li < 0 || li >= L || (D != 128 && D != 256) || (rep != 1 && rep != 2 && rep != 4) ||
      rep * D > 512 || P <= 0 || P % kChunk || MAXP <= 0 || nsplit < 1 || nsplit > MAXP ||
      shmem > 232448 || (nsplit > 1 && (part == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(Hkv, B, nsplit);
  auto* kp8 = reinterpret_cast<const int8_t*>(kp);
  auto* vp8 = reinterpret_cast<const int8_t*>(vp);
  auto* ksf = reinterpret_cast<const float*>(ks);
  auto* vsf = reinterpret_cast<const float*>(vs);
  auto* pt = reinterpret_cast<const int*>(page_table);
  auto* ln = reinterpret_cast<const int*>(lens);
  auto* al = reinterpret_cast<const float*>(alibi);
  auto* kn8 = has_new ? reinterpret_cast<const int8_t*>(kn) : nullptr;
  auto* ksnf = reinterpret_cast<const float*>(ksn);
  auto* vn8 = reinterpret_cast<const int8_t*>(vn);
  auto* vsnf = reinterpret_cast<const float*>(vsn);
  auto* pf = reinterpret_cast<float*>(part);
  auto* tk = reinterpret_cast<int*>(tickets);
#define BNB_SPLIT_LAUNCH(R, PC, KV4)                                                         \
  return launch_split<R, PC, KV4>(grid, st, shmem, q, q_bf16, kp8, ksf, vp8, vsf, pt, ln, al, \
                                  kn8, ksnf, vn8, vsnf, out, pf, tk, li, NP, Hkv, P, MAXP,    \
                                  window, scale, softcap)
#define BNB_SPLIT_SHAPES(KV4)               \
  if (D == 128) {                           \
    if (rep == 1) BNB_SPLIT_LAUNCH(1, 1, KV4); \
    if (rep == 2) BNB_SPLIT_LAUNCH(2, 1, KV4); \
    BNB_SPLIT_LAUNCH(4, 1, KV4);               \
  }                                         \
  if (rep == 1) BNB_SPLIT_LAUNCH(1, 2, KV4);   \
  BNB_SPLIT_LAUNCH(2, 2, KV4)
  if (kv4) {
    BNB_SPLIT_SHAPES(true);
  }
  BNB_SPLIT_SHAPES(false);
#undef BNB_SPLIT_SHAPES
#undef BNB_SPLIT_LAUNCH
}
