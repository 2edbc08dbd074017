// Kernel C: causal flash prefill over the layer-stacked int8 KV cache.
//
// Replaces bitsandbytes_sycl_tpu/ops/attention.py `_prefill_kernel` (called
// through `_prefill_attn_call_stacked`).
//
// Computes, for query row t of batch b at absolute position
// qpos = starts[b] + t and q head h (kv head h / (Hq / Hkv)):
//   score_s = (q . k_i8[:, s]) * k_scale[s] * scale    (scale = sm / 127)
//             + slope_h * (s - qpos)                   (ALiBi, optional)
//   then softcap * tanh(score / softcap)               (optional)
//   masked to s <= qpos (and qpos - s < window);
// an online softmax over keys, with V weighted by v_scale / 127.
//
// The TPU kernel visits all S = max_seq_len cache columns; these stop at
// the last qpos, which is exact because a fully masked key range leaves
// (m, l, acc) unchanged (every causal row has key 0 valid, or a later valid
// key that zeroes the correction factor of any fully masked range before
// it). Two bodies; the wrapper picks one (`ops/attention.prefill_plan`).
//
// Tensor-core body (`prefill_tc_kernel<CTA dims, BN, stages, cluster>`:
// bf16 q, D = 128 to 1024, S a multiple of the key tile BN: 64 at D = 128
// and 256 and past 512, 32 at 384 and 512). Bound on the H100: bf16
// tensor-core operations (4 T^2 D / 2 per head) or the bytes of q, out and
// the K/V prefix, whichever is larger.
// One CTA per (64-row query tile, q head, batch row), heaviest tiles
// launched first, with D / 128 warpgroups: each computes the whole tile's
// S = Q K^T (the same bits in each, so the same softmax) and owns 128 dims
// of O, 64 f32 registers a thread: at D = 256 one warpgroup's O alone
// would take 128 of its 255. Q (bf16) sits in shared memory in wgmma's
// K-major layout. Key tiles: one thread's TMA copy brings the K tile (D
// rows of BN contiguous keys of the transposed cache, 2-D boxes of at most
// 256 rows), bulk copies the V tile (BN x D contiguous bytes) and both
// scale rows, into a ring of raw tiles on mbarriers (3 slots; 2 at D = 512,
// whose bf16 Q alone is 64 KB: 206,336 bytes of shared memory there,
// 207,360 at D = 256). The threads dequantize the int8 tiles to bf16
// (exact: |code| <= 127), 8 bytes in, 16 bytes out: wgmma reads both as
// MN-major B operands, which is the int8 tiles' own layout (K keys-contiguous
// per dim, V dims-contiguous per key), so nothing is transposed (an 8 x 8
// byte-permute transpose into K-major tiles took 6 us more at D = 128,
// T = 512). Then S by wgmma m64nBNk16 (bf16 x integer products are exact,
// so only the f32 summation order differs from the plain version); scale,
// ALiBi, softcap and the masks (on diagonal and window-edge tiles only) and
// the online softmax run on the accumulator registers, four threads per
// row; P * v_scale / 127 as a bf16 high part plus a bf16 remainder is the A
// operand from registers (the accumulator's layout is the A fragment's) of
// O += P V, two wgmma m64n128k16 per k16 step into the warpgroup's 128
// dims: P rounded once, to bf16 or to f16 with V in f16 (one product, 5 us
// less), passed the 1% kernel check but moved 2-layer 7B logits 4.8% and
// 4.1% from the CPU's, over the 4% limit of chip_smoke.py phase 5. The
// exponentials run on the special-function unit as powers of 2, the options
// as whole-tile passes (a test inside the unrolled element loop compiled to
// a branch per element) and the O rescale only when a row max moved: the
// epilogue had taken half the time (chip_smoke.py --probe attention). Tiles
// wholly outside the window are skipped. A warpgroup's wgmma_wait covers
// its own products; with several, a barrier before each conversion lets
// every warpgroup finish reading the last tile. At D = 128 (one
// warpgroup), two warpgroups sharing each converted tile over 128 query
// rows, and a producer warpgroup converting the next tile while two
// consumers computed, both measured no faster on the H100.
// Past D = 512 the tile's O (64 x D f32) no longer fits beside S and P in
// one CTA's registers (65,536: 102 a thread for 5 warpgroups), so a
// cluster of D / 128 CTAs of one warpgroup serves the tile, CTA r (its
// rank) holding dims 128 r .. 128 r + 127 of Q, K and V, the D = 128
// instance's tiles (V by TMA boxes of its dims). Per key tile each CTA
// computes its dims' share of S; the shares are added in rank order
// through distributed shared memory (a reduce-scatter and an all-gather,
// two cluster barriers a tile), so every CTA holds the same S bits and
// computes the same softmax, then adds P V into its own 128 output dims.
// What bounds it is that exchange (`chip_smoke.py --probe attention`).
//
// SIMT body (`prefill_kernel`: f32 q, and S that is not a whole number of
// key tiles; the C entry takes D = 128 to 1024 in steps of 128). Bound the
// same way, at the f32 rate. One warp per query row, four rows (warps) per
// block sharing the (b, h) K/V reads through L1; q's four rows
// sit in shared memory (16 KB at D = 1024) and each lane's D/32 output
// elements in registers (32 at D = 1024). Keys go in chunks of 32, one key
// per lane: the K cache is transposed (D, S), so a lane's key column is read
// with the warp's 32 neighbouring keys, 32 contiguous bytes per d. For P.V
// each lane owns D/32 contiguous output elements of the V row (S, D) and
// the key weights are broadcast by shuffles.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kRows = 4;  // query rows (warps) per block

template <int kDPL>  // output elements per lane, D / 32
__global__ void __launch_bounds__(32 * kRows)
prefill_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kq,
               const float* __restrict__ ks, const int8_t* __restrict__ vq,
               const float* __restrict__ vs, const int* __restrict__ starts,
               const float* __restrict__ alibi, void* out, int li, int B, int T, int Hq, int Hkv,
               int S, int window, float scale, float softcap) {
  constexpr int D = 32 * kDPL;
  __shared__ float qs[kRows][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, h = blockIdx.y, t = blockIdx.x * kRows + warp;
  if (t >= T) return;  // whole warps only; no block-wide sync below
  const int hk = h / (Hq / Hkv);
  const size_t qoff = (((size_t)b * T + t) * Hq + h) * D;
  for (int d = lane; d < D; d += 32) qs[warp][d] = ld_f(q, qoff + d, q_bf16);
  __syncwarp();

  const int qpos = starts[b] + t;
  const size_t head = ((size_t)li * B + b) * Hkv + hk;
  const int8_t* K = kq + head * D * (size_t)S;  // (D, S)
  const float* KS = ks + head * (size_t)S;
  const int8_t* V = vq + head * (size_t)S * D;  // (S, D)
  const float* VS = vs + head * (size_t)S;
  const float slope = alibi != nullptr ? alibi[h] : 0.0f;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float inv127 = 1.0f / 127.0f;

  float m = -1e30f, l = 0.0f;
  float acc[kDPL];
#pragma unroll
  for (int c = 0; c < kDPL; ++c) acc[c] = 0.0f;

  const int nkeys = min(qpos + 1, S);
  for (int s0 = 0; s0 < nkeys; s0 += 32) {
    const int s = s0 + lane;
    const bool in_cache = s < S;
    float sc = -1e30f;
    if (in_cache) {
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qs[warp][d], (float)K[(size_t)d * S + s], dot);
      sc = dot * (KS[s] * scale);
      if (alibi != nullptr) sc = sc + slope * (float)(s - qpos);
      if (softcap > 0.0f) sc = softcap * tanhf(sc * inv_cap);
      const bool valid = s <= qpos && (window <= 0 || qpos - s < window);
      if (!valid) sc = -1e30f;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float corr = expf(m - m_new);
    const float w = in_cache ? expf(sc - m_new) : 0.0f;
    l = l * corr + warp_sum(w);
    m = m_new;
    const float wv = in_cache ? w * (VS[s] * inv127) : 0.0f;
#pragma unroll
    for (int c = 0; c < kDPL; ++c) acc[c] *= corr;
    const int n = min(32, S - s0);
    for (int i = 0; i < n; ++i) {
      const float wi = __shfl_sync(BNB_FULL_MASK, wv, i);
      const int8_t* vr = V + (size_t)(s0 + i) * D + lane * kDPL;
#pragma unroll
      for (int c = 0; c < kDPL; ++c) acc[c] = fmaf(wi, (float)vr[c], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kDPL; ++c) st_f(out, qoff + lane * kDPL + c, acc[c] / l, q_bf16);
}

// ---------------------------------------------------------------------------
// tensor-core body
// ---------------------------------------------------------------------------
constexpr int kTcBM = 64;  // query rows per CTA (one warpgroup's wgmma rows)
// The dequantized tiles are wgmma B operands in the MN-major layout, the
// int8 tiles' own: a core matrix holds 8 K rows of 8 consecutive MN values
// (16 bytes each); MN groups of 8 are kTcSbo bytes apart (144, not 128, so
// that the 8 lanes of a store phase, one per group, hit distinct banks)
// and K groups of 8 one group row apart.
constexpr int kTcSbo = 144;

// The body's instance for a CTA of kD dims: kD / 128 warpgroups, each
// owning 128 output dims of the tile's 64 rows; key tiles of kBN; a ring of
// kStages raw tiles; with kCl, clusters of CTAs of kD = 128 dims (a
// run-time count, one instance for every head dim past 512).
template <int kD, int kBN, int kStages, bool kCl = false>
struct TcShape {
  static constexpr int kWG = kD / 128;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kRaw = 2 * kD * kBN + 2 * 4 * kBN;  // K, V, k and v scales
  static constexpr int kQ = kTcBM * kD * 2;                // bf16 Q
  static constexpr int kKLbo = (kBN / 8) * kTcSbo;         // K tile: MN = kBN keys, K = kD dims
  static constexpr int kVLbo = (kD / 8) * kTcSbo;          // V tile: MN = kD dims, K = kBN keys
  static constexpr int kKb = (kD / 8) * kKLbo;             // bf16 K tile
  static constexpr int kVb = (kBN / 8) * kVLbo;            // bf16 V tile
  static constexpr int kBox = kD <= 256 ? kD : 128;        // dims of one TMA box of K (<= 256)
  // kCl: each tile's S shares and their sums, two slots each, 32 floats a thread
  static constexpr int kPart = kCl ? 4 * 128 * 32 * 4 : 0;
  static constexpr int kSmem = 1024 + kStages * kRaw + kQ + kKb + kVb + kPart;
  static_assert(kD % 128 == 0 && (kBN == 32 || kBN == 64), "unsupported instance");
  static_assert(!kCl || kD == 128, "a cluster's CTAs are one warpgroup each");
  static_assert(kSmem <= 232448 - 64, "shared memory");
};

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22; its results
// are rounded to bf16 before they reach the tensor cores)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S (64 x kBN) += Q (64 x 16) K^T (16 x kBN)
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db) {
  wgmma_bf16_n64_bmn(d, da, db);
}
__device__ __forceinline__ void wgmma_s(float (&d)[16], uint64_t da, uint64_t db) {
  wgmma_bf16_n32_bmn(d, da, db);
}

constexpr int kMaxCluster = 8;  // CTAs of a cluster at most (D = 1024)

template <int kD, int kBN, int kStages, bool kCl>
__global__ void __launch_bounds__(TcShape<kD, kBN, kStages, kCl>::kThreads, 1)
prefill_tc_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q, const float* __restrict__ ks,
                  const int8_t* __restrict__ vq, const float* __restrict__ vs,
                  const int* __restrict__ starts, const float* __restrict__ alibi,
                  __nv_bfloat16* __restrict__ out, int li, int B, int T, int Hq, int Hkv, int S,
                  int nc, int window, float scale, float softcap) {
  using Sh = TcShape<kD, kBN, kStages, kCl>;
  constexpr int D = kD, kNT = Sh::kThreads;
  const int DT = kD * nc;  // this CTA's dims, the head's (nc CTAs a cluster, 1 without kCl)
  constexpr int kSN = kBN / 2;   // S values a thread holds
  constexpr int kKC = kBN / 16;  // k16 steps of P V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem + kStages * Sh::kRaw;
  uint8_t* kb = qs + Sh::kQ;
  uint8_t* vb = kb + Sh::kKb;
  float* part = reinterpret_cast<float*>(vb + Sh::kVb);  // kCl: shares, sums [2][8][128][4] each
  __shared__ __align__(8) uint64_t full[kStages];

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;  // this thread's warpgroup, its warp in it
  const int ds = kCl ? (int)cluster_rank() : 0;  // this CTA's dims: D ds .. D ds + D - 1
  const int qt = gridDim.x / nc - 1 - blockIdx.x / nc;  // the longest causal prefixes first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int t0 = qt * kTcBM;
  const int start = starts[b];
  const int qpos_lo = start + t0, qpos_hi = start + min(t0 + kTcBM, T) - 1;
  const int nkeys = min(qpos_hi + 1, S);
  const int tile_hi = (nkeys + kBN - 1) / kBN;
  const int tile_lo = window > 0 ? max(qpos_lo - window + 1, 0) / kBN : 0;
  const int ntiles = max(tile_hi - tile_lo, 0);
  const size_t head = ((size_t)li * B + b) * Hkv + hk;
  const int8_t* V = vq + head * (size_t)S * DT;
  const float* KS = ks + head * (size_t)S;
  const float* VS = vs + head * (size_t)S;
  const float slope = alibi != nullptr ? alibi[h] : 0.0f;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float inv127 = 1.0f / 127.0f;

  // one thread: key tile i (absolute tile_lo + i) into slot i % kStages
  // (in a cluster, this CTA's dims of the V rows are a TMA box column)
  auto load = [&](int i) {
    const int s0 = (tile_lo + i) * kBN;
    uint8_t* dst = smem + (i % kStages) * Sh::kRaw;
    uint64_t* bar = &full[i % kStages];
    mbar_expect_tx(bar, Sh::kRaw);
#pragma unroll
    for (int c = 0; c < D / Sh::kBox; ++c)
      tma_load_2d(dst + c * Sh::kBox * kBN, &kmap, bar, s0,
                  (int)(head * DT) + D * ds + c * Sh::kBox);
    if (kCl)
      tma_load_2d(dst + D * kBN, &vmap, bar, D * ds, (int)(head * S) + s0);
    else
      bulk_load(dst + D * kBN, V + (size_t)s0 * D, kBN * D, bar);
    bulk_load(dst + 2 * D * kBN, KS + s0, 4 * kBN, bar);
    bulk_load(dst + 2 * D * kBN + 4 * kBN, VS + s0, 4 * kBN, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < kStages - 1 && i < ntiles; ++i) load(i);
  }
  // Q rows t0..t0+63 (zeros past T) into the K-major layout: row r, 16-byte
  // chunk c (dims 8c..8c+7) at core_offset(r, c, 64)
  {
    constexpr int kCh = D / 8;                   // 16-byte chunks of a row
    constexpr int kQn = kTcBM * kCh / kNT;       // pieces per thread, all loads first
    uint4 v[kQn];
#pragma unroll
    for (int k = 0; k < kQn; ++k) {
      const int idx = tid + kNT * k, r = idx / kCh, c = idx % kCh, t = t0 + r;
      v[k] = t < T ? *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * Hq + h) * DT +
                                                     D * ds + 8 * c)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kQn; ++k) {
      const int idx = tid + kNT * k;
      *reinterpret_cast<uint4*>(qs + core_offset(idx / kCh, idx % kCh, kTcBM)) = v[k];
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if constexpr (kCl) cluster_sync();  // every CTA of the cluster runs (its shared memory exists)

  // this thread's accumulator rows (r, r + 8) of the tile's 64; its
  // warpgroup's output dims 128 wg .. 128 wg + 127
  const int row0 = 16 * warp + (lane >> 2);
  const int qp[2] = {qpos_lo + row0, qpos_lo + row0 + 8};
  float o[64], sacc[kSN];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < ntiles; ++i) {
    const int slot = i % kStages;
    const int s0 = (tile_lo + i) * kBN;
    // every warpgroup's products of the last tile have read kb and vb
    // (one warpgroup: its own wgmma_wait covers them)
    if constexpr (Sh::kWG > 1) __syncthreads();
    mbar_wait(&full[slot], (i / kStages) & 1);
    const uint8_t* raw = smem + slot * Sh::kRaw;
    // dequantize in place: 8 int8 of a raw row (K: dim d, keys 8c..; V: key
    // s, dims 8c..) become one 16-byte row of an MN-major core matrix. The
    // lanes of a load phase read one raw row, those of a store phase 8
    // MN groups.
#ifndef BNB_PROBE_NO_DECODE  // chip_smoke.py --probe: the int8 -> bf16 conversion switched off
    {
      constexpr int kJ = D * kBN / 8 / kNT;  // 8-byte jobs a thread, per tile
      constexpr int kKc = kBN / 8, kVc = D / 8;
      uint2 w[2 * kJ];
#pragma unroll
      for (int k = 0; k < kJ; ++k) {
        const int job = tid + kNT * k;
        w[k] = *reinterpret_cast<const uint2*>(raw + (job / kKc) * kBN + 8 * (job % kKc));
        w[kJ + k] = *reinterpret_cast<const uint2*>(raw + D * kBN + (job / kVc) * D + 8 * (job % kVc));
      }
#pragma unroll
      for (int k = 0; k < 2 * kJ; ++k) {
        const int job = tid + kNT * (k % kJ);
        const int row = k < kJ ? job / kKc : job / kVc, c = k < kJ ? job % kKc : job % kVc;
        uint8_t* dst = (k < kJ ? kb + (row >> 3) * Sh::kKLbo : vb + (row >> 3) * Sh::kVLbo) +
                       c * kTcSbo + (row & 7) * 16;
        float f[8];
        i8x4_to_f32(w[k].x, f);
        i8x4_to_f32(w[k].y, f + 4);
        *reinterpret_cast<uint4*>(dst) = make_uint4(bf16x2_bits(f[0], f[1]), bf16x2_bits(f[2], f[3]),
                                                    bf16x2_bits(f[4], f[5]), bf16x2_bits(f[6], f[7]));
      }
    }
#endif
    fence_proxy_async();
    __syncthreads();  // tiles converted; slot (i - 1) % kStages is free
    if (tid == 0 && i + kStages - 1 < ntiles) load(i + kStages - 1);

    // S = Q K^T (each warpgroup the whole tile: P is the same in all)
#pragma unroll
    for (int e = 0; e < kSN; ++e) sacc[e] = 0.0f;
    acc_fence(sacc);
    wgmma_fence();
#ifndef BNB_PROBE_NO_MMA  // chip_smoke.py --probe: the products switched off
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_s(sacc, gmma_desc(qs + core_offset(0, 2 * kk, kTcBM), kTcBM * 16, 128),
              gmma_desc(kb + 2 * kk * Sh::kKLbo, Sh::kKLbo, kTcSbo));
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(sacc);
    if constexpr (kCl) {
      // every CTA's share of S, added in rank order: the same S in every
      // CTA. Reduce-scatter, then all-gather: CTA r adds up the value
      // groups j with j % nc == r of every share (nc reads of one float4 a
      // thread and group) and stores the sum into every CTA, so a CTA moves
      // 2 x 16 KB a tile, not nc x 16 KB. Group j of thread t sits at
      // float4 j * 128 + t: a warp's accesses fall on distinct banks. A
      // slot is rewritten two tiles on, after every CTA has passed the next
      // tile's barriers, which follow its reads of this one.
#ifndef BNB_PROBE_NO_EXCHANGE  // chip_smoke.py --probe: the shares not exchanged
      float4* share = reinterpret_cast<float4*>(part) + (i & 1) * 1024 + tid;
      float4* sums = reinterpret_cast<float4*>(part) + 2048 + (i & 1) * 1024 + tid;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        share[128 * j] = make_float4(sacc[4 * j], sacc[4 * j + 1], sacc[4 * j + 2], sacc[4 * j + 3]);
      cluster_sync();  // every share of tile i is written
#pragma unroll 1
      for (int j = ds; j < 8; j += nc) {
        float4 v[kMaxCluster];  // every load issued before the first add
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c)
          if (c < nc) v[c] = ld_peer(peer_addr(share + 128 * j, (uint32_t)c));
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < nc) {
            t.x += v[c].x;
            t.y += v[c].y;
            t.z += v[c].z;
            t.w += v[c].w;
          }
        }
        for (int c = 0; c < nc; ++c) st_peer(peer_addr(sums + 128 * j, (uint32_t)c), t);
      }
      cluster_sync();  // every sum of tile i is in every CTA
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 t = sums[128 * j];
        sacc[4 * j] = t.x;
        sacc[4 * j + 1] = t.y;
        sacc[4 * j + 2] = t.z;
        sacc[4 * j + 3] = t.w;
      }
#endif
    }

    const float* ksr = reinterpret_cast<const float*>(raw + 2 * D * kBN);
    const float* vsr = ksr + kBN;
    uint32_t pa[kKC][4], pb[kKC][4];  // P's bf16 high parts and the remainders, as A fragments
#ifdef BNB_PROBE_NO_SOFTMAX  // chip_smoke.py --probe: the score epilogue and softmax switched off
#pragma unroll
    for (int e = 0; e < kSN; e += 2) {
      pa[e >> 3][(e >> 1) & 3] = bf16x2_bits(sacc[e], sacc[e + 1]);
      pb[e >> 3][(e >> 1) & 3] = 0;
    }
    (void)vsr;
#else
    // this thread's kBN / 4 columns (pairs 8j + 2 (lane % 4) + {0, 1}): their
    // k_scale * scale and v_scale / 127
    float kf[kBN / 4], vf[kBN / 4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(ksr + 8 * j + 2 * (lane & 3));
      const float2 v2 = *reinterpret_cast<const float2*>(vsr + 8 * j + 2 * (lane & 3));
      kf[2 * j] = k2.x * scale;
      kf[2 * j + 1] = k2.y * scale;
      vf[2 * j] = v2.x * inv127;
      vf[2 * j + 1] = v2.y * inv127;
    }
    // the options as whole-tile passes: a test inside the unrolled element
    // loop became a branch per element
#pragma unroll
    for (int e = 0; e < kSN; ++e) sacc[e] *= kf[2 * (e >> 2) + (e & 1)];
    if (alibi != nullptr) {
#pragma unroll
      for (int e = 0; e < kSN; ++e) sacc[e] += slope * (float)(s0 + acc_col(lane, e) - qp[(e >> 1) & 1]);
    }
    if (softcap > 0.0f) {
#pragma unroll
      for (int e = 0; e < kSN; ++e) sacc[e] = softcap * tanhf(sacc[e] * inv_cap);
    }
    if (s0 + kBN - 1 > qpos_lo || (window > 0 && qpos_hi - s0 >= window)) {  // a diagonal or window-edge tile
#pragma unroll
      for (int e = 0; e < kSN; ++e) {
        const int key = s0 + acc_col(lane, e), qq = qp[(e >> 1) & 1];
        if (!(key <= qq && (window <= 0 || qq - key < window))) sacc[e] = -1e30f;
      }
    }
    float mt[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int e = 0; e < kSN; ++e) mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], sacc[e]);
    // exponentials on the SFU: exp(x - m) = 2^(x log2 e - m log2 e); masked
    // keys weigh exactly 0, and alpha is exactly 1 while the row max holds
    float alpha[2], ml[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = mt[rr];
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      ml[rr] = m_new * kLog2e;
      alpha[rr] = m_new == m[rr] ? 1.0f : ex2_approx(fmaf(m[rr], kLog2e, -ml[rr]));
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    // p = exp(s - m) (0 where masked); l sums p; P = p * v_scale / 127 as a
    // bf16 high part and a bf16 remainder (16 significant bits, see the
    // note at the top), the A fragments of the k16 steps
#pragma unroll
    for (int e = 0; e < kSN; e += 2) {
      const int rr = (e >> 1) & 1, f = 2 * (e >> 2);
      const float p0 = sacc[e] > -1e30f ? ex2_approx(fmaf(sacc[e], kLog2e, -ml[rr])) : 0.0f;
      const float p1 = sacc[e + 1] > -1e30f ? ex2_approx(fmaf(sacc[e + 1], kLog2e, -ml[rr])) : 0.0f;
      l[rr] += p0 + p1;
      const float x0 = p0 * vf[f], x1 = p1 * vf[f + 1];
      const uint32_t hi = bf16x2_bits(x0, x1);
      pa[e >> 3][(e >> 1) & 3] = hi;
      pb[e >> 3][(e >> 1) & 3] = bf16x2_bits(x0 - __uint_as_float(hi << 16),
                                             x1 - __uint_as_float(hi & 0xffff0000u));
    }
    if (__any_sync(BNB_FULL_MASK, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int e = 0; e < 64; ++e) o[e] *= alpha[(e >> 1) & 1];
    }
#endif

    // O[:, this warpgroup's 128 dims] += P V
    acc_fence(o);
    wgmma_fence();
#ifndef BNB_PROBE_NO_MMA
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      const uint64_t dv = gmma_desc(vb + 2 * kc * Sh::kVLbo + 16 * wg * kTcSbo, Sh::kVLbo, kTcSbo);
      wgmma_bf16_n128_ra_bmn(o, pa[kc], dv);
      wgmma_bf16_n128_ra_bmn(o, pb[kc], dv);
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();  // kb and vb are free for the next tile (this warpgroup's reads)
    acc_fence(o);
  }

  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float ls = l[rr];
    ls += __shfl_xor_sync(BNB_FULL_MASK, ls, 1);
    ls += __shfl_xor_sync(BNB_FULL_MASK, ls, 2);
    inv[rr] = ls > 0.0f ? 1.0f / ls : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < 64; e += 2) {
    const int rr = (e >> 1) & 1, t = t0 + row0 + 8 * rr;
    if (t >= T) continue;
    const int col = D * ds + 128 * wg + acc_col(lane, e);
    *reinterpret_cast<uint32_t*>(out + (((size_t)b * T + t) * Hq + h) * DT + col) =
        bf16x2_bits(o[e] * inv[rr], o[e + 1] * inv[rr]);
  }
  if constexpr (kCl) cluster_sync();  // no CTA leaves while another may read its shares
}

template <int kD, int kBN, int kStages, bool kCl>
int launch_tc(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
              const void* starts, const void* alibi, void* out, int li, int L, int B, int T, int Hq,
              int Hkv, int S, int nc, int window, float scale, float softcap, cudaStream_t st) {
  using Sh = TcShape<kD, kBN, kStages, kCl>;
  const int DT = kD * nc;
  if (S % kBN) return (int)cudaErrorInvalidValue;
  // the K cache as rows of S keys: (L B Hkv D) rows, boxes of kBN keys x
  // kBox dims; in a cluster also the V cache as rows of D bytes, boxes of
  // kBN keys x 128 dims
  CUtensorMap kmap, vmap;
  int err = make_tmap_2d(&kmap, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)L * B * Hkv * DT, S,
                         S, Sh::kBox, kBN, false);
  if (err != 0) return err;
  vmap = kmap;
  if (kCl) {
    err = make_tmap_2d(&vmap, vq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)L * B * Hkv * S, DT,
                       DT, kBN, 128, false);
    if (err != 0) return err;
  }
  auto kernel = prefill_tc_kernel<kD, kBN, kStages, kCl>;
  const cudaError_t e = allow_smem_once<prefill_tc_kernel<kD, kBN, kStages, kCl>>(Sh::kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * ((T + kTcBM - 1) / kTcBM), Hq, B);
  cfg.blockDim = dim3(Sh::kThreads, 1, 1);
  cfg.dynamicSmemBytes = Sh::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCl ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kernel, kmap, vmap, reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const float*>(ks), reinterpret_cast<const int8_t*>(vq),
      reinterpret_cast<const float*>(vs), reinterpret_cast<const int*>(starts),
      reinterpret_cast<const float*>(alibi), reinterpret_cast<__nv_bfloat16*>(out), li, B, T, Hq,
      Hkv, S, nc, window, scale, softcap);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, T, Hq, D) f32/bf16; kq (L, B, Hkv, D, S) int8; ks, vs
// (L, B, Hkv, S) f32; vq (L, B, Hkv, S, D) int8; starts (B) int32; alibi
// (Hq) f32 or null. window <= 0: none; softcap <= 0: none. D is a multiple of
// 128 up to 1024.
extern "C" int prefill_attn_int8(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, const void* starts, const void* alibi, void* out,
                                 int li, int L, int B, int T, int Hq, int Hkv, int D, int S,
                                 int window, int q_bf16, float scale, float softcap,
                                 void* stream) {
  if (li < 0 || li >= L || Hkv <= 0 || Hq % Hkv || T <= 0 || D < 128 || D > 1024 || D % 128) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid((T + kRows - 1) / kRows, Hq, B);
  auto* kq8 = reinterpret_cast<const int8_t*>(kq);
  auto* vq8 = reinterpret_cast<const int8_t*>(vq);
  auto* ksf = reinterpret_cast<const float*>(ks);
  auto* vsf = reinterpret_cast<const float*>(vs);
  auto* st32 = reinterpret_cast<const int*>(starts);
  auto* al = reinterpret_cast<const float*>(alibi);
#define BNB_PREFILL_LAUNCH(DPL)                                                                 \
  prefill_kernel<DPL><<<grid, 32 * kRows, 0, st>>>(q, q_bf16, kq8, ksf, vq8, vsf, st32, al, out, \
                                                   li, B, T, Hq, Hkv, S, window, scale, softcap)
  switch (D / 128) {
    case 1: BNB_PREFILL_LAUNCH(4); break;
    case 2: BNB_PREFILL_LAUNCH(8); break;
    case 3: BNB_PREFILL_LAUNCH(12); break;
    case 4: BNB_PREFILL_LAUNCH(16); break;
    case 5: BNB_PREFILL_LAUNCH(20); break;
    case 6: BNB_PREFILL_LAUNCH(24); break;
    case 7: BNB_PREFILL_LAUNCH(28); break;
    default: BNB_PREFILL_LAUNCH(32); break;
  }
#undef BNB_PREFILL_LAUNCH
  return (int)cudaGetLastError();
}

// The tensor-core body. q and out (B, T, Hq, D) bf16; the cache as
// prefill_attn_int8's; D = 128 or 256 with S a multiple of 64, D = 384 or
// 512 with S a multiple of 32, D = 640 to 1024 (clusters of D / 128 CTAs)
// with S a multiple of 64 (`ops/attention.TC_KEY_TILE`); every tensor
// 16-byte aligned.
extern "C" int prefill_attn_int8_tc(const void* q, const void* kq, const void* ks, const void* vq,
                                    const void* vs, const void* starts, const void* alibi,
                                    void* out, int li, int L, int B, int T, int Hq, int Hkv, int D,
                                    int S, int window, float scale, float softcap, void* stream) {
  if (li < 0 || li >= L || Hkv <= 0 || Hq % Hkv || T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BNB_TC_LAUNCH(DD, BN, ST, CL, NC)                                                        \
  return launch_tc<DD, BN, ST, CL>(q, kq, ks, vq, vs, starts, alibi, out, li, L, B, T, Hq, Hkv, S, \
                                   NC, window, scale, softcap, st)
  switch (D) {
    case 128: BNB_TC_LAUNCH(128, 64, 3, false, 1);
    case 256: BNB_TC_LAUNCH(256, 64, 3, false, 1);
    case 384: BNB_TC_LAUNCH(384, 32, 3, false, 1);
    case 512: BNB_TC_LAUNCH(512, 32, 2, false, 1);
    case 640:
    case 768:
    case 896:
    case 1024: BNB_TC_LAUNCH(128, 64, 3, true, D / 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BNB_TC_LAUNCH
}
