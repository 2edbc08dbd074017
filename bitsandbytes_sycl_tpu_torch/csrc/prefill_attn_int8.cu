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
// Tensor-core body (`prefill_tc_kernel`: bf16 q, D = 128, S a multiple of
// 64). Bound on the H100: bf16 tensor-core operations (4 T^2 D / 2 per
// head) or the bytes of q, out and the K/V prefix, whichever is larger.
// One warpgroup per (64-row query tile, q head, batch row), heaviest tiles
// launched first. Q (bf16) sits in shared memory in wgmma's K-major layout.
// Key tiles of 64: one thread's TMA copy brings the K tile (128 rows of 64
// contiguous keys of the transposed cache, a 2-D box), bulk copies the V
// tile (64 x 128 contiguous bytes) and both scale rows, into a 3-slot ring
// two tiles ahead on mbarriers. The threads dequantize the int8 tiles to
// bf16 in place (exact: |code| <= 127), 8 bytes in, 16 bytes out: wgmma
// reads both as MN-major B operands, which is the int8 tiles' own layout
// (K keys-contiguous per dim, V dims-contiguous per key), so nothing is
// transposed (an 8 x 8 byte-permute transpose into K-major tiles took
// 6 us more at T = 512). Then
// S = Q K^T by wgmma m64n64k16 (bf16 x integer products are exact, so only
// the f32 summation order differs from the plain version); scale, ALiBi,
// softcap and the masks (on diagonal and window-edge tiles only) and the
// online softmax run on the accumulator registers, four threads per row;
// P * v_scale / 127 as a bf16 high part plus a bf16 remainder is the A
// operand from registers (the accumulator's layout is the A fragment's) of
// O += P V, two wgmma m64n128k16 per k16 step: P rounded once, to bf16 or
// to f16 with V in f16 (one product, 5 us less), passed the 1% kernel check
// but moved 2-layer 7B logits 4.8% and 4.1% from the CPU's, over the 4%
// limit of chip_smoke.py phase 5. The exponentials run on the special-function
// unit as powers of 2, the options as whole-tile passes (a test inside the
// unrolled element loop compiled to a branch per element) and the O
// rescale only when a row max moved: the epilogue had taken half the time
// (chip_smoke.py --probe attention). Tiles wholly outside the window are
// skipped. One warpgroup per CTA, so wgmma_wait covers every product that
// read a buffer before the threads write it again. Two warpgroups sharing
// each converted tile, and a producer warpgroup converting the next tile
// while two consumers computed, both measured no faster on the H100.
//
// SIMT body (`prefill_kernel`: f32 q, D = 256, other S). Bound the same
// way, at the f32 rate. One warp per query row, four rows (warps) per block
// sharing the (b, h) K/V reads through L1. Keys go in chunks of 32, one key
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
constexpr int kTcD = 128;     // head dim
constexpr int kTcBM = 64;     // query rows per CTA (one warpgroup)
constexpr int kTcBN = 64;     // keys per tile
constexpr int kTcStages = 3;  // ring slots of raw int8 tiles
constexpr int kTcRaw = 2 * kTcD * kTcBN + 2 * 4 * kTcBN;  // K, V, k and v scales
constexpr int kTcQ = kTcBM * kTcD * 2;                    // bf16 Q
// The dequantized tiles are wgmma B operands in the MN-major layout, the
// int8 tiles' own: a core matrix holds 8 K rows of 8 consecutive MN values
// (16 bytes each); MN groups of 8 are kTcSbo bytes apart (144, not 128, so
// that the 8 lanes of a store phase, one per group, hit distinct banks)
// and K groups of 8 one group row apart.
constexpr int kTcSbo = 144;
constexpr int kTcKLbo = (kTcBN / 8) * kTcSbo;  // K tile: MN = 64 keys, K = 128 dims
constexpr int kTcVLbo = (kTcD / 8) * kTcSbo;   // V tile: MN = 128 dims, K = 64 keys
constexpr int kTcKb = (kTcD / 8) * kTcKLbo;    // bf16 K tile
constexpr int kTcVb = (kTcBN / 8) * kTcVLbo;   // bf16 V tile
constexpr int kTcSmem = 1024 + kTcStages * kTcRaw + kTcQ + kTcKb + kTcVb;

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

__global__ void __launch_bounds__(128)
prefill_tc_kernel(const __grid_constant__ CUtensorMap kmap, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ ks, const int8_t* __restrict__ vq,
                  const float* __restrict__ vs, const int* __restrict__ starts,
                  const float* __restrict__ alibi, __nv_bfloat16* __restrict__ out, int li, int B,
                  int T, int Hq, int Hkv, int S, int window, float scale, float softcap) {
  constexpr int D = kTcD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem + kTcStages * kTcRaw;
  uint8_t* kb = qs + kTcQ;
  uint8_t* vb = kb + kTcKb;
  __shared__ __align__(8) uint64_t full[kTcStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal prefixes first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int t0 = qt * kTcBM;
  const int start = starts[b];
  const int qpos_lo = start + t0, qpos_hi = start + min(t0 + kTcBM, T) - 1;
  const int nkeys = min(qpos_hi + 1, S);
  const int tile_hi = (nkeys + kTcBN - 1) / kTcBN;
  const int tile_lo = window > 0 ? max(qpos_lo - window + 1, 0) / kTcBN : 0;
  const int ntiles = max(tile_hi - tile_lo, 0);
  const size_t head = ((size_t)li * B + b) * Hkv + hk;
  const int8_t* V = vq + head * (size_t)S * D;
  const float* KS = ks + head * (size_t)S;
  const float* VS = vs + head * (size_t)S;
  const float slope = alibi != nullptr ? alibi[h] : 0.0f;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float inv127 = 1.0f / 127.0f;

  // one thread: key tile i (absolute tile_lo + i) into slot i % kTcStages
  auto load = [&](int i) {
    const int s0 = (tile_lo + i) * kTcBN;
    uint8_t* dst = smem + (i % kTcStages) * kTcRaw;
    uint64_t* bar = &full[i % kTcStages];
    mbar_expect_tx(bar, kTcRaw);
    tma_load_2d(dst, &kmap, bar, s0, (int)(head * D));
    bulk_load(dst + D * kTcBN, V + (size_t)s0 * D, kTcBN * D, bar);
    bulk_load(dst + 2 * D * kTcBN, KS + s0, 4 * kTcBN, bar);
    bulk_load(dst + 2 * D * kTcBN + 4 * kTcBN, VS + s0, 4 * kTcBN, bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < kTcStages - 1 && i < ntiles; ++i) load(i);
  }
  // Q rows t0..t0+63 (zeros past T) into the K-major layout: row r, 16-byte
  // chunk c (dims 8c..8c+7) at core_offset(r, c, 64)
  {
    constexpr int kQn = kTcBM * (D / 8) / 128;  // 16-byte pieces per thread, all loads first
    uint4 v[kQn];
#pragma unroll
    for (int k = 0; k < kQn; ++k) {
      const int idx = tid + 128 * k, r = idx >> 4, c = idx & 15, t = t0 + r;
      v[k] = t < T ? *reinterpret_cast<const uint4*>(q + (((size_t)b * T + t) * Hq + h) * D + 8 * c)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kQn; ++k) {
      const int idx = tid + 128 * k;
      *reinterpret_cast<uint4*>(qs + core_offset(idx >> 4, idx & 15, kTcBM)) = v[k];
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them

  // this thread's accumulator rows (r, r + 8) of the warpgroup's 64
  const int row0 = 16 * warp + (lane >> 2);
  const int qp[2] = {qpos_lo + row0, qpos_lo + row0 + 8};
  float o[64], sacc[32];
#pragma unroll
  for (int e = 0; e < 64; ++e) o[e] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};

  for (int i = 0; i < ntiles; ++i) {
    const int slot = i % kTcStages;
    const int s0 = (tile_lo + i) * kTcBN;
    mbar_wait(&full[slot], (i / kTcStages) & 1);
    const uint8_t* raw = smem + slot * kTcRaw;
    // dequantize in place: 8 int8 of a raw row (K: dim d, keys 8c..; V: key
    // s, dims 8c..) become one 16-byte row of an MN-major core matrix. The
    // lanes of a load phase read one raw row, those of a store phase 8
    // MN groups.
#ifndef BNB_PROBE_NO_DECODE  // chip_smoke.py --probe: the int8 -> bf16 conversion switched off
    {
      uint2 w[16];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int job = tid + 128 * k;
        w[k] = *reinterpret_cast<const uint2*>(raw + (job >> 3) * kTcBN + 8 * (job & 7));
        w[8 + k] = *reinterpret_cast<const uint2*>(raw + D * kTcBN + (job >> 4) * D + 8 * (job & 15));
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int job = tid + 128 * (k & 7);
        const int row = k < 8 ? job >> 3 : job >> 4, c = k < 8 ? job & 7 : job & 15;
        uint8_t* dst = (k < 8 ? kb + (row >> 3) * kTcKLbo : vb + (row >> 3) * kTcVLbo) +
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
    __syncthreads();  // tiles converted; slot (i - 1) % kTcStages is free
    if (tid == 0 && i + kTcStages - 1 < ntiles) load(i + kTcStages - 1);

    // S = Q K^T
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
    acc_fence(sacc);
    wgmma_fence();
#ifndef BNB_PROBE_NO_MMA  // chip_smoke.py --probe: the products switched off
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_bf16_n64_bmn(sacc, gmma_desc(qs + core_offset(0, 2 * kk, kTcBM), kTcBM * 16, 128),
                         gmma_desc(kb + 2 * kk * kTcKLbo, kTcKLbo, kTcSbo));
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();
    acc_fence(sacc);

    const float* ksr = reinterpret_cast<const float*>(raw + 2 * D * kTcBN);
    const float* vsr = ksr + kTcBN;
    uint32_t pa[4][4], pb[4][4];  // P's bf16 high parts and the remainders, as A fragments
#ifdef BNB_PROBE_NO_SOFTMAX  // chip_smoke.py --probe: the score epilogue and softmax switched off
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      pa[e >> 3][(e >> 1) & 3] = bf16x2_bits(sacc[e], sacc[e + 1]);
      pb[e >> 3][(e >> 1) & 3] = 0;
    }
    (void)vsr;
#else
    // this thread's 16 columns (pairs 8j + 2 (lane % 4) + {0, 1}): their
    // k_scale * scale and v_scale / 127
    float kf[16], vf[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
    for (int e = 0; e < 32; ++e) sacc[e] *= kf[2 * (e >> 2) + (e & 1)];
    if (alibi != nullptr) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] += slope * (float)(s0 + acc_col(lane, e) - qp[(e >> 1) & 1]);
    }
    if (softcap > 0.0f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = softcap * tanhf(sacc[e] * inv_cap);
    }
    if (s0 + kTcBN - 1 > qpos_lo || (window > 0 && qpos_hi - s0 >= window)) {  // a diagonal or window-edge tile
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = s0 + acc_col(lane, e), qq = qp[(e >> 1) & 1];
        if (!(key <= qq && (window <= 0 || qq - key < window))) sacc[e] = -1e30f;
      }
    }
    float mt[2] = {-1e30f, -1e30f};
#pragma unroll
    for (int e = 0; e < 32; ++e) mt[(e >> 1) & 1] = fmaxf(mt[(e >> 1) & 1], sacc[e]);
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
    // note at the top), the A fragments of four k16 steps each
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
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

    // O += P V
    acc_fence(o);
    wgmma_fence();
#ifndef BNB_PROBE_NO_MMA
#pragma unroll
    for (int kc = 0; kc < kTcBN / 16; ++kc) {
      const uint64_t dv = gmma_desc(vb + 2 * kc * kTcVLbo, kTcVLbo, kTcSbo);
      wgmma_bf16_n128_ra_bmn(o, pa[kc], dv);
      wgmma_bf16_n128_ra_bmn(o, pb[kc], dv);
    }
#endif
    wgmma_commit();
    wgmma_wait<0>();  // kb and vb are free for the next tile
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
    const int col = acc_col(lane, e);
    *reinterpret_cast<uint32_t*>(out + (((size_t)b * T + t) * Hq + h) * D + col) =
        bf16x2_bits(o[e] * inv[rr], o[e + 1] * inv[rr]);
  }
}

}  // namespace

// q and out (B, T, Hq, D) f32/bf16; kq (L, B, Hkv, D, S) int8; ks, vs
// (L, B, Hkv, S) f32; vq (L, B, Hkv, S, D) int8; starts (B) int32; alibi
// (Hq) f32 or null. window <= 0: none; softcap <= 0: none. D is 128 or 256.
extern "C" int prefill_attn_int8(const void* q, const void* kq, const void* ks, const void* vq,
                                 const void* vs, const void* starts, const void* alibi, void* out,
                                 int li, int L, int B, int T, int Hq, int Hkv, int D, int S,
                                 int window, int q_bf16, float scale, float softcap,
                                 void* stream) {
  if (li < 0 || li >= L || Hkv <= 0 || Hq % Hkv || T <= 0 || (D != 128 && D != 256)) {
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
  if (D == 128) {
    prefill_kernel<4><<<grid, 32 * kRows, 0, st>>>(q, q_bf16, kq8, ksf, vq8, vsf, st32, al, out,
                                                   li, B, T, Hq, Hkv, S, window, scale, softcap);
  } else {
    prefill_kernel<8><<<grid, 32 * kRows, 0, st>>>(q, q_bf16, kq8, ksf, vq8, vsf, st32, al, out,
                                                   li, B, T, Hq, Hkv, S, window, scale, softcap);
  }
  return (int)cudaGetLastError();
}

// The tensor-core body. q and out (B, T, Hq, D) bf16; the cache as
// prefill_attn_int8's, D = 128, S a multiple of 64; every tensor 16-byte
// aligned.
extern "C" int prefill_attn_int8_tc(const void* q, const void* kq, const void* ks, const void* vq,
                                    const void* vs, const void* starts, const void* alibi,
                                    void* out, int li, int L, int B, int T, int Hq, int Hkv, int D,
                                    int S, int window, float scale, float softcap, void* stream) {
  if (li < 0 || li >= L || Hkv <= 0 || Hq % Hkv || T <= 0 || D != kTcD || S % kTcBN) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the K cache as rows of S keys: (L B Hkv D) rows, boxes of 64 keys x D dims
  CUtensorMap kmap;
  int err = make_tmap_2d(&kmap, kq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)L * B * Hkv * D, S,
                         S, D, kTcBN, false);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(prefill_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kTcSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kTcBM - 1) / kTcBM, Hq, B);
  prefill_tc_kernel<<<grid, 128, kTcSmem, st>>>(
      kmap, reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const float*>(ks),
      reinterpret_cast<const int8_t*>(vq), reinterpret_cast<const float*>(vs),
      reinterpret_cast<const int*>(starts), reinterpret_cast<const float*>(alibi),
      reinterpret_cast<__nv_bfloat16*>(out), li, B, T, Hq, Hkv, S, window, scale, softcap);
  return (int)cudaGetLastError();
}
