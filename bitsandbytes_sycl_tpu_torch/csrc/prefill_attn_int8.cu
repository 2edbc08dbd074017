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
// Bound on the H100: memory. Each row reads the int8 K and V rows of its
// causal prefix once; the work per byte is a few flops. The TPU kernel
// visits all S = max_seq_len cache columns; this one stops at qpos, which
// is exact because a fully masked chunk leaves (m, l, acc) unchanged
// (every causal row has key 0 valid, or a later valid key that zeroes the
// correction factor of any fully masked chunk before it).
//
// Design: one warp per query row, four rows (warps) per block sharing the
// (b, h) K/V reads through L1. Keys go in chunks of 32, one key per lane:
// the K cache is transposed (D, S), so a lane's key column is read with the
// warp's 32 neighbouring keys, 32 contiguous bytes per d. For P.V each lane
// owns D/32 contiguous output elements of the V row (S, D) and the key
// weights are broadcast by shuffles.
#include "common.cuh"

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
