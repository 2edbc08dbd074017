// Kernel H: single-token decode attention over the contiguous int8 KV cache.
//
// Replaces bitsandbytes_sycl_tpu/ops/attention.py `_attn_kernel` (called
// through `_decode_attn_call` and `_decode_attn_call_stacked`).
//
// Computes, for batch row b, kv head hk and its `rep` q heads, over cache
// layer li (K (L, B, Hkv, D, S) int8 transposed, V (L, B, Hkv, S, D) int8,
// scales (L, B, Hkv, S) f32):
//   score = (q . k_i8) * (k_scale * scale) (+ ALiBi slope * (pos - qpos)),
//   softcapped, masked to pos < len[b] (and pos >= qpos + 1 - window), with
//   qpos = len (new_kv given) or len - 1; online softmax over chunks of
//   positions; V weighted by v_scale * f32(1/127); the new_kv token folded
//   in last as one exact online-softmax step. len == 0 without new_kv gives
//   zeros (the JAX kernel's inv = where(len > 0, 1/l, 0)).
//
// Bound on the H100: memory. Each used position's K and V bytes (2 D per kv
// head) and scales are read once; a position costs ~4 flops per byte.
//
// Design: one block of 8 warps per (kv head, batch row); all rep q heads of
// the kv head share each K/V read. The block walks only positions < len
// (from the window's first position, where one binds), 1024 at a time.
// Scores: K is stored (D, S), so a thread takes 4 consecutive positions and
// reads one 4-byte word per d, a warp 128 contiguous bytes of each K row.
// Softmax reductions run across the block. P.V: a warp takes every 8th
// position and each lane 4 consecutive d of the V row (one 4-byte word, a
// warp the whole 128-byte row); the 8 warps' partial sums meet in shared
// memory and add in a fixed order at the end.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCH = 4 * kThreads;  // positions per chunk

__device__ __forceinline__ void unpack4(uint32_t w, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = (float)(int8_t)((w >> (8 * e)) & 0xffu);
}

// kDW = D / 128: the 4-byte words of a V row that each lane reads.
template <int kRep, int kDW>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kc,
              const float* __restrict__ ks, const int8_t* __restrict__ vc,
              const float* __restrict__ vs, const int* __restrict__ lens,
              const float* __restrict__ alibi, const int8_t* __restrict__ kn,
              const float* __restrict__ ksn, const int8_t* __restrict__ vn,
              const float* __restrict__ vsn, void* out, int li, int B, int Hkv, int S,
              int window, float scale, float softcap) {
  constexpr int D = 128 * kDW;
  constexpr int kScratch = kCH > kWarps * D ? kCH : kWarps * D;
  extern __shared__ float smem[];
  float* qs = smem;                      // [rep][D]
  float* sc = qs + kRep * D;             // [rep][kCH]; at the end [warps][rep][D]
  float* red = sc + kRep * kScratch;     // [32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const size_t qbase = ((size_t)b * Hkv + hk) * kRep * D;
  for (int i = tid; i < kRep * D; i += kThreads) qs[i] = ld_f(q, qbase + i, q_bf16);

  const size_t slab = ((size_t)li * B + b) * Hkv + hk;
  const int8_t* K = kc + slab * D * S;
  const int8_t* V = vc + slab * S * D;
  const float* KS = ks + slab * S;
  const float* VS = vs + slab * S;
  const int len = lens[b];
  const bool has_new = kn != nullptr;
  const int qpos = has_new ? len : len - 1;
  const int end = min(max(len, 0), S);
  const int lo = window > 0 ? max(0, qpos + 1 - window) : 0;
  const int begin = min(lo, end) & ~3;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float inv127 = (float)(1.0 / 127.0);

  float m[kRep], l[kRep], acc[kRep][kDW][4];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.0f;
  }
  __syncthreads();

  for (int s0 = begin; s0 < end; s0 += kCH) {
    const int p0 = s0 + 4 * tid;  // this thread's 4 positions
    if (p0 < end) {
      float dot[kRep][4];
#pragma unroll
      for (int r = 0; r < kRep; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[r][e] = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float kv[4];
        unpack4(__ldg(reinterpret_cast<const unsigned int*>(K + (size_t)d * S + p0)), kv);
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float qv = qs[r * D + d];
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[r][e] = fmaf(qv, kv[e], dot[r][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + e;
        const bool valid = pos < end && pos >= lo;
        const float kscale = valid ? KS[pos] * scale : 0.0f;
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          float s = dot[r][e] * kscale;
          if (alibi != nullptr) s = s + alibi[hk * kRep + r] * (float)(pos - qpos);
          if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
          sc[r * kCH + 4 * tid + e] = valid ? s : -1e30f;
        }
      }
    }
    __syncthreads();
    const int n = min(kCH, end - s0);
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float mx = -1e30f;
      for (int t = tid; t < n; t += kThreads) mx = fmaxf(mx, sc[r * kCH + t]);
      const float m_new = fmaxf(m[r], block_reduce<true>(mx, red));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.0f;
      for (int t = tid; t < n; t += kThreads) {
        const float w = expf(sc[r * kCH + t] - m_new);
        sum += w;
        sc[r * kCH + t] = w * (VS[s0 + t] * inv127);
      }
      l[r] = l[r] * alpha + block_reduce<false>(sum, red);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kDW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][j][e] *= alpha;
    }
    __syncthreads();
    for (int t = warp; t < n; t += kWarps) {
      const unsigned int* vrow = reinterpret_cast<const unsigned int*>(V + (size_t)(s0 + t) * D);
#pragma unroll
      for (int j = 0; j < kDW; ++j) {
        float v[4];
        unpack4(__ldg(vrow + j * 32 + lane), v);
#pragma unroll
        for (int r = 0; r < kRep; ++r) {
          const float p = sc[r * kCH + t];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = fmaf(p, v[e], acc[r][j][e]);
        }
      }
    }
    __syncthreads();
  }

  // the warps' partial sums, then the new token's score per q head
  float* part = sc;  // [warps][rep][D]
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int j = 0; j < kDW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[(warp * kRep + r) * D + (j * 32 + lane) * 4 + e] = acc[r][j][e];
  const size_t nb = (size_t)b * Hkv + hk;
  float sn[kRep];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    sn[r] = 0.0f;
    if (has_new) {
      float dsum = 0.0f;
      for (int d = tid; d < D; d += kThreads) dsum += qs[r * D + d] * (float)kn[nb * D + d];
      sn[r] = block_reduce<false>(dsum, red) * (ksn[nb] * scale);
      if (softcap > 0.0f) sn[r] = softcap * tanhf(sn[r] * inv_cap);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += part[(w * kRep + r) * D + d];
      if (has_new) {
        const float m2 = fmaxf(m[r], sn[r]);
        const float alpha = expf(m[r] - m2);
        const float w_new = expf(sn[r] - m2);
        const float inv = 1.0f / (l[r] * alpha + w_new);
        o = o * alpha * inv + (w_new * inv * (vsn[nb] * inv127)) * (float)vn[nb * D + d];
      } else {
        o = o * (len > 0 ? 1.0f / l[r] : 0.0f);
      }
      st_f(out, qbase + (size_t)r * D + d, o, q_bf16);
    }
  }
}

template <int kRep, int kDW>
int launch(dim3 grid, cudaStream_t st, const void* q, int q_bf16, const int8_t* kc,
           const float* ks, const int8_t* vc, const float* vs, const int* lens,
           const float* alibi, const int8_t* kn, const float* ksn, const int8_t* vn,
           const float* vsn, void* out, int li, int B, int Hkv, int S, int window, float scale,
           float softcap) {
  constexpr int D = 128 * kDW;
  constexpr int kScratch = kCH > kWarps * D ? kCH : kWarps * D;
  const size_t shmem = ((size_t)kRep * D + (size_t)kRep * kScratch + 32) * sizeof(float);
  auto kernel = decode_kernel<kRep, kDW>;
  if (shmem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, shmem, st>>>(q, q_bf16, kc, ks, vc, vs, lens, alibi, kn, ksn, vn, vsn,
                                        out, li, B, Hkv, S, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q and out (B, Hkv, rep, D) f32/bf16; kc (L, B, Hkv, D, S) int8; vc (L, B,
// Hkv, S, D) int8; ks, vs (L, B, Hkv, S) f32; lens (B) int32; alibi (Hkv *
// rep) f32 or null; kn, vn (B, Hkv, D) int8 and ksn, vsn (B, Hkv) f32, all
// four null or all four given. rep in {1, 2, 4, 8}, D in {128, 256}, S % 4
// == 0. window <= 0: none; softcap <= 0: none.
extern "C" int decode_attn_int8(const void* q, const void* kc, const void* ks, const void* vc,
                                const void* vs, const void* lens, const void* alibi,
                                const void* kn, const void* ksn, const void* vn, const void* vsn,
                                void* out, int li, int L, int B, int Hkv, int rep, int D, int S,
                                int window, int has_new, int q_bf16, float scale, float softcap,
                                void* stream) {
  if (li < 0 || li >= L || (rep != 1 && rep != 2 && rep != 4 && rep != 8) ||
      (D != 128 && D != 256) || S <= 0 || S % 4) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  dim3 grid(Hkv, B);
  auto* k8 = reinterpret_cast<const int8_t*>(kc);
  auto* v8 = reinterpret_cast<const int8_t*>(vc);
  auto* ksf = reinterpret_cast<const float*>(ks);
  auto* vsf = reinterpret_cast<const float*>(vs);
  auto* ln = reinterpret_cast<const int*>(lens);
  auto* al = reinterpret_cast<const float*>(alibi);
  auto* kn8 = has_new ? reinterpret_cast<const int8_t*>(kn) : nullptr;
  auto* ksnf = reinterpret_cast<const float*>(ksn);
  auto* vn8 = reinterpret_cast<const int8_t*>(vn);
  auto* vsnf = reinterpret_cast<const float*>(vsn);
#define BNB_DECODE_LAUNCH(R, W)                                                              \
  return launch<R, W>(grid, st, q, q_bf16, k8, ksf, v8, vsf, ln, al, kn8, ksnf, vn8, vsnf, out, \
                      li, B, Hkv, S, window, scale, softcap)
  const int dw = D / 128;
  switch (rep * 10 + dw) {
    case 11: BNB_DECODE_LAUNCH(1, 1);
    case 12: BNB_DECODE_LAUNCH(1, 2);
    case 21: BNB_DECODE_LAUNCH(2, 1);
    case 22: BNB_DECODE_LAUNCH(2, 2);
    case 41: BNB_DECODE_LAUNCH(4, 1);
    case 42: BNB_DECODE_LAUNCH(4, 2);
    case 81: BNB_DECODE_LAUNCH(8, 1);
    default: BNB_DECODE_LAUNCH(8, 2);
  }
#undef BNB_DECODE_LAUNCH
}
