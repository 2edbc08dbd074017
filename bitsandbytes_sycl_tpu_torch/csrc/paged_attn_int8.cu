// Kernel D: single-token decode attention over the paged int8 KV pool.
//
// Replaces bitsandbytes_sycl_tpu/ops/paged_attention.py `_paged_attn_kernel`
// (called through `_paged_attn_call`) for int8 pages.
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
// Bound on the H100: memory. Each used page's K and V bytes (2 * P * D per
// kv head) and scales are read once; a page costs ~4 flops per byte.
//
// Design: one block per (kv head, batch row), D threads. The block reads its
// own page table row (no scalar prefetch on this card) and walks only the
// row's used pages, max(ceil(len / P), 1), so short rows fetch no tail
// pages. All rep q heads of the kv head share each page read. Scores: a
// thread per token, K row read in 16-byte pieces; softmax reductions across
// the block; P.V: a thread per output element, reading V rows coalesced.
#include "common.cuh"

namespace {

template <int kRep>
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
  const float inv127 = 1.0f / 127.0f;

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
    const int8_t* K = kp + page * P * D;
    const int8_t* V = vp + page * P * D;
    const float* KS = ks + page * P;
    const float* VS = vs + page * P;
    for (int t = tid; t < P; t += nt) {
      float dot[kRep];
      for (int r = 0; r < kRep; ++r) dot[r] = 0.0f;
      const int4* kr = reinterpret_cast<const int4*>(K + (size_t)t * D);
      for (int d16 = 0; d16 < D / 16; ++d16) {
        const int4 raw = __ldg(kr + d16);
        const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float kv = (float)kb[i];
          for (int r = 0; r < rep; ++r) dot[r] = fmaf(qs[r * D + d16 * 16 + i], kv, dot[r]);
        }
      }
      const int pos = j * P + t;
      const float kscale = KS[t] * scale;
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
        sc[r * P + t] = w * (VS[t] * inv127);
      }
      l[r] = l[r] * alpha + block_reduce<false>(sum, red);
      m[r] = m_new;
      acc[r] *= alpha;
    }
    __syncthreads();
    for (int d = tid; d < D; d += nt) {
#pragma unroll 8
      for (int t = 0; t < P; ++t) {
        const float v = (float)V[(size_t)t * D + d];
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
      const float wv_new = w_new * (vsn[nb] * inv127);
      o = (acc[r] * alpha + wv_new * (float)vn[nb * D + d]) / l2;
    } else {
      o = acc[r] * (len > 0 ? 1.0f / l[r] : 0.0f);
    }
    st_f(out, qbase + (size_t)r * D + d, o, q_bf16);
  }
}

}  // namespace

// q and out (B, Hkv, rep, D) f32/bf16; kp, vp (L, NP, Hkv, P, D) int8; ks,
// vs (L, NP, Hkv, P) f32; page_table (B, MAXP) int32; lens (B) int32; alibi
// (Hkv * rep) f32 or null; kn, vn (B, Hkv, D) int8 and ksn, vsn (B, Hkv) f32,
// all four null or all four given. window <= 0: none; softcap <= 0: none.
extern "C" int paged_attn_int8(const void* q, const void* kp, const void* ks, const void* vp,
                               const void* vs, const void* page_table, const void* lens,
                               const void* alibi, const void* kn, const void* ksn, const void* vn,
                               const void* vsn, void* out, int li, int L, int NP, int B, int Hkv,
                               int rep, int D, int P, int MAXP, int window, int has_new,
                               int q_bf16, float scale, float softcap, void* stream) {
  if (li < 0 || li >= L || (rep != 1 && rep != 2 && rep != 4 && rep != 8) || D % 32 ||
      D > 1024 || P <= 0 || MAXP <= 0) {
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
#define BNB_PAGED_LAUNCH(R)                                                                  \
  paged_kernel<R><<<grid, D, shmem, st>>>(q, q_bf16, kp8, ksf, vp8, vsf, pt, ln, al, kn8, ksnf, \
                                          vn8, vsnf, out, li, NP, Hkv, D, P, MAXP, window,    \
                                          scale, softcap)
  switch (rep) {
    case 1: BNB_PAGED_LAUNCH(1); break;
    case 2: BNB_PAGED_LAUNCH(2); break;
    case 4: BNB_PAGED_LAUNCH(4); break;
    default: BNB_PAGED_LAUNCH(8); break;
  }
#undef BNB_PAGED_LAUNCH
  return (int)cudaGetLastError();
}
