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
// Two bodies; the wrapper picks one (`ops/attention.decode_plan`). Both take
// any group size rep = Hq / Hkv: a CTA serves a group of kG q heads of one
// kv head (kG a template constant, each K/V read shared by the group), and
// the rep heads of a kv head are ceil(rep / kG) groups on the grid's third
// axis. A last group with fewer than kG heads repeats its last head in the
// spare places and stores only its own heads. kG = rep for rep 1, 2 and 4
// (and 8 in the SIMT body): one group, as before.
//
// Split body (`decode_split_kernel<kG, kDW, cluster>`: D = 128 to 1024, S % 16
// == 0, groups of up to 4 heads): flash-decoding over the contiguous
// layout. A CTA holds kDW x 128 dims of the head: all of them at D = 128
// and 256; past 256, where three 128-position ring slots of the whole head
// pass 227 KB, a cluster of D / 128 CTAs each holds 128 dims (K and V
// by TMA boxes of its dims), adds each tile's score shares of every CTA
// from distributed shared memory in rank order (the same scores, so the
// same softmax, in every CTA; one cluster barrier a tile) and owns its 128
// output dims through the split merge, with tickets and partials per CTA.
// The grid is (kv head, batch row, group x split); split z takes an equal
// share of the 128-position tiles of the row's used span [lo, len), read
// from the lengths on the card, so
// every CTA of a row gets the same work however long the row; the plan
// sets the split count from host-known sizes only. One thread brings each
// tile into a 3-slot ring on mbarriers: K's D rows x 128 positions (row
// stride S) by one TMA box with the 128-byte swizzle (256 rows, TMA's
// largest box, at D = 256), V's 128 x D contiguous bytes and the two scale
// rows by bulk copies, so two tiles (66 KB at D = 128, 130 KB at 256;
// 200,704 bytes of shared memory there) stream in while one is scored and a
// short row is one round trip.
// Each of the 8 warps takes 16 positions of a tile. Scores: a lane holds q
// at D / 32 dims (32 j + lane) of each head of its group in registers and
// reads those K rows' 16 positions as one 16-byte piece (the swizzle keeps
// the 8 lanes of
// a load phase on 8 banks), then 16 shuffles per head leave each lane
// with one position's score. Each warp keeps its own online softmax (m, l
// warp-uniform), with masked positions at weight 0, so an empty share
// keeps l = 0 and acc = 0. P.V: D / 16 lanes read one V row in 16-byte
// pieces (8 at D = 128: 4 rows a load; 16 at D = 256: 2 rows), so a lane
// keeps 16 output dims of each head at either width (218 registers a
// thread at D = 256 with 4 heads). int8 becomes f32 by a byte permute into
// 2^23's mantissa and one add. The warps merge in shared memory in a fixed
// order; each split
// writes its (m, l, acc) to an f32 scratch and takes a ticket (a fence,
// then atomicAdd on a per-(b, hk, group) counter): the group's last CTA
// merges the partials in split order (so the output repeats bit for bit),
// folds in new_kv and sets the counter back to 0.
//
// SIMT body (`decode_kernel`, f32 or bf16 q, D = 128 to 1024 in steps of
// 128, groups of up to 8 heads, 4 past D = 512; the plan gives it rep 8 at
// D = 128, D = 384 to 1024 and S % 16 != 0): one block of 8 warps per
// (kv head, batch row, group); the heads of the group share each K/V read. The block walks only positions < len
// (from the window's first position, where one binds), 1024 at a time.
// Scores: K is stored (D, S), so a thread takes 4 consecutive positions and
// reads one 4-byte word per d, a warp 128 contiguous bytes of each K row.
// Softmax reductions run across the block. P.V: a warp takes every 8th
// position and each lane 4 consecutive d of the V row (one 4-byte word, a
// warp the whole 128-byte row); the 8 warps' partial sums meet in shared
// memory and add in a fixed order at the end.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCH = 4 * kThreads;  // positions per chunk

__device__ __forceinline__ void unpack4(uint32_t w, float (&v)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = (float)(int8_t)((w >> (8 * e)) & 0xffu);
}

// the q head of place r of group g (rep heads per kv head, groups of kG):
// a place past the last head repeats it
template <int kG>
__device__ __forceinline__ int group_head(int g, int r, int rep) {
  return min(g * kG + r, rep - 1);
}

// kRep: the heads of a group; kDW = D / 128: the 4-byte words of a V row
// that each lane reads.
template <int kRep, int kDW>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q, int q_bf16, const int8_t* __restrict__ kc,
              const float* __restrict__ ks, const int8_t* __restrict__ vc,
              const float* __restrict__ vs, const int* __restrict__ lens,
              const float* __restrict__ alibi, const int8_t* __restrict__ kn,
              const float* __restrict__ ksn, const int8_t* __restrict__ vn,
              const float* __restrict__ vsn, void* out, int li, int B, int Hkv, int rep, int S,
              int window, float scale, float softcap) {
  constexpr int D = 128 * kDW;
  constexpr int kScratch = kCH > kWarps * D ? kCH : kWarps * D;
  extern __shared__ float smem[];
  float* qs = smem;                      // [kRep][D]
  float* sc = qs + kRep * D;             // [kRep][kCH]; at the end [warps][kRep][D]
  float* red = sc + kRep * kScratch;     // [32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
  const int nr = min(kRep, rep - grp * kRep);  // this group's own heads
  const size_t hbase = ((size_t)b * Hkv + hk) * rep;  // the kv head's first q head
  for (int i = tid; i < kRep * D; i += kThreads)
    qs[i] = ld_f(q, (hbase + group_head<kRep>(grp, i / D, rep)) * D + i % D, q_bf16);

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

  float m[kRep], l[kRep], acc[kRep][kDW][4], slope[kRep];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    slope[r] = alibi != nullptr ? alibi[(size_t)hk * rep + group_head<kRep>(grp, r, rep)] : 0.0f;
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
          if (alibi != nullptr) s = s + slope[r] * (float)(pos - qpos);
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
    if (r >= nr) break;
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
      st_f(out, (hbase + grp * kRep + r) * D + d, o, q_bf16);
    }
  }
}

template <int kRep, int kDW>
int launch(dim3 grid, cudaStream_t st, const void* q, int q_bf16, const int8_t* kc,
           const float* ks, const int8_t* vc, const float* vs, const int* lens,
           const float* alibi, const int8_t* kn, const float* ksn, const int8_t* vn,
           const float* vsn, void* out, int li, int B, int Hkv, int rep, int S, int window,
           float scale, float softcap) {
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
                                        out, li, B, Hkv, rep, S, window, scale, softcap);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// split body
// ---------------------------------------------------------------------------
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kTile = 128;   // positions per tile (16 per warp)
constexpr int kStages = 3;   // ring slots (2 to 5 measured alike on the H100 at D = 128)
// K, V, k scales, v scales of one tile at head dim D
__host__ __device__ constexpr int split_stage_bytes(int D) { return 2 * D * kTile + 8 * kTile; }
// alignment slack, the ring
__host__ __device__ constexpr int split_smem_bytes(int D) { return 1024 + kStages * split_stage_bytes(D); }

// v[0..15]: this lane's partial dots of 16 positions. Sums them over the
// warp so that lane l ends with position l & 15 (a fixed order: bit for
// bit the same in every launch).
__device__ __forceinline__ float transpose_sum16(float (&v)[16], int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool up = lane & 8;
    const float send = up ? v[k] : v[k + 8];
    v[k] = (up ? v[k + 8] : v[k]) + __shfl_xor_sync(BNB_FULL_MASK, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool up = lane & 4;
    const float send = up ? v[k] : v[k + 4];
    v[k] = (up ? v[k + 4] : v[k]) + __shfl_xor_sync(BNB_FULL_MASK, send, 4);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool up = lane & 2;
    const float send = up ? v[k] : v[k + 2];
    v[k] = (up ? v[k + 2] : v[k]) + __shfl_xor_sync(BNB_FULL_MASK, send, 2);
  }
  {
    const bool up = lane & 1;
    const float send = up ? v[0] : v[1];
    v[0] = (up ? v[1] : v[0]) + __shfl_xor_sync(BNB_FULL_MASK, send, 1);
  }
  return v[0] + __shfl_xor_sync(BNB_FULL_MASK, v[0], 16);
}

constexpr int kMaxCluster = 8;  // CTAs of a cluster at most (D = 1024)

// kRep: the heads of a group; kDW: the CTA's dims / 128 (1 or 2); kCl: a
// cluster of nc CTAs (a run-time count, one instance for every D past
// 256), each holding kDW x 128 of the head's nc kDW x 128 dims; without
// it nc is 1
template <int kRep, int kDW, bool kCl>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const void* __restrict__ q,
                    int q_bf16, const float* __restrict__ ks, const int8_t* __restrict__ vc,
                    const float* __restrict__ vs, const int* __restrict__ lens,
                    const float* __restrict__ alibi, const int8_t* __restrict__ kn,
                    const float* __restrict__ ksn, const int8_t* __restrict__ vn,
                    const float* __restrict__ vsn, void* out, float* __restrict__ part,
                    int* __restrict__ tickets, int li, int B, int Hkv, int rep, int S,
                    int nsplit, int nc, int window, float scale, float softcap) {
  constexpr int D = 128 * kDW, kW = kSplitWarps;
  const int DT = D * nc;  // this CTA's dims, the head's
  constexpr int kStageBytes = split_stage_bytes(D);
  // P.V: a V row is 8 kDW 16-byte pieces, read by as many lanes; the warp's
  // kG token groups each take every kG-th of its 16 positions
  constexpr int kLanesRow = 8 * kDW, kG = 32 / kLanesRow;
  constexpr int kElems = kRep * D, kPer = (kElems + kSplitThreads - 1) / kSplitThreads;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int s_last;
  // kCl: the cluster's CTAs' shares of each tile's scores (two slots, by
  // tile parity) and of the new token's
  __shared__ float share[kCl ? 2 * kW * kRep * 16 : 1], share_new[kRep];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / kLanesRow, c = lane % kLanesRow;  // P.V: token group, 16-byte piece
  const int ds = kCl ? (int)cluster_rank() : 0;     // this CTA's dims: D ds .. D ds + D - 1
  const int hk = blockIdx.x / nc, b = blockIdx.y, z = blockIdx.z % nsplit, grp = blockIdx.z / nsplit;
  const int nr = min(kRep, rep - grp * kRep);         // this group's own heads
  const size_t kvp = (size_t)b * Hkv + hk;            // the new token's row
  const size_t hbase = kvp * rep;                     // the kv head's first q head
  // tickets and partials: per group (and per CTA of a cluster)
  const size_t pair = (kvp * (gridDim.z / nsplit) + grp) * nc + ds;
  const size_t slab = ((size_t)li * B + b) * Hkv + hk;
  const int len = lens[b];
  const bool has_new = kn != nullptr;
  const int qpos = has_new ? len : len - 1;
  const int end = min(max(len, 0), S);
  const int lo = window > 0 ? max(0, qpos + 1 - window) : 0;
  // this split's share of the tiles of the used span [lo, end)
  const int t_lo = min(lo, end) / kTile, nt = (end + kTile - 1) / kTile - t_lo;
  const int i0 = t_lo + z * nt / nsplit, ntiles = t_lo + (z + 1) * nt / nsplit - i0;
  const float inv_cap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  const float inv127 = 1.0f / 127.0f;

  // one thread: tile i of this split into slot i % kStages (V and the
  // scales of a tile past S only as far as S; K's box reads zeros there,
  // and so does V's in a cluster, where this CTA's dims of a V row are a
  // box column of the (rows, DT) V cache)
  auto load = [&](int i) {
    const int s0 = (i0 + i) * kTile, nv = min(kTile, S - s0);
    uint8_t* dst = smem + (i % kStages) * kStageBytes;
    uint64_t* bar = &full[i % kStages];
    mbar_expect_tx(bar, (uint32_t)(D * kTile + (kCl ? kTile : nv) * D + 8 * nv));
    tma_load_2d(dst, &kmap, bar, s0, (int)(slab * DT) + D * ds);
    if (kCl)
      tma_load_2d(dst + D * kTile, &vmap, bar, D * ds, (int)(slab * S) + s0);
    else
      bulk_load(dst + D * kTile, vc + (slab * S + s0) * D, (uint32_t)(nv * D), bar);
    bulk_load(dst + 2 * D * kTile, ks + slab * S + s0, (uint32_t)(4 * nv), bar);
    bulk_load(dst + 2 * D * kTile + 4 * kTile, vs + slab * S + s0, (uint32_t)(4 * nv), bar);
  };
  if (ntiles > 0) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
      mbar_init_fence();
      for (int i = 0; i < kStages && i < ntiles; ++i) load(i);
    }
    __syncthreads();  // the barriers are initialised before anyone waits on them
  }

  // q at this lane's dims 32 j + lane of each rep head
  float qr[kRep][4 * kDW];
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int j = 0; j < 4 * kDW; ++j)
      qr[r][j] = ld_f(q, (hbase + group_head<kRep>(grp, r, rep)) * DT + D * ds + 32 * j + lane,
                      q_bf16);
  // the new token's score for each rep head, in every lane (only the CTA
  // that finishes the row uses it), and this thread's new V values
  float sn[kRep], vnf[kPer];
  float vsn_s = 0.0f;
  if (has_new) {
    float kf[4 * kDW];
#pragma unroll
    for (int j = 0; j < 4 * kDW; ++j) kf[j] = (float)kn[kvp * DT + D * ds + 32 * j + lane];
    const float ks_new = ksn[kvp] * scale;
    float dn[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < 4 * kDW; ++j) v = fmaf(qr[r][j], kf[j], v);
      dn[r] = warp_sum(v);
    }
    if constexpr (kCl) {  // the cluster's shares, added in rank order
      if (tid == 0) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) share_new[r] = dn[r];
      }
      cluster_sync();
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        float t = 0.0f;
#pragma unroll
        for (int cc = 0; cc < nc; ++cc) t += ld_peer_f(peer_addr(&share_new[r], (uint32_t)cc));
        dn[r] = t;
      }
    }
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float v = dn[r] * ks_new;
      if (softcap > 0.0f) v = softcap * tanhf(v * inv_cap);
      sn[r] = v;
    }
    vsn_s = vsn[kvp] * inv127;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kSplitThreads;
      vnf[k] = e < kElems ? (float)vn[kvp * DT + D * ds + e % D] : 0.0f;
    }
  }
  float m[kRep], l[kRep], acc[kRep][16], slope[kRep];
#pragma unroll
  for (int r = 0; r < kRep; ++r) {
    slope[r] = alibi != nullptr ? alibi[(size_t)hk * rep + group_head<kRep>(grp, r, rep)] : 0.0f;
    m[r] = -1e30f;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.0f;
  }

  const int tq = warp * 16 + (lane & 15);  // the tile position whose score this lane keeps
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
    const uint8_t* Kt = smem + (i % kStages) * kStageBytes;  // [D][kTile], 128-byte swizzle
    const uint8_t* Vt = Kt + D * kTile;                       // [kTile][D]
    const float* KS = reinterpret_cast<const float*>(Vt + kTile * D);
    const float* VS = KS + kTile;
    const int s0 = (i0 + i) * kTile;
    float sc[kRep];
#ifndef BNB_PROBE_NO_MATH  // chip_smoke.py --probe: scores and P.V switched off
    {
      float v[kRep][16];
#pragma unroll
      for (int r = 0; r < kRep; ++r)
#pragma unroll
        for (int e = 0; e < 16; ++e) v[r][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4 * kDW; ++j) {
        const int d = 32 * j + lane;
        float kf[16];
        i8x16_to_f32(*reinterpret_cast<const uint4*>(Kt + d * kTile + ((warp ^ (d & 7)) << 4)), kf);
#pragma unroll
        for (int r = 0; r < kRep; ++r)
#pragma unroll
          for (int e = 0; e < 16; ++e) v[r][e] = fmaf(qr[r][j], kf[e], v[r][e]);
      }
#pragma unroll
      for (int r = 0; r < kRep; ++r) sc[r] = transpose_sum16(v[r], lane);
    }
#else
#pragma unroll
    for (int r = 0; r < kRep; ++r) sc[r] = qr[r][0];
#endif
    if constexpr (kCl) {
      // each CTA's share of the scores, added in rank order: the same
      // scores, so the same softmax, in every CTA of the cluster. A slot is
      // written again two tiles on, after every CTA passed the next
      // tile's barrier, which follows its reads of this one.
      float* sh = share + (i & 1) * (kW * kRep * 16) + warp * kRep * 16 + (lane & 15);
      if (lane < 16) {
#pragma unroll
        for (int r = 0; r < kRep; ++r) sh[16 * r] = sc[r];
      }
      cluster_sync();
      float v[kRep][kMaxCluster];  // every load issued before the first add
#pragma unroll
      for (int r = 0; r < kRep; ++r)
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc)
          if (cc < nc) v[r][cc] = ld_peer_f(peer_addr(sh + 16 * r, (uint32_t)cc));
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        float t = 0.0f;
#pragma unroll
        for (int cc = 0; cc < kMaxCluster; ++cc)
          if (cc < nc) t += v[r][cc];
        sc[r] = t;
      }
    }
    const int pos = s0 + tq;
    const bool ok = pos >= lo && pos < end;
    const float kscale = KS[tq] * scale;  // stale past S: masked below
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float s = sc[r] * kscale;
      if (alibi != nullptr) s = s + slope[r] * (float)(pos - qpos);
      if (softcap > 0.0f) s = softcap * tanhf(s * inv_cap);
      sc[r] = ok ? s : -1e30f;
    }
    // the warp's online softmax step over its 16 positions (lanes 16-31
    // repeat lanes 0-15), masked positions at weight 0
    const float vsc = VS[tq] * inv127;
    float pw[kRep];
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      float mx = sc[r];
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(BNB_FULL_MASK, mx, 8));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float w = ok ? expf(sc[r] - m_new) : 0.0f;
      float sum = w;
      sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 1);
      sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 2);
      sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 4);
      sum += __shfl_xor_sync(BNB_FULL_MASK, sum, 8);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
      pw[r] = ok ? w * vsc : 0.0f;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[r][e] *= alpha;
    }
#ifndef BNB_PROBE_NO_MATH
#pragma unroll
    for (int it = 0; it < 16 / kG; ++it) {
      const int src = kG * it + g;  // the lane that holds position src's weight
      float vf[16];
      i8x16_to_f32(*reinterpret_cast<const uint4*>(Vt + (warp * 16 + src) * D + c * 16), vf);
#pragma unroll
      for (int r = 0; r < kRep; ++r) {
        const float p = __shfl_sync(BNB_FULL_MASK, pw[r], src);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
#else
#pragma unroll
    for (int r = 0; r < kRep; ++r) acc[r][0] += pw[r];
#endif
    __syncthreads();  // every warp is done with slot i % kStages
    if (tid == 0 && i + kStages < ntiles) load(i + kStages);
  }
  if constexpr (kCl) cluster_sync();  // no CTA leaves while another reads its shares

  // the warp's token groups, then the warps in order; the ring is free
  float* red_m = reinterpret_cast<float*>(smem);  // [kW][kRep]
  float* red_l = red_m + kW * kRep;               // [kW][kRep]
  float* red_acc = red_l + kW * kRep;             // [kW][kRep][D]
#pragma unroll
  for (int r = 0; r < kRep; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      float v = acc[r][e];
#pragma unroll
      for (int x = kLanesRow; x < 32; x *= 2) v += __shfl_xor_sync(BNB_FULL_MASK, v, x);
      if (g == 0) red_acc[(warp * kRep + r) * D + c * 16 + e] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRep; ++r) {
      red_m[warp * kRep + r] = m[r];
      red_l[warp * kRep + r] = l[r];
    }
  }
  __syncthreads();
  // this CTA's (M, L, A) of element e = r * D + d
  float Mv[kPer], Lv[kPer], Av[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
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
    // [kv heads x rows x groups][nsplit][kRep][2], then [..][kRep][D]
    float* part_ml = part;
    float* part_acc = part + (size_t)gridDim.x * gridDim.y * gridDim.z * kRep * 2;
    const size_t slot = pair * nsplit + z;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
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
    for (int k = 0; k < kPer; ++k) {
      const int e = tid + k * kSplitThreads;
      if (e >= kElems) break;
      const int r = e / D;
      float M = -1e30f;
#pragma unroll 4
      for (int s2 = 0; s2 < nsplit; ++s2)
        M = fmaxf(M, __ldcg(part_ml + ((pair * nsplit + s2) * kRep + r) * 2));
      float Ls = 0.0f, As = 0.0f;
#pragma unroll 4
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
  for (int k = 0; k < kPer; ++k) {
    const int e = tid + k * kSplitThreads;
    if (e >= kElems) break;
    const int r = e / D;
    if (r >= nr) break;
    float o;
    if (has_new) {
      float snr = sn[0];
#pragma unroll
      for (int rr = 1; rr < kRep; ++rr) snr = r == rr ? sn[rr] : snr;
      const float m2 = fmaxf(Mv[k], snr);
      const float alpha = expf(Mv[k] - m2);
      const float w_new = expf(snr - m2);
      const float inv = 1.0f / (Lv[k] * alpha + w_new);
      o = Av[k] * alpha * inv + (w_new * inv * vsn_s) * vnf[k];
    } else {
      o = Av[k] * (len > 0 ? 1.0f / Lv[k] : 0.0f);
    }
    st_f(out, (hbase + grp * kRep + r) * DT + D * ds + e % D, o, q_bf16);
  }
}

template <int kRep, int kDW, bool kCl>
int launch_split(dim3 grid, cudaStream_t st, const CUtensorMap& kmap, const CUtensorMap& vmap,
                 const void* q, int q_bf16, const float* ks, const int8_t* vc, const float* vs,
                 const int* lens, const float* alibi, const int8_t* kn, const float* ksn,
                 const int8_t* vn, const float* vsn, void* out, float* part, int* tickets, int li,
                 int B, int Hkv, int rep, int S, int nsplit, int nc, int window, float scale,
                 float softcap) {
  auto kernel = decode_split_kernel<kRep, kDW, kCl>;
  constexpr int kSmem = split_smem_bytes(128 * kDW);
  const cudaError_t e = allow_smem_once<decode_split_kernel<kRep, kDW, kCl>>(kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x * nc, grid.y, grid.z);
  cfg.blockDim = dim3(kSplitThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCl ? 1 : 0;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, kmap, vmap, q, q_bf16, ks, vc, vs, lens,
                                            alibi, kn, ksn, vn, vsn, out, part, tickets, li, B,
                                            Hkv, rep, S, nsplit, nc, window, scale, softcap);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // namespace

// The heads of a group: rep itself for 1, 2 and 4 (and 8 in the SIMT
// body), else the next of those up to the body's largest
// (`ops/attention.decode_groups`).
static int group_size(int rep, int largest) {
  int g = 1;
  while (g < rep && g < largest) g *= 2;
  return g;
}

// q and out (B, Hkv, rep, D) f32/bf16; kc (L, B, Hkv, D, S) int8; vc (L, B,
// Hkv, S, D) int8; ks, vs (L, B, Hkv, S) f32; lens (B) int32; alibi (Hkv *
// rep) f32 or null; kn, vn (B, Hkv, D) int8 and ksn, vsn (B, Hkv) f32, all
// four null or all four given. rep >= 1, D a multiple of 128 up to 1024, S %
// 4 == 0. window <= 0: none; softcap <= 0: none. Past D = 512 a group holds
// at most 4 heads: the shared memory of 8 (their q rows and the warps'
// partial sums, 8 D floats per head) passes 227 KB from D = 896.
extern "C" int decode_attn_int8(const void* q, const void* kc, const void* ks, const void* vc,
                                const void* vs, const void* lens, const void* alibi,
                                const void* kn, const void* ksn, const void* vn, const void* vsn,
                                void* out, int li, int L, int B, int Hkv, int rep, int D, int S,
                                int window, int has_new, int q_bf16, float scale, float softcap,
                                void* stream) {
  if (li < 0 || li >= L || rep < 1 || D < 128 || D > 1024 || D % 128 || S <= 0 || S % 4) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int kg = group_size(rep, D > 512 ? 4 : 8);
  dim3 grid(Hkv, B, (rep + kg - 1) / kg);
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
                      li, B, Hkv, rep, S, window, scale, softcap)
#define BNB_DECODE_WIDTHS(R)                \
  switch (D / 128) {                        \
    case 1: BNB_DECODE_LAUNCH(R, 1);        \
    case 2: BNB_DECODE_LAUNCH(R, 2);        \
    case 3: BNB_DECODE_LAUNCH(R, 3);        \
    default: BNB_DECODE_LAUNCH(R, 4);       \
  }
#define BNB_DECODE_WIDE(R)                  \
  switch (D / 128) {                        \
    case 5: BNB_DECODE_LAUNCH(R, 5);        \
    case 6: BNB_DECODE_LAUNCH(R, 6);        \
    case 7: BNB_DECODE_LAUNCH(R, 7);        \
    default: BNB_DECODE_LAUNCH(R, 8);       \
  }
  if (D > 512) {
    switch (kg) {
      case 1: BNB_DECODE_WIDE(1);
      case 2: BNB_DECODE_WIDE(2);
      default: BNB_DECODE_WIDE(4);
    }
  }
  switch (kg) {
    case 1: BNB_DECODE_WIDTHS(1);
    case 2: BNB_DECODE_WIDTHS(2);
    case 4: BNB_DECODE_WIDTHS(4);
    default: BNB_DECODE_WIDTHS(8);
  }
#undef BNB_DECODE_WIDE
#undef BNB_DECODE_WIDTHS
#undef BNB_DECODE_LAUNCH
}

// The split body. Arguments as decode_attn_int8's, plus: part, an f32
// scratch of B * Hkv * groups * nsplit * kG * (D + 2 n) floats, kG the
// group size (1, 2 or 4), groups = ceil(rep / kG) and n the CTAs of a
// cluster (D / 128 past D = 256, else 1; unused when nsplit == 1);
// tickets, B * Hkv * groups * n int32 counters, all 0 (left at 0); nsplit
// >= 1 splits, at most the cache's ceil(S / 128) tiles, split z of a row
// taking the tiles [t + z m / nsplit, t + (z + 1) m / nsplit) of the m
// tiles from tile t = min(lo, len) / 128 to the one holding position len -
// 1. D a multiple of 128 up to 1024 (past 256 a cluster of D / 128 CTAs,
// each holding 128 dims), rep >= 1, S % 16 == 0 (the TMA row stride), the
// caches 16-byte aligned.
extern "C" int decode_attn_int8_split(const void* q, const void* kc, const void* ks, const void* vc,
                                      const void* vs, const void* lens, const void* alibi,
                                      const void* kn, const void* ksn, const void* vn,
                                      const void* vsn, void* out, void* part, void* tickets, int li,
                                      int L, int B, int Hkv, int rep, int D, int S, int nsplit,
                                      int window, int has_new, int q_bf16, float scale,
                                      float softcap, void* stream) {
  if (li < 0 || li >= L || rep < 1 || D < 128 || D > 1024 || D % 128 || S <= 0 || S % 16 ||
      nsplit < 1 || nsplit > (S + kTile - 1) / kTile ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // the K cache as rows of S positions: (L B Hkv D) rows, boxes of the
  // CTA's dims x 128 positions; past D = 256 also the V cache as rows of D
  // bytes, boxes of 128 positions x 128 dims
  const int cta_d = D <= 256 ? D : 128;
  CUtensorMap kmap, vmap;
  int err = make_tmap_2d_swizzled(&kmap, kc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                                  (uint64_t)L * B * Hkv * D, S, S, cta_d, kTile,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  vmap = kmap;
  if (D > 256) {
    err = make_tmap_2d(&vmap, vc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (uint64_t)L * B * Hkv * S, D, D,
                       kTile, 128, false);
    if (err != 0) return err;
  }
  const int kg = group_size(rep, 4);
  dim3 grid(Hkv, B, ((rep + kg - 1) / kg) * nsplit);
  auto* ksf = reinterpret_cast<const float*>(ks);
  auto* v8 = reinterpret_cast<const int8_t*>(vc);
  auto* vsf = reinterpret_cast<const float*>(vs);
  auto* ln = reinterpret_cast<const int*>(lens);
  auto* al = reinterpret_cast<const float*>(alibi);
  auto* kn8 = has_new ? reinterpret_cast<const int8_t*>(kn) : nullptr;
  auto* ksnf = reinterpret_cast<const float*>(ksn);
  auto* vn8 = reinterpret_cast<const int8_t*>(vn);
  auto* vsnf = reinterpret_cast<const float*>(vsn);
  auto* pf = reinterpret_cast<float*>(part);
  auto* tk = reinterpret_cast<int*>(tickets);
#define BNB_SPLIT_LAUNCH(R, W, CL, NC)                                                            \
  return launch_split<R, W, CL>(grid, st, kmap, vmap, q, q_bf16, ksf, v8, vsf, ln, al, kn8, ksnf, \
                                vn8, vsnf, out, pf, tk, li, B, Hkv, rep, S, nsplit, NC, window,   \
                                scale, softcap)
#define BNB_SPLIT_GROUPS(W, CL, NC)              \
  if (kg == 1) BNB_SPLIT_LAUNCH(1, W, CL, NC);   \
  if (kg == 2) BNB_SPLIT_LAUNCH(2, W, CL, NC);   \
  BNB_SPLIT_LAUNCH(4, W, CL, NC)
  if (D == 128) {
    BNB_SPLIT_GROUPS(1, false, 1);
  }
  if (D == 256) {
    BNB_SPLIT_GROUPS(2, false, 1);
  }
  BNB_SPLIT_GROUPS(1, true, D / 128);
#undef BNB_SPLIT_GROUPS
#undef BNB_SPLIT_LAUNCH
}
