// Kernel A: W4A8 matmul, 4-bit weights times int8 activations.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_w4a8.py `_w4a8_kernel` (called
// through `_w4a8_call`), together with the XLA-side activation quantization
// and row-scale epilogue that `_w4a8_call` wraps around it.
//
// Computes out[m, n] = (sum over planes and quant blocks of
// (sum_{k in block} xq[m, k] * wq[k, n]) * absmax[plane, blk, n] / 127)
// * row_absmax[m] / 127 (+ bias), with xq = clip(rint(x * 127 / row_absmax))
// and wq = round(code * 127) the int8 table. Each block sum is an exact int32.
//
// Bound on the H100: memory. At decode (M <= 128 rows, usually 4) each weight
// byte is used for 2*M multiply-adds, far below the card's ridge point, so
// the floor is the weight bytes (K/2 * N) plus the scales over 3.35 TB/s.
//
// Two bodies; the wrapper picks one (`ops/matmul_w4a8.gemv_plan`).
//
// Fused body (`w4a8_fused_kernel`: decode rows, M <= 8, blocksize 32 or
// 64): one launch per call. The grid is (column tile of 128, K split). A
// CTA of 8 warps first asks for its first 8 stages of weights (64 packed
// rows x 128 columns, 8 KB each, by TMA into an 8-slot ring on mbarriers,
// one slot per warp), then, while they stream in, reads every row of x
// for its absmax and quantizes its own K slice into shared memory, bit
// for bit as `quant_rows_kernel` (common.cuh) does. Each warp takes every
// 8th stage; a lane owns one plane (hi: x[:, :K/2], lo: x[:, K/2:]) of 8
// columns and all 64 rows, reads 8 bytes of 4 rows at a time, and decodes
// the nibbles in registers: the 16-entry int8 table sits in four words,
// and per 4 codes two byte permutes on the low three bits plus a third on
// bit 3 give a word of 4 int8 weights of one column, which __dp4a takes
// with 4 consecutive int8 x of a row. The int32 sums stay exact per
// quantization block, then take the block scale in f32. A warp refills its
// slot as soon as it has read it. The warps' and planes' sums meet in
// shared memory in a fixed order; with a K split, each split writes its
// f32 partial and takes a ticket (a fence, then atomicAdd on a per-column-
// tile counter): the last CTA sums the partials in split order, applies
// row_absmax / 127 and the bias, and sets the counter back to 0. So the
// result repeats bit for bit, and no other kernel runs.
//
// SIMT body (`w4a8_kernel`, the rows and blocksizes the fused body does not
// take, up to 128 rows): a thread owns 4 neighbouring output columns, so a
// warp reads 128 contiguous bytes of each packed row. One shared 256-entry
// table turns a packed byte into both of its int8 codes at once; byte
// permutes gather 4 consecutive rows' codes of a column into one word, and
// __dp4a does 4 multiply-adds per instruction. Each warp of a block takes
// its own quantization blocks (its int32 sums never cross a block); the
// warps' f32 sums meet in shared memory in a fixed order, and the K splits
// of the grid are summed in order by a second small kernel, so the result
// does not depend on scheduling. Rows go in tiles of 4 (grid z); the
// activations are quantized by `quant_rows_kernel` first: three launches.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMT = 4;       // activation rows per tile
constexpr int kCols = 128;   // output columns per block (32 lanes x 4)

struct Table16 {
  int8_t v[16];
};

__global__ void __launch_bounds__(32 * kWarps)
w4a8_kernel(const int8_t* __restrict__ xq, const uint32_t* __restrict__ packed,
            const void* __restrict__ scales, int s_bf16, float* __restrict__ part,
            int M, int N, int K, int bs, int G, Table16 tbl) {
  __shared__ uint32_t lut[256];
  __shared__ float red[kWarps][kMT][kCols];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    lut[i] = (uint32_t)(uint8_t)tbl.v[i >> 4] | ((uint32_t)(uint8_t)tbl.v[i & 15] << 8);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = blockIdx.y, m0 = blockIdx.z * kMT;
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const int col4 = blockIdx.x * (kCols / 4) + lane;  // this thread's uint32 column
  const float inv127 = 1.0f / 127.0f;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int i = 0; i < G; ++i) {
    const int qb = (kc * G + i) * kWarps + warp;
    if (qb >= nbh) break;
    int ihi[kMT][4], ilo[kMT][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) ihi[m][c] = ilo[m][c] = 0;

#pragma unroll 4
    for (int r = 0; r < bs; r += 4) {
      const int j = qb * bs + r;
      const uint32_t w0 = __ldg(packed + (size_t)(j + 0) * N4 + col4);
      const uint32_t w1 = __ldg(packed + (size_t)(j + 1) * N4 + col4);
      const uint32_t w2 = __ldg(packed + (size_t)(j + 2) * N4 + col4);
      const uint32_t w3 = __ldg(packed + (size_t)(j + 3) * N4 + col4);
      int xh[kMT], xl[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const bool ok = m0 + m < M;
        const int8_t* xr = xq + (size_t)(ok ? m0 + m : 0) * K;
        xh[m] = ok ? __ldg(reinterpret_cast<const int*>(xr + j)) : 0;
        xl[m] = ok ? __ldg(reinterpret_cast<const int*>(xr + half + j)) : 0;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t L0 = lut[(w0 >> (8 * c)) & 0xFF];
        const uint32_t L1 = lut[(w1 >> (8 * c)) & 0xFF];
        const uint32_t L2 = lut[(w2 >> (8 * c)) & 0xFF];
        const uint32_t L3 = lut[(w3 >> (8 * c)) & 0xFF];
        const uint32_t p01 = __byte_perm(L0, L1, 0x5140);  // hi0 hi1 lo0 lo1
        const uint32_t p23 = __byte_perm(L2, L3, 0x5140);  // hi2 hi3 lo2 lo3
        const int hi4 = (int)__byte_perm(p01, p23, 0x5410);
        const int lo4 = (int)__byte_perm(p01, p23, 0x7632);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          ihi[m][c] = __dp4a(hi4, xh[m], ihi[m][c]);
          ilo[m][c] = __dp4a(lo4, xl[m], ilo[m][c]);
        }
      }
    }
    float sh[4], sl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t n = (size_t)col4 * 4 + c;
      sh[c] = ld_f(scales, (size_t)qb * N + n, s_bf16) * inv127;
      sl[c] = ld_f(scales, ((size_t)nbh + qb) * N + n, s_bf16) * inv127;
    }
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[m][c] += (float)ihi[m][c] * sh[c];
        acc[m][c] += (float)ilo[m][c] * sl[c];
      }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMT * kCols; idx += blockDim.x) {
    const int m = idx / kCols, col = idx % kCols;
    if (m0 + m >= M) continue;
    float s = red[0][m][col];
    for (int w = 1; w < kWarps; ++w) s += red[w][m][col];
    part[((size_t)kc * M + m0 + m) * N + (size_t)blockIdx.x * kCols + col] = s;
  }
}

// ---------------------------------------------------------------------------
// fused body
// ---------------------------------------------------------------------------
constexpr int kFWarps = 8;  // each warp owns one ring slot
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFRows = 64;                   // packed rows per stage
constexpr int kFCols = 128;                  // output columns per CTA
constexpr int kFSlots = 8;                   // ring slots, one per warp
constexpr int kFStage = kFRows * kFCols;     // bytes per stage
constexpr int kFC = 8;                       // columns per lane
constexpr int kFMaxX = 32768;                // bytes of quantized x a CTA keeps

__host__ __device__ constexpr size_t fused_smem_bytes(int kM, int per) {
  return 1024 + (size_t)kFSlots * kFStage + (size_t)kM * 2 * per * kFRows;
}

// Four int8 weights of one column from the selector word's low 16 bits
// (four 4-bit codes, rows k..k+3): codes 0-7 from t0:t1, 8-15 from t2:t3,
// then bit 3 of each code picks between the two.
struct Dec2 {
  uint32_t a, b;  // the columns in the selector's low and high halves
};
__device__ __forceinline__ Dec2 decode2(uint32_t sel, uint4 t) {
  const uint32_t idx = sel & 0x77777777u;
  const uint32_t pick = ((sel >> 1) & 0x44444444u) | 0x32103210u;
  Dec2 d;
  d.a = __byte_perm(__byte_perm(t.x, t.y, idx), __byte_perm(t.z, t.w, idx), pick);
  const uint32_t idx_b = idx >> 16, pick_b = pick >> 16;
  d.b = __byte_perm(__byte_perm(t.x, t.y, idx_b), __byte_perm(t.z, t.w, idx_b), pick_b);
  return d;
}

template <int kM>
__global__ void __launch_bounds__(kFThreads)
w4a8_fused_kernel(const __grid_constant__ CUtensorMap wmap, const void* __restrict__ x, int x_bf16,
                  const void* __restrict__ scales, int s_bf16, const float* __restrict__ bias,
                  void* out, int out_bf16, float* __restrict__ part, int* __restrict__ tickets,
                  int M, int N, int K, int bs, int per, uint4 tbl) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + kFSlots * kFStage);  // [kM][2][per * kFRows]
  __shared__ __align__(8) uint64_t full[kFSlots];
  __shared__ float s_amax[kFWarps][kM];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = blockIdx.x, z = blockIdx.y, ksplit = gridDim.y;
  const int half = K / 2, nbh = half / bs;
  const int steps = half / kFRows;
  const int st0 = z * per, nst = min(per, steps - st0);  // this split's stages
  const int j0 = st0 * kFRows, pitch = per * kFRows;

  // one thread: stage i of this split into slot i % kFSlots
  auto load = [&](int i) {
    uint64_t* bar = &full[i % kFSlots];
    mbar_expect_tx(bar, (uint32_t)kFStage);
    tma_load_2d(smem + (i % kFSlots) * kFStage, &wmap, bar, ct * kFCols, j0 + i * kFRows);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kFSlots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < kFSlots && i < nst; ++i) load(i);
  }

  // every row's absmax over all of K (16-byte loads, all rows at once), while
  // the weights stream in
  float amax[kM];
#pragma unroll
  for (int m = 0; m < kM; ++m) amax[m] = 0.0f;
  const int per16 = x_bf16 ? 8 : 4;  // elements per 16 bytes
#ifdef BNB_PROBE_NO_PROLOGUE  // chip_smoke.py --probe: the row absmax switched off
  const int n16 = 0;
#else
  const int n16 = K / per16;
#endif
  constexpr int kXU = kM >= 8 ? 2 : 4;  // 16-byte loads in flight: kXU * kM a thread
#pragma unroll kXU
  for (int k = tid; k < n16; k += kFThreads) {
    uint4 v[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m)
      v[m] = m < M ? __ldg(reinterpret_cast<const uint4*>(x) + (size_t)m * n16 + k) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const uint32_t w[4] = {v[m].x, v[m].y, v[m].z, v[m].w};
      float a = amax[m];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (x_bf16) {
          a = fmaxf(a, fabsf(__uint_as_float(w[e] << 16)));
          a = fmaxf(a, fabsf(__uint_as_float(w[e] & 0xFFFF0000u)));
        } else {
          a = fmaxf(a, fabsf(__uint_as_float(w[e])));
        }
      }
      amax[m] = a;
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) amax[m] = warp_max(amax[m]);
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) s_amax[warp][m] = amax[m];
  }
  __syncthreads();  // also: the barriers are initialised before anyone waits on them
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    float a = s_amax[0][m];
#pragma unroll
    for (int w = 1; w < kFWarps; ++w) a = fmaxf(a, s_amax[w][m]);
    amax[m] = a;
  }
  // this split's K slice of x as int8, both planes, 4 values a thread at a
  // time: xq = clip(rint(x * (127 * (1 / amax))), +-127), as quant_rows_kernel
  {
#ifdef BNB_PROBE_NO_PROLOGUE  // and the quantization of the K slice
    const int n4 = 0;
#else
    const int n4 = nst * kFRows / 4;
#endif
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float f = 127.0f * (amax[m] > 0.0f ? 1.0f / amax[m] : 0.0f);
      for (int idx = tid; idx < 2 * n4; idx += kFThreads) {
        const int p = idx >= n4, k4 = (idx - p * n4) * 4;
        uint32_t word = 0;
        if (m < M) {
          const size_t base = (size_t)m * K + (size_t)p * half + j0 + k4;
          float xv[4];
          if (x_bf16) {
            const uint2 u = __ldg(reinterpret_cast<const uint2*>(reinterpret_cast<const __nv_bfloat16*>(x) + base));
            xv[0] = __uint_as_float(u.x << 16);
            xv[1] = __uint_as_float(u.x & 0xFFFF0000u);
            xv[2] = __uint_as_float(u.y << 16);
            xv[3] = __uint_as_float(u.y & 0xFFFF0000u);
          } else {
            const float4 u = __ldg(reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + base));
            xv[0] = u.x;
            xv[1] = u.y;
            xv[2] = u.z;
            xv[3] = u.w;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = rintf(xv[e] * f);  // half to even
            v = fminf(fmaxf(v, -127.0f), 127.0f);
            word |= (uint32_t)(uint8_t)(int8_t)v << (8 * e);
          }
        }
        *reinterpret_cast<uint32_t*>(xs + (m * 2 + p) * pitch + k4) = word;
      }
    }
  }
  __syncthreads();

  // a lane: plane p (0: hi nibbles, x[:, :K/2]; 1: lo, x[:, K/2:]), columns
  // 8 cg .. 8 cg + 7 of the tile, all 64 rows of its warp's stages
  const int p = lane >> 4, cg = lane & 15;
  const int sh = p ? 0 : 4;  // a packed byte's code of plane p to the low nibble
  const size_t col0 = (size_t)ct * kFCols + cg * kFC;
  const float inv127 = 1.0f / 127.0f;
  float facc[kM][kFC];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < kFC; ++e) facc[m][e] = 0.0f;

  for (int i = warp; i < nst; i += kFWarps) {
    // the scales of the stage's quantization blocks (1 or 2), before the wait
    const int j = j0 + i * kFRows, nblk = kFRows / bs;
    float scl[2][kFC];
#pragma unroll
    for (int bk = 0; bk < 2; ++bk) {
      if (bk >= nblk) break;
      const size_t off = ((size_t)p * nbh + j / bs + bk) * N + col0;
      if (s_bf16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(scales) + off));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          scl[bk][2 * e] = __uint_as_float(w[e] << 16) * inv127;
          scl[bk][2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u) * inv127;
        }
      } else {
        const float4* sp = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(scales) + off);
        const float4 a = __ldg(sp), b2 = __ldg(sp + 1);
        const float v[8] = {a.x, a.y, a.z, a.w, b2.x, b2.y, b2.z, b2.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) scl[bk][e] = v[e] * inv127;
      }
    }
    mbar_wait(&full[i % kFSlots], (i / kFSlots) & 1);
    const uint8_t* W = smem + (i % kFSlots) * kFStage + cg * kFC;
    const int8_t* xp = xs + p * pitch + i * kFRows;
    int iacc[kM][kFC];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int e = 0; e < kFC; ++e) iacc[m][e] = 0;
    // two halves of 32 rows: at blocksize 32 the first half's exact sums
    // take their block's scale between them
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int r = 32 * hf; r < 32 * hf + 32; r += 4) {
        uint2 R[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) R[k] = *reinterpret_cast<const uint2*>(W + (r + k) * kFCols);
        int xw[kM];
#pragma unroll
        for (int m = 0; m < kM; ++m) xw[m] = *reinterpret_cast<const int*>(xp + m * 2 * pitch + r);
#ifndef BNB_PROBE_NO_MATH  // chip_smoke.py --probe: decode and products switched off
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns 4h .. 4h + 3
          const uint32_t A = h ? R[0].y : R[0].x, Bw = h ? R[1].y : R[1].x;
          const uint32_t C = h ? R[2].y : R[2].x, Dw = h ? R[3].y : R[3].x;
          // byte c of X: the codes of rows r, r + 1 of column c (low, high
          // nibble); of Y: rows r + 2, r + 3
          const uint32_t X = ((A >> sh) & 0x0F0F0F0Fu) | ((Bw << (4 - sh)) & 0xF0F0F0F0u);
          const uint32_t Y = ((C >> sh) & 0x0F0F0F0Fu) | ((Dw << (4 - sh)) & 0xF0F0F0F0u);
          const Dec2 d01 = decode2(__byte_perm(X, Y, 0x5140), tbl);
          const Dec2 d23 = decode2(__byte_perm(X, Y, 0x7362), tbl);
          const int wv[4] = {(int)d01.a, (int)d01.b, (int)d23.a, (int)d23.b};
#pragma unroll
          for (int m = 0; m < kM; ++m)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) iacc[m][4 * h + cc] = __dp4a(wv[cc], xw[m], iacc[m][4 * h + cc]);
        }
#else
#pragma unroll
        for (int m = 0; m < kM; ++m) iacc[m][0] += (int)(R[0].x ^ R[1].y ^ R[2].x ^ R[3].y) + xw[m];
#endif
      }
      if (bs == 32 && hf == 0) {  // the stage's first block ends: its exact sums take its scale
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int e = 0; e < kFC; ++e) {
            facc[m][e] = fmaf((float)iacc[m][e], scl[0][e], facc[m][e]);
            iacc[m][e] = 0;
          }
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int e = 0; e < kFC; ++e)
        facc[m][e] = fmaf((float)iacc[m][e], nblk == 2 ? scl[1][e] : scl[0][e], facc[m][e]);
    __syncwarp();  // every lane of the warp is done with the slot
    if (lane == 0 && i + kFSlots < nst) load(i + kFSlots);
  }

  // the warps' and planes' sums in a fixed order; the ring is free
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kFWarps][kM][2][kFCols]
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int e = 0; e < kFC; ++e) red[((warp * kM + m) * 2 + p) * kFCols + cg * kFC + e] = facc[m][e];
  __syncthreads();
  constexpr int kOut = (kM * kFCols + kFThreads - 1) / kFThreads;  // outputs per thread
  float o[kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = tid + k * kFThreads, m = idx / kFCols, col = idx % kFCols;
    if (m >= kM) break;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kFWarps; ++w) s += red[((w * kM + m) * 2) * kFCols + col] + red[((w * kM + m) * 2 + 1) * kFCols + col];
    o[k] = s;
  }
#ifdef BNB_PROBE_NO_MERGE  // chip_smoke.py --probe: the split merge switched off
  if (false) {
#else
  if (ksplit > 1) {
#endif
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int idx = tid + k * kFThreads, m = idx / kFCols, col = idx % kFCols;
      if (m < M && m < kM) part[((size_t)z * M + m) * N + (size_t)ct * kFCols + col] = o[k];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(&tickets[ct], 1);
      s_last = ticket == ksplit - 1;
      if (s_last) tickets[ct] = 0;  // no other CTA of this launch takes it again
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < kOut; ++k) {
      const int idx = tid + k * kFThreads, m = idx / kFCols, col = idx % kFCols;
      if (m >= M) continue;
      float s = 0.0f;
#pragma unroll 4
      for (int s2 = 0; s2 < ksplit; ++s2) s += __ldcg(part + ((size_t)s2 * M + m) * N + (size_t)ct * kFCols + col);
      o[k] = s;
    }
  }
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int idx = tid + k * kFThreads, m = idx / kFCols, col = idx % kFCols;
    if (m >= M) continue;
    const size_t n = (size_t)ct * kFCols + col;
    float v = __fmul_rn(o[k], __fdiv_rn(amax[m], 127.0f));
    if (bias != nullptr) v = __fadd_rn(v, bias[n]);
    st_f(out, (size_t)m * N + n, v, out_bf16);
  }
}

template <int kM>
int launch_fused(dim3 grid, cudaStream_t st, const CUtensorMap& wmap, const void* x, int x_bf16,
                 const void* scales, int s_bf16, const float* bias, void* out, int out_bf16,
                 float* part, int* tickets, int M, int N, int K, int bs, int per, uint4 tbl) {
  auto kernel = w4a8_fused_kernel<kM>;
  const size_t shmem = fused_smem_bytes(kM, per);
  // the limit for the largest x slice the entry takes
  const cudaError_t e =
      allow_smem_once<w4a8_fused_kernel<kM>>((int)fused_smem_bytes(kM, kFMaxX / (kM * 2 * kFRows)));
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kFThreads, shmem, st>>>(wmap, x, x_bf16, scales, s_bf16, bias, out, out_bf16,
                                         part, tickets, M, N, K, bs, per, tbl);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32/bf16; packed (K/2, N) uint8; scales (2, K/(2 bs), N) f32/bf16;
// bias (N) f32 or null; out (M, N) f32/bf16. Scratch: xq (M, K) int8,
// row_absmax (M) f32, part (ksplit, M, N) f32. table: 16 int8 on the host.
extern "C" int w4a8_gemv(const void* x, const void* packed, const void* scales, const void* bias,
                         void* out, void* xq, void* row_absmax, void* part, const void* table,
                         int M, int N, int K, int bs, int G, int ksplit, int x_bf16, int s_bf16,
                         int out_bf16, void* stream) {
  if (M <= 0 || N % kCols || K % (2 * bs) || bs % 4 || G < 1 || ksplit < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  Table16 tbl;
  memcpy(tbl.v, table, 16);
  quant_rows_kernel<<<M, 256, 0, st>>>(x, x_bf16, K, reinterpret_cast<int8_t*>(xq),
                                       reinterpret_cast<float*>(row_absmax));
  dim3 grid(N / kCols, ksplit, (M + kMT - 1) / kMT);
  w4a8_kernel<<<grid, 32 * kWarps, 0, st>>>(
      reinterpret_cast<const int8_t*>(xq), reinterpret_cast<const uint32_t*>(packed), scales,
      s_bf16, reinterpret_cast<float*>(part), M, N, K, bs, G, tbl);
  const size_t MN = (size_t)M * N;
  reduce_partials_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float*>(part), ksplit, M, N,
      reinterpret_cast<const float*>(row_absmax), reinterpret_cast<const float*>(bias), out,
      out_bf16);
  return (int)cudaGetLastError();
}

// The fused body, one launch. x (M, K) f32/bf16, 16-byte aligned; packed,
// scales, bias, out as w4a8_gemv's; part, an f32 scratch of ksplit * M * N
// (unused when ksplit == 1); tickets, N / 128 int32 counters, all 0 (left
// at 0). Split z takes the stages [z per, min((z + 1) per, K / 128)) of 64
// packed rows; ksplit = ceil(K / 128 / per). M <= 8, bs 32 or 64,
// K % 128 == 0, N % 128 == 0.
extern "C" int w4a8_gemv_fused(const void* x, const void* packed, const void* scales,
                               const void* bias, void* out, void* part, void* tickets,
                               const void* table, int M, int N, int K, int bs, int per, int ksplit,
                               int x_bf16, int s_bf16, int out_bf16, void* stream) {
  const int steps = K / 2 / kFRows;
  const int kM = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  if (M <= 0 || M > 8 || N % kFCols || K % (2 * kFRows) || (bs != 32 && bs != 64) || per < 1 ||
      ksplit != (steps + per - 1) / per || (size_t)kM * 2 * per * kFRows > kFMaxX ||
      (ksplit > 1 && (part == nullptr || tickets == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  CUtensorMap wmap;  // the packed (K/2, N) bytes in boxes of 64 rows x 128 columns
  const int err = make_tmap_2d(&wmap, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N, N,
                               kFRows, kFCols, false);
  if (err != 0) return err;
  uint4 tbl;
  memcpy(&tbl, table, 16);
  dim3 grid(N / kFCols, ksplit);
  auto* b = reinterpret_cast<const float*>(bias);
  auto* pf = reinterpret_cast<float*>(part);
  auto* tk = reinterpret_cast<int*>(tickets);
#define BNB_FUSED_LAUNCH(R)                                                                       \
  return launch_fused<R>(grid, st, wmap, x, x_bf16, scales, s_bf16, b, out, out_bf16, pf, tk, M, \
                         N, K, bs, per, tbl)
  if (kM == 1) BNB_FUSED_LAUNCH(1);
  if (kM == 2) BNB_FUSED_LAUNCH(2);
  if (kM == 4) BNB_FUSED_LAUNCH(4);
  BNB_FUSED_LAUNCH(8);
#undef BNB_FUSED_LAUNCH
}
