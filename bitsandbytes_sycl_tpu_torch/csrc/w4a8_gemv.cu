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
// Design: a thread owns 4 neighbouring output columns, so a warp reads 128
// contiguous bytes of each packed row. One shared 256-entry table turns a
// packed byte into both of its int8 codes at once; byte permutes gather 4
// consecutive rows' codes of a column into one word, and __dp4a does 4
// multiply-adds per instruction. Each warp of a block takes its own
// quantization blocks (its int32 sums never cross a block); the warps'
// f32 sums meet in shared memory in a fixed order, and the K splits of
// the grid are summed in order by a second small kernel, so the result
// does not depend on scheduling. Rows go in tiles of 4 (grid z).
#include <string.h>

#include "common.cuh"

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
