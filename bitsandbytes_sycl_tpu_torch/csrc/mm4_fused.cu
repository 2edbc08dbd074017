// Kernel B: exact 4-bit dequant-matmul.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_4bit.py `_mm4_kernel` (called
// through `_matmul_4bit_call`) for raw f32/bf16 block scales.
//
// Computes out = x[:, :K/2] @ (dec(hi) * s_hi) + x[:, K/2:] @ (dec(lo) * s_lo)
// (+ bias) with f32 accumulation, decoding as the TPU kernel does:
//   mode 2 (bf16 compute, table codebook): bf16(table) * bf16(scale),
//          the product rounded to bf16;
//   mode 0 (f32 table decode) and mode 1 (int4, (7 - (i & 7)) / 7 or
//          -(i & 7) / 7): the f32 product, rounded to bf16 when x is bf16.
//
// Bound on the H100: memory at the rows this route serves (M < 2048; the
// engine sends it M <= 128): the weight bytes plus scales over 3.35 TB/s.
// The per-element decode and 2*M f32 multiply-adds per weight byte make it
// bound by instruction throughput before that at small M; a first,
// simple version.
//
// Design: the work split of kernel A (w4a8_gemv.cu). A thread owns 4
// neighbouring columns; each warp takes whole quantization blocks (so one
// scale per column and plane per block); warps meet in shared memory in a
// fixed order and the grid's K splits are summed in order by a second small
// kernel. The 16-entry table sits in shared memory, where distinct entries
// fall in distinct banks.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMT = 4;
constexpr int kCols = 128;

template <int kMode>
__device__ __forceinline__ float decode(int code, const float* tbl, float s, int x_bf16) {
  if (kMode == 2) {
    return round_bf16(tbl[code] * s);  // tbl and s already on the bf16 grid
  }
  float v;
  if (kMode == 1) {
    const int mag = code & 7;
    v = (float)((code & 8) ? -mag : 7 - mag) * (1.0f / 7.0f);
  } else {
    v = tbl[code];
  }
  v = v * s;
  return x_bf16 ? round_bf16(v) : v;
}

template <int kMode>
__global__ void __launch_bounds__(32 * kWarps)
mm4_kernel(const void* __restrict__ x, int x_bf16, const uint32_t* __restrict__ packed,
           const void* __restrict__ scales, int s_bf16, float* __restrict__ part, int M, int N,
           int K, int bs, int G, TableF16 table) {
  __shared__ float tbl[16];
  __shared__ float red[kWarps][kMT][kCols];
  if (threadIdx.x < 16) tbl[threadIdx.x] = table.v[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = blockIdx.y, m0 = blockIdx.z * kMT;
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const int col4 = blockIdx.x * (kCols / 4) + lane;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int i = 0; i < G; ++i) {
    const int qb = (kc * G + i) * kWarps + warp;
    if (qb >= nbh) break;
    float sh[4], sl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t n = (size_t)col4 * 4 + c;
      sh[c] = ld_f(scales, (size_t)qb * N + n, s_bf16);
      sl[c] = ld_f(scales, ((size_t)nbh + qb) * N + n, s_bf16);
      if (kMode == 2) {
        sh[c] = round_bf16(sh[c]);
        sl[c] = round_bf16(sl[c]);
      }
    }
#pragma unroll 2
    for (int r = 0; r < bs; ++r) {
      const int j = qb * bs + r;
      const uint32_t w = __ldg(packed + (size_t)j * N4 + col4);
      float xh[kMT], xl[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const bool ok = m0 + m < M;
        const size_t row = (size_t)(ok ? m0 + m : 0) * K;
        xh[m] = ok ? ld_f(x, row + j, x_bf16) : 0.0f;
        xl[m] = ok ? ld_f(x, row + half + j, x_bf16) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int byte = (w >> (8 * c)) & 0xFF;
        const float dh = decode<kMode>(byte >> 4, tbl, sh[c], x_bf16);
        const float dl = decode<kMode>(byte & 15, tbl, sl[c], x_bf16);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          acc[m][c] = fmaf(xh[m], dh, acc[m][c]);
          acc[m][c] = fmaf(xl[m], dl, acc[m][c]);
        }
      }
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

// x (M, K) in the compute dtype (f32/bf16); packed (K/2, N) uint8; scales
// (2, K/(2 bs), N) f32/bf16; bias (N) f32 or null; out (M, N) in the compute
// dtype. Scratch: part (ksplit, M, N) f32. table: 16 floats on the host.
extern "C" int mm4_fused(const void* x, const void* packed, const void* scales, const void* bias,
                         void* out, void* part, const void* table, int M, int N, int K, int bs,
                         int G, int ksplit, int x_bf16, int s_bf16, int mode, void* stream) {
  if (M <= 0 || N % kCols || K % (2 * bs) || G < 1 || ksplit < 1 || mode < 0 || mode > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  dim3 grid(N / kCols, ksplit, (M + kMT - 1) / kMT);
  const uint32_t* pk = reinterpret_cast<const uint32_t*>(packed);
  float* pt = reinterpret_cast<float*>(part);
  if (mode == 0) {
    mm4_kernel<0><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, pt, M, N, K, bs, G, tbl);
  } else if (mode == 1) {
    mm4_kernel<1><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, pt, M, N, K, bs, G, tbl);
  } else {
    mm4_kernel<2><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, pt, M, N, K, bs, G, tbl);
  }
  const size_t MN = (size_t)M * N;
  reduce_partials_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      pt, ksplit, M, N, nullptr, reinterpret_cast<const float*>(bias), out, x_bf16);
  return (int)cudaGetLastError();
}
