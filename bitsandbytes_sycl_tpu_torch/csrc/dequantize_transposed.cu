// Kernel E: 4-bit weight -> dense transposed weight W^T (K, N).
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_4bit.py `_dequant_kernel`
// (called through `_dequant_to_hbm_call` and `dequantize_transposed`) for raw
// f32/bf16 block scales. It backs the large-M prefill route of
// matmul_4bit_fused: decode the weight once, then one dense matmul.
//
// Computes, for j < K/2 and every column n,
//   Wt[j, n]       = dec(hi nibble of packed[j, n]) * s[0, j / bs, n]
//   Wt[K/2 + j, n] = dec(lo nibble of packed[j, n]) * s[1, j / bs, n]
// with kernel B's rounding points: when bf16_product is set (bf16 output, a
// table codebook) the bf16 table entry times the bf16-rounded scale, the
// product rounded to bf16 once; otherwise the f32 value (int4's arithmetic
// value comes in the table) times the f32 scale, cast to the output type.
//
// Bound on the H100: memory. It reads K/2 * N packed bytes and the scales
// and writes K * N outputs (2 or 4 bytes each), with no reuse; the floor is
// those bytes over 3.35 TB/s.
//
// Design: a plain elementwise pass. A thread owns 4 neighbouring columns of
// one packed row: one 4-byte load, the 2 x 4 scales, and two stores (8 or 16
// bytes) to the hi row j and the lo row K/2 + j, so a warp reads 128
// contiguous bytes and writes contiguous runs. The Pallas kernel pads each
// half to 8 quantization blocks for Mosaic's tiling; nothing here needs it.
#include <string.h>

#include "common.cuh"

namespace {

__global__ void dequant4_kernel(const uint32_t* __restrict__ packed, const void* __restrict__ scales,
                                int s_bf16, void* __restrict__ out, int out_bf16, int bf16_product,
                                int K, int N, int bs, TableF16 table) {
  __shared__ float tbl[16];
  if (threadIdx.x < 16) tbl[threadIdx.x] = table.v[threadIdx.x];
  __syncthreads();
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const size_t items = (size_t)half * N4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(i / N4), col4 = (int)(i % N4);
    const uint32_t w = __ldg(packed + i);
    const int blk = j / bs;
    float v[2][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t n = (size_t)col4 * 4 + c;
      const int byte = (w >> (8 * c)) & 0xFF;
      float sh = ld_f(scales, (size_t)blk * N + n, s_bf16);
      float sl = ld_f(scales, ((size_t)nbh + blk) * N + n, s_bf16);
      if (bf16_product) {
        v[0][c] = round_bf16(tbl[byte >> 4] * round_bf16(sh));
        v[1][c] = round_bf16(tbl[byte & 15] * round_bf16(sl));
      } else {
        v[0][c] = tbl[byte >> 4] * sh;
        v[1][c] = tbl[byte & 15] * sl;
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const size_t o = ((size_t)(p * half + j)) * N + (size_t)col4 * 4;
      if (out_bf16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[p][0], v[p][1]);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[p][2], v[p][3]);
        uint2 pk;
        memcpy(&pk.x, &lo2, 4);
        memcpy(&pk.y, &hi2, 4);
        *reinterpret_cast<uint2*>(reinterpret_cast<__nv_bfloat16*>(out) + o) = pk;
      } else {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(out) + o) =
            make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
      }
    }
  }
}

}  // namespace

// packed (K/2, N) uint8; scales (2, K/(2 bs), N) f32/bf16; out (K, N) f32 or
// bf16. table: the 16 decoded values (f32) on the host.
extern "C" int dequantize_transposed(const void* packed, const void* scales, void* out,
                                     const void* table, int K, int N, int bs, int s_bf16,
                                     int out_bf16, int bf16_product, void* stream) {
  if (K <= 0 || N <= 0 || N % 4 || bs <= 0 || K % (2 * bs)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  const size_t items = (size_t)(K / 2) * (N / 4);
  const int threads = 256;
  const size_t want = (items + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  dequant4_kernel<<<blocks, threads, 0, st>>>(reinterpret_cast<const uint32_t*>(packed), scales,
                                               s_bf16, out, out_bf16, bf16_product, K, N, bs, tbl);
  return (int)cudaGetLastError();
}
