// Kernel F: 4-bit weight -> int8 codes on one grid per output column.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_w4a8.py `_dequant8_kernel`
// (called through `_dequant8_call` and `dequantize_to_int8`). It backs the
// per-call W8A8 prefill route: decode once, then one int8 x int8 product.
// The route's per-row activation quantization (`quant_rows`) and the
// per-column grid (`col_grid`: colmax and f, which kernel G also takes) are
// here too.
//
// Computes wq[k, n] = clip(rint(dec(nibble(k, n)) * f[plane, blk, n]), +-127)
// with dec the bf16 table value (int4: its f32 arithmetic value; both come
// in the table) and f = absmax * 127 * safe_inv(colmax), computed in f32
// by `col_grid`. k < K/2 reads the hi nibble of packed[k, n], k >= K/2 the
// lo nibble of packed[k - K/2, n]. rint rounds half to even, as jnp.round.
//
// The codes are stored as (N, K) rows, i.e. wq in column-major order: that
// is the "TN" layout cuBLAS's int8 GEMM takes, so torch._int_mm consumes the
// transposed view without a copy.
//
// Bound on the H100: memory. It reads K/2 * N packed bytes and the f32
// factors and writes K * N int8 codes, with no reuse.
//
// Design: a plain elementwise pass. A thread decodes 4 consecutive rows of
// 4 neighbouring columns (one quantization block: bs % 4 == 0) and writes,
// per column, one 4-byte word of 4 consecutive k to the hi half and one to
// the lo half of that column's row. Neighbouring threads take neighbouring
// k, so a warp's writes to one column are one contiguous run.
#include <string.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t q8(float dec, float f) {
  const float q = fminf(fmaxf(rintf(dec * f), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)q;
}

// colmax[n] = the column's largest block scale over both planes, and
// f = absmax * (127 * safe_inv(colmax)), each operation rounded as the
// plain version's (`ops/matmul_w4a8._col_grid`)
__global__ void col_grid_kernel(const void* __restrict__ absmax, int s_bf16, int nb2, int N,
                                float* __restrict__ colmax, float* __restrict__ f) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float cm = ld_f(absmax, n, s_bf16);
  for (int b = 1; b < nb2; ++b) cm = fmaxf(cm, ld_f(absmax, (size_t)b * N + n, s_bf16));
  colmax[n] = cm;
  const float sc = __fmul_rn(127.0f, cm > 0.0f ? __frcp_rn(cm) : 0.0f);
  for (int b = 0; b < nb2; ++b) {
    f[(size_t)b * N + n] = __fmul_rn(ld_f(absmax, (size_t)b * N + n, s_bf16), sc);
  }
}

__global__ void dequant_int8_kernel(const uint32_t* __restrict__ packed,
                                    const float* __restrict__ f, int8_t* __restrict__ out_t,
                                    int K, int N, int bs, TableF16 table) {
  __shared__ float tbl[16];
  if (threadIdx.x < 16) tbl[threadIdx.x] = table.v[threadIdx.x];
  __syncthreads();
  const int half = K / 2, nbh = half / bs, N4 = N / 4, H4 = half / 4;
  const size_t items = (size_t)H4 * N4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += (size_t)gridDim.x * blockDim.x) {
    const int kw = (int)(i % H4), col4 = (int)(i / H4);
    const int j = kw * 4, blk = j / bs;
    uint32_t w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = __ldg(packed + (size_t)(j + r) * N4 + col4);
    const float4 fh = __ldg(reinterpret_cast<const float4*>(f + (size_t)blk * N) + col4);
    const float4 fl = __ldg(reinterpret_cast<const float4*>(f + ((size_t)nbh + blk) * N) + col4);
    const float fhc[4] = {fh.x, fh.y, fh.z, fh.w}, flc[4] = {fl.x, fl.y, fl.z, fl.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t hi = 0, lo = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int byte = (w[r] >> (8 * c)) & 0xFF;
        hi |= q8(tbl[byte >> 4], fhc[c]) << (8 * r);
        lo |= q8(tbl[byte & 15], flc[c]) << (8 * r);
      }
      int8_t* row = out_t + ((size_t)col4 * 4 + c) * K;
      *reinterpret_cast<uint32_t*>(row + j) = hi;
      *reinterpret_cast<uint32_t*>(row + half + j) = lo;
    }
  }
}

}  // namespace

// packed (K/2, N) uint8; f (2, K/(2 bs), N) f32; out_t (N, K) int8.
// table: the 16 decoded values (f32) on the host.
extern "C" int dequant_int8(const void* packed, const void* f, void* out_t, const void* table,
                            int K, int N, int bs, void* stream) {
  if (K <= 0 || N <= 0 || N % 4 || bs <= 0 || bs % 4 || K % (2 * bs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  const size_t items = (size_t)(K / 8) * (N / 4);
  const int threads = 256;
  const size_t want = (items + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  dequant_int8_kernel<<<blocks, threads, 0, st>>>(reinterpret_cast<const uint32_t*>(packed),
                                                  reinterpret_cast<const float*>(f),
                                                  reinterpret_cast<int8_t*>(out_t), K, N, bs, tbl);
  return (int)cudaGetLastError();
}

// The W8A8 route's activations: x (M, K) f32/bf16 -> xq (M, K) int8 and
// row_absmax (M) f32, by the per-row quantization kernels A and G also run.
extern "C" int quant_rows(const void* x, void* xq, void* row_absmax, int M, int K, int x_bf16,
                          void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  quant_rows_kernel<<<M, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, K, reinterpret_cast<int8_t*>(xq), reinterpret_cast<float*>(row_absmax));
  return (int)cudaGetLastError();
}

// The per-column int8 grid of kernels F and G: absmax (2, K/(2 bs), N)
// f32/bf16 -> colmax (N) f32 and f (2, K/(2 bs), N) f32; nb2 = K / bs.
extern "C" int col_grid(const void* absmax, void* colmax, void* f, int nb2, int N, int s_bf16,
                        void* stream) {
  if (nb2 <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  col_grid_kernel<<<(N + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      absmax, s_bf16, nb2, N, reinterpret_cast<float*>(colmax), reinterpret_cast<float*>(f));
  return (int)cudaGetLastError();
}
