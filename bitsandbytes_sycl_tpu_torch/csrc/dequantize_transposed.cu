// Kernel E: 4-bit weight -> dense transposed weight W^T (K, N).
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_4bit.py `_dequant_kernel`
// (called through `_dequant_to_hbm_call` and `dequantize_transposed`), for
// raw f32/bf16 block scales and for compressed ones (uint8 dynamic-map codes
// with a per-(plane, column) range and mean). It backs the large-M prefill
// route of matmul_4bit_fused (decode the weight once, then one dense
// matmul) and the backward of every 4-bit route.
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
//
// Compressed scales (`dequant4_dq_kernel`): a CTA owns a strip of 128
// columns over `rb` quantization blocks of packed rows. It first decodes the
// strip's 2 x rb x 128 scale codes once into f32 in shared memory, each as
// fma(table[code], range, mean) rounded once (`__fmaf_rn`; the table is the
// port's dynamic-map decode, `ops/dynamic8.decode_table`), which is what
// `ops/common.decode_absmax` computes, so the output stays bit for bit. The
// Pallas kernel decodes its whole k-invariant strip once per column tile
// into VMEM scratch the same way. Then each warp walks the strip's rows as
// the raw body does, its scales read from shared memory: a code is decoded
// once, never per element, and no dense f32 scale tensor is written.
#include <string.h>

#include "common.cuh"

namespace {

// one packed row's 4 columns (the bytes of w) into both planes' outputs
__device__ __forceinline__ void dequant4_store(uint32_t w, const float* sh, const float* sl,
                                               const float* tbl, void* out, int out_bf16,
                                               int bf16_product, int half, int j, int N,
                                               int col4) {
  float v[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int byte = (w >> (8 * c)) & 0xFF;
    if (bf16_product) {
      v[0][c] = round_bf16(tbl[byte >> 4] * round_bf16(sh[c]));
      v[1][c] = round_bf16(tbl[byte & 15] * round_bf16(sl[c]));
    } else {
      v[0][c] = tbl[byte >> 4] * sh[c];
      v[1][c] = tbl[byte & 15] * sl[c];
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
    float sh[4], sl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t n = (size_t)col4 * 4 + c;
      sh[c] = ld_f(scales, (size_t)blk * N + n, s_bf16);
      sl[c] = ld_f(scales, ((size_t)nbh + blk) * N + n, s_bf16);
    }
    dequant4_store(w, sh, sl, tbl, out, out_bf16, bf16_product, half, j, N, col4);
  }
}

constexpr int kDqCols = 128;  // columns of a compressed-scale strip

// grid (ceil(N / 128), ceil(nbh / rb)), 256 threads; dynamic shared memory
// 2 * rb * 128 floats
__global__ void __launch_bounds__(256)
dequant4_dq_kernel(const uint32_t* __restrict__ packed, const uint8_t* __restrict__ codes,
                   const float* __restrict__ am_scale, const float* __restrict__ am_offset,
                   const float* __restrict__ dtab, void* __restrict__ out, int out_bf16,
                   int bf16_product, int K, int N, int bs, int rb, TableF16 table) {
  extern __shared__ float sdec[];  // [plane][rb][128]
  __shared__ float tbl[16];
  __shared__ float dt[256];
  const int tid = threadIdx.x;
  if (tid < 16) tbl[tid] = table.v[tid];
  dt[tid] = dtab[tid];
  __syncthreads();
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const int n0 = blockIdx.x * kDqCols, b0 = blockIdx.y * rb;
  const int nb = min(rb, nbh - b0);
  for (int i = tid; i < 2 * rb * kDqCols; i += blockDim.x) {
    const int p = i / (rb * kDqCols), b = (i / kDqCols) % rb, n = n0 + i % kDqCols;
    if (b < nb && n < N) {
      const int pn = p * N + n;
      sdec[i] = __fmaf_rn(dt[codes[((size_t)p * nbh + b0 + b) * N + n]], am_scale[pn], am_offset[pn]);
    }
  }
  __syncthreads();
  const int col4 = n0 / 4 + (tid & 31);
  if (col4 >= N4) return;
  const int c0 = (tid & 31) * 4;
  for (int j = b0 * bs + (tid >> 5); j < (b0 + nb) * bs; j += blockDim.x / 32) {
    const uint32_t w = __ldg(packed + (size_t)j * N4 + col4);
    const float* s0 = sdec + (j / bs - b0) * kDqCols + c0;
    dequant4_store(w, s0, s0 + rb * kDqCols, tbl, out, out_bf16, bf16_product, half, j, N, col4);
  }
}

}  // namespace

// packed (K/2, N) uint8; scales (2, K/(2 bs), N) f32/bf16, or uint8 codes
// when am_scale is given; am_scale and am_offset (2, 1, N) f32 (or null);
// dtab: the 256 signed dynamic-map values (f32, on the card); out (K, N) f32
// or bf16. table: the 16 decoded values (f32) on the host.
extern "C" int dequantize_transposed(const void* packed, const void* scales, void* out,
                                     const void* table, int K, int N, int bs, int s_bf16,
                                     int out_bf16, int bf16_product, const void* am_scale,
                                     const void* am_offset, const void* dtab, void* stream) {
  if (K <= 0 || N <= 0 || N % 4 || bs <= 0 || K % (2 * bs)) return (int)cudaErrorInvalidValue;
  if (am_scale != nullptr && (am_offset == nullptr || dtab == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  const int threads = 256;
  if (am_scale != nullptr) {
    // about 256 packed rows a CTA (at most 32 blocks: 32 KB of decoded
    // scales), so the strip's decode is a small part of its work
    const int nbh = K / 2 / bs, want_rb = (256 + bs - 1) / bs;
    const int rb = want_rb > 32 ? 32 : want_rb > nbh ? nbh : want_rb;
    const int smem = 2 * rb * kDqCols * (int)sizeof(float);
    dim3 grid((N + kDqCols - 1) / kDqCols, (nbh + rb - 1) / rb);
    dequant4_dq_kernel<<<grid, threads, smem, st>>>(
        reinterpret_cast<const uint32_t*>(packed), reinterpret_cast<const uint8_t*>(scales),
        reinterpret_cast<const float*>(am_scale), reinterpret_cast<const float*>(am_offset),
        reinterpret_cast<const float*>(dtab), out, out_bf16, bf16_product, K, N, bs, rb, tbl);
    return (int)cudaGetLastError();
  }
  const size_t items = (size_t)(K / 2) * (N / 4);
  const size_t want = (items + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  dequant4_kernel<<<blocks, threads, 0, st>>>(reinterpret_cast<const uint32_t*>(packed), scales,
                                               s_bf16, out, out_bf16, bf16_product, K, N, bs, tbl);
  return (int)cudaGetLastError();
}
