// Kernel G: grouped W4A8 matmul, one int32 sum over all of K.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_w4a8.py `_grouped_kernel`
// (called through `_grouped_call` and `matmul_4bit_w4a8_grouped`), together
// with the XLA-side activation quantization and row-scale epilogue around it.
//
// Computes out[m, n] = ((float)(sum_k xq[m, k] * wg[k, n]) * (colmax[n] * (1/127)))
//                      * (row_absmax[m] / 127) (+ bias[n])
// with xq = clip(rint(x * 127 * safe_inv(row_absmax)), +-127) per row and the
// weight regridded onto its column's int8 grid in the kernel:
// wg = clip(rint(i8code(nibble) * (f[plane, blk, n] * (1/127)))), +-127),
// i8code = round(code * 127) and f = absmax * 127 * safe_inv(colmax) from the
// caller. The int32 sum is exact (127 * 127 * K < 2^31 up to K ~ 133k), and
// the epilogue keeps the JAX package's order with rounded multiplies
// (__fmul_rn cannot be contracted into an FMA), so the result is the plain
// version's bit for bit.
//
// Bound on the H100: int8 operations. It serves 257-4095 rows, where 2 M N K
// operations over 1979 TOPS exceed the bytes over 3.35 TB/s.
//
// Design: one block of 8 warps per 128 x 128 output tile; the K loop walks
// the hi plane then the lo plane, 64 rows at a time, and masks a plane's
// ragged last step (half-K not a multiple of 64, as at blocksize 32 with a
// whole-half K step in the JAX kernel's tiling). Each step stages the
// 128 x 64 int8 activation tile and decodes and regrids the matching 64 x 128
// weight slice into shared memory, stored column-major (each column's 64
// codes contiguous) because mma.sync takes B by columns. Each warp owns a
// 64 x 32 sub-tile and issues mma.sync.m16n8k32 s8 x s8 -> s32. Rows of 80
// bytes make every fragment load and every decode store conflict-free. A
// ragged M is masked (zero rows in, no store out) instead of padded. There is
// no cp.async/TMA pipelining and no wgmma yet: a first, simple version
// (loading the next step into registers during the products was tried and
// did not move its time).
#include <string.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kLd = kBK + 16;  // shared-memory row stride in bytes
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t regrid(float code, float g) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(code, g)), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)q;
}

// kRagged: half-K is not a multiple of kBK, so each plane's last step is
// masked (rows past the plane read as zero codes on both sides), and the
// 16-byte activation loads fall back to bytes where a plane row is not
// 16-byte aligned (K % 32 != 0). Without it the loop is the plain one.
template <bool kRagged>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const int8_t* __restrict__ xq, const uint32_t* __restrict__ packed,
               const float* __restrict__ f, const float* __restrict__ colmax,
               const float* __restrict__ row_absmax, const float* __restrict__ bias,
               void* __restrict__ out, int out_bf16, int M, int N, int K, int bs,
               TableF16 table) {
  __shared__ __align__(16) int8_t As[kBM * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];
  __shared__ float code[16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 16) code[tid] = table.v[tid];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64 x 32 outputs each
  const int gid = lane >> 2, t4 = lane & 3;
  const float inv127 = 1.0f / 127.0f;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int steps = (half + kBK - 1) / kBK;  // per plane
  for (int step = 0; step < 2 * steps; ++step) {
    const int plane = step >= steps;
    const int j0 = (step - plane * steps) * kBK, shift = plane ? 0 : 4;
    const bool full = !kRagged || (K % 32 == 0 && j0 + kBK <= half);
    __syncthreads();  // the previous step's fragments have been read
    // activations: 128 rows x 64 bytes, 16 bytes per thread and pass
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * kThreads, row = idx >> 2, ch = idx & 3;
      const int c0 = j0 + ch * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + row < M) {
        const int8_t* src = xq + (size_t)(m0 + row) * K + plane * half + c0;
        if (full) {
          v = __ldg(reinterpret_cast<const int4*>(src));
        } else {
          __align__(16) int8_t b[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) b[e] = c0 + e < half ? src[e] : 0;
          v = *reinterpret_cast<const int4*>(b);
        }
      }
      *reinterpret_cast<int4*>(As + row * kLd + ch * 16) = v;
    }
    // weights: 64 rows x 128 columns; a thread takes 4 rows (one
    // quantization block, bs % 4 == 0, so all 4 or none lie in the plane)
    // of 4 columns, twice
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int kw = lane & 15, c4 = warp * 2 + (lane >> 4) + p * 16;
      const int j = j0 + kw * 4;
      if (kRagged && j >= half) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          *reinterpret_cast<uint32_t*>(Bs + (c4 * 4 + c) * kLd + kw * 4) = 0;
        }
        continue;
      }
      const int blk = j / bs, col4 = n0 / 4 + c4;
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = __ldg(packed + (size_t)(j + r) * N4 + col4);
      const float4 fv = __ldg(reinterpret_cast<const float4*>(f + ((size_t)plane * nbh + blk) * N) + col4);
      const float g[4] = {__fmul_rn(fv.x, inv127), __fmul_rn(fv.y, inv127),
                          __fmul_rn(fv.z, inv127), __fmul_rn(fv.w, inv127)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t word = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          word |= regrid(code[(w[r] >> (8 * c + shift)) & 15], g[c]) << (8 * r);
        }
        *reinterpret_cast<uint32_t*>(Bs + (c4 * 4 + c) * kLd + kw * 4) = word;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* base = As + (wm * 64 + mi * 16 + gid) * kLd + ks + t4 * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = Bs + (wn * 32 + ni * 8 + gid) * kLd + ks + t4 * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // epilogue, in the JAX order: (acc * (colmax * 1/127)) * (row_absmax / 127) + bias
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + gid + h * 8;
      if (m >= M) continue;
      const float rs = __fdiv_rn(row_absmax[m], 127.0f);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + t4 * 2 + e;
          float v = __fmul_rn(__int2float_rn(acc[mi][ni][h * 2 + e]), __fmul_rn(colmax[n], inv127));
          v = __fmul_rn(v, rs);
          if (bias != nullptr) v = __fadd_rn(v, bias[n]);
          st_f(out, (size_t)m * N + n, v, out_bf16);
        }
    }
}

}  // namespace

// x (M, K) f32/bf16; packed (K/2, N) uint8; f (2, K/(2 bs), N) f32; colmax
// (N) f32; bias (N) f32 or null; out (M, N) f32/bf16. Scratch: xq (M, K)
// int8, row_absmax (M) f32. table: the 16 int8 codes as floats on the host.
extern "C" int w4a8_grouped(const void* x, const void* packed, const void* f, const void* colmax,
                            const void* bias, void* out, void* xq, void* row_absmax,
                            const void* table, int M, int N, int K, int bs, int x_bf16,
                            int out_bf16, void* stream) {
  if (M <= 0 || N % kBN || bs <= 0 || bs % 4 || K % (2 * bs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  quant_rows_kernel<<<M, 256, 0, st>>>(x, x_bf16, K, reinterpret_cast<int8_t*>(xq),
                                       reinterpret_cast<float*>(row_absmax));
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  auto kernel = (K / 2) % kBK ? grouped_kernel<true> : grouped_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(
      reinterpret_cast<const int8_t*>(xq), reinterpret_cast<const uint32_t*>(packed),
      reinterpret_cast<const float*>(f), reinterpret_cast<const float*>(colmax),
      reinterpret_cast<const float*>(row_absmax), reinterpret_cast<const float*>(bias), out,
      out_bf16, M, N, K, bs, tbl);
  return (int)cudaGetLastError();
}
