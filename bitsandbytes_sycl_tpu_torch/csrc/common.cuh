// Helpers shared by the port's kernels: typed loads and stores, warp and
// block reductions, the per-row int8 quantization of activations, and the
// fixed-order reduction of split-K partials.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BNB_FULL_MASK 0xffffffffu

// Raise a kernel's dynamic shared memory limit to `bytes`, once per device
// (setting it on every launch costs host time in a decode step).
template <auto kernel>
inline cudaError_t allow_smem_once(int bytes) {
  static cudaError_t done[64];
  static bool set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (!set[dev]) {
    done[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    set[dev] = true;
  }
  return done[dev];
}

// A grid-stride loop's grid: at most 16 blocks per SM of the H100's 132.
constexpr size_t kMaxBlocks = 132 * 16;

// The 16 decoded values of a 4-bit codebook, passed by value to a kernel.
struct TableF16 {
  float v[16];
};

__device__ __forceinline__ float ld_f(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_f(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The four signed bytes of w as exact floats, without the quarter-rate
// integer conversion: each byte, offset to unsigned, becomes the low
// mantissa bits of 2^23 (one byte permute), and one add removes 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | k)) - 8388736.0f;
  }
}

// 16 signed bytes (one 16-byte load) as exact floats
__device__ __forceinline__ void i8x16_to_f32(uint4 w, float* f) {
  i8x4_to_f32(w.x, f);
  i8x4_to_f32(w.y, f + 4);
  i8x4_to_f32(w.z, f + 8);
  i8x4_to_f32(w.w, f + 12);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(BNB_FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(BNB_FULL_MASK, v, o);
  return v;
}

// Block-wide max or sum (blockDim.x a multiple of 32); every thread gets
// the result. `red` holds at least 32 floats of shared memory.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nwarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// One block per row m: row_absmax[m] = max |x[m, :]| and
// xq[m, k] = clip(rint(x[m, k] * (127 * safe_inv(row_absmax[m]))), +-127),
// rint rounding half to even (the JAX package's activation quantization).
__global__ void quant_rows_kernel(const void* __restrict__ x, int x_bf16, int K,
                                  int8_t* __restrict__ xq, float* __restrict__ row_absmax) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const size_t base = (size_t)m * K;
  float amax = 0.0f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) amax = fmaxf(amax, fabsf(ld_f(x, base + k, x_bf16)));
  amax = block_reduce<true>(amax, red);
  const float f = 127.0f * (amax > 0.0f ? 1.0f / amax : 0.0f);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = rintf(ld_f(x, base + k, x_bf16) * f);  // half to even
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    xq[base + k] = (int8_t)v;
  }
  if (threadIdx.x == 0) row_absmax[m] = amax;
}

// out[m, n] = (sum over s, in order, of part[s, m, n]) * row_absmax[m] / 127
// (when row_absmax is given) + bias[n] (when given), stored as f32 or bf16.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int ksplit, int M, int N,
                                       const float* __restrict__ row_absmax,
                                       const float* __restrict__ bias, void* out, int out_bf16) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float acc = part[i];
  for (int s = 1; s < ksplit; ++s) acc += part[(size_t)s * MN + i];
  if (row_absmax != nullptr) acc = acc * (row_absmax[i / N] / 127.0f);
  if (bias != nullptr) acc = acc + bias[i % N];
  st_f(out, i, acc, out_bf16);
}
