// Kernel I: fused LLM.int8 matmul of up to 128 rows.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_int8.py `_mm8_kernel` (called
// through `_int8_matmul_call` and `int8_matmul_fused`).
//
// Computes out[m, n] = (float)(sum_k xq[m, k] * cb[n, k])
//                      * ((1 / inv[m]) * (scb[n] * f32(1/127))) (+ bias[n])
// with xq = clip(rint(x * inv), +-127) quantized in the kernel per K step
// (rint: half to even, as the JAX package's round). The int32 sum is exact
// (127 * 127 * K < 2^31 up to K ~ 133k) and the epilogue keeps the JAX
// order with rounded operations (__fdiv_rn/__fmul_rn cannot be contracted
// into an FMA), so the result is the plain version's bit for bit.
//
// Bound on the H100: memory. At <= 128 rows the N x K int8 weight read
// (16.8 MB at 4096 x 4096) outweighs 2 M N K int8 operations at 1979 TOPS.
//
// Design: CB (N, K) row-major is already the column-major B that
// mma.sync.m16n8k32.row.col wants, so weight tiles copy straight into
// shared memory. One block of 4 warps per 64-column tile and K split; each
// K step of 128 stages the 64 x 128 weight tile (16-byte loads) and
// quantizes the x rows into an int8 tile of 16 * kMT rows (rows >= M are
// zero), and each warp runs m16n8k32 s8 x s8 -> s32 over its 16 columns and
// every row tile. Rows of 144 bytes keep fragment loads conflict-free. The
// K splits (enough blocks to fill the 132 SMs at decode sizes) write int32
// partials, and a second kernel sums them in a fixed order and applies the
// epilogue. No cp.async/TMA pipeline and no wgmma yet: a first, simple
// version.
#include "common.cuh"

namespace {

constexpr int kBN = 64, kBK = 128;
constexpr int kLd = kBK + 16;  // shared-memory row stride in bytes
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t quant4(const float* v, float f) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(v[e], f)), -127.0f), 127.0f);
    w |= (uint32_t)(uint8_t)(int8_t)q << (8 * e);
  }
  return w;
}

// kMT: row tiles of 16, 16 * kMT >= M.
template <int kMT>
__global__ void __launch_bounds__(kThreads)
mm8_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ inv,
           const int8_t* __restrict__ cb, int* __restrict__ part, int M, int N, int K,
           int steps_per) {
  __shared__ __align__(16) int8_t As[kMT * 16 * kLd];
  __shared__ __align__(16) int8_t Bs[kBN * kLd];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kBN, split = blockIdx.y;
  const int s_begin = split * steps_per, s_end = min(s_begin + steps_per, K / kBK);

  int acc[kMT][2][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int s = s_begin; s < s_end; ++s) {
    const int k0 = s * kBK;
    __syncthreads();  // the previous step's fragments have been read
    // weights: 64 rows x 128 bytes, 16 bytes per thread and pass
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int idx = tid + p * kThreads, row = idx >> 3, ch = idx & 7;
      const int4 v = __ldg(reinterpret_cast<const int4*>(cb + (size_t)(n0 + row) * K + k0) + ch);
      *reinterpret_cast<int4*>(Bs + row * kLd + ch * 16) = v;
    }
    // activations: 16 * kMT rows x 128 values, quantized 8 at a time
#pragma unroll
    for (int p = 0; p < 2 * kMT; ++p) {
      const int idx = tid + p * kThreads, row = idx >> 4, ch = idx & 15;
      uint2 w = make_uint2(0u, 0u);
      if (row < M) {
        const size_t base = (size_t)row * K + k0 + ch * 8;
        float v[8];
        if (x_bf16) {
          const int4 raw = __ldg(reinterpret_cast<const int4*>(
              reinterpret_cast<const __nv_bfloat16*>(x) + base));
          const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
        } else {
          const float4* src = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + base);
          const float4 a = __ldg(src), b = __ldg(src + 1);
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        }
        const float f = inv[row];
        w = make_uint2(quant4(v, f), quant4(v + 4, f));
      }
      *reinterpret_cast<uint2*>(As + row * kLd + ch * 8) = w;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t b[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int8_t* base = Bs + (warp * 16 + ni * 8 + gid) * kLd + ks + t4 * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int8_t* base = As + (mi * 16 + gid) * kLd + ks + t4 * 4;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(base),
                               *reinterpret_cast<const uint32_t*>(base + 8 * kLd),
                               *reinterpret_cast<const uint32_t*>(base + 16),
                               *reinterpret_cast<const uint32_t*>(base + 8 * kLd + 16)};
        mma_s8(acc[mi][0], a, b[0]);
        mma_s8(acc[mi][1], a, b[1]);
      }
    }
  }

  // this split's int32 sums: part[split, m, n]
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mi * 16 + gid + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + warp * 16 + ni * 8 + t4 * 2 + e;
          part[((size_t)split * M + m) * N + n] = acc[mi][ni][h * 2 + e];
        }
    }
}

// out[m, n] = (float)(sum over s, in order, of part[s, m, n])
//             * ((1 / inv[m]) * (scb[n] * f32(1/127))) (+ bias[n])
__global__ void mm8_epilogue(const int* __restrict__ part, int ksplit, int M, int N,
                             const float* __restrict__ inv, const float* __restrict__ scb,
                             const float* __restrict__ bias, void* out, int out_bf16) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  int acc = part[i];
  for (int s = 1; s < ksplit; ++s) acc += part[(size_t)s * MN + i];
  const int m = (int)(i / N), n = (int)(i % N);
  const float scale = __fmul_rn(__fdiv_rn(1.0f, inv[m]), __fmul_rn(scb[n], (float)(1.0 / 127.0)));
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  st_f(out, i, v, out_bf16);
}

}  // namespace

// x (M, K) f32/bf16; inv (M) f32; cb (N, K) int8; scb (N) f32; bias (N) f32
// or null; part (ksplit, M, N) int32 scratch; out (M, N) f32/bf16.
// 1 <= M <= 128, N % 64 == 0, K % 128 == 0.
extern "C" int int8_matmul(const void* x, const void* inv, const void* cb, const void* scb,
                           const void* bias, void* part, void* out, int M, int N, int K,
                           int ksplit, int x_bf16, int out_bf16, void* stream) {
  if (M < 1 || M > 128 || N % kBN || K % kBK || ksplit < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int steps = K / kBK;
  const int per = (steps + ksplit - 1) / ksplit;
  dim3 grid(N / kBN, ksplit);
  auto* iv = reinterpret_cast<const float*>(inv);
  auto* w = reinterpret_cast<const int8_t*>(cb);
  auto* p = reinterpret_cast<int*>(part);
  const int mt = (M + 15) / 16;
  if (mt == 1) {
    mm8_kernel<1><<<grid, kThreads, 0, st>>>(x, x_bf16, iv, w, p, M, N, K, per);
  } else if (mt == 2) {
    mm8_kernel<2><<<grid, kThreads, 0, st>>>(x, x_bf16, iv, w, p, M, N, K, per);
  } else if (mt <= 4) {
    mm8_kernel<4><<<grid, kThreads, 0, st>>>(x, x_bf16, iv, w, p, M, N, K, per);
  } else {
    mm8_kernel<8><<<grid, kThreads, 0, st>>>(x, x_bf16, iv, w, p, M, N, K, per);
  }
  const size_t MN = (size_t)M * N;
  mm8_epilogue<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      p, ksplit, M, N, iv, reinterpret_cast<const float*>(scb),
      reinterpret_cast<const float*>(bias), out, out_bf16);
  return (int)cudaGetLastError();
}
