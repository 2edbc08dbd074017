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
// column-grid kernel (`col_grid`, dequant_int8.cu), which kernel F's route
// also runs. The int32 sum is exact (127 * 127 * K < 2^31 up to K ~ 133k) in
// any order and any split of K, and the epilogue keeps the JAX package's
// order with rounded multiplies (__fmul_rn cannot be contracted into an
// FMA), so the result is the plain version's bit for bit.
//
// Bound on the H100: int8 operations. It serves 257-4095 rows, where 2 M N K
// operations over 1979 TOPS exceed the bytes over 3.35 TB/s; the regrid
// (about eight instructions per weight element) is the work that competes
// with the products.
//
// wgmma body (`grouped_wgmma_kernel`; half-K a multiple of 64, blocksize a
// multiple of 16): warp-specialized. A CTA owns a 256-row by 128-column
// tile. Two producer warpgroups (72 registers a thread, `setmaxnreg`): one
// thread issues TMA copies of each 64-deep K step's int8 activation tile
// (64-byte swizzle, read by wgmma as it lands), the packed weight bytes and
// the step's factors f into a 4-slot ring two steps ahead, completing on
// the slot's `loaded` mbarrier; all of them then regrid the weight slice
// into the slot as a K-major int8 tile and arrive on its `full` mbarrier.
// Two consumer warpgroups (184 registers) each run 2 x 2 wgmma m64n128k32
// s8 on their 128 rows and release the slot on its `empty` mbarrier when
// their products are done, so the regrid of one step overlaps the products
// of the one before. Each regrid serves 256 rows (16 times per weight
// element at 2048 rows in the mma.sync body, 8 here). The plan's K splits
// (ranges of whole quantization blocks, the same range in both planes)
// write int32 partials that a second kernel sums and scales; without a
// split the epilogue runs in the kernel.
//
// mma.sync body (`grouped_kernel`, the other shapes, e.g. blocksize 32 at
// K = 1088 or blocksize 8): one block of 8 warps per 128 x 128 output
// tile; the K loop walks the hi plane then the lo plane, 64 rows at a
// time, and masks a plane's ragged last step. Each step stages the
// activation tile and the regridded weight slice (column-major, rows of 80
// bytes, conflict-free) in shared memory with plain loads, then each warp
// issues mma.sync.m16n8k32 on its 64 x 32 sub-tile.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

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

// clip(rint(code * g), +-127) as a byte: cvt.rni rounds half to even, and
// clamping the integer equals clamping rint's float (it saturates past 2^31)
__device__ __forceinline__ uint32_t regrid(float code, float g) {
  return (uint32_t)max(-127, min(127, __float2int_rn(__fmul_rn(code, g)))) & 0xFFu;
}

// the epilogue, in the JAX order: (acc * (colmax * 1/127)) * (row_absmax / 127) + bias
__device__ __forceinline__ float grouped_out(int acc, int m, int n, const float* colmax,
                                             const float* row_absmax, const float* bias) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(colmax[n], 1.0f / 127.0f));
  v = __fmul_rn(v, __fdiv_rn(row_absmax[m], 127.0f));
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  return v;
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

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + mi * 16 + gid + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + t4 * 2 + e;
          st_f(out, (size_t)m * N + n,
               grouped_out(acc[mi][ni][h * 2 + e], m, n, colmax, row_absmax, bias), out_bf16);
        }
    }
}


// ---------------------------------------------------------------------------
// wgmma body
// ---------------------------------------------------------------------------
constexpr int kWBM = 256, kWBN = 128, kWK = 64, kWStages = 4;
constexpr int kWAhead = 2;  // steps the producers load ahead of the one they regrid (<= kWStages - 2)
constexpr int kWProd = 2;   // producer warpgroups
constexpr int kWA = kWBM * kWK;         // int8 activation tile bytes
constexpr int kWP = kWK * kWBN;         // packed bytes
constexpr int kWF = 4 * kWBN * 4;       // f rows (<= 4 blocks per step, f32)
constexpr int kWB = kWBN * kWK;         // regridded weight tile bytes
constexpr int kWSlot = kWA + kWP + kWF + kWB;
constexpr int kWSmem = 1024 + kWStages * kWSlot;
constexpr int kWPT = 128 * kWProd;      // producer threads
constexpr int kWThreads = 256 + kWPT;   // consumer warpgroups 0-1, then the producers
constexpr int kWRows = kWK / (4 * kWProd);  // K rows of one regrid item: 8

// xq (M, K) int8 in boxes of 64 x 256 (64-byte swizzle), packed (K/2, N) in
// boxes of 128 x 64, f (2 nbh, N) in boxes of 128 x frows
struct GroupedMaps {
  CUtensorMap xq, packed, f;
};


__global__ void __launch_bounds__(kWThreads, 1)
grouped_wgmma_kernel(const __grid_constant__ GroupedMaps maps, const float* __restrict__ colmax,
                     const float* __restrict__ row_absmax, const float* __restrict__ bias,
                     void* __restrict__ out, int* __restrict__ part, int out_bf16, int M, int N,
                     int K, int bs, int per, TableF16 table) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  __shared__ __align__(8) uint64_t loaded[kWStages], full[kWStages], empty[kWStages];
  __shared__ float code[16];
  const int tid = threadIdx.x;
  if (tid < 16) code[tid] = table.v[tid];
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], kWPT);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n0 = blockIdx.x * kWBN, m0 = blockIdx.y * kWBM;
  const int half = K / 2, nbh = half / bs;
  const int total = half / kWK, s0 = blockIdx.z * per;
  const int n = min(per, total - s0), steps = 2 * n;  // hi plane's steps, then lo's

  if (tid >= 256) {
    // ---- producer warpgroups: one thread's TMA copies kWAhead steps ahead,
    // everyone's regrid
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    const int t = tid - 256;
    const int frows = bs >= kWK ? 1 : kWK / bs;
    const float inv127 = 1.0f / 127.0f;
    for (int i = 0; i < steps + kWAhead; ++i) {
      if (i < steps && t == 0) {
        const int slot = i % kWStages, plane = i / n, j0 = (s0 + i % n) * kWK;
        if (i >= kWStages) mbar_wait(&empty[slot], ((i / kWStages) - 1) & 1);
        uint8_t* base = smem + slot * kWSlot;
        mbar_expect_tx(&loaded[slot], kWA + kWP + frows * kWBN * 4);
        tma_load_2d(base, &maps.xq, &loaded[slot], plane * half + j0, m0);
        tma_load_2d(base + kWA, &maps.packed, &loaded[slot], n0, j0);
        tma_load_2d(base + kWA + kWP, &maps.f, &loaded[slot], n0, plane * nbh + j0 / bs);
      }
      if (i >= kWAhead) {
        const int k = i - kWAhead, slot = k % kWStages, shift = k < n ? 4 : 0;
        mbar_wait(&loaded[slot], (k / kWStages) & 1);
        uint8_t* base = smem + slot * kWSlot;
#ifndef BNB_PROBE_NO_REGRID  // chip_smoke.py --probe: the regrid switched off
        const int col4 = t & 31, kq = t >> 5;  // 4 columns x kWRows rows of K
        uint32_t w[kWRows];
#pragma unroll
        for (int r = 0; r < kWRows; ++r) {
          w[r] = *reinterpret_cast<const uint32_t*>(base + kWA + (kWRows * kq + r) * kWBN + 4 * col4);
        }
        const int fr = bs >= kWK ? 0 : (kWRows * kq) / bs;
        const float4 fv = *reinterpret_cast<const float4*>(base + kWA + kWP + fr * (kWBN * 4) + 16 * col4);
        const float g4[4] = {__fmul_rn(fv.x, inv127), __fmul_rn(fv.y, inv127),
                             __fmul_rn(fv.z, inv127), __fmul_rn(fv.w, inv127)};
        const int rot = col4 >> 1;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int c = (cc + rot) & 3;  // by lane, so each 8-lane phase covers all banks
          const float g = c == 0 ? g4[0] : c == 1 ? g4[1] : c == 2 ? g4[2] : g4[3];
          uint32_t q[2];
#pragma unroll
          for (int wd = 0; wd < 2; ++wd) {
            uint32_t word = 0;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              word |= regrid(code[(w[4 * wd + r] >> (8 * c + shift)) & 15], g) << (8 * r);
            }
            q[wd] = word;
          }
          // 8 K rows: one half of a core matrix row
          *reinterpret_cast<uint2*>(base + kWA + kWP + kWF + core_offset(4 * col4 + c, kq / 2, kWBN) +
                                    8 * (kq & 1)) = make_uint2(q[0], q[1]);
        }
#endif
        fence_proxy_async();
        mbar_arrive(&full[slot]);
      }
    }
  } else {
    // ---- consumer warpgroups: rows 128 * wg .. + 127 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 184;\n" ::: "memory");
    const int wg = tid >> 7, t = tid & 127;
    int acc0[64], acc1[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc0[e] = acc1[e] = 0;
    for (int k = 0; k < steps; ++k) {
      const int slot = k % kWStages;
      mbar_wait(&full[slot], (k / kWStages) & 1);
      const uint8_t* base = smem + slot * kWSlot;
      acc_fence(acc0);
      acc_fence(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t db = gmma_desc(base + kWA + kWP + kWF + core_offset(0, 2 * kk, kWBN), kWBN * 16, 128);
        // rows of 64 bytes, 64-byte swizzle; the second k32 32 bytes in
#ifndef BNB_PROBE_NO_MMA
        wgmma_s8_n128(acc0, gmma_desc(base + (wg * 128) * kWK + 32 * kk, 16, 512, 2), db);
        wgmma_s8_n128(acc1, gmma_desc(base + (wg * 128 + 64) * kWK + 32 * kk, 16, 512, 2), db);
#else
        (void)db;
#endif
      }
      wgmma_commit();
      wgmma_wait<1>();
      acc_fence(acc0);
      acc_fence(acc1);
      if (k >= 1) mbar_arrive(&empty[(k - 1) % kWStages]);
    }
    wgmma_wait<0>();
    acc_fence(acc0);
    acc_fence(acc1);
    const bool direct = gridDim.z == 1;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int a = u ? acc1[e] : acc0[e];
        const int m = m0 + wg * 128 + u * 64 + acc_row(t, e), nn = n0 + acc_col(t, e);
        if (m >= M) continue;
        if (direct) {
          st_f(out, (size_t)m * N + nn, grouped_out(a, m, nn, colmax, row_absmax, bias), out_bf16);
        } else {
          part[((size_t)blockIdx.z * M + m) * N + nn] = a;
        }
      }
    }
  }
}

// the K splits' int32 partials summed (exact in any order), then the epilogue
__global__ void grouped_epilogue_kernel(const int* __restrict__ part, int ksplit, int M, int N,
                                        const float* __restrict__ colmax,
                                        const float* __restrict__ row_absmax,
                                        const float* __restrict__ bias, void* out, int out_bf16) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  int acc = part[i];
  for (int s = 1; s < ksplit; ++s) acc += part[(size_t)s * MN + i];
  st_f(out, i, grouped_out(acc, (int)(i / N), (int)(i % N), colmax, row_absmax, bias), out_bf16);
}

}  // namespace

// x (M, K) f32/bf16; packed (K/2, N) uint8; f (2, K/(2 bs), N) f32 and
// colmax (N) f32 from `col_grid`; bias (N) f32 or null; out (M, N)
// f32/bf16. Scratch: xq (M, K) int8, row_absmax (M) f32, part (ksplit, M,
// N) int32 when ksplit > 1. table: the 16 int8 codes as floats on the
// host. body 1 runs the wgmma body with K split into ksplit ranges of
// `per` 64-row steps per plane; body 0 the mma.sync body (ksplit 1).
extern "C" int w4a8_grouped(const void* x, const void* packed, const void* f, const void* colmax,
                            const void* bias, void* out, void* xq, void* row_absmax, void* part,
                            const void* table, int M, int N, int K, int bs, int x_bf16,
                            int out_bf16, int body, int per, int ksplit, void* stream) {
  const int half = K / 2;
  if (M <= 0 || N % kBN || bs <= 0 || bs % 4 || K % (2 * bs) || body < 0 || body > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (body == 1 && (half % kWK || bs % 16 || (bs % kWK && kWK % bs) || per < 1 || ksplit < 1 ||
                    (size_t)ksplit * per < (size_t)(half / kWK) || (ksplit - 1) * per >= half / kWK)) {
    return (int)cudaErrorInvalidValue;
  }
  if (body == 0 && ksplit != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  quant_rows_kernel<<<M, 256, 0, st>>>(x, x_bf16, K, reinterpret_cast<int8_t*>(xq),
                                       reinterpret_cast<float*>(row_absmax));
  const int8_t* q = reinterpret_cast<const int8_t*>(xq);
  const float* fp = reinterpret_cast<const float*>(f);
  const float* cm = reinterpret_cast<const float*>(colmax);
  const float* ra = reinterpret_cast<const float*>(row_absmax);
  const float* bp = reinterpret_cast<const float*>(bias);
  if (body == 1) {
    GroupedMaps maps;
    int err = make_tmap_2d(&maps.xq, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, K, kWBM, kWK, true);
    if (err == 0) {
      err = make_tmap_2d(&maps.packed, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, N, N, kWK,
                         kWBN, false);
    }
    if (err == 0) {
      err = make_tmap_2d(&maps.f, f, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / bs, N, N,
                         bs >= kWK ? 1 : kWK / bs, kWBN, false);
    }
    if (err != 0) return err;
    cudaError_t e = cudaFuncSetAttribute(grouped_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(N / kWBN, (M + kWBM - 1) / kWBM, ksplit);
    grouped_wgmma_kernel<<<grid, kWThreads, kWSmem, st>>>(
        maps, cm, ra, bp, out, reinterpret_cast<int*>(part), out_bf16, M, N, K, bs, per, tbl);
    if (ksplit > 1) {
      const size_t MN = (size_t)M * N;
      grouped_epilogue_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
          reinterpret_cast<const int*>(part), ksplit, M, N, cm, ra, bp, out, out_bf16);
    }
    return (int)cudaGetLastError();
  }
  dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  auto kernel = half % kBK ? grouped_kernel<true> : grouped_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(q, reinterpret_cast<const uint32_t*>(packed), fp, cm, ra, bp,
                                    out, out_bf16, M, N, K, bs, tbl);
  return (int)cudaGetLastError();
}
