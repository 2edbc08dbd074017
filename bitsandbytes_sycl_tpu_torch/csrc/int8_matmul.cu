// Kernel I: fused LLM.int8 matmul of up to 128 rows, one launch.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_int8.py `_mm8_kernel` (called
// through `_int8_matmul_call` and `int8_matmul_fused`).
//
// Computes out[m, n] = (float)(sum_k xq[m, k] * cb[n, k])
//                      * ((1 / inv[m]) * (scb[n] * f32(1/127))) (+ bias[n])
// with xq = clip(rint(x * inv), +-127) quantized in the kernel (rint: half
// to even, as the JAX package's round). The int32 sum is exact (127 * 127 *
// K < 2^31 up to K ~ 133k) in any order and any split of K, and the
// epilogue keeps the JAX order with rounded operations (__fdiv_rn/__fmul_rn
// cannot be contracted into an FMA), so the result is the plain version's
// bit for bit.
//
// Bound on the H100: memory. At <= 128 rows the N x K int8 weight read
// (16.8 MB at 4096 x 4096) outweighs 2 M N K int8 operations at 1979 TOPS.
//
// Design: the weight is the wide side of the product. A CTA of one
// warpgroup owns 128 output columns (two 64-row A tiles of CB, which is
// already K-major) and one K split. The plan (`ops/matmul_int8.int8_plan`)
// also sets the K bytes a stage and the ring's shared-memory budget. One
// thread's TMA copies bring each K stage of the weight and of x into a
// ring of 3-12 slots on mbarriers (as many as fit the budget: an SM where
// the grid has one CTA per SM, about half of one where two share it),
// issued before anything else:
// - the weight as 128-row boxes of 128 bytes with the 128-byte swizzle at
//   X = 8 (two boxes a stage, 256 bytes, where the grid has one CTA per
//   SM, halving the loop's fixed cost a stage), of 64 bytes with the
//   64-byte swizzle above, where x's stages take the room;
// - x as boxes of X rows x 128 bytes with the 128-byte swizzle; rows past
//   M read as zeros.
// The warpgroup quantizes a stage's x rows once, from shared memory into
// the slot's B operand (the no-swizzle core-matrix layout of wgmma.cuh),
// while the products of the stage before run: wgmma.m64nXk32.s32.s8.s8
// with X = M rounded up to a width wgmma takes for s8 (8, 16, 24, 32, 48,
// 64, 80, 96, 112, 128), so M = 4 computes 8 rows, not the 16 of an
// m16n8k32 A fragment. The quantization rounds with full-rate float adds
// (a clamped product plus 1.5 * 2^23), not the quarter-rate conversions.
// A slot is reloaded once every warp has passed the wgmma.wait_group of
// its stage (a barrier between the two). K splits store their exact int32 sums in a scratch and
// take a fenced ticket per column tile; the last CTA adds the other
// splits' sums, applies the epilogue, writes out and sets the ticket back
// to 0. Without a split the epilogue runs from the accumulators. One
// launch per call.
//
// The BNB_PROBE_* macros (NO_COPY in wgmma.cuh, NO_MMA, NO_QUANT,
// NO_MERGE) switch one part off for `chip_smoke.py --probe int8`; those
// builds compute wrong results.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBN = 128;       // output columns per CTA: two 64-row A tiles
constexpr int kThreads = 128;  // one warpgroup
constexpr int kMaxSlots = 12;
constexpr int kSmemMax = 227 * 1024 - 2048;  // dynamic shared memory a CTA may take

// d (64 x X s32, this thread's X / 2) += A (64 x 32 s8) * B (32 x X s8),
// both K-major, from shared memory
template <int X>
__device__ __forceinline__ void wgmma_s8(int (&d)[X / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<8>(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<24>(int (&d)[12], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, %12, %13, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<48>(int (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<80>(int (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<96>(int (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<112>(int (&d)[56], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %58, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n112k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void acc_fence_n(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// clip(rint(x * f), +-127) in the low byte: the clamped product plus
// 1.5 * 2^23 rounds half to even to an integer whose two's complement is
// the sum's low mantissa byte
__device__ __forceinline__ uint32_t q8_bits(float x, float f) {
  const float v = fminf(fmaxf(__fmul_rn(x, f), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// the weight CB (N, K) in boxes of 128 rows x min(kb, 128) bytes (that
// many bytes' swizzle); x (M, K) in boxes of X rows x 128 bytes (128-byte
// swizzle)
struct Mm8Maps {
  CUtensorMap cb, x;
};

// a slot of kb K bytes: the weight stage, the raw x stage (kb * esz / 128
// boxes), then its int8 codes (X rows x kb bytes, core matrices), 1024-byte
// aligned
__host__ __device__ constexpr int mm8_slot_bytes(int X, int esz, int kb) {
  return (kBN * kb + X * kb * esz + X * kb + 1023) / 1024 * 1024;
}

// the ring's slots in `budget` bytes, 3 to kMaxSlots
__host__ __device__ constexpr int mm8_slots(int X, int esz, int kb, int budget) {
  return budget / mm8_slot_bytes(X, esz, kb) < 3 ? 3
         : budget / mm8_slot_bytes(X, esz, kb) > kMaxSlots ? kMaxSlots
                                                            : budget / mm8_slot_bytes(X, esz, kb);
}

template <int kX, int kKB>
__global__ void __launch_bounds__(kThreads)
mm8_wgmma_kernel(const __grid_constant__ Mm8Maps maps, int x_bf16, const float* __restrict__ inv,
                 const float* __restrict__ scb, const float* __restrict__ bias, void* out,
                 int out_bf16, int* __restrict__ part, int* __restrict__ tickets, int M, int N,
                 int K, int per, int nslots) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ float s_inv[kX], s_rinv[kX];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  // kKB K bytes a stage: weight boxes of kWB bytes a row (the kWB-byte swizzle)
  constexpr int kb = kKB, kWB = kKB < 128 ? kKB : 128, kWBoxes = kKB / kWB;
  const int esz = x_bf16 ? 2 : 4;
  const int slot_bytes = mm8_slot_bytes(kX, esz, kb);
  const int wbytes = kBN * kb, nbox = kb * esz / 128, code_off = wbytes + nbox * kX * 128;
  const int n0 = blockIdx.x * kBN, z = blockIdx.y, ksplit = gridDim.y;
  const int sps = per * 128 / kb;  // stages a split (per 128-byte plan steps)
  const int st0 = z * sps, nst = min(sps, K / kb - st0);  // this split's stages

  // one thread: stage i of this split into slot `slot`
  auto load = [&](int i, int slot) {
    uint8_t* s = smem + slot * slot_bytes;
    uint64_t* bar = &full[slot];
    const int k0 = (st0 + i) * kb;
    mbar_expect_tx(bar, (uint32_t)(wbytes + nbox * kX * 128));
#pragma unroll
    for (int w = 0; w < kWBoxes; ++w) tma_load_2d(s + w * kBN * kWB, &maps.cb, bar, k0 + w * kWB, n0);
    for (int b = 0; b < nbox; ++b) {
      tma_load_2d(s + wbytes + b * kX * 128, &maps.x, bar, k0 + b * (128 / esz), 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < nslots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < nslots && i < nst; ++i) load(i, i);
  }
  for (int r = tid; r < kX; r += kThreads) {
    s_inv[r] = r < M ? inv[r] : 0.0f;
    s_rinv[r] = r < M ? __fdiv_rn(1.0f, inv[r]) : 0.0f;
  }
  // this thread's 4 output columns (acc_row takes two values per A tile):
  // their scales and bias, read while the copies stream
  float sc_n[2][2], bias_n[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 64 * u + acc_row(tid, 2 * h);
      sc_n[u][h] = n < N ? __fmul_rn(__ldg(scb + n), (float)(1.0 / 127.0)) : 0.0f;
      bias_n[u][h] = n < N && bias != nullptr ? __ldg(bias + n) : 0.0f;
    }
  __syncthreads();

  // stage i's x rows as int8 codes: a unit is one 16-byte raw chunk j of
  // box b of row r (chunk j ^ (r % 8) under the swizzle), 16 / esz codes
  // from K byte e0 of the stage into the core-matrix tile (core_offset).
  // Lanes 0-7 of a phase take rows 0-7 of one chunk.
  auto quantize = [&](int slot) {
#ifndef BNB_PROBE_NO_QUANT
    uint8_t* s = smem + slot * slot_bytes;
    const uint8_t* raw = s + wbytes;
    uint8_t* codes = s + code_off;
    constexpr int kGroups = kX / 8;
    const int units = kX * 8 * nbox;
    for (int u = tid; u < units; u += kThreads) {
      const int r8 = u & 7, j = (u >> 3) & 7, rest = u >> 6;
      const int rg = rest % kGroups, b = rest / kGroups, r = 8 * rg + r8;
      const uint4 v = *reinterpret_cast<const uint4*>(raw + b * kX * 128 + r * 128 + ((j ^ r8) << 4));
      const float f = s_inv[r];
      const int e0 = b * (128 / esz) + j * (16 / esz);
      uint8_t* dst = codes + core_offset(r, e0 >> 4, kX) + (e0 & 15);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      if (x_bf16) {
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[2 * e] = q8_bits(__uint_as_float(w[e] << 16), f);
          q[2 * e + 1] = q8_bits(__uint_as_float(w[e] & 0xFFFF0000u), f);
        }
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(low_bytes(q[0], q[1], q[2], q[3]), low_bytes(q[4], q[5], q[6], q[7]));
      } else {
        *reinterpret_cast<uint32_t*>(dst) =
            low_bytes(q8_bits(__uint_as_float(w[0]), f), q8_bits(__uint_as_float(w[1]), f),
                      q8_bits(__uint_as_float(w[2]), f), q8_bits(__uint_as_float(w[3]), f));
      }
    }
#endif
    fence_proxy_async();  // for wgmma's reads of the codes and the slot's next TMA write
  };

  int acc0[kX / 2], acc1[kX / 2];
#pragma unroll
  for (int e = 0; e < kX / 2; ++e) acc0[e] = acc1[e] = 0;
  if (nst > 0) {
    mbar_wait(&full[0], 0);
    quantize(0);
  }
  __syncthreads();
  // A: rows of kWB bytes with the kWB-byte swizzle (descriptor layout 1 for
  // 128, 2 for 64; 8-row groups 8 kWB apart); each k32 32 bytes further
  // in, the next box kBN * kWB bytes on
  constexpr int a_layout = kWB == 128 ? 1 : 2;
  // slots of stages i - 1, i and i + 1, and the mbarrier parity of i + 1
  int prv = nslots - 1, cur = 0, nxt = 1, nph = 0;
  for (int i = 0; i < nst; ++i) {
    const uint8_t* s = smem + cur * slot_bytes;
    acc_fence_n(acc0);
    acc_fence_n(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kb / 32; ++kk) {
      const uint64_t db = gmma_desc(s + code_off + kk * 32 * kX, kX * 16, 128);
      const uint8_t* a = s + (32 * kk / kWB) * kBN * kWB + (32 * kk) % kWB;
#ifndef BNB_PROBE_NO_MMA
      wgmma_s8<kX>(acc0, gmma_desc(a, 16, 8 * kWB, a_layout), db);
      wgmma_s8<kX>(acc1, gmma_desc(a + 64 * kWB, 16, 8 * kWB, a_layout), db);
#else
      (void)db;
#endif
    }
    wgmma_commit();
    if (i + 1 < nst) {  // the next stage's x, while these products run
      mbar_wait(&full[nxt], nph);
      quantize(nxt);
    }
    wgmma_wait<1>();
    acc_fence_n(acc0);
    acc_fence_n(acc1);
    __syncthreads();  // every warp is past stage i - 1's products, and stage i + 1's codes are in
    if (tid == 0 && i >= 1 && i - 1 + nslots < nst) load(i - 1 + nslots, prv);
    prv = cur;
    cur = nxt;
    if (++nxt == nslots) {
      nxt = 0;
      nph ^= 1;
    }
  }
  wgmma_wait<0>();
  acc_fence_n(acc0);
  acc_fence_n(acc1);

  // value e of tile u: row m = acc_col (the wgmma's N), column n0 + 64 u
  // + acc_row, whose scale and bias sit at [u][(e / 2) % 2]
  auto epilogue = [&](int a, int m, int n, int u, int h) {
    float v = __fmul_rn(__int2float_rn(a), __fmul_rn(s_rinv[m], sc_n[u][h]));
    if (bias != nullptr) v = __fadd_rn(v, bias_n[u][h]);
    st_f(out, (size_t)m * N + n, v, out_bf16);
  };
#ifdef BNB_PROBE_NO_MERGE  // chip_smoke.py --probe int8: the split merge switched off
  const bool merge = false;
#else
  const bool merge = ksplit > 1;
#endif
  if (merge) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < kX / 2; ++e) {
        const int m = acc_col(tid, e), n = n0 + 64 * u + acc_row(tid, e);
        if (m < M && n < N) part[((size_t)z * M + m) * N + n] = u ? acc1[e] : acc0[e];
      }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int ticket = atomicAdd(&tickets[blockIdx.x], 1);
      s_last = ticket == ksplit - 1;
      if (s_last) tickets[blockIdx.x] = 0;  // no other CTA of this launch takes it again
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    // the other splits' exact sums added to this one's (any order), all of
    // a split's loads in flight at once
    for (int s2 = 0; s2 < ksplit; ++s2) {
      if (s2 == z) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < kX / 2; ++e) {
          const int m = acc_col(tid, e), n = n0 + 64 * u + acc_row(tid, e);
          if (m < M && n < N) {
            const int v = __ldcg(part + ((size_t)s2 * M + m) * N + n);
            if (u) acc1[e] += v; else acc0[e] += v;
          }
        }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < kX / 2; ++e) {
      const int m = acc_col(tid, e), n = n0 + 64 * u + acc_row(tid, e);
      if (m < M && n < N) epilogue(u ? acc1[e] : acc0[e], m, n, u, (e >> 1) & 1);
    }
}

template <int kX, int kKB>
int launch_mm8_kb(const void* x, int x_bf16, const float* inv, const void* cb, const float* scb,
                  const float* bias, int* part, int* tickets, void* out, int out_bf16, int M, int N,
                  int K, int per, int ksplit, int budget, cudaStream_t st) {
  constexpr int kb = kKB, kWB = kKB < 128 ? kKB : 128;
  const int esz = x_bf16 ? 2 : 4;
  Mm8Maps maps;
  int err = make_tmap_2d_swizzled(&maps.cb, cb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, K, K, kBN, kWB,
                                  kWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0) {
    err = make_tmap_2d_swizzled(&maps.x, x,
                                x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_UINT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                esz, M, K, K, kX, 128 / esz, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err != 0) return err;
  const cudaError_t e = allow_smem_once<mm8_wgmma_kernel<kX, kKB>>(kSmemMax);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kBN - 1) / kBN, ksplit);
  const int nslots = mm8_slots(kX, esz, kb, budget);
  mm8_wgmma_kernel<kX, kKB><<<grid, kThreads, 1024 + nslots * mm8_slot_bytes(kX, esz, kb), st>>>(
      maps, x_bf16, inv, scb, bias, out, out_bf16, part, tickets, M, N, K, per, nslots);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32/bf16, 16-byte aligned; inv (M) f32; cb (N, K) int8, 16-byte
// aligned; scb (N) f32; bias (N) f32 or null; out (M, N) f32/bf16. width:
// the wgmma's N (8, 16, 24, 32, 48, 64, 80, 96, 112 or 128, >= M). Split z
// takes the 128-byte K steps [z per, min((z + 1) per, K / 128)); ksplit =
// ceil(K / 128 / per). kb: K bytes a stage (256 or 128 at width 8, 64
// above; it divides K and per * 128); ring: the ring's shared-memory
// budget in bytes (at most 227 KB less 3 KB). With ksplit > 1, part is an
// int32 scratch of ksplit * M * N and tickets ceil(N / 128) int32
// counters, all 0 (left at 0). 1 <= M <= 128, N % 64 == 0, K % 128 == 0.
extern "C" int int8_matmul(const void* x, const void* inv, const void* cb, const void* scb,
                           const void* bias, void* part, void* tickets, void* out, int M, int N,
                           int K, int width, int per, int ksplit, int kb, int ring, int x_bf16,
                           int out_bf16, void* stream) {
  const int steps = K / 128;
  const bool kb_ok = width == 8 ? kb == 256 || kb == 128 : kb == 64;
  if (M < 1 || M > 128 || width < M || N % 64 || K % 128 || per < 1 ||
      ksplit != (steps + per - 1) / per || (ksplit > 1 && (part == nullptr || tickets == nullptr)) ||
      !kb_ok || K % kb || (per * 128) % kb || ring < 1 || ring > kSmemMax - 1024 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(cb) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* iv = reinterpret_cast<const float*>(inv);
  auto* sc = reinterpret_cast<const float*>(scb);
  auto* b = reinterpret_cast<const float*>(bias);
  auto* p = reinterpret_cast<int*>(part);
  auto* tk = reinterpret_cast<int*>(tickets);
#define BNB_MM8_LAUNCH_KB(X, KB) \
  launch_mm8_kb<X, KB>(x, x_bf16, iv, cb, sc, b, p, tk, out, out_bf16, M, N, K, per, ksplit, ring, st)
#define BNB_MM8_LAUNCH(X) \
  case X:                 \
    return BNB_MM8_LAUNCH_KB(X, 64)
  switch (width) {
    case 8:
      return kb == 256 ? BNB_MM8_LAUNCH_KB(8, 256) : BNB_MM8_LAUNCH_KB(8, 128);
    BNB_MM8_LAUNCH(16);
    BNB_MM8_LAUNCH(24);
    BNB_MM8_LAUNCH(32);
    BNB_MM8_LAUNCH(48);
    BNB_MM8_LAUNCH(64);
    BNB_MM8_LAUNCH(80);
    BNB_MM8_LAUNCH(96);
    BNB_MM8_LAUNCH(112);
    BNB_MM8_LAUNCH(128);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BNB_MM8_LAUNCH
#undef BNB_MM8_LAUNCH_KB
}
