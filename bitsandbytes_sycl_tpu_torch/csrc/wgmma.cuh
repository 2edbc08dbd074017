// Hopper building blocks shared by the tensor-core bodies of kernels B
// (mm4_fused.cu), G (w4a8_grouped.cu), C (prefill_attn_int8.cu) and I
// (int8_matmul.cu), the split bodies of kernels D (paged_attn_int8.cu) and
// H (decode_attn_int8.cu), the fused body of kernel A (w4a8_gemv.cu) and
// the tiled body of kernel F (dequant_int8.cu): TMA tensor and bulk copies
// and TMA tensor stores, mbarriers, shared-memory matrix descriptors and
// the warpgroup products they use, and the cluster barrier and distributed
// shared memory accesses of C's and H's widest head dims (and of kernel K's
// resident body, optim8_1state.cu), written as inline PTX for sm_90a.
//
// Operand layouts in shared memory, both K-major:
// - activations arrive by TMA as rows of 64 bytes with the 64-byte swizzle
//   (descriptor layout 2, 8-row groups 512 bytes apart); a wgmma 32 bytes
//   further along K starts 32 bytes further in; with the 128-byte swizzle
//   (kernel I's weights) rows are 128 bytes, layout 1, 8-row groups 1024
//   bytes apart, and the same 32-byte step holds;
// - decoded weights are written by threads without swizzle: a tile of R
//   rows by KB bytes of K is stored as 8-row x 16-byte core matrices of 128
//   contiguous bytes, row groups fastest,
//     byte (r, kb) at ((kb / 16) * (R / 8) + r / 8) * 128 + (r % 8) * 16 + kb % 16,
//   so 8-row groups are 128 bytes apart and the two 16-byte K chunks one
//   wgmma reads R * 16 bytes apart.
// One wgmma consumes 32 bytes of K (k16 of bf16, k32 of s8).
//
// The BNB_PROBE_* macros switch one part of a kernel off (the copies here;
// the decode, the regrid or the products in the kernels), for
// `chip_smoke.py --probe`, which times such builds to see what bounds a
// kernel. Their results are wrong; the package's own build defines none.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of row r, 16-byte K chunk c in a tile of R rows
__device__ __forceinline__ int core_offset(int r, int c, int R) {
  return (c * (R / 8) + (r >> 3)) * 128 + (r & 7) * 16;
}

// generic-proxy writes to shared memory (st.shared) made visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// the arrival of the thread that issues a TMA copy, expecting its bytes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
#ifdef BNB_PROBE_NO_COPY  // chip_smoke.py --probe: the copies switched off, no bytes come
  (void)bytes;
  mbar_arrive(bar);
#else
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
#endif
}

// ---- TMA: a box of a 2-D tensor (c0 along the contiguous dimension, c1
// the row) into shared memory, completing on `bar`; rows past the tensor
// read as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1) {
#ifndef BNB_PROBE_NO_COPY
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
#endif
}

// ---- bulk copy: `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from global into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
#ifndef BNB_PROBE_NO_COPY
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#endif
}

// ---- TMA store: a box of shared memory to a 2-D tensor at (c0, c1), in
// the calling thread's bulk group; the box's part past the tensor is not
// written. The threads that wrote the box run fence_proxy_async() and a
// barrier before one thread issues it.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
#ifndef BNB_PROBE_NO_COPY
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_addr(src)), "r"(c0), "r"(c1)
               : "memory");
#endif
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// wait until at most N of this thread's bulk groups are incomplete
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Host: encode a map of the row-major (rows, cols) tensor at `ptr` (row
// stride `ld` elements) read in boxes of (box_rows, box_cols) with the
// given swizzle; 0 or a CUDA error.
static inline int encode_tmap_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                                 int esz, uint64_t rows, uint64_t cols, uint64_t ld, int box_rows,
                                 int box_cols, CUtensorMapSwizzle swizzle) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault);
    if (err != cudaSuccess || fn == nullptr) return err != cudaSuccess ? (int)err : (int)cudaErrorUnknown;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld * (cuuint64_t)esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The same map, from a table of the last maps made, keyed by every
// argument (a map depends on nothing else): a call on the same weight or
// cache as an earlier one costs a lookup, not an encode.
struct TmapKey {
  const void* ptr;
  uint64_t rows, cols, ld;
  int type, esz, box_rows, box_cols, swizzle;
  bool operator==(const TmapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && ld == o.ld && type == o.type &&
           esz == o.esz && box_rows == o.box_rows && box_cols == o.box_cols && swizzle == o.swizzle;
  }
};

static inline int make_tmap_2d_swizzled(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                                        int esz, uint64_t rows, uint64_t cols, uint64_t ld,
                                        int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  constexpr int kSlots = 1024;
  static TmapKey keys[kSlots];
  static CUtensorMap maps[kSlots];
  static std::mutex lock;
  const TmapKey key{ptr, rows, cols, ld, (int)type, esz, box_rows, box_cols, (int)swizzle};
  const size_t slot = ((reinterpret_cast<uintptr_t>(ptr) >> 8) ^ rows ^ (cols << 7) ^
                       ((uint64_t)box_rows << 17) ^ ((uint64_t)swizzle << 29)) % kSlots;
  std::lock_guard<std::mutex> guard(lock);
  if (ptr != nullptr && keys[slot] == key) {
    *map = maps[slot];
    return 0;
  }
  const int err = encode_tmap_2d(map, ptr, type, esz, rows, cols, ld, box_rows, box_cols, swizzle);
  if (err == 0) {
    keys[slot] = key;
    maps[slot] = *map;
  }
  return err;
}

// the same, without swizzle or with the 64-byte one
static inline int make_tmap_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esz,
                               uint64_t rows, uint64_t cols, uint64_t ld, int box_rows,
                               int box_cols, bool swizzle64) {
  return make_tmap_2d_swizzled(map, ptr, type, esz, rows, cols, ld, box_rows, box_cols,
                               swizzle64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the first 1024-byte boundary at or after p in shared memory (TMA's
// swizzled boxes and the descriptors assume it)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---- wgmma
// layout 0: no swizzle; K-major: lbo between K chunks, sbo between 8-row
// groups; MN-major (C's B operands): lbo between 8-deep K groups, sbo
// between 8-wide MN groups (the other assignment faults on the card);
// layout 2: the 64-byte swizzle (sbo between 8-row groups, lbo unused)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo_bytes, int sbo_bytes,
                                              int layout = 0) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;  // base offset 0
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define BNB_ACC64(c)                                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),       \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),       \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31]), c(d[32]), c(d[33]),       \
      c(d[34]), c(d[35]), c(d[36]), c(d[37]), c(d[38]), c(d[39]), c(d[40]), c(d[41]),       \
      c(d[42]), c(d[43]), c(d[44]), c(d[45]), c(d[46]), c(d[47]), c(d[48]), c(d[49]),       \
      c(d[50]), c(d[51]), c(d[52]), c(d[53]), c(d[54]), c(d[55]), c(d[56]), c(d[57]),       \
      c(d[58]), c(d[59]), c(d[60]), c(d[61]), c(d[62]), c(d[63])

#define BNB_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32, this thread's 64) += A (64 x 16 bf16) * B (16 x 128 bf16),
// both from shared memory, both K-major
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " BNB_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : BNB_ACC64("+f")
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

#define BNB_ACC32(c)                                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),       \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),       \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])

#define BNB_REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, this thread's 32) += A (64 x 16 bf16, K-major) * B (16 x
// 64 bf16, MN-major: 8 consecutive N values per 16-byte row of a core
// matrix, its 8 rows the 8 K values), both from shared memory
__device__ __forceinline__ void wgmma_bf16_n64_bmn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BNB_REGS32
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : BNB_ACC32("+f")
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

#define BNB_ACC16(c)                                                                       \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]), \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])

#define BNB_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32 f32, this thread's 16) += A (64 x 16 bf16, K-major) * B (16 x
// 32 bf16, MN-major), both from shared memory, as wgmma_bf16_n64_bmn
__device__ __forceinline__ void wgmma_bf16_n32_bmn(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " BNB_REGS16
      ", %16, %17, p, 1, 1, 0, 1;\n}\n"
      : BNB_ACC16("+f")
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128 f32) += A (64 x 16 bf16, from registers: a[0..3] hold this
// thread's pairs in the layout of an m64nN accumulator's columns 0-15, see
// acc_row / acc_col) * B (16 x 128 bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_bf16_n128_ra_bmn(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " BNB_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : BNB_ACC64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128 s32) += A (64 x 32 s8) * B (32 x 128 s8), both K-major
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " BNB_REGS64 ", %64, %65, p;\n}\n"
      : BNB_ACC64("+r")
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// fence, commit or wait
__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void acc_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Accumulator fragment of m64nN: value i of thread t (0..127 of the
// warpgroup) is row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int t, int i) { return 8 * (i >> 2) + 2 * (t & 3) + (i & 1); }

// ---- thread block clusters (C's cluster body, H's split body past D = 256,
// kernel K's resident body)
// this CTA's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives (releasing its shared
// memory writes) and waits for the others (acquiring theirs)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// p's address in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// 4-byte and 16-byte loads and a 16-byte store at a peer's address
__device__ __forceinline__ void st_peer(uint32_t a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_peer_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ float ld_peer_f(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_peer(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
