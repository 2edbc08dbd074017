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
// transposed view without a copy. The job is a transpose.
//
// Bound on the H100: memory. It reads K/2 * N packed bytes and the f32
// factors and writes K * N int8 codes, with no reuse.
//
// Tiled body (`dequant_tiled_kernel`: blocksize % 16 == 0, N % 16 == 0):
// a persistent grid (`ops/matmul_w4a8.dequant8_plan`) walks tiles of kR =
// 128 packed rows x 128 columns. One thread's TMA copies
// bring a tile's packed bytes and its factors of both planes into a
// 3-slot mbarrier ring, so the next tiles stream in while one is decoded.
// Per tile the CTA first builds, for each (plane, block, column) of the
// tile, the 16 int8 codes q8(table[i], f) (the codebook on that column's
// grid, rounded as the plain version rounds each element) as 16 bytes in
// shared memory; a warp then owns 16 packed rows, a lane 4 columns, and
// each code is one byte permute of its column's 16 codes by its nibble
// (3 permutes per 4 codes). The codes go transposed into two shared-memory
// out tiles (one per plane, 128 rows of 128 bytes, TMA's 128-byte swizzle,
// double-buffered) and leave by TMA tensor stores, whole rows of 128 bytes
// at (n0, k0) and (n0, K/2 + k0). A lane writes its 4 columns in an order
// rotated by its lane, so a warp's 16-byte stores into the swizzled tile
// are free of bank conflicts. A slot is reloaded once every thread has
// decoded it; an out tile is rewritten once the store of two tiles back
// has read it (`cp.async.bulk.wait_group.read`).
//
// Stride body (`dequant_int8_kernel`, the other shapes): a plain
// elementwise pass. A thread decodes 4 consecutive rows of 4 neighbouring
// columns (one quantization block: bs % 4 == 0) and writes, per column, one
// 4-byte word of 4 consecutive k to the hi half and one to the lo half of
// that column's row.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

__device__ __forceinline__ uint32_t q8(float dec, float f) {
  const float q = fminf(fmaxf(rintf(dec * f), -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)q;
}

// block b's scale of column n: raw f32/bf16, or (kCodes) a compressed code
// decoded as fma(table[code], range, mean) rounded once
// (`ops/common.decode_absmax`). A template parameter, not a test in the
// loop: with the test in the loop the raw scales' grid took 5x as long on
// the H100 (9.9 ms over a 7B prefill's 225 launches, against 2.0)
template <bool kCodes>
__device__ __forceinline__ float col_scale(const void* absmax, int s_bf16, const float* am_s,
                                           const float* am_o, const float* dtab, int nb2, int N,
                                           int b, int n) {
  const size_t i = (size_t)b * N + n;
  if (!kCodes) return ld_f(absmax, i, s_bf16);
  const int pn = (b < nb2 / 2 ? 0 : N) + n;
  return __fmaf_rn(__ldg(dtab + reinterpret_cast<const uint8_t*>(absmax)[i]), am_s[pn], am_o[pn]);
}

// colmax[n] = the column's largest block scale over both planes, and
// f = absmax * (127 * safe_inv(colmax)), each operation rounded as the
// plain version's (`ops/matmul_w4a8._col_grid`); compressed scales are
// decoded here, as the JAX package decodes them before its kernel F
template <bool kCodes>
__global__ void col_grid_kernel(const void* __restrict__ absmax, int s_bf16,
                                const float* __restrict__ am_s, const float* __restrict__ am_o,
                                const float* __restrict__ dtab, int nb2, int N,
                                float* __restrict__ colmax, float* __restrict__ f) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float cm = col_scale<kCodes>(absmax, s_bf16, am_s, am_o, dtab, nb2, N, 0, n);
  for (int b = 1; b < nb2; ++b) {
    cm = fmaxf(cm, col_scale<kCodes>(absmax, s_bf16, am_s, am_o, dtab, nb2, N, b, n));
  }
  colmax[n] = cm;
  const float sc = __fmul_rn(127.0f, cm > 0.0f ? __frcp_rn(cm) : 0.0f);
  for (int b = 0; b < nb2; ++b) {
    f[(size_t)b * N + n] =
        __fmul_rn(col_scale<kCodes>(absmax, s_bf16, am_s, am_o, dtab, nb2, N, b, n), sc);
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

// ---------------------------------------------------------------------------
// tiled body
// ---------------------------------------------------------------------------
constexpr int kTC = 128;    // columns per tile
constexpr int kR = 128;     // packed rows per tile (64 timed equal or slower on the H100)
constexpr int kTSlots = 3;  // ring slots
constexpr int kTSmemMax = 227 * 1024 - 1024;  // dynamic shared memory the tiled body may take

// packed (K/2, N) in boxes of kR x 128; f (2 nbh, N) in boxes of nf x 128;
// the out rows' hi half (N, K/2 at out_t) and lo half (at out_t + K/2),
// row stride K, in boxes of 128 x kR with the 128-byte swizzle
struct DequantMaps {
  CUtensorMap packed, f, out_hi, out_lo;
};

// shared memory of the tiled body: two out buffers of two planes, the
// ring, the code tables, and 1 KB to align to
__host__ __device__ constexpr size_t tiled_smem_bytes(int nf) {
  return 1024 + 4 * (size_t)kTC * kR + kTSlots * ((size_t)kTC * kR + 2 * nf * kTC * 4) +
         2 * (size_t)nf * kTC * 16;
}

// the byte rint(clip(dec * f, +-127)) as q8 gives it, in the low byte: a
// clamped value plus 1.5 * 2^23 rounds half to even to an integer whose
// two's complement is the sum's low mantissa byte
__device__ __forceinline__ uint32_t q8_bits(float dec, float f) {
  const float v = fminf(fmaxf(__fmul_rn(dec, f), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(v, 12582912.0f));
}

__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// byte k of the result = byte nibble_k of t (the 16 codes of a column) for
// the four nibbles in the low 16 bits of sel: codes 0-7 from t.x:t.y and
// 8-15 from t.z:t.w, then bit 3 of each nibble picks between the two
__device__ __forceinline__ uint32_t decode4(uint32_t sel, uint4 t) {
  const uint32_t idx = sel & 0x7777u;
  const uint32_t pick = ((sel >> 1) & 0x4444u) | 0x3210u;
  return __byte_perm(__byte_perm(t.x, t.y, idx), __byte_perm(t.z, t.w, idx), pick);
}

__global__ void __launch_bounds__(2 * kR)
dequant_tiled_kernel(const __grid_constant__ DequantMaps maps, int N, int half, int bs, int nf,
                     TableF16 table) {
  constexpr int kThreads = 2 * kR, kTile = kTC * kR;  // kR / 16 warps; tile bytes per plane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* outb = smem;  // [2 buffers][2 planes][128 rows][kR bytes], swizzled
  uint8_t* ring = smem + 4 * kTile;
  const int fbytes = 2 * nf * kTC * 4, slot_bytes = kTile + fbytes;
  uint4* tables = reinterpret_cast<uint4*>(ring + kTSlots * slot_bytes);  // [2][nf][128]
  __shared__ __align__(8) uint64_t full[kTSlots];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbh = half / bs, ntn = (N + kTC - 1) / kTC;
  const int ntiles = (half + kR - 1) / kR * ntn;
  const int my = (int)blockIdx.x < ntiles ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;

  // one thread: this CTA's tile number it into slot it % kTSlots
  auto load = [&](int it) {
    const int t = blockIdx.x + it * gridDim.x, j0 = t / ntn * kR, n0 = t % ntn * kTC;
    uint8_t* s = ring + (it % kTSlots) * slot_bytes;
    uint64_t* bar = &full[it % kTSlots];
    mbar_expect_tx(bar, (uint32_t)(kTile + fbytes));
    tma_load_2d(s, &maps.packed, bar, n0, j0);
    tma_load_2d(s + kTile, &maps.f, bar, n0, j0 / bs);
    tma_load_2d(s + kTile + fbytes / 2, &maps.f, bar, n0, nbh + j0 / bs);
  };
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kTSlots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < kTSlots && i < my; ++i) load(i);
  }
  __syncthreads();

  for (int it = 0; it < my; ++it) {
    const int t = blockIdx.x + it * gridDim.x, j0 = t / ntn * kR, n0 = t % ntn * kTC;
    const uint8_t* s = ring + (it % kTSlots) * slot_bytes;
    mbar_wait(&full[it % kTSlots], (it / kTSlots) & 1);
#ifndef BNB_PROBE_NO_DECODE  // chip_smoke.py --probe int8: tables and decode switched off
    // the codebook on each (plane, block, column) grid of the tile: entry
    // (p * nf + b) * 128 + n, as the f boxes lie
    const float* fs = reinterpret_cast<const float*>(s + kTile);
    for (int idx = tid; idx < 2 * nf * kTC; idx += kThreads) {
      const float f = fs[idx];
      uint32_t q[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) q[i] = q8_bits(table.v[i], f);
      tables[idx] = make_uint4(low_bytes(q[0], q[1], q[2], q[3]), low_bytes(q[4], q[5], q[6], q[7]),
                               low_bytes(q[8], q[9], q[10], q[11]),
                               low_bytes(q[12], q[13], q[14], q[15]));
    }
#endif
    __syncthreads();  // tables built; this out buffer's last store has read it (thread 0 waited)

#ifndef BNB_PROBE_NO_DECODE
    // warp: packed rows 16 w .. 16 w + 15 of the tile; lane: columns 4 l .. 4 l + 3.
    // Byte c of xh[i] holds column c's codes of rows 2i (low nibble) and
    // 2i + 1 (high nibble) in the hi plane, of xl[i] in the lo plane.
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(s) + 16 * warp * (kTC / 4) + lane;
    uint32_t xh[8], xl[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t a = pw[2 * i * (kTC / 4)], b = pw[(2 * i + 1) * (kTC / 4)];
      xh[i] = ((a >> 4) & 0x0F0F0F0Fu) | (b & 0xF0F0F0F0u);
      xl[i] = (a & 0x0F0F0F0Fu) | ((b << 4) & 0xF0F0F0F0u);
    }
    // the 16 rows lie in one quantization block (bs % 16 == 0)
    const int blk = (j0 + 16 * warp) / bs - j0 / bs;
    uint8_t* ob = outb + (it & 1) * 2 * kTile;
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      // the lanes of each 8-lane store phase take all four columns and
      // both lane parities, so their rows cover every bank of the swizzle
      const int c = (step + (lane >> 1)) & 3, n = 4 * lane + c;
      const uint32_t pick_c = (uint32_t)(c | ((c + 4) << 4));
      const int chunk = warp ^ (n & 7);  // the 128-byte swizzle
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint4 tb = tables[(p * nf + blk) * kTC + n];
        const uint32_t* x = p ? xl : xh;
        uint4 o;
        o.x = decode4(__byte_perm(x[0], x[1], pick_c), tb);
        o.y = decode4(__byte_perm(x[2], x[3], pick_c), tb);
        o.z = decode4(__byte_perm(x[4], x[5], pick_c), tb);
        o.w = decode4(__byte_perm(x[6], x[7], pick_c), tb);
        *reinterpret_cast<uint4*>(ob + p * kTile + n * kR + chunk * 16) = o;
      }
    }
    fence_proxy_async();
#endif
    __syncthreads();  // the slot is read and the out tile written
    if (tid == 0) {
      const uint8_t* ob = outb + (it & 1) * 2 * kTile;
      tma_store_2d(&maps.out_hi, ob, j0, n0);
      tma_store_2d(&maps.out_lo, ob + kTile, j0, n0);
      bulk_commit();
      if (it + kTSlots < my) load(it + kTSlots);
      bulk_wait_read<1>();  // the other out buffer, written next, has been read
    }
  }
  if (tid == 0) bulk_wait<0>();
}

int launch_tiled(const void* packed, const void* f, void* out_t, int K, int N, int bs, int grid,
                 const TableF16& tbl, cudaStream_t st) {
  const int half = K / 2;
  // blocks a tile's rows can touch: R / bs aligned, else one more
  const int nf = bs >= kR ? (bs % kR ? 2 : 1) : (kR % bs ? (kR - 1) / bs + 2 : kR / bs);
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  DequantMaps maps;
  int err = make_tmap_2d(&maps.packed, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, N, N, kR,
                         kTC, false);
  if (err == 0) {
    err = make_tmap_2d(&maps.f, f, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / bs, N, N, nf, kTC, false);
  }
  if (err == 0) {
    err = make_tmap_2d_swizzled(&maps.out_hi, out_t, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, half, K,
                                kTC, kR, sw);
  }
  if (err == 0) {
    err = make_tmap_2d_swizzled(&maps.out_lo, reinterpret_cast<int8_t*>(out_t) + half,
                                CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, N, half, K, kTC, kR, sw);
  }
  if (err != 0) return err;
  const size_t shmem = tiled_smem_bytes(nf);
  if (shmem > kTSmemMax) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem_once<dequant_tiled_kernel>(kTSmemMax);
  if (e != cudaSuccess) return (int)e;
  dequant_tiled_kernel<<<grid, 2 * kR, shmem, st>>>(maps, N, half, bs, nf, tbl);
  return (int)cudaGetLastError();
}

}  // namespace

// packed (K/2, N) uint8; f (2, K/(2 bs), N) f32; out_t (N, K) int8.
// table: the 16 decoded values (f32) on the host. grid > 0 runs the tiled
// body on `grid` CTAs (bs % 16 == 0, N % 16 == 0); grid 0 the stride body.
extern "C" int dequant_int8(const void* packed, const void* f, void* out_t, const void* table,
                            int K, int N, int bs, int grid, void* stream) {
  if (K <= 0 || N <= 0 || N % 4 || bs <= 0 || bs % 4 || K % (2 * bs)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  if (grid != 0) {
    if (bs % 16 || N % 16 || grid < 0) return (int)cudaErrorInvalidValue;
    return launch_tiled(packed, f, out_t, K, N, bs, grid, tbl, st);
  }
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
// Compressed scales: absmax holds the uint8 codes, am_s and am_o the
// (2, 1, N) f32 range and mean, dtab the 256 signed dynamic-map values on
// the card (all null for raw scales).
extern "C" int col_grid(const void* absmax, void* colmax, void* f, int nb2, int N, int s_bf16,
                        const void* am_s, const void* am_o, const void* dtab, void* stream) {
  if (nb2 <= 0 || nb2 % 2 || N <= 0 || (am_s != nullptr && (am_o == nullptr || dtab == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = am_s != nullptr ? col_grid_kernel<true> : col_grid_kernel<false>;
  kernel<<<(N + 255) / 256, 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      absmax, s_bf16, reinterpret_cast<const float*>(am_s), reinterpret_cast<const float*>(am_o),
      reinterpret_cast<const float*>(dtab), nb2, N, reinterpret_cast<float*>(colmax),
      reinterpret_cast<float*>(f));
  return (int)cudaGetLastError();
}
