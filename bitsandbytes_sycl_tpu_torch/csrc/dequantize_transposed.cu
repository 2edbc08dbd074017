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
// A compressed scale is fma(table[code], range, mean) rounded once
// (`__fmaf_rn`; the table is the port's dynamic-map decode,
// `ops/dynamic8.decode_table`), which is what `ops/common.decode_absmax`
// computes, so the output is bit for bit the plain version's.
//
// Bound on the H100: memory. It reads K/2 * N packed bytes and the scales
// and writes K * N outputs (2 or 4 bytes each), with no reuse; the floor is
// those bytes over 3.35 TB/s. About 80% of the bytes are writes (bf16 out:
// 4 bytes written for every packed byte read).
//
// TMA body (`dequant4_tma_kernel<bf16 out, bf16 product, codes>`, N % 16
// == 0; `ops/matmul_4bit.dequant4_plan` picks its tile, ring depth and
// grid): one body for both scale formats. A persistent grid walks tiles of
// `rows` packed rows (a whole number of quantization blocks, or a part of
// one block) by `cols` columns (128 or 256). One thread's TMA copies bring
// each tile's packed bytes, its 2 x nsr scale rows as they lie (raw f32 or
// bf16 scales, or the codes) and, for codes, the columns' range and mean
// into a ring of `slots` stages, each completing on its own mbarrier, so
// several tiles' bytes are in flight on every SM while one is decoded.
// Codes are decoded once a tile by all threads into shared memory (one
// more barrier). A thread owns 8 columns of a row for bf16 out (4 for f32:
// 16 output bytes a plane either way) and walks the tile's rows with them,
// reading its scales once a scale row; per row one 8- or 4-byte shared
// load and two 16-byte stores, one to each plane, so a warp stores whole
// 512-byte runs. With bf16 out and a table codebook (the prefill's case)
// the decode is byte permutes: 4 nibbles select the bf16 table entries'
// low and high bytes, paired into bf16 pairs and multiplied by the scale
// pairs with one `fma.rn.bf16x2` (a bf16 x bf16 product is exact in f32,
// so this rounds as round_bf16(f32 product) does); the other modes
// multiply in f32. A stage is refilled once every thread has read it.
// Stores are plain 16-byte stores: TMA stores of out tiles staged in shared
// memory timed no faster on the H100 (PERF.md, kernel E's findings).
//
// Unaligned route (N % 16 != 0, rows that TMA cannot address): the bodies
// of the first port, kept for those shapes only. Raw scales
// (`dequant4_unaligned_kernel`): a grid-stride pass, a thread one 4-byte word
// of a packed row and its 2 x 4 scales. Compressed scales
// (`dequant4_unaligned_dq_kernel`): a CTA decodes the codes of a strip of
// 128 columns over `rb` quantization blocks into shared memory once, then
// its warps walk the strip's rows. `BNB_E_OLD_BODIES` sends every shape to
// them, for timing the TMA body beside the bodies it replaced.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// unaligned route
// ---------------------------------------------------------------------------

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

__global__ void dequant4_unaligned_kernel(const uint32_t* __restrict__ packed,
                                          const void* __restrict__ scales, int s_bf16,
                                          void* __restrict__ out, int out_bf16, int bf16_product,
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
dequant4_unaligned_dq_kernel(const uint32_t* __restrict__ packed, const uint8_t* __restrict__ codes,
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

int launch_unaligned(const void* packed, const void* scales, void* out, const TableF16& tbl, int K,
                     int N, int bs, int s_bf16, int out_bf16, int bf16_product, const void* am_scale,
                     const void* am_offset, const void* dtab, cudaStream_t st) {
  const int threads = 256;
  if (am_scale != nullptr) {
    // about 256 packed rows a CTA (at most 32 blocks: 32 KB of decoded
    // scales), so the strip's decode is a small part of its work
    const int nbh = K / 2 / bs, want_rb = (256 + bs - 1) / bs;
    const int rb = want_rb > 32 ? 32 : want_rb > nbh ? nbh : want_rb;
    const int smem = 2 * rb * kDqCols * (int)sizeof(float);
    dim3 grid((N + kDqCols - 1) / kDqCols, (nbh + rb - 1) / rb);
    dequant4_unaligned_dq_kernel<<<grid, threads, smem, st>>>(
        reinterpret_cast<const uint32_t*>(packed), reinterpret_cast<const uint8_t*>(scales),
        reinterpret_cast<const float*>(am_scale), reinterpret_cast<const float*>(am_offset),
        reinterpret_cast<const float*>(dtab), out, out_bf16, bf16_product, K, N, bs, rb, tbl);
    return (int)cudaGetLastError();
  }
  const size_t items = (size_t)(K / 2) * (N / 4);
  const size_t want = (items + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
  dequant4_unaligned_kernel<<<blocks, threads, 0, st>>>(reinterpret_cast<const uint32_t*>(packed),
                                                        scales, s_bf16, out, out_bf16, bf16_product,
                                                        K, N, bs, tbl);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// TMA body (not in the BNB_E_OLD_BODIES build, which runs the unaligned route only)
// ---------------------------------------------------------------------------
#ifndef BNB_E_OLD_BODIES
constexpr int kThreads = 256;
constexpr int kMaxSlots = 8;
constexpr int kSmemMax = 225 * 1024;  // dynamic shared memory a CTA may take (beside ~1.1 KB static)

// packed (K/2, N) in boxes of rows x cols; the scales or codes (2 nbh, N)
// in boxes of nsr x cols; compressed scales' range and mean (2, N) in
// boxes of 2 x cols
struct Deq4Maps {
  CUtensorMap packed, scales, range, mean;
};

// a stage: the packed box, then each plane's scale box (room for f32),
// then for compressed scales both planes' range and mean
__host__ __device__ inline int deq4_slot_bytes(int rows, int cols, int nsr, bool codes) {
  return rows * cols + 2 * nsr * cols * 4 + (codes ? 4 * cols * 4 : 0);
}

// byte k of the result = byte nibble_k of t (16 bytes) for the four
// nibbles in the low 16 bits of sel: bytes 0-7 from t.x:t.y and 8-15 from
// t.z:t.w, then bit 3 of each nibble picks between the two
__device__ __forceinline__ uint32_t lut16_bytes(uint32_t sel, uint4 t) {
  const uint32_t idx = sel & 0x7777u;
  const uint32_t pick = ((sel >> 1) & 0x4444u) | 0x3210u;
  return __byte_perm(__byte_perm(t.x, t.y, idx), __byte_perm(t.z, t.w, idx), pick);
}

// the low nibbles of x's four bytes as four nibbles in the low 16 bits
__device__ __forceinline__ uint32_t nibbles4(uint32_t x) {
  x &= 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0xFFFFu;
}

// a * b on bf16 pairs, each rounded to bf16 once (the exact product of two
// bf16 values fits f32, so this is round_bf16(f32 a * f32 b))
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// a raw scale: element i of a stage's scale box, f32 or (s_bf16) bf16
__device__ __forceinline__ float stage_scale(const uint8_t* s, int i, int s_bf16) {
  return s_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(s)[i])
                : reinterpret_cast<const float*>(s)[i];
}

// kCodes: compressed scales (uint8 codes, their columns' range and mean);
// else raw f32 or (s_bf16) bf16 scales
template <bool kBf16Out, bool kProd, bool kCodes>
__global__ void __launch_bounds__(kThreads, 3)
dequant4_tma_kernel(const __grid_constant__ Deq4Maps maps, void* __restrict__ out,
                    const float* __restrict__ dtab, int K, int N, int bs, int rows, int cols,
                    int slots, int s_bf16, TableF16 table) {
  const int esz = kCodes ? 1 : s_bf16 ? 2 : 4;
  constexpr int kC = kBf16Out ? 8 : 4;  // columns a thread owns: 16 output bytes a plane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ float tbl[16];
  __shared__ float dt[kCodes ? 256 : 1];
  const int tid = threadIdx.x;
  if (tid < 16) tbl[tid] = table.v[tid];
  if constexpr (kCodes) dt[tid] = dtab[tid];

  const int half = K / 2, nbh = half / bs;
  const int nsr = rows >= bs ? rows / bs : 1;  // scale rows a tile touches
  const int pbytes = rows * cols, sbytes = nsr * cols * esz, amoff = pbytes + 2 * nsr * cols * 4;
  const int slot_bytes = deq4_slot_bytes(rows, cols, nsr, kCodes);
  const int ntn = (N + cols - 1) / cols;
  const int ntiles = half / rows * ntn;
  const int my = (int)blockIdx.x < ntiles ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  // compressed scales: the tile's 2 x nsr x cols decoded scales, after the ring
  float* sdec = reinterpret_cast<float*>(ring + slots * slot_bytes);

  // one thread: this CTA's tile number `it` into slot it % slots
  auto load = [&](int it) {
    const int t = blockIdx.x + it * gridDim.x, j0 = t / ntn * rows, n0 = t % ntn * cols;
    uint8_t* s = ring + (it % slots) * slot_bytes;
    uint64_t* bar = &full[it % slots];
    mbar_expect_tx(bar, (uint32_t)(pbytes + 2 * sbytes + (kCodes ? 16 * cols : 0)));
    tma_load_2d(s, &maps.packed, bar, n0, j0);
    tma_load_2d(s + pbytes, &maps.scales, bar, n0, j0 / bs);
    tma_load_2d(s + pbytes + sbytes, &maps.scales, bar, n0, nbh + j0 / bs);
    if constexpr (kCodes) {
      tma_load_2d(s + amoff, &maps.range, bar, n0, 0);
      tma_load_2d(s + amoff + 8 * cols, &maps.mean, bar, n0, 0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < slots && i < my; ++i) load(i);
  }
  __syncthreads();

  const int units = cols / kC;  // threads a row
  const int u = tid % units, rstep = kThreads / units;
  // bf16 out with the bf16 product: the table's bf16 entries, their low
  // bytes and their high bytes 16 to a uint4, looked up by byte permutes
  uint4 tlo = make_uint4(0, 0, 0, 0), thi = tlo;
  if constexpr (kBf16Out && kProd) {
    uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t b = __float_as_uint(table.v[i]) >> 16;  // exact: a bf16 value
      lo[i / 4] |= (b & 0xFFu) << (8 * (i % 4));
      hi[i / 4] |= (b >> 8) << (8 * (i % 4));
    }
    tlo = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    thi = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  }
  for (int it = 0; it < my; ++it) {
    const int t = blockIdx.x + it * gridDim.x, j0 = t / ntn * rows, n0 = t % ntn * cols;
    const uint8_t* s = ring + (it % slots) * slot_bytes;
    mbar_wait(&full[it % slots], (it / slots) & 1);
    if constexpr (kCodes) {  // decode the tile's codes once, each as fma(table, range, mean)
      const float* am = reinterpret_cast<const float*>(s + amoff);
      for (int i = tid; i < 2 * nsr * cols; i += kThreads) {
        const int p = i / (nsr * cols), col = i % cols;
        sdec[i] = __fmaf_rn(dt[s[pbytes + i]], am[p * cols + col], am[(2 + p) * cols + col]);
      }
      __syncthreads();
    }
    const int n = n0 + u * kC;  // N % 16 == 0: a thread's columns lie all in or all out
    if (n < N) {
      float sc[2][kC];
      uint32_t sp[2][kC / 2];  // kProd, bf16 out: the scales as bf16 pairs
      int cur = -1;
      for (int r = tid / units; r < rows; r += rstep) {
        const int sr = r / bs;  // the tile's scale row of packed row r
        if (sr != cur) {  // the thread's 2 x kC scales, once a scale row
          cur = sr;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
#pragma unroll
            for (int c = 0; c < kC; ++c) {
              const int i = (p * nsr + sr) * cols + u * kC + c;
              const float v = kCodes ? sdec[i] : stage_scale(s + pbytes, i, s_bf16);
              sc[p][c] = kProd ? round_bf16(v) : v;
            }
#pragma unroll
            for (int c = 0; c < kC / 2; ++c) sp[p][c] = pack_bf16(sc[p][2 * c], sc[p][2 * c + 1]);
          }
        }
        uint32_t wb[2];  // the thread's kC packed bytes of row r
        if constexpr (kBf16Out) {
          const uint2 w2 = *reinterpret_cast<const uint2*>(s + r * cols + u * kC);
          wb[0] = w2.x;
          wb[1] = w2.y;
        } else {
          wb[0] = wb[1] = *reinterpret_cast<const uint32_t*>(s + r * cols + u * kC);
        }
        uint4 o[2];
#ifdef BNB_PROBE_NO_DECODE  // chip_smoke.py --probe dequant: the packed words stored as they are
        o[0] = o[1] = make_uint4(wb[0], wb[1], wb[0], wb[1]);
#else
        if constexpr (kBf16Out && kProd) {
          // per plane and 4 columns: the entries' low and high bytes by
          // nibble, paired into bf16 pairs, times the scale pairs
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            uint32_t q[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t sel = nibbles4(p == 0 ? wb[h] >> 4 : wb[h]);
              const uint32_t L = lut16_bytes(sel, tlo), H = lut16_bytes(sel, thi);
              q[2 * h] = bf16x2_mul(__byte_perm(L, H, 0x5140), sp[p][2 * h]);
              q[2 * h + 1] = bf16x2_mul(__byte_perm(L, H, 0x7362), sp[p][2 * h + 1]);
            }
            o[p] = make_uint4(q[0], q[1], q[2], q[3]);
          }
        } else {
          float v[2][kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int byte = (wb[c / 4] >> (8 * (c % 4))) & 0xFF;
            const float hi = tbl[byte >> 4], lo = tbl[byte & 15];
            v[0][c] = kProd ? round_bf16(hi * sc[0][c]) : hi * sc[0][c];
            v[1][c] = kProd ? round_bf16(lo * sc[1][c]) : lo * sc[1][c];
          }
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if constexpr (kBf16Out) {
              o[p] = make_uint4(pack_bf16(v[p][0], v[p][1]), pack_bf16(v[p][2], v[p][3]),
                                pack_bf16(v[p][4], v[p][5]), pack_bf16(v[p][6], v[p][7]));
            } else {
              o[p] = make_uint4(__float_as_uint(v[p][0]), __float_as_uint(v[p][1]),
                                __float_as_uint(v[p][2]), __float_as_uint(v[p][3]));
            }
          }
        }
#endif
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#ifdef BNB_PROBE_NO_STORE  // chip_smoke.py --probe dequant: no output (the test never holds)
          if (o[p].x != 0x7f812345u) continue;
#endif
          const size_t row = (size_t)(p * half + j0 + r);
          *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(out) +
                                    (row * N + n) * (kBf16Out ? 2 : 4)) = o[p];
        }
      }
    }
    __syncthreads();  // the slot is read
    if (tid == 0 && it + slots < my) load(it + slots);
  }
}

template <bool kBf16Out, bool kProd, bool kCodes>
int launch_tma(const Deq4Maps& maps, void* out, const void* dtab, int K, int N, int bs, int rows,
               int cols, int slots, int grid, int s_bf16, size_t smem, const TableF16& tbl,
               cudaStream_t st) {
  auto kernel = dequant4_tma_kernel<kBf16Out, kProd, kCodes>;
  const cudaError_t e = allow_smem_once<dequant4_tma_kernel<kBf16Out, kProd, kCodes>>(kSmemMax);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, st>>>(maps, out, reinterpret_cast<const float*>(dtab), K, N, bs,
                                       rows, cols, slots, s_bf16, tbl);
  return (int)cudaGetLastError();
}

template <bool kBf16Out, bool kProd>
int launch_tma_scales(bool codes, const Deq4Maps& maps, void* out, const void* dtab, int K, int N,
                      int bs, int rows, int cols, int slots, int grid, int s_bf16, size_t smem,
                      const TableF16& tbl, cudaStream_t st) {
  return codes ? launch_tma<kBf16Out, kProd, true>(maps, out, dtab, K, N, bs, rows, cols, slots,
                                                   grid, s_bf16, smem, tbl, st)
               : launch_tma<kBf16Out, kProd, false>(maps, out, dtab, K, N, bs, rows, cols, slots,
                                                    grid, s_bf16, smem, tbl, st);
}
#endif  // BNB_E_OLD_BODIES

}  // namespace

// packed (K/2, N) uint8; scales (2, K/(2 bs), N) f32/bf16, or uint8 codes
// when am_scale is given; am_scale and am_offset (2, 1, N) f32 (or null);
// dtab: the 256 signed dynamic-map values (f32, on the card); out (K, N) f32
// or bf16. table: the 16 decoded values (f32) on the host. grid > 0 runs
// the TMA body on `grid` CTAs with tiles of rows x cols and a ring of
// `slots` stages (N % 16 == 0, K/2 % rows == 0, rows a multiple or a
// divisor of bs, cols 128 or 256, packed and scales 16-byte aligned, and
// no bf16 product with f32 out); grid 0 the unaligned route.
// ops/matmul_4bit.dequant4_plan is what picks the route.
extern "C" int dequantize_transposed(const void* packed, const void* scales, void* out,
                                     const void* table, int K, int N, int bs, int s_bf16,
                                     int out_bf16, int bf16_product, int rows, int cols, int slots,
                                     int grid, const void* am_scale, const void* am_offset,
                                     const void* dtab, void* stream) {
  if (K <= 0 || N <= 0 || N % 4 || bs <= 0 || K % (2 * bs) || grid < 0) return (int)cudaErrorInvalidValue;
  if (am_scale != nullptr && (am_offset == nullptr || dtab == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
#ifdef BNB_E_OLD_BODIES  // chip_smoke.py: the bodies the TMA body replaced, every shape
  (void)rows, (void)cols, (void)slots, (void)grid;
  return launch_unaligned(packed, scales, out, tbl, K, N, bs, s_bf16, out_bf16, bf16_product,
                          am_scale, am_offset, dtab, st);
#else
  if (grid == 0) {
    return launch_unaligned(packed, scales, out, tbl, K, N, bs, s_bf16, out_bf16, bf16_product,
                            am_scale, am_offset, dtab, st);
  }
  const int half = K / 2, nbh = half / bs;
  if (N % 16 || rows <= 0 || half % rows || (rows % bs && bs % rows) || (cols != 128 && cols != 256) ||
      slots < 1 || slots > kMaxSlots || (bf16_product && !out_bf16) ||
      ((reinterpret_cast<uintptr_t>(packed) | reinterpret_cast<uintptr_t>(scales) |
        reinterpret_cast<uintptr_t>(am_scale) | reinterpret_cast<uintptr_t>(am_offset)) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int kind = am_scale != nullptr ? 2 : s_bf16 ? 1 : 0;
  const int nsr = rows >= bs ? rows / bs : 1;
  Deq4Maps maps;
  int err = make_tmap_2d(&maps.packed, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, N, N, rows,
                         cols, false);
  if (err == 0) {
    const CUtensorMapDataType type = kind == 2   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                     : kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    err = make_tmap_2d(&maps.scales, scales, type, kind == 2 ? 1 : kind == 1 ? 2 : 4, 2 * nbh, N, N,
                       nsr, cols, false);
  }
  if (err == 0 && kind == 2) {
    err = make_tmap_2d(&maps.range, am_scale, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, N, N, 2, cols,
                       false);
    if (err == 0) {
      err = make_tmap_2d(&maps.mean, am_offset, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2, N, N, 2, cols,
                         false);
    }
  }
  const size_t smem = 1024 + (size_t)slots * deq4_slot_bytes(rows, cols, nsr, kind == 2) +
                      (kind == 2 ? 2 * (size_t)nsr * cols * 4 : 0);
  if (err != 0) return err;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const bool codes = kind == 2;
  if (out_bf16) {
    return bf16_product ? launch_tma_scales<true, true>(codes, maps, out, dtab, K, N, bs, rows, cols,
                                                        slots, grid, s_bf16, smem, tbl, st)
                        : launch_tma_scales<true, false>(codes, maps, out, dtab, K, N, bs, rows,
                                                         cols, slots, grid, s_bf16, smem, tbl, st);
  }
  return launch_tma_scales<false, false>(codes, maps, out, dtab, K, N, bs, rows, cols, slots, grid,
                                         s_bf16, smem, tbl, st);
#endif
}
