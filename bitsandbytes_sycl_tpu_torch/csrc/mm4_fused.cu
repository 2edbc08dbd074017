// Kernel B: exact 4-bit dequant-matmul.
//
// Replaces bitsandbytes_sycl_tpu/ops/matmul_4bit.py `_mm4_kernel` (called
// through `_matmul_4bit_call`), for raw f32/bf16 block scales and for
// compressed ones: uint8 dynamic-map codes with a per-(plane, column) range
// and mean, each scale decoded as fma(table[code], range, mean) rounded once
// (`__fmaf_rn`; the table is the port's dynamic-map decode), which is
// `ops/common.decode_absmax` bit for bit.
//
// Computes out = x[:, :K/2] @ (dec(hi) * s_hi) + x[:, K/2:] @ (dec(lo) * s_lo)
// (+ bias) with f32 accumulation, decoding as the TPU kernel does:
//   mode 2 (bf16 compute, table codebook): bf16(table) * bf16(scale),
//          the product rounded to bf16;
//   mode 0 (f32 table decode) and mode 1 (int4, (7 - (i & 7)) / 7 or
//          -(i & 7) / 7): the f32 product, rounded to bf16 when x is bf16.
//
// Two bodies; the wrapper picks one from the call's dtype and shape
// (`ops/matmul_4bit.mm4_plan`).
//
// Tensor-core body (`mm4_tc_kernel`, bf16 x). Bound on the H100: the weight
// bytes at decode rows, bf16 tensor-core operations (2 M N K / 989 TFLOP/s)
// from a few hundred rows. With bf16 x every decoded weight is a bf16
// value, so the products on the tensor cores are exact and only the f32
// summation order differs from the plain version. A CTA owns a 64 x 128,
// 128 x 128, 128 x 256 or 256 x 128 output tile and walks its share of K
// in steps of 32 packed rows: one load of packed bytes feeds both planes
// (hi nibbles pair with x[:, j], lo nibbles with x[:, K/2 + j]), so a step
// is 64 of K. One thread's TMA copies bring each step's two x planes
// (64-byte swizzle, read by wgmma as they land), the packed bytes and the
// scales into a 4-slot ring two steps ahead, completing on an mbarrier.
// Every thread then decodes the step's weight once per CTA into a bf16
// K-major tile (mode 2 multiplies two table entries by the scale in one
// bf16x2 operation; the column order rotates by lane so that every 8-lane
// phase of a store covers all banks), and each warpgroup issues wgmma
// m64n128k16 on its 64 or 128 rows while the next step is decoded. A
// warpgroup's wgmma_wait proves only its own products done, so the decoded
// tiles rotate through two buffers with one warpgroup (step i overwrites
// step i - 2's tile, which the warpgroup waited for at the end of step
// i - 1) and three with two (step i overwrites step i - 3's tile, which
// every warpgroup waited for before the barrier of step i - 1). The K
// splits write f32 partials that a second kernel sums in a fixed order (no
// atomics). What bounds it now is the decode (PERF.md): the taller the
// tile, the fewer decodes per product.
//
// SIMT body (`mm4_kernel`: f32 x and shapes the tensor-core body does not
// tile). Bound by instruction throughput: the work split of kernel A
// (w4a8_gemv.cu). A thread owns 4 neighbouring columns; each warp takes
// whole quantization blocks (one scale per column and plane per block);
// warps meet in shared memory in a fixed order and the grid's K splits are
// summed in order by a second small kernel. The 16-entry table sits in
// shared memory, where distinct entries fall in distinct banks. It decodes
// the weight again for every 4-row tile. A warp decodes a compressed block's
// scales once, where it would load raw ones, from the dynamic-map table in
// shared memory.
//
// Compressed scales in the tensor-core body: the Pallas kernel decodes the
// n-tile's whole k-invariant strip once into VMEM scratch. Here the f32
// strip would not fit beside the ring: at K = 11008, bs 64 and 128 columns
// it is 2 x 86 x 128 x 4 = 88 KB, and the ring and decoded tiles already
// take 97-225 KB. So a stage's copy brings the step's scale codes (1 byte
// where a raw scale takes 2 or 4) in place of the raw scales, and the
// decode of a step turns each (plane, block, column) code into its f32
// scale where it would load the raw one: one table read and one fma per 8
// decoded weights. The table (1 KB) and the tile's range and mean (16 bytes
// a column) sit in shared memory behind the decoded tiles; the 128 x 256
// tile has no room for them, so the plan does not give it compressed
// weights.
#include <string.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMT = 4;
constexpr int kCols = 128;

template <int kMode>
__device__ __forceinline__ float decode(int code, const float* tbl, float s, int x_bf16) {
  if (kMode == 2) {
    return round_bf16(tbl[code] * s);  // tbl and s already on the bf16 grid
  }
  float v;
  if (kMode == 1) {
    const int mag = code & 7;
    v = (float)((code & 8) ? -mag : 7 - mag) * (1.0f / 7.0f);
  } else {
    v = tbl[code];
  }
  v = v * s;
  return x_bf16 ? round_bf16(v) : v;
}

// a compressed scale: the code's table value times the range plus the mean,
// rounded once
__device__ __forceinline__ float dq_scale(const float* dt, uint8_t code, float range, float mean) {
  return __fmaf_rn(dt[code], range, mean);
}

// am_s, am_o: the (2, 1, N) range and mean of compressed scales (then
// `scales` holds the uint8 codes), or null; dtab: the 256 signed
// dynamic-map values
template <int kMode>
__global__ void __launch_bounds__(32 * kWarps)
mm4_kernel(const void* __restrict__ x, int x_bf16, const uint32_t* __restrict__ packed,
           const void* __restrict__ scales, int s_bf16, const float* __restrict__ am_s,
           const float* __restrict__ am_o, const float* __restrict__ dtab,
           float* __restrict__ part, int M, int N, int K, int bs, int G, TableF16 table) {
  __shared__ float tbl[16];
  __shared__ float dt[256];
  __shared__ float red[kWarps][kMT][kCols];
  if (threadIdx.x < 16) tbl[threadIdx.x] = table.v[threadIdx.x];
  if (am_s != nullptr) dt[threadIdx.x] = dtab[threadIdx.x];  // 256 threads
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kc = blockIdx.y, m0 = blockIdx.z * kMT;
  const int half = K / 2, nbh = half / bs, N4 = N / 4;
  const int col4 = blockIdx.x * (kCols / 4) + lane;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int i = 0; i < G; ++i) {
    const int qb = (kc * G + i) * kWarps + warp;
    if (qb >= nbh) break;
    float sh[4], sl[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const size_t n = (size_t)col4 * 4 + c;
      if (am_s != nullptr) {
        const uint8_t* cd = reinterpret_cast<const uint8_t*>(scales);
        sh[c] = dq_scale(dt, cd[(size_t)qb * N + n], am_s[n], am_o[n]);
        sl[c] = dq_scale(dt, cd[((size_t)nbh + qb) * N + n], am_s[N + n], am_o[N + n]);
      } else {
        sh[c] = ld_f(scales, (size_t)qb * N + n, s_bf16);
        sl[c] = ld_f(scales, ((size_t)nbh + qb) * N + n, s_bf16);
      }
      if (kMode == 2) {
        sh[c] = round_bf16(sh[c]);
        sl[c] = round_bf16(sl[c]);
      }
    }
#pragma unroll 2
    for (int r = 0; r < bs; ++r) {
      const int j = qb * bs + r;
      const uint32_t w = __ldg(packed + (size_t)j * N4 + col4);
      float xh[kMT], xl[kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const bool ok = m0 + m < M;
        const size_t row = (size_t)(ok ? m0 + m : 0) * K;
        xh[m] = ok ? ld_f(x, row + j, x_bf16) : 0.0f;
        xl[m] = ok ? ld_f(x, row + half + j, x_bf16) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int byte = (w >> (8 * c)) & 0xFF;
        const float dh = decode<kMode>(byte >> 4, tbl, sh[c], x_bf16);
        const float dl = decode<kMode>(byte & 15, tbl, sl[c], x_bf16);
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
          acc[m][c] = fmaf(xh[m], dh, acc[m][c]);
          acc[m][c] = fmaf(xl[m], dl, acc[m][c]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMT * kCols; idx += blockDim.x) {
    const int m = idx / kCols, col = idx % kCols;
    if (m0 + m >= M) continue;
    float s = red[0][m][col];
    for (int w = 1; w < kWarps; ++w) s += red[w][m][col];
    part[((size_t)kc * M + m0 + m) * N + (size_t)blockIdx.x * kCols + col] = s;
  }
}


// ---------------------------------------------------------------------------
// tensor-core body
// ---------------------------------------------------------------------------
constexpr int kTcJ = 32;      // packed rows per step (64 of K: 32 hi + 32 lo)
constexpr int kTcStages = 4;  // ring slots of raw operands
constexpr int kTcAhead = kTcStages - 2;  // steps loaded ahead of the one decoded

__host__ __device__ constexpr int tc_slot_bytes(int bm, int bn) {
  return bm * 2 * kTcJ * 2 + kTcJ * bn + 2 * 4 * bn * 4;  // x, packed, scales (<= 4 blocks, f32)
}

// decoded-tile buffers: see the note at the top
__host__ __device__ constexpr int tc_dec_bufs(int wgs) { return wgs > 1 ? 3 : 2; }

// compressed scales: the dynamic-map table and the tile's range and mean
__host__ __device__ constexpr int tc_codes_bytes(bool codes, int bn) {
  return codes ? 256 * 4 + 4 * bn * 4 : 0;
}

__host__ __device__ constexpr int tc_smem_bytes(int wgs, int bm, int bn, bool codes) {
  return 1024 + kTcStages * tc_slot_bytes(bm, bn) + tc_dec_bufs(wgs) * bn * 2 * kTcJ * 2 +
         tc_codes_bytes(codes, bn);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

// two bf16 products, each rounded once: RN(a * b + (-0)) = RN(a * b), the
// value round_bf16(f32(a) * f32(b)) takes (the f32 product of two bf16 is
// exact) wherever that product is not an f32 subnormal
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// x (M, K) bf16 in boxes of 32 x bm (64-byte swizzle), packed (K/2, N) in
// boxes of bn x 32, scales (2 nbh, N) in boxes of bn x srows (f32, bf16 or
// uint8 codes)
struct TcMaps {
  CUtensorMap x, packed, scales;
};

// kWG warpgroups, each on kMS 64-row sub-tiles of the CTA's rows; kCodes:
// compressed scales (am_s, am_o, dtab as in mm4_kernel)
template <int kMode, int kWG, int kMS, int kBN, bool kCodes>
__global__ void __launch_bounds__(128 * kWG)
mm4_tc_kernel(const __grid_constant__ TcMaps maps, int s_bf16, const float* __restrict__ am_s,
              const float* __restrict__ am_o, const float* __restrict__ dtab,
              const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
              float* __restrict__ part, int M, int N, int K, int bs, int per, TableF16 table) {
  constexpr int kBM = 64 * kWG * kMS, kThreads = 128 * kWG, kNH = kBN / 128, kAcc = kMS * kNH;
  constexpr int kXp = kBM * kTcJ * 2, kPk = kTcJ * kBN;  // one plane's x tile, packed bytes
  constexpr int kSlot = tc_slot_bytes(kBM, kBN), kDec = kBN * 2 * kTcJ * 2;
  constexpr int kDecBufs = tc_dec_bufs(kWG);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* dec = smem + kTcStages * kSlot;
  float* dts = reinterpret_cast<float*>(dec + kDecBufs * kDec);  // kCodes: [256] table
  float* side = dts + 256;  // kCodes: range of planes 0, 1, then mean of planes 0, 1 [4][kBN]
  __shared__ float tbl[16];      // decoded table values (modes 0, 1)
  __shared__ uint32_t tb16[16];  // bf16 bits of the table (mode 2)
  __shared__ __align__(8) uint64_t full[kTcStages];

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  if (tid < 16) {
    const float v = table.v[tid];
    tbl[tid] = v;
    tb16[tid] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  if (kCodes) {
    for (int i = tid; i < 256; i += kThreads) dts[i] = dtab[i];
    for (int i = tid; i < 4 * kBN; i += kThreads) {
      const int q = i / kBN, n = n0 + i % kBN;
      side[i] = (q < 2 ? am_s : am_o)[(q & 1) * N + n];
    }
  }
  __syncthreads();
  const int half = K / 2, nbh = half / bs;
  const int total = half / kTcJ, s0 = blockIdx.z * per;
  const int nsteps = min(per, total - s0);
  const int esz = kCodes ? 1 : s_bf16 ? 2 : 4;
  const int srows = bs >= kTcJ ? 1 : kTcJ / bs;  // scale rows per plane and step

  // one thread: step i's x planes, packed rows and scales into its slot
  auto load = [&](int i) {
    const int slot = i % kTcStages, j0 = (s0 + i) * kTcJ, blk0 = j0 / bs;
    uint8_t* base = smem + slot * kSlot;
    mbar_expect_tx(&full[slot], 2 * kXp + kPk + 2 * srows * kBN * esz);
    tma_load_2d(base, &maps.x, &full[slot], j0, m0);
    tma_load_2d(base + kXp, &maps.x, &full[slot], half + j0, m0);
    tma_load_2d(base + 2 * kXp, &maps.packed, &full[slot], n0, j0);
    for (int p = 0; p < 2; ++p) {
      tma_load_2d(base + 2 * kXp + kPk + p * (4 * kBN * 4), &maps.scales, &full[slot], n0,
                  p * nbh + blk0);
    }
  };

  // decode step i into dec[i % kDecBufs]. Item (8-row group g, 4 columns col4,
  // column pair cp): 2 columns x 8 rows x both planes, 16 bytes per column
  // and plane. A warp covers 16 col4 x 2 pairs; the column order rotates
  // with col4 so that each 8-lane phase of a store covers all banks.
  auto decode_step = [&](int i) {
    const uint8_t* ps = smem + (i % kTcStages) * kSlot + 2 * kXp;
    const uint8_t* ss = ps + kPk;
    uint8_t* dd = dec + (i % kDecBufs) * kDec;
    for (int idx = tid; idx < 2 * kBN; idx += kThreads) {
      const int wb = idx >> 5, cp = idx & 1;
      const int col4 = (wb % (kBN / 64)) * 16 + ((idx & 31) >> 1), g = wb / (kBN / 64);
      uint32_t w[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) w[r] = *reinterpret_cast<const uint32_t*>(ps + (8 * g + r) * kBN + 4 * col4);
      const int sr = bs >= kTcJ ? 0 : (8 * g) / bs;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int c = 2 * cp + ((cc + (col4 >> 1)) & 1), n = 4 * col4 + c;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float s;
          if (kCodes) {
            s = dq_scale(dts, ss[p * (4 * kBN * 4) + sr * kBN + n], side[p * kBN + n],
                         side[(2 + p) * kBN + n]);
          } else {
            s = ld_f(ss + p * (4 * kBN * 4), sr * kBN + n, s_bf16);
          }
          const int sh = 8 * c + (p ? 0 : 4);
          uint4 q;
          if (kMode == 2) {
            const uint32_t sb = __bfloat16_as_ushort(__float2bfloat16_rn(s));
            const uint32_t s2 = sb | (sb << 16);
            uint32_t o[4];
#pragma unroll
            for (int h = 0; h < 4; ++h) {
              const uint32_t a = tb16[(w[2 * h] >> sh) & 15], b = tb16[(w[2 * h + 1] >> sh) & 15];
              o[h] = bf16x2_mul(__byte_perm(a, b, 0x5410), s2);
            }
            q = make_uint4(o[0], o[1], o[2], o[3]);
          } else {
            float v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] = decode<kMode>((w[r] >> sh) & 15, tbl, s, 1);
            q = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                           pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
          }
          *reinterpret_cast<uint4*>(dd + core_offset(n, 4 * p + g, kBN)) = q;
        }
      }
    }
  };

  float acc[kAcc][64];  // sub-tile u, 128-column half h at u * kNH + h
#pragma unroll
  for (int a = 0; a < kAcc; ++a)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[a][e] = 0.0f;

  if (tid == 0) {
    for (int i = 0; i < kTcAhead && i < nsteps; ++i) load(i);
  }
  for (int i = 0; i < nsteps; ++i) {
    mbar_wait(&full[i % kTcStages], (i / kTcStages) & 1);
#ifndef BNB_PROBE_NO_DECODE  // chip_smoke.py --probe: the decode switched off
    decode_step(i);
#endif
    fence_proxy_async();
    __syncthreads();  // step i decoded; every warpgroup's wgmma i - 2 is done
    if (tid == 0 && i + kTcAhead < nsteps) load(i + kTcAhead);  // into step i - 2's slot
    const uint8_t* a = smem + (i % kTcStages) * kSlot;
    const uint8_t* b = dec + (i % kDecBufs) * kDec;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc_fence(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < kMS; ++u) {
        // plane kk / 2, 32 bytes further along K for the odd k16
        const uint64_t da = gmma_desc(a + (kk >> 1) * kXp + (wg * kMS + u) * 64 * 64 + (kk & 1) * 32,
                                      16, 512, 2);
#pragma unroll
        for (int h = 0; h < kNH; ++h) {
#ifndef BNB_PROBE_NO_MMA
          wgmma_bf16_n128(acc[u * kNH + h], da,
                          gmma_desc(b + core_offset(128 * h, 2 * kk, kBN), kBN * 16, 128));
#endif
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc_fence(acc[c]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc_fence(acc[c]);

  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int c = 0; c < kAcc; ++c) {
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int m = m0 + (wg * kMS + c / kNH) * 64 + acc_row(t, e);
      const int n = n0 + 128 * (c % kNH) + acc_col(t, e);
      if (m >= M) continue;
      if (direct) {
        float v0 = acc[c][e], v1 = acc[c][e + 1];
        if (bias != nullptr) {
          v0 = v0 + bias[n];
          v1 = v1 + bias[n + 1];
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = pack_bf16x2(v0, v1);
      } else {
        *reinterpret_cast<float2*>(part + ((size_t)blockIdx.z * M + m) * N + n) =
            make_float2(acc[c][e], acc[c][e + 1]);
      }
    }
  }
}

// the arguments of a tensor-core launch past the maps and the grid
struct TcArgs {
  int s_bf16;
  const float *am_s, *am_o, *dtab;
  const void* bias;
  void *out, *part;
  int M, N, K, bs, per;
  TableF16 tbl;
};

template <int kMode, int kWG, int kMS, int kBN, bool kCodes>
int launch_tc(dim3 grid, cudaStream_t st, const TcMaps& maps, const TcArgs& a) {
  auto kernel = mm4_tc_kernel<kMode, kWG, kMS, kBN, kCodes>;
  const int bytes = tc_smem_bytes(kWG, 64 * kWG * kMS, kBN, kCodes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, 128 * kWG, bytes, st>>>(maps, a.s_bf16, a.am_s, a.am_o, a.dtab,
                                         reinterpret_cast<const float*>(a.bias),
                                         reinterpret_cast<__nv_bfloat16*>(a.out),
                                         reinterpret_cast<float*>(a.part), a.M, a.N, a.K, a.bs,
                                         a.per, a.tbl);
  return (int)cudaGetLastError();
}

// the tile shapes (64 x 128, 128 x 128, 128 x 256, 256 x 128) in each decode
// mode; with compressed scales all but 128 x 256
template <int kMode, bool kCodes>
int launch_tc_tile(int bm, int bn, dim3 grid, cudaStream_t st, const TcMaps& maps, const TcArgs& a) {
  if (bm == 64) return launch_tc<kMode, 1, 1, 128, kCodes>(grid, st, maps, a);
  if (bm == 256) return launch_tc<kMode, 2, 2, 128, kCodes>(grid, st, maps, a);
  if (bn == 128) return launch_tc<kMode, 2, 1, 128, kCodes>(grid, st, maps, a);
  if constexpr (kCodes) {
    return (int)cudaErrorInvalidValue;
  } else {
    return launch_tc<kMode, 2, 1, 256, false>(grid, st, maps, a);
  }
}

template <bool kCodes>
int launch_tc_mode(int mode, int bm, int bn, dim3 grid, cudaStream_t st, const TcMaps& maps,
                   const TcArgs& a) {
  return mode == 0   ? launch_tc_tile<0, kCodes>(bm, bn, grid, st, maps, a)
         : mode == 1 ? launch_tc_tile<1, kCodes>(bm, bn, grid, st, maps, a)
                     : launch_tc_tile<2, kCodes>(bm, bn, grid, st, maps, a);
}

}  // namespace

// x (M, K) in the compute dtype (f32/bf16); packed (K/2, N) uint8; scales
// (2, K/(2 bs), N) f32/bf16, or uint8 codes when am_s is given; am_s, am_o
// (2, 1, N) f32 range and mean of compressed scales, or null; dtab: the 256
// signed dynamic-map values (f32, on the card; read when am_s is given);
// bias (N) f32 or null; out (M, N) in the compute dtype. Scratch: part
// (ksplit, M, N) f32. table: 16 floats on the host.
extern "C" int mm4_fused(const void* x, const void* packed, const void* scales, const void* bias,
                         void* out, void* part, const void* table, int M, int N, int K, int bs,
                         int G, int ksplit, int x_bf16, int s_bf16, int mode, const void* am_s,
                         const void* am_o, const void* dtab, void* stream) {
  if (M <= 0 || N % kCols || K % (2 * bs) || G < 1 || ksplit < 1 || mode < 0 || mode > 2 ||
      (am_s != nullptr && (am_o == nullptr || dtab == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  auto* ams = reinterpret_cast<const float*>(am_s);
  auto* amo = reinterpret_cast<const float*>(am_o);
  auto* dt = reinterpret_cast<const float*>(dtab);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  dim3 grid(N / kCols, ksplit, (M + kMT - 1) / kMT);
  const uint32_t* pk = reinterpret_cast<const uint32_t*>(packed);
  float* pt = reinterpret_cast<float*>(part);
  if (mode == 0) {
    mm4_kernel<0><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, ams, amo, dt, pt, M,
                                                  N, K, bs, G, tbl);
  } else if (mode == 1) {
    mm4_kernel<1><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, ams, amo, dt, pt, M,
                                                  N, K, bs, G, tbl);
  } else {
    mm4_kernel<2><<<grid, 32 * kWarps, 0, st>>>(x, x_bf16, pk, scales, s_bf16, ams, amo, dt, pt, M,
                                                  N, K, bs, G, tbl);
  }
  const size_t MN = (size_t)M * N;
  reduce_partials_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
      pt, ksplit, M, N, nullptr, reinterpret_cast<const float*>(bias), out, x_bf16);
  return (int)cudaGetLastError();
}

// The tensor-core body. x (M, K) bf16; packed (K/2, N) uint8; scales
// (2, K/(2 bs), N) f32/bf16, or uint8 codes with am_s, am_o and dtab as in
// mm4_fused; bias (N) f32 or null; out (M, N) bf16. Tiles of bm x bn (64 x
// 128, 128 x 128, 128 x 256 or 256 x 128; compressed scales: not 128 x 256);
// K split into ksplit ranges of `per` steps of 32 packed rows. Scratch: part
// (ksplit, M, N) f32 when ksplit > 1.
extern "C" int mm4_fused_tc(const void* x, const void* packed, const void* scales, const void* bias,
                            void* out, void* part, const void* table, int M, int N, int K, int bs,
                            int bm, int bn, int per, int ksplit, int s_bf16, int mode,
                            const void* am_s, const void* am_o, const void* dtab, void* stream) {
  const int half = K / 2;
  const bool codes = am_s != nullptr;
  const bool tile_ok = ((bm == 64 || bm == 256) && bn == 128) ||
                       (bm == 128 && (bn == 128 || (bn == 256 && !codes)));
  if (M <= 0 || !tile_ok || N % bn || (codes && (am_o == nullptr || dtab == nullptr)) || K % (2 * bs) || bs % 8 || (bs % kTcJ && kTcJ % bs) ||
      half % kTcJ || per < 1 || ksplit < 1 || mode < 0 || mode > 2 ||
      (size_t)ksplit * per < (size_t)(half / kTcJ) || (ksplit - 1) * per >= half / kTcJ) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  TableF16 tbl;
  memcpy(tbl.v, table, sizeof(tbl.v));
  const int srows = bs >= kTcJ ? 1 : kTcJ / bs;
  TcMaps maps;
  int err = make_tmap_2d(&maps.x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, K, bm, kTcJ, true);
  if (err == 0) {
    err = make_tmap_2d(&maps.packed, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, half, N, N, kTcJ, bn,
                       false);
  }
  if (err == 0) {
    err = make_tmap_2d(&maps.scales, scales,
                       codes    ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                       : s_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       codes ? 1 : s_bf16 ? 2 : 4, K / bs, N, N, srows, bn, false);
  }
  if (err != 0) return err;
  dim3 grid(N / bn, (M + bm - 1) / bm, ksplit);
  const TcArgs args{s_bf16, reinterpret_cast<const float*>(am_s), reinterpret_cast<const float*>(am_o),
                    reinterpret_cast<const float*>(dtab), bias, out, part, M, N, K, bs, per, tbl};
  err = codes ? launch_tc_mode<true>(mode, bm, bn, grid, st, maps, args)
              : launch_tc_mode<false>(mode, bm, bn, grid, st, maps, args);
  if (err != 0) return err;
  if (ksplit > 1) {
    const size_t MN = (size_t)M * N;
    reduce_partials_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float*>(part), ksplit, M, N, nullptr,
        reinterpret_cast<const float*>(bias), out, 1);
  }
  return (int)cudaGetLastError();
}
