// The 8-bit dynamic-map codec of the optimizer kernels J (optim8_2state.cu)
// and K (optim8_1state.cu): the arithmetic of ops/dynamic8.py, operation by
// operation, with the rounding intrinsics (__fmul_rn, __fsub_rn, __fdiv_rn)
// so that nvcc cannot contract a product and a sum into an FMA: the codes
// must equal the plain PyTorch version's bit for bit.
//
// Decode reads a 256-entry table per map that the wrapper made by running
// the arithmetic decode on all 256 codes (ops/dynamic8.decode_table); the
// block stages both tables in shared memory. Encode is arithmetic: the
// decade by comparison with the 7 decade edges, then ceil(y) - 1 on the
// uniform in-decade grid, y = (a * 10^(6-i) - 0.1) * (n / 0.9).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace dyn8 {

constexpr int kThreads = 256;    // one block of 256 threads per quantization block
constexpr int kMaxPer = 8;       // elements per thread: blocksize <= 2048
constexpr int kNumConsts = 23;   // signed edges (7) + top, unsigned edges (7) + top, 10^(6-i) (7)

// The encoder's constants, passed by value (ops/dynamic8.encode_consts).
struct Consts {
  float v[kNumConsts];
};

__device__ __forceinline__ float exp2i(int i) { return __int_as_float((i + 127) << 23); }

// ops/dynamic8.dynamic_encode for one value; returns the code (0..255).
template <bool kSigned>
__device__ __forceinline__ int encode(float x, const float* c) {
  const float* edges = kSigned ? c : c + 8;
  const float top_edge = edges[7];
  const float* inv_scale = c + 16;
  float a = kSigned ? fabsf(x) : (x > 0.0f || x != x ? x : 0.0f);
  a = (a < 1.0f || a != a) ? a : 1.0f;  // jnp.minimum: NaN stays NaN
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < 7; ++e) cnt += edges[e] < a ? 1 : 0;
  const int i = cnt > 0 ? cnt - 1 : 0;
  const float n = kSigned ? exp2i(i) : exp2i(i + 1);
  const float base = kSigned ? n : __fsub_rn(n, 1.0f);
  const float y = __fmul_rn(__fsub_rn(__fmul_rn(a, inv_scale[i]), 0.1f), __fdiv_rn(n, 0.9f));
  const float j = fminf(fmaxf(ceilf(y) - 1.0f, 0.0f), __fsub_rn(n, 1.0f));
  int r = (int)__fadd_rn(base, j);
  if (cnt == 0) r = 0;
  if (a > top_edge) r = kSigned ? 128 : 255;
  if (kSigned) return x < 0.0f ? 127 - min(r, 127) : 127 + r;
  return r;
}

// State1's sign preservation (ops/optim8._apply_sign_fix, n_neg 127, top 255).
__device__ __forceinline__ int sign_fix(int r, float normed) {
  const bool mism = (r < 127) != (bool)signbit(normed);
  const int step = normed > 0.0f ? 1 : -1;
  return mism ? min(max(r + step, 0), 255) : r;
}

// ops/dynamic8.stochastic_adjust: step to the bracketing neighbour with
// probability |x - v_c| / |v_n - v_c|; tbl is the map's decode table.
__device__ __forceinline__ int stochastic(int c, float x, float u, const float* tbl) {
  const float vc = tbl[c];
  const int c2 = min(max(c + (x > vc ? 1 : -1), 0), 255);
  const float denom = __fsub_rn(tbl[c2], vc);
  float prob = denom != 0.0f ? __fdiv_rn(__fsub_rn(x, vc), denom) : 0.0f;
  prob = fminf(fmaxf(prob, 0.0f), 1.0f);
  return u < prob ? c2 : c;
}

// Requantize one state held in registers (kMaxPer values a thread, element
// t + k * kThreads of the block): fresh block absmax, then codes.
template <bool kSigned, bool kSignFix>
__device__ __forceinline__ void requant(const float (&s)[kMaxPer], int per, int bs, size_t row0,
                                        const float* __restrict__ u, bool scramble,
                                        const float* consts, const float* tbl, float* red,
                                        uint8_t* __restrict__ codes, float* __restrict__ absmax) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k)
    if (k < per && threadIdx.x + k * kThreads < bs) m = fmaxf(m, fabsf(s[k]));
  m = block_reduce<true>(m, red);
  const float inv = m > 0.0f ? __fdiv_rn(1.0f, m) : 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (k >= per || e >= bs) continue;
    const float normed = __fmul_rn(s[k], inv);
    int c = encode<kSigned>(normed, consts);
    if (u != nullptr) {
      float uu = u[row0 + e];
      // state2's noise: the golden-ratio scramble of state1's
      if (scramble) uu = fmodf(__fadd_rn(__fmul_rn(uu, 0.6180339887f), 0.3819660113f), 1.0f);
      c = stochastic(c, normed, uu, tbl);
    } else if (kSignFix) {
      c = sign_fix(c, normed);
    }
    codes[row0 + e] = (uint8_t)c;
  }
  if (threadIdx.x == 0) absmax[blockIdx.x] = m;
}

}  // namespace dyn8
