// Host-side blockwise quantization library: the port's copy of the JAX
// package's csrc/quant_cpu.cpp, the same functions and the same bytes.
//
// Quantizes multi-GB checkpoint weights on the host (8-bit blockwise,
// 4-bit in bnb byte order) and converts bf16/fp16 bit patterns to f32.
//
// Round-to-nearest with strict-`>` midpoint thresholds: ties at a
// midpoint take the lower sorted value. Each block is scaled by the f32
// reciprocal of its absmax, as the port's torch quantizers do, so the
// codes equal theirs bit for bit. Parallelized with std::thread over block
// ranges.
//
// Built by bitsandbytes_sycl_tpu_torch/native.py at first use:
//   g++ -O3 -ffp-contract=off -shared -fPIC quant_cpu.cpp -o libquant_cpu.so -pthread
// (no -march=native: the library may be loaded on another host than the one
// that built it; no FMA contraction anywhere).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// nearest index into a sorted table via midpoint binary search
inline int nearest_sorted(const float* mids, int n_mids, float x) {
  // count of midpoints strictly less than x  == lower_bound(mids, x)
  return static_cast<int>(std::lower_bound(mids, mids + n_mids, x) - mids);
}

struct Codebook16 {
  float sorted_vals[16];
  float mids[15];
  uint8_t perm[16];  // sorted rank -> code index
};

Codebook16 build16(const float* code16) {
  Codebook16 cb;
  int order[16];
  for (int i = 0; i < 16; ++i) order[i] = i;
  std::sort(order, order + 16, [&](int a, int b) { return code16[a] < code16[b]; });
  for (int i = 0; i < 16; ++i) {
    cb.sorted_vals[i] = code16[order[i]];
    cb.perm[i] = static_cast<uint8_t>(order[i]);
  }
  for (int i = 0; i < 15; ++i) cb.mids[i] = 0.5f * (cb.sorted_vals[i] + cb.sorted_vals[i + 1]);
  return cb;
}

void parallel_blocks(long n_blocks, const std::function<void(long, long)>& fn) {
  unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
  if (n_blocks < 4 * static_cast<long>(n_threads)) {
    fn(0, n_blocks);
    return;
  }
  std::vector<std::thread> pool;
  long per = (n_blocks + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    long lo = t * per, hi = std::min<long>(n_blocks, lo + per);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// ---- 8-bit blockwise (codebook: 256 sorted floats in [-1,1]) -------------

void quantize_blockwise_cpu_fp32(const float* code_sorted, const float* A,
                                 float* absmax, uint8_t* out, int blocksize,
                                 long n) {
  float mids[255];
  for (int i = 0; i < 255; ++i) mids[i] = 0.5f * (code_sorted[i] + code_sorted[i + 1]);
  long n_blocks = (n + blocksize - 1) / blocksize;
  parallel_blocks(n_blocks, [&](long blo, long bhi) {
    for (long b = blo; b < bhi; ++b) {
      long lo = b * blocksize, hi = std::min<long>(n, lo + blocksize);
      float amax = 0.f;
      for (long i = lo; i < hi; ++i) amax = std::max(amax, std::fabs(A[i]));
      absmax[b] = amax;
      float inv = amax > 0.f ? 1.0f / amax : 0.f;
      for (long i = lo; i < hi; ++i)
        out[i] = static_cast<uint8_t>(nearest_sorted(mids, 255, A[i] * inv));
    }
  });
}

void dequantize_blockwise_cpu_fp32(const float* code, const uint8_t* A,
                                   const float* absmax, float* out,
                                   int blocksize, long n) {
  long n_blocks = (n + blocksize - 1) / blocksize;
  parallel_blocks(n_blocks, [&](long blo, long bhi) {
    for (long b = blo; b < bhi; ++b) {
      long lo = b * blocksize, hi = std::min<long>(n, lo + blocksize);
      float s = absmax[b];
      for (long i = lo; i < hi; ++i) out[i] = code[A[i]] * s;
    }
  });
}

// ---- 4-bit blockwise (16-entry codebook in code order; bnb pairing:
//      element 2i -> high nibble) ------------------------------------------

void quantize_4bit_cpu_fp32(const float* code16, const float* A, float* absmax,
                            uint8_t* out, int blocksize, long n) {
  Codebook16 cb = build16(code16);
  long n_blocks = (n + blocksize - 1) / blocksize;
  std::vector<uint8_t> codes(static_cast<size_t>(n));
  parallel_blocks(n_blocks, [&](long blo, long bhi) {
    for (long b = blo; b < bhi; ++b) {
      long lo = b * blocksize, hi = std::min<long>(n, lo + blocksize);
      float amax = 0.f;
      for (long i = lo; i < hi; ++i) amax = std::max(amax, std::fabs(A[i]));
      absmax[b] = amax;
      float inv = amax > 0.f ? 1.0f / amax : 0.f;
      for (long i = lo; i < hi; ++i)
        codes[i] = cb.perm[nearest_sorted(cb.mids, 15, A[i] * inv)];
    }
  });
  long n_bytes = (n + 1) / 2;
  parallel_blocks(n_bytes, [&](long lo, long hi) {
    for (long j = lo; j < hi; ++j) {
      uint8_t hi_nib = codes[2 * j];
      uint8_t lo_nib = (2 * j + 1 < n) ? codes[2 * j + 1] : 0;
      out[j] = static_cast<uint8_t>((hi_nib << 4) | lo_nib);
    }
  });
}

void dequantize_4bit_cpu_fp32(const float* code16, const uint8_t* A,
                              const float* absmax, float* out, int blocksize,
                              long n) {
  long n_blocks = (n + blocksize - 1) / blocksize;
  parallel_blocks(n_blocks, [&](long blo, long bhi) {
    for (long b = blo; b < bhi; ++b) {
      long lo = b * blocksize, hi = std::min<long>(n, lo + blocksize);
      float s = absmax[b];
      for (long i = lo; i < hi; ++i) {
        uint8_t byte = A[i / 2];
        uint8_t c = (i % 2 == 0) ? (byte >> 4) : (byte & 0x0F);
        out[i] = code16[c] * s;
      }
    }
  });
}

// ---- planar transposed repack for the TPU kernel layout ------------------
// codes (N, K) row-major -> packed (K/2, N): byte (j, n) = code(n, j)<<4 |
// code(n, j + K/2)  (ops/common.py layout)
void pack_planar_transposed_cpu(const uint8_t* codes, uint8_t* out, long N, long K) {
  long half = K / 2;
  parallel_blocks(half, [&](long jlo, long jhi) {
    for (long j = jlo; j < jhi; ++j)
      for (long nn = 0; nn < N; ++nn)
        out[j * N + nn] = static_cast<uint8_t>(
            (codes[nn * K + j] << 4) | codes[nn * K + half + j]);
  });
}

// ---- checkpoint-loader dtype converters (multithreaded) ------------------
// Real HF checkpoints ship bf16/fp16 safetensors; numpy has no bf16 and
// the python-side loop would be single-threaded. These feed the mmap'd
// shard bytes straight into f32 buffers (checkpoints.read_safetensors).

void bf16_to_f32_cpu(const uint16_t* src, float* dst, long n) {
  parallel_blocks(n / 65536 + 1, [&](long blo, long bhi) {
    long lo = blo * 65536, hi = std::min<long>(n, bhi * 65536);
    for (long i = lo; i < hi; ++i) {
      uint32_t u = static_cast<uint32_t>(src[i]) << 16;
      std::memcpy(&dst[i], &u, 4);
    }
  });
}

void fp16_to_f32_cpu(const uint16_t* src, float* dst, long n) {
  parallel_blocks(n / 65536 + 1, [&](long blo, long bhi) {
    long lo = blo * 65536, hi = std::min<long>(n, bhi * 65536);
    for (long i = lo; i < hi; ++i) {
      uint16_t h = src[i];
      uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
      uint32_t exp = (h >> 10) & 0x1F;
      uint32_t mant = h & 0x3FF;
      uint32_t u;
      if (exp == 0) {
        if (mant == 0) {
          u = sign;  // +-0
        } else {  // subnormal: renormalize
          int e = -1;
          do { mant <<= 1; ++e; } while (!(mant & 0x400));
          u = sign | ((112 - e) << 23) | ((mant & 0x3FF) << 13);
        }
      } else if (exp == 31) {
        u = sign | 0x7F800000u | (mant << 13);  // inf/nan
      } else {
        u = sign | ((exp + 112) << 23) | (mant << 13);
      }
      std::memcpy(&dst[i], &u, 4);
    }
  });
}

int quant_cpu_version() { return 2; }

}  // extern "C"
