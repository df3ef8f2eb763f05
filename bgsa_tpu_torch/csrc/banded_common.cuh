// Shared pieces of the banded Myers kernels (banded.cu, banded_pair.cu, and
// through banded_packed_common.cuh the packed kernels).
//
// The reference's band register is one 64-bit word; the TPU kernels emulate
// it with (lo, hi) uint32 pairs (bgsa_tpu/ops/banded.py: _add64, _shr1).
// Here it is a native uint64_t, so the pair arithmetic is one operator each
// and wraps exactly like the reference's 64-bit register.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bgsa_banded {

constexpr int kChars = 5;
constexpr int kThreads = 128;
constexpr int kBatchCols = 32;  // early-exit granularity (columns)
constexpr int kMaxGridY = 65535;
constexpr int kMaxError = 127;  // "over budget" (banded_ref.MAX_ERROR)
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// One thread per subject (x) and row of the output (y), the rows walked
// with a stride where they exceed the grid's y limit.
inline dim3 grid_for(int S, int rows) {
  return dim3((S + kThreads - 1) / kThreads, rows < kMaxGridY ? rows : kMaxGridY);
}

// Bits 0..band_down set. band_down == 63 is the full register: (1 << 64) - 1
// is undefined in C++, so it is its own case (banded.py branches the same
// way on band_down < 63).
__device__ __forceinline__ uint64_t band_mask(int band_down) {
  return band_down >= 63 ? ~0ull : (1ull << (band_down + 1)) - 1ull;
}

// Word w of one character's bit-stream (words are S apart); 0 past the end,
// where the packed stream is zero padding anyway.
__device__ __forceinline__ uint32_t stream_word(const uint32_t* __restrict__ p, int w, int W,
                                                int S) {
  return w < W ? __ldg(p + static_cast<size_t>(w) * S) : 0u;
}

// Stream bits [32w + b, 32w + b + 63]: the column's 64-bit Eq window, built
// from three words with funnel shifts. __funnelshift_r(lo, hi, 0) returns lo,
// which is what the JAX two-shift form (banded.py:278-279) exists to get.
__device__ __forceinline__ uint64_t stream_window(const uint32_t* __restrict__ p, int w, int b,
                                                  int W, int S) {
  const uint32_t w0 = stream_word(p, w, W, S);
  const uint32_t w1 = stream_word(p, w + 1, W, S);
  const uint32_t w2 = stream_word(p, w + 2, W, S);
  return (static_cast<uint64_t>(__funnelshift_r(w1, w2, b)) << 32) | __funnelshift_r(w0, w1, b);
}

// Myers band recurrence on one column's Eq window (banded.py::_band_update):
// updates vp/vn and counts an error when D0's bit 0 is clear and the column
// is scored (t >= k).
__device__ __forceinline__ void band_update(uint64_t eq, uint64_t& vp, uint64_t& vn, int& err,
                                            bool scored) {
  const uint64_t x = eq | vn;
  const uint64_t d0 = (((x & vp) + vp) ^ vp) | x;
  const uint64_t hn = d0 & vp;
  const uint64_t hp = ~(d0 | vp) | vn;
  const uint64_t xs = d0 >> 1;
  vn = xs & hp;
  vp = ~(hp | xs) | hn;
  err += scored ? 1 - static_cast<int>(d0 & 1ull) : 0;
}

// The last row's minimum over band heights 0..h (banded.py::_epilogue);
// a dead lane reports kMaxError.
__device__ __forceinline__ int band_epilogue(uint64_t vp, uint64_t vn, int err, bool dead, int h) {
  int cur = err, mn = err;
  for (int i = 0; i <= h; ++i) {
    cur += static_cast<int>((vp >> i) & 1ull) - static_cast<int>((vn >> i) & 1ull);
    mn = min(mn, cur);
  }
  return dead ? kMaxError : mn;
}

}  // namespace bgsa_banded
