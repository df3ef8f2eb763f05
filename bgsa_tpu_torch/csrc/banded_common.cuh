// Shared pieces of the banded Myers kernels (banded.cu, banded_pair.cu, and
// through banded_packed_common.cuh the packed kernels).
//
// The reference's band register is one 64-bit word; the TPU kernels emulate
// it with (lo, hi) uint32 pairs (bgsa_tpu/ops/banded.py: _add64, _shr1).
// Here it is a native uint64_t, so the pair arithmetic is one operator each
// and wraps exactly like the reference's 64-bit register.

#pragma once

#include <cstdint>
#include <type_traits>
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

// The window fold of the stream kernels (banded.cu; stream_window is the
// per-column form it replaced, kept for the paired-query kernel and the
// probes). Within the 32-column window w = t >> 5 every code's words w, w + 1
// (and w + 2 where the window's high half is needed) are fixed, so a thread
// loads them once a window into its shared-memory slot, one StreamSlot per
// code at slot[c * kThreads] (slot pointing at its own column of the block's
// slots, so neighbouring threads take neighbouring 8- or 16-byte words), and
// a column reads its code's words in one LDS.64 or LDS.128 and funnel-shifts
// them by t & 31. Wide: the high word too (band_down >= 32, or the dual
// kernel's preload stream A, whose window is taken whole). Slot kChars is
// zero, set once a launch: the staged query row clamps codes above 4 to it,
// so they match nothing without a check a column.
constexpr int kSlotCodes = kChars + 1;

template <bool Wide>
using StreamSlot = typename std::conditional<Wide, uint4, uint2>::type;

template <bool Wide>
__device__ __forceinline__ void load_stream_slot(StreamSlot<Wide>* __restrict__ slot,
                                                 const uint32_t* __restrict__ base, size_t plane,
                                                 int w, int W, int S) {
#pragma unroll
  for (int c = 0; c < kChars; ++c) {
    const uint32_t* p = base + c * plane;
    if constexpr (Wide) {
      slot[c * kThreads] = make_uint4(stream_word(p, w, W, S), stream_word(p, w + 1, W, S),
                                      stream_word(p, w + 2, W, S), 0u);
    } else {
      slot[c * kThreads] = make_uint2(stream_word(p, w, W, S), stream_word(p, w + 1, W, S));
    }
  }
}

// Column t's window (bits b = t & 31 on of the loaded words) for query code
// c in 0..kChars (kChars: the zero slot), masked. Narrow: the low half only,
// which is the whole window where mask < 2^32. stream_window(...) & mask, bit
// for bit.
template <bool Wide>
__device__ __forceinline__ uint64_t fold_stream_slot(const StreamSlot<Wide>* __restrict__ slot,
                                                     int c, int b, uint64_t mask) {
  const StreamSlot<Wide> v = slot[c * kThreads];
  if constexpr (Wide) {
    return ((static_cast<uint64_t>(__funnelshift_r(v.y, v.z, b)) << 32) |
            __funnelshift_r(v.x, v.y, b)) & mask;
  } else {
    return __funnelshift_r(v.x, v.y, b) & static_cast<uint32_t>(mask);
  }
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
