// The non-packed BitPAl column network (general integer scoring M, I, G):
// one indicator plane per vertical-delta value, the Net of bitpal_common.cuh
// that bitpal.cu launches (see there for what it computes).

#pragma once

#include "bitpal_common.cuh"

namespace bitpal {
namespace {

template <int M, int I, int G, int WB>
struct Unpacked {
  using Sc = Scheme<M, I, G>;
  using Wd = Word<WB>;
  static constexpr int kPlanes = Sc::kValues;  // plane of value v: v - lo
  static constexpr int lo = Sc::kMin, mid = Sc::kMid, hi = Sc::kMax;
  static constexpr int kMaxSubMid = hi - mid;
  static constexpr uint32_t CM = Wd::kMask;

  struct Carries {
    uint32_t add[Sc::kAdds];   // run-propagation add carries, key 0..kAdds-1
    uint32_t prev[kPlanes];    // one-row shift carries, by value
  };

  // The add carries, then the shift carries of the values lo+1 .. hi-1 (the
  // network reads no other).
  static constexpr int kCarryBits = Sc::kAdds + kPlanes - 2;
  template <class F>
  static __device__ __forceinline__ void each_carry(Carries& c, F&& f) {
#pragma unroll
    for (int k = 0; k < Sc::kAdds; ++k) f(c.add[k], k);
#pragma unroll
    for (int p = 1; p < kPlanes - 1; ++p) f(c.prev[p], Sc::kAdds + p - 1);
  }

  static __device__ __forceinline__ void init(uint32_t (&pl)[kPlanes], int semi) {
    const int boundary = semi ? 0 : lo;
#pragma unroll
    for (int v = lo; v <= hi; ++v) pl[v - lo] = v == boundary ? CM : 0u;
  }

  static __device__ __forceinline__ void word(uint32_t (&pl)[kPlanes], uint32_t matches,
                                              Carries& c) {
    uint32_t dh[kPlanes], dv[kPlanes], dvsnm[kPlanes];  // by value - lo
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) dh[p] = pl[p];
    const uint32_t not_matches = ~matches;

    // ---- Phase A: horizontal-delta ("dv_shift") indicators ----
    const uint32_t init_max = dh[0] & matches;
    const uint32_t s0 = Wd::add(init_max, dh[0], c.add[0]);
    dv[hi - lo] = (s0 ^ dh[0] ^ init_max) & CM;
    const uint32_t remain = (init_max & CM) ^ dh[0];
    const uint32_t dv_max_or_match = dv[hi - lo] | matches;
#pragma unroll
    for (int i = hi - 1; i > mid; --i) {
      const int cnt = lo + (hi - i);
      uint32_t init = dh[cnt - lo] & dv_max_or_match;
#pragma unroll
      for (int x = 1; x < hi - i; ++x) init |= dh[cnt - x - lo] & dvsnm[hi - x - lo];
      const uint32_t nxt = Wd::top_bit(init);
      const uint32_t val = ((init << 1) | c.prev[i - lo]) & CM;
      c.prev[i - lo] = nxt;
      const uint32_t s = Wd::add(val, remain, c.add[hi - i]);
      dv[i - lo] = s ^ remain;
      dvsnm[i - lo] = dv[i - lo] & not_matches;
    }
    uint32_t acc = dv_max_or_match;
#pragma unroll
    for (int i = hi - 1; i > mid; --i) acc |= dv[i - lo];
    const uint32_t dv_not_hi = ~acc;

#pragma unroll
    for (int i = mid; i > lo; --i) {
      const int index = lo + M - I + (mid - i);
      uint32_t init = dh[index - lo] & dv_max_or_match;
#pragma unroll
      for (int j = hi - 1; j > mid; --j) init |= dh[index - hi + j - lo] & dvsnm[j - lo];
      init |= dh[index - hi + mid - lo] & dv_not_hi;
      dv[i - lo] = (init << 1) | c.prev[i - lo];
      c.prev[i - lo] = Wd::top_bit(init);
    }
    acc = dv[hi - lo];
#pragma unroll
    for (int i = hi - 1; i > lo; --i) acc |= dv[i - lo];
    dv[0] = ~acc;

    // ---- Phase B: new vertical-delta planes ----
#pragma unroll
    for (int i = mid + 1; i < hi; ++i) dh[i - lo] &= not_matches;
    const uint32_t dh_max_or_match = dh[hi - lo] | matches;
    acc = dh_max_or_match;
#pragma unroll
    for (int i = hi - 1; i > mid; --i) acc |= dh[i - lo];
    const uint32_t dh_lo_mask = ~acc;

#pragma unroll
    for (int i = lo + 1; i <= mid; ++i) {
      const int index = hi - 1 - (i - lo - 1);
      uint32_t t1 = dv[index - lo] & dh_max_or_match;
#pragma unroll
      for (int j = 1; j < kMaxSubMid; ++j) t1 |= dv[index - j - lo] & dh[hi - j - lo];
      pl[i - lo] = t1 | (dv[index - kMaxSubMid - lo] & dh_lo_mask);
    }
#pragma unroll
    for (int i = mid + 1; i <= hi; ++i) {
      const int k = i - mid - 1;
      const int index = hi - 1 - (mid - lo) - k;
      uint32_t t1 = dv[index - lo] & dh_max_or_match;
#pragma unroll
      for (int j = 1; j < kMaxSubMid - k; ++j) t1 |= dv[index - j - lo] & dh[hi - j - lo];
      pl[i - lo] = t1;
    }
    acc = pl[hi - lo];
#pragma unroll
    for (int i = hi - 1; i > lo; --i) acc |= pl[i - lo];
    pl[0] = ~acc & CM;
  }

  static __device__ __forceinline__ int global_base(int m, int) { return G * m; }

  static __device__ __forceinline__ int word_score(const uint32_t (&pl)[kPlanes],
                                                   uint32_t mask) {
    int score = 0;
#pragma unroll
    for (int v = lo; v <= hi; ++v) {
      if (v != 0) score += v * __popc(pl[v - lo] & mask);
    }
    return score;
  }

  static __device__ __forceinline__ int row_delta(const uint32_t (&pl)[kPlanes], int b) {
    int delta = 0;
#pragma unroll
    for (int v = lo; v <= hi; ++v) {
      if (v != 0) delta += v * static_cast<int>((pl[v - lo] >> b) & 1u);
    }
    return delta;
  }
};

}  // namespace
}  // namespace bitpal
