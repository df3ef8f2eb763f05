// Shared pieces of the subject-interleaved packed banded kernels
// (banded_packed.cu and the paired-query kernel and probes of
// banded_packed_pair.cu): the field masks, the column window fold (per
// column, and per 32-column window through a shared-memory slot), the
// packed band update, the SWAR over-budget latch and the epilogue.
//
// n_sub = 64 / (band_down + 2) subjects' bands share one 64-bit register at
// pitch band_down + 2, one guard bit per field; field j of a thread scores
// subject s of stream chunk j (ops/banded_packed.py: pack_packed_streams).

#pragma once

#include "banded_common.cuh"

namespace bgsa_banded {

constexpr int kMaxSub = 32;  // pitch >= 2

struct PackedConsts {
  uint64_t band;  // bits 0..band_down of every field
  uint64_t xsm;   // bits 0..band_down-1 of every field (Xs keeps the band)
  uint64_t ones;  // bit 0 of every field (match counters)
  uint64_t tops;  // the guard bit of every field (dead flags, compare)
};

// The masks of n_sub fields at pitch band_down + 2 (host side).
inline PackedConsts packed_consts(int n_sub, int band_down) {
  const int pitch = band_down + 2;
  PackedConsts pc{0, 0, 0, 0};
  for (int j = 0; j < n_sub; ++j) {
    const int o = pitch * j;
    pc.band |= ((1ull << (band_down + 1)) - 1ull) << o;
    pc.xsm |= ((1ull << band_down) - 1ull) << o;
    pc.ones |= 1ull << o;
    pc.tops |= 1ull << (o + pitch - 1);
  }
  return pc;
}

// The packed launches' argument check: a narrow band (band_down <= 30), at
// least two fields that fit the register, and the two stream words a window
// reads.
inline bool packed_args_ok(int Q, int m, int W, int S_sub, int n_sub, int band_down) {
  return Q > 0 && S_sub > 0 && W >= 3 && m >= 0 && band_down >= 0 && band_down <= 30 &&
         n_sub >= 2 && n_sub * (band_down + 2) <= 64;
}

// One thread's n_sub band registers, SWAR match counters (at each field's
// bit 0) and dead flags (at each field's guard bit).
struct PackedState {
  uint64_t vp = 0, vn = 0, matches = 0, dead = 0;
};

// Set dead (the field's top bit) where matches < thr (err > max_err).
__device__ __forceinline__ void latch(uint64_t& dead, uint64_t matches, int thr,
                                      const PackedConsts& pc) {
  const uint64_t t = static_cast<uint64_t>(max(thr, 0)) * pc.ones;  // thr in every field
  const uint64_t ge = (matches | pc.tops) - t;  // a field's top bit survives iff matches >= thr
  dead |= ~ge & pc.tops;
}

// Column t's Eq register for query code c: field j holds the band_down + 1
// bits of chunk j's stream at t (two words and a funnel shift each); 0 for
// codes outside 0..4. base points at this thread's subject in chunk 0, plane
// 0; a chunk is kChars planes of W x S_sub words. NSUB > 0 fixes n_sub at
// compile time.
template <int NSUB>
__device__ __forceinline__ uint64_t packed_window(const uint32_t* __restrict__ base, size_t plane,
                                                  int S_sub, int W, int n_sub, int pitch,
                                                  uint32_t wmask, int c, int t) {
  uint64_t eq = 0;
  if (c < kChars) {
    const int w = min(t >> 5, W - 2), b = t & 31;
    const uint32_t* p = base + c * plane + static_cast<size_t>(w) * S_sub;
#pragma unroll
    for (int j = 0; j < (NSUB > 0 ? NSUB : kMaxSub); ++j) {
      if (j < n_sub) {
        const uint32_t* pj = p + j * kChars * plane;
        const uint32_t win = __funnelshift_r(__ldg(pj), __ldg(pj + S_sub), b) & wmask;
        eq |= static_cast<uint64_t>(win) << (pitch * j);
      }
    }
  }
  return eq;
}

// The window fold (the shipping kernel's column; packed_window is the
// per-column form it replaced, kept for the paired-query kernel and the
// probes). Within the 32-column window w = min(t >> 5, W - 2) every code's
// and field's word pair is fixed, so a thread loads the 5 x n_sub pairs
// once a window into its shared-memory slot, slot[(c * n_sub + j) *
// kThreads] (slot pointing at its own column of the block's slots, so
// neighbouring threads take neighbouring 8-byte words), and a column only
// selects its code's pairs and funnel-shifts each by t & 31.
constexpr int kSlotBytesPerField = kChars * sizeof(uint2) * kThreads;

// Up to 4 fields all 10 n_sub loads are in flight (52-80 registers); from 5
// fields on, one code's 2 n_sub at a time: all in flight took 168 and 188
// registers at n_sub = 5 and 6 (2 blocks an SM), while one code at a time
// ran n_sub = 2 and 3 7-8 % slower (PERF.md). The generic instance (NSUB ==
// 0) loops to n_sub: unrolled to kMaxSub fields it took 252 registers.
template <int NSUB>
__device__ __forceinline__ void load_window(uint2* __restrict__ slot,
                                            const uint32_t* __restrict__ base, size_t plane,
                                            int S_sub, int n_sub, int w) {
  auto code = [&](int c) {
#pragma unroll
    for (int j = 0; j < (NSUB > 0 ? NSUB : n_sub); ++j) {  // NSUB == 0: not unrolled
      const uint32_t* p = base + (j * kChars + c) * plane + static_cast<size_t>(w) * S_sub;
      slot[(c * n_sub + j) * kThreads] = make_uint2(__ldg(p), __ldg(p + S_sub));
    }
  };
  if constexpr (NSUB > 0 && NSUB <= 4) {
#pragma unroll
    for (int c = 0; c < kChars; ++c) code(c);
  } else {
#pragma unroll 1
    for (int c = 0; c < kChars; ++c) code(c);
  }
}

// Column t's Eq register for query code c from the loaded window (0 for
// codes outside 0..4): packed_window's value, bit for bit.
template <int NSUB>
__device__ __forceinline__ uint64_t fold_window(const uint2* __restrict__ slot, int n_sub,
                                                int pitch, uint32_t wmask, int c, int t) {
  uint64_t eq = 0;
  if (c < kChars) {
    const uint2* sc = slot + c * n_sub * kThreads;
    const int b = t & 31;
#pragma unroll
    for (int j = 0; j < (NSUB > 0 ? NSUB : n_sub); ++j) {  // NSUB == 0: not unrolled
      const uint2 v = sc[j * kThreads];
      eq |= static_cast<uint64_t>(__funnelshift_r(v.x, v.y, b) & wmask) << (pitch * j);
    }
  }
  return eq;
}

// The band recurrence of every field at once: D0 is masked to the band so
// no carry or shift crosses a field; a scored column counts D0's bit 0.
__device__ __forceinline__ void packed_update(PackedState& st, uint64_t eq, bool scored,
                                              const PackedConsts& pc) {
  const uint64_t x = eq | st.vn;
  const uint64_t d0 = (((x & st.vp) + st.vp) ^ st.vp) | x;
  const uint64_t hn = d0 & st.vp;
  const uint64_t hp = ~(d0 | st.vp) | st.vn;
  const uint64_t xs = ((d0 & pc.band) >> 1) & pc.xsm;
  st.vn = xs & hp;
  st.vp = (~(hp | xs) | hn) & pc.band;
  if (scored) st.matches += d0 & pc.ones;
}

// Each field's score into orow[j * S_sub]: err = charged - matches (charged
// = max(m, k): k errors up front, then every column from k on is scored),
// the minimum over the field's h + 1 band heights, kMaxError where dead.
__device__ __forceinline__ void packed_epilogue(const PackedState& st, int32_t* orow, int S_sub,
                                                int n_sub, int pitch, int h, int charged) {
  for (int j = 0; j < n_sub; ++j) {
    const int o = pitch * j;
    const int err = charged - static_cast<int>((st.matches >> o) & ((1ull << pitch) - 1ull));
    int cur = err, mn = err;
    for (int i = 0; i <= h; ++i) {
      cur += static_cast<int>((st.vp >> (o + i)) & 1ull) -
             static_cast<int>((st.vn >> (o + i)) & 1ull);
      mn = min(mn, cur);
    }
    orow[static_cast<size_t>(j) * S_sub] = ((st.dead >> (o + pitch - 1)) & 1ull) ? kMaxError : mn;
  }
}

}  // namespace bgsa_banded
