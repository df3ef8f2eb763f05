// Subject-interleaved packed banded Myers for Hopper.
//
// Replaces bgsa_tpu/ops/banded_packed.py::_packed_kernel (the Pallas TPU
// kernel launched by banded_stream_packed). Where the band is narrow
// (band_down <= 30, s_len >= q_len), n_sub = 64 / (band_down + 2) subjects'
// bands share one 64-bit register at pitch band_down + 2 (one guard bit per
// field absorbs the add's carry). Field j of a thread scores subject s of
// chunk j (pack_packed_streams). Scores equal the one-band-per-register
// kernels bit for bit (the module docstring of banded_packed.py proves why
// masking D0 to the band reproduces the 64-bit dynamics).
//
// What bounds it: like banded.cu, a serial chain of 64-bit integer ALU
// operations per column (the packed update is ~16 64-bit operations for
// n_sub subjects at once), plus n_sub funnel windows (two 4-byte stream words
// each, L2-resident: a bucket's streams are reread by every query) folded
// into the register. wgmma and TMA do not apply.
//
// Design (simple first):
//   * one thread per (query, group of n_sub subjects); blockIdx.y walks the
//     queries; no state crosses blocks;
//   * native uint64_t replaces the (lo, hi) pairs: _add64/_sub64/_shr1 are
//     one operator each, fields are never unpacked per column;
//   * error counting is SWAR: per-field match counters at the field's low
//     bit; "err > max_err" is the packed compare matches < thr by the
//     top-bit subtraction of _latch, with thr clamped at 0 (thr <= 0 means
//     no field can be over budget yet);
//   * the first min(k, m) columns are unscored; dead is latched per field at
//     32-column batch boundaries <= the last checkpoint and exactly at it
//     (err is nondecreasing, so this is the reference's outcome), and a warp
//     leaves the column loop when __all_sync says every field of every lane
//     is dead. No shared memory, no block barrier;
//   * the epilogue takes err = max(m, k) - matches per field (k errors are
//     charged up front and every column from k on is scored), then the min
//     over the field's h + 1 band heights;
//   * query codes outside 0..4 match nothing.
// The launch uses the caller's stream, allocates nothing, and the C entry
// point returns cudaGetLastError().

#include "banded_common.cuh"

namespace {

using namespace bgsa_banded;

constexpr int kMaxSub = 32;  // pitch >= 2

struct PackedConsts {
  uint64_t band;  // bits 0..band_down of every field
  uint64_t xsm;   // bits 0..band_down-1 of every field (Xs keeps the band)
  uint64_t ones;  // bit 0 of every field (match counters)
  uint64_t tops;  // the guard bit of every field (dead flags, compare)
};

// Set dead (the field's top bit) where matches < thr (err > max_err).
__device__ __forceinline__ void latch(uint64_t& dead, uint64_t matches, int thr,
                                      const PackedConsts& pc) {
  const uint64_t t = static_cast<uint64_t>(max(thr, 0)) * pc.ones;  // thr in every field
  const uint64_t ge = (matches | pc.tops) - t;  // a field's top bit survives iff matches >= thr
  dead |= ~ge & pc.tops;
}

// streams: (n_sub, 5, W, S_sub) uint32; queries: (Q, m) uint8;
// out: (Q, n_sub * S_sub) int32. NSUB > 0 fixes n_sub at compile time.
template <int NSUB>
__global__ void __launch_bounds__(kThreads)
banded_packed_kernel(const uint32_t* __restrict__ streams, const uint8_t* __restrict__ queries,
                     int32_t* __restrict__ out, int Q, int m, int W, int S_sub, int n_sub_rt,
                     int k, int h, int band_down, int last_chk, PackedConsts pc) {
  const int n_sub = NSUB > 0 ? NSUB : n_sub_rt;
  const int pitch = band_down + 2;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S_sub;
  const size_t plane = static_cast<size_t>(W) * S_sub;
  const uint32_t* const base = streams + (active ? s : S_sub - 1);
  const uint32_t wmask = (1u << (band_down + 1)) - 1u;  // band_down <= 30
  const int head_end = min(k, m);
  const int nb = max(0, (last_chk - head_end) / kBatchCols);
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const qrow = queries + static_cast<size_t>(q) * m;
    uint64_t vp = 0, vn = 0, matches = 0;
    uint64_t dead = active ? 0ull : pc.tops;

    auto column = [&](int t) {
      const int c = __ldg(qrow + t);
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
      const uint64_t x = eq | vn;
      const uint64_t d0 = (((x & vp) + vp) ^ vp) | x;
      const uint64_t hn = d0 & vp;
      const uint64_t hp = ~(d0 | vp) | vn;
      const uint64_t xs = ((d0 & pc.band) >> 1) & pc.xsm;
      vn = xs & hp;
      vp = (~(hp | xs) | hn) & pc.band;
      if (t >= k) matches += d0 & pc.ones;
    };

    for (int t = 0; t < head_end; ++t) column(t);  // unscored head
    bool all_dead = false;
    for (int i = 0; i < nb && !all_dead; ++i) {
      const int t0 = head_end + i * kBatchCols;
      for (int t = t0; t < t0 + kBatchCols; ++t) column(t);
      latch(dead, matches, (i + 1) * kBatchCols - h - 1, pc);  // pseudo-checkpoint
      all_dead = __all_sync(kFullWarp, dead == pc.tops);
    }
    if (!all_dead) {
      for (int t = head_end + nb * kBatchCols; t < m; ++t) {  // tail holds last_chk
        column(t);
        if (t + 1 == last_chk) latch(dead, matches, last_chk - k - h - 1, pc);
      }
    }
    if (!active) continue;
    int32_t* const orow = out + static_cast<size_t>(q) * n_sub * S_sub + s;
    const int charged = max(m, k);
    for (int j = 0; j < n_sub; ++j) {
      const int o = pitch * j;
      const int err = charged - static_cast<int>((matches >> o) & ((1ull << pitch) - 1ull));
      int cur = err, mn = err;
      for (int i = 0; i <= h; ++i) {
        cur += static_cast<int>((vp >> (o + i)) & 1ull) - static_cast<int>((vn >> (o + i)) & 1ull);
        mn = min(mn, cur);
      }
      orow[static_cast<size_t>(j) * S_sub] = ((dead >> (o + pitch - 1)) & 1ull) ? kMaxError : mn;
    }
  }
}

template <int NSUB>
void launch(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o, int Q,
            int m, int W, int S_sub, int n_sub, int k, int h, int band_down, int last_chk,
            const PackedConsts& pc) {
  banded_packed_kernel<NSUB><<<grid, kThreads, 0, cs>>>(st, qs, o, Q, m, W, S_sub, n_sub, k, h,
                                                        band_down, last_chk, pc);
}

}  // namespace

extern "C" {

int bgsa_banded_packed(const void* streams, const void* queries, void* out, int Q, int m, int W,
                       int S_sub, int n_sub, int k, int h, int band_down, int last_chk,
                       void* cuda_stream) {
  const int pitch = band_down + 2;
  if (Q <= 0 || S_sub <= 0 || W < 3 || m < 0 || band_down < 0 || band_down > 30 || n_sub < 2 ||
      n_sub * pitch > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PackedConsts pc{0, 0, 0, 0};
  for (int j = 0; j < n_sub; ++j) {
    const int o = pitch * j;
    pc.band |= ((1ull << (band_down + 1)) - 1ull) << o;
    pc.xsm |= ((1ull << band_down) - 1ull) << o;
    pc.ones |= 1ull << o;
    pc.tops |= 1ull << (o + pitch - 1);
  }
  const dim3 grid((S_sub + kThreads - 1) / kThreads, Q < kMaxGridY ? Q : kMaxGridY);
  const auto* st = static_cast<const uint32_t*>(streams);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  // the common field counts get an unrolled fold; the rest loop to n_sub
#define BGSA_PACKED_LAUNCH(N) \
  launch<N>(grid, cs, st, qs, o, Q, m, W, S_sub, n_sub, k, h, band_down, last_chk, pc)
  switch (n_sub) {
    case 2: BGSA_PACKED_LAUNCH(2); break;
    case 3: BGSA_PACKED_LAUNCH(3); break;
    case 4: BGSA_PACKED_LAUNCH(4); break;
    case 5: BGSA_PACKED_LAUNCH(5); break;
    case 6: BGSA_PACKED_LAUNCH(6); break;
    default: BGSA_PACKED_LAUNCH(0);
  }
#undef BGSA_PACKED_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
