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

#include "banded_packed_common.cuh"

namespace {

using namespace bgsa_banded;

// A full SM's 2048 threads in blocks of kThreads.
constexpr int kFullSmBlocks = 2048 / kThreads;

// streams: (n_sub, 5, W, S_sub) uint32; queries: (Q, m) uint8;
// out: (Q, n_sub * S_sub) int32. NSUB > 0 fixes n_sub at compile time.
// Launch bounds: with none beyond kThreads, ptxas compiles every instance to
// 32 registers (a full SM) but the two-field one to 40 registers with a
// 4-byte spill; that one asks for at least one block per SM and spills
// nothing (58 registers, 8 blocks an SM instead of 12; on an H100 no slower,
// PERF.md), the others keep their 32 registers.
template <int NSUB>
__global__ void __launch_bounds__(kThreads, NSUB == 2 ? 1 : kFullSmBlocks)
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
    PackedState st;
    st.dead = active ? 0ull : pc.tops;

    auto column = [&](int t) {
      const uint64_t eq = packed_window<NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask,
                                              __ldg(qrow + t), t);
      packed_update(st, eq, t >= k, pc);
    };

    for (int t = 0; t < head_end; ++t) column(t);  // unscored head
    bool all_dead = false;
    for (int i = 0; i < nb && !all_dead; ++i) {
      const int t0 = head_end + i * kBatchCols;
      for (int t = t0; t < t0 + kBatchCols; ++t) column(t);
      latch(st.dead, st.matches, (i + 1) * kBatchCols - h - 1, pc);  // pseudo-checkpoint
      all_dead = __all_sync(kFullWarp, st.dead == pc.tops);
    }
    if (!all_dead) {
      for (int t = head_end + nb * kBatchCols; t < m; ++t) {  // tail holds last_chk
        column(t);
        if (t + 1 == last_chk) latch(st.dead, st.matches, last_chk - k - h - 1, pc);
      }
    }
    if (!active) continue;
    packed_epilogue(st, out + static_cast<size_t>(q) * n_sub * S_sub + s, S_sub, n_sub, pitch, h,
                    max(m, k));
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
  if (!packed_args_ok(Q, m, W, S_sub, n_sub, band_down)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedConsts pc = packed_consts(n_sub, band_down);
  const dim3 grid = grid_for(S_sub, Q);
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
