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
// n_sub subjects at once), plus the n_sub funnel windows folded into the
// register. wgmma and TMA do not apply.
//
// Design (simple first):
//   * one thread per (query, group of n_sub subjects); blockIdx.y walks the
//     queries; no state crosses blocks;
//   * the query row is staged once per query in shared memory (every thread
//     of the block reads the same row);
//   * the window fold: once per 32-column window of the stream (w =
//     min(t >> 5, W - 2)), a thread loads the two words of each of the 5
//     codes for every field (10 n_sub L2-resident reads, where a column
//     read 2 n_sub) into its shared-memory slot; a column then selects its
//     code's pairs and funnel-shifts each by t & 31 (load_window and
//     fold_window, banded_packed_common.cuh). The window follows t, not the
//     32-column latch batches, which start at min(k, m);
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
//     is dead. The only block barriers are around the query row's staging,
//     which every warp reaches;
//   * the epilogue takes err = max(m, k) - matches per field (k errors are
//     charged up front and every column from k on is scored), then the min
//     over the field's h + 1 band heights;
//   * query codes outside 0..4 match nothing.
// The launch uses the caller's stream, allocates nothing (the slots and the
// query row are dynamic shared memory), and the C entry point returns
// cudaGetLastError().

#include "banded_packed_common.cuh"

namespace {

using namespace bgsa_banded;

// Dynamic shared memory of a launch: the slots, then the query row.
inline size_t packed_smem_bytes(int n_sub, int m) {
  return static_cast<size_t>(n_sub) * kSlotBytesPerField + m;
}

// streams: (n_sub, 5, W, S_sub) uint32; queries: (Q, m) uint8;
// out: (Q, n_sub * S_sub) int32. NSUB > 0 fixes n_sub at compile time.
// Launch bounds: at least one block per SM, so ptxas may take the registers
// it needs. A full SM's 2048 threads (32 registers), the bound of the
// per-column form, spilled the three-field window fold; the slots cap the
// blocks an SM holds anyway (n_sub x 5 KB each: 14 blocks at n_sub = 3).
template <int NSUB>
__global__ void __launch_bounds__(kThreads, 1)
banded_packed_kernel(const uint32_t* __restrict__ streams, const uint8_t* __restrict__ queries,
                     int32_t* __restrict__ out, int Q, int m, int W, int S_sub, int n_sub_rt,
                     int k, int h, int band_down, int last_chk, PackedConsts pc) {
  extern __shared__ uint2 smem[];
  const int n_sub = NSUB > 0 ? NSUB : n_sub_rt;
  const int pitch = band_down + 2;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S_sub;
  const size_t plane = static_cast<size_t>(W) * S_sub;
  const uint32_t* const base = streams + (active ? s : S_sub - 1);
  uint2* const slot = smem + threadIdx.x;
  uint8_t* const qs = reinterpret_cast<uint8_t*>(smem + n_sub * kChars * kThreads);
  const uint32_t wmask = (1u << (band_down + 1)) - 1u;  // band_down <= 30
  const int head_end = min(k, m);
  const int nb = max(0, (last_chk - head_end) / kBatchCols);
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    __syncthreads();  // every warp is done with the previous query's row
    for (int i = threadIdx.x; i < m; i += blockDim.x) qs[i] = queries[static_cast<size_t>(q) * m + i];
    __syncthreads();
    PackedState st;
    st.dead = active ? 0ull : pc.tops;
    int window = -1;

    auto column = [&](int t) {
      const int w = min(t >> 5, W - 2);
      if (w != window) {
        load_window<NSUB>(slot, base, plane, S_sub, n_sub, w);
        window = w;
      }
      packed_update(st, fold_window<NSUB>(slot, n_sub, pitch, wmask, qs[t], t), t >= k, pc);
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
int launch(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o, int Q,
           int m, int W, int S_sub, int n_sub, int k, int h, int band_down, int last_chk,
           const PackedConsts& pc) {
  const size_t smem = packed_smem_bytes(n_sub, m);
  if (smem > 48 * 1024) {  // past the default: opt in (fails past the card's limit)
    const cudaError_t rc = cudaFuncSetAttribute(
        banded_packed_kernel<NSUB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  banded_packed_kernel<NSUB><<<grid, kThreads, smem, cs>>>(st, qs, o, Q, m, W, S_sub, n_sub, k,
                                                           h, band_down, last_chk, pc);
  return static_cast<int>(cudaGetLastError());
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
    case 2: return BGSA_PACKED_LAUNCH(2);
    case 3: return BGSA_PACKED_LAUNCH(3);
    case 4: return BGSA_PACKED_LAUNCH(4);
    case 5: return BGSA_PACKED_LAUNCH(5);
    case 6: return BGSA_PACKED_LAUNCH(6);
    default: return BGSA_PACKED_LAUNCH(0);
  }
#undef BGSA_PACKED_LAUNCH
}

}  // extern "C"
