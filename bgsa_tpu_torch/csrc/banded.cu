// Banded Myers verification (error threshold k) for Hopper: the stream,
// dual-stream and Peq-carry kernels.
//
// Replaces three Pallas TPU kernels of bgsa_tpu/ops/banded.py:
//   * _stream_kernel with dual=False (launched by banded_stream) and with
//     dual=True (banded_stream_dual): here one template on `bool Dual`,
//     banded_stream_kernel<Dual, Wide> (Wide: band_down >= 32);
//   * _kernel (launched by banded, the Peq-carry kernel): banded_peq_kernel.
// Each computes the reference's banded recurrence (bgsa_tpu.banded_ref) per
// (query, subject) pair: a 64-bit band register, err counted from column k,
// early termination at the checkpoint columns (score 127), and the minimum
// over the last row's h + 1 band heights.
//
// What bounds it: a serial chain of 64-bit integer ALU operations per column
// (band_update: ~13 64-bit logic/add/shift operations, each two 32-bit
// instructions, plus the window's funnel shifts and the err/dead updates),
// i.e. int ALU issue rate and dependency latency. The stream kernels read
// two or three 4-byte words per code and stream once every 32 columns (the
// Peq-carry kernel one injection word per character); a bucket's streams
// are reread by every query, so they are L2-resident. wgmma and TMA do not
// apply.
//
// Design (simple first):
//   * one thread per (query, subject): subjects contiguous across a warp
//     (coalesced stream reads), blockIdx.y walks the queries; the TPU's
//     sequential (row block, query) grid becomes that loop, and no state
//     crosses blocks;
//   * native uint64_t for the band register (no (lo, hi) pairs);
//   * stream kernels: the query row is staged once per query in shared
//     memory (every thread of the block reads the same row; the only block
//     barriers are around the staging, which every warp reaches), and the
//     window fold (banded_common.cuh): at the top of each 32-column batch,
//     which is the stream's window w = t0 >> 5, a thread loads every code's
//     words w, w + 1 (and w + 2 where Wide) into its shared-memory slot; a
//     column selects its code's words with one shared load and
//     funnel-shifts them by t & 31 (words past the end read as 0). Codes
//     above 4 are clamped to a zero slot when the row is staged. The dual
//     kernel's columns t <= 2k also read the preload stream A's whole window
//     from a second slot, loaded only in the windows those columns reach;
//     the later columns read B alone (the JAX kernel's split). A batch of
//     32 scored B-only columns that holds no latch but its end runs
//     unrolled, its funnel amounts constants;
//   * the Peq-carry kernel keeps five Peq planes in registers and
//     shifts/injects per column;
//   * early exit: the stream kernels latch dead at every 32-column boundary
//     <= the last checkpoint and at the last checkpoint (err is
//     nondecreasing, so "over budget after some checkpoint" is "over budget
//     after the last one"), the Peq-carry kernel at the reference
//     checkpoints (chk) and the same boundaries; a warp leaves the column
//     loop when __all_sync says all its lanes are dead; lanes past S follow
//     their warp as dead lanes and write nothing;
//   * query codes outside 0..4 match nothing.
// Launches use the caller's stream, allocate nothing (the stream kernels'
// slots and query row are dynamic shared memory), and the C entry points
// return cudaGetLastError().

#include "banded_common.cuh"

namespace {

using namespace bgsa_banded;

// Dynamic shared memory of a stream launch: the preload stream A's slots
// (Dual; whole windows), the slots of the stream (B where Dual), then the
// query row.
__host__ __device__ constexpr size_t stream_smem_bytes(bool dual, bool wide, int m) {
  return (dual ? kSlotCodes * kThreads * sizeof(StreamSlot<true>) : 0) +
         kSlotCodes * kThreads * (wide ? sizeof(StreamSlot<true>) : sizeof(StreamSlot<false>)) +
         m;
}

// stream: (5, W, S) uint32 bit-streams, or (2, 5, W, S) with the preload
// stream A first when Dual; queries: (Q, m) uint8; out: (Q, S) int32.
// Wide: band_down >= 32 (the window's high half is read). Launch bounds: at
// least one block per SM, so ptxas may take the registers it needs: without
// the minimum the <true, true> instance took 56 registers and spilled.
template <bool Dual, bool Wide>
__global__ void __launch_bounds__(kThreads, 1)
banded_stream_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                     int32_t* __restrict__ out, int Q, int m, int W, int S, int k, int h,
                     int band_down, int max_err, int last_chk) {
  extern __shared__ uint4 smem[];
  uint4* const a_slot = smem + threadIdx.x;  // Dual only
  StreamSlot<Wide>* const b_slot =
      reinterpret_cast<StreamSlot<Wide>*>(smem + (Dual ? kSlotCodes * kThreads : 0)) +
      threadIdx.x;
  uint8_t* const qs = reinterpret_cast<uint8_t*>(smem) + stream_smem_bytes(Dual, Wide, 0);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const a_base = stream + (active ? s : S - 1);
  const uint32_t* const b_base = a_base + (Dual ? kChars * plane : 0);
  const uint64_t mask = band_mask(band_down);
  const int head_end = Dual ? min(2 * k + 1, m) : 0;  // columns t <= 2k also read A
  const int lead = max(k, head_end);  // columns unscored or in the dual head
  b_slot[kChars * kThreads] = StreamSlot<Wide>{};  // the zero slot
  if (Dual) a_slot[kChars * kThreads] = uint4{};
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    __syncthreads();  // every warp is done with the previous query's row
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int c = queries[static_cast<size_t>(q) * m + i];
      qs[i] = static_cast<uint8_t>(c < kChars ? c : kChars);
    }
    __syncthreads();
    uint64_t vp = 0, vn = 0;
    int err = k;
    bool dead = !active;

    // columns [ta, tb) of the loaded window: the dual head's (A | B), then B's
    auto columns = [&](int ta, int tb) {
      if constexpr (Dual) {
        const int te = min(tb, head_end);
        for (int t = ta; t < te; ++t) {
          const int c = qs[t], b = t & 31;
          band_update(fold_stream_slot<Wide>(b_slot, c, b, mask) |
                          fold_stream_slot<true>(a_slot, c, b, ~0ull),
                      vp, vn, err, t >= k);
        }
        ta = max(ta, te);
      }
      for (int t = ta; t < tb; ++t) {
        band_update(fold_stream_slot<Wide>(b_slot, qs[t], t & 31, mask), vp, vn, err, t >= k);
      }
    };

    // The 32-column batch at t0, the stream's window t0 >> 5: the window's
    // load, then its columns. Whole: 32 scored B-only columns, unrolled (the
    // funnel amounts constants). dead is latched at the batch ends <=
    // last_chk and at last_chk (err is nondecreasing: the reference's
    // outcome). False when every lane of the warp is dead.
    auto batch = [&](int t0, bool whole) {
      load_stream_slot<Wide>(b_slot, b_base, plane, t0 >> 5, W, S);
      if (Dual && t0 < head_end) load_stream_slot<true>(a_slot, a_base, plane, t0 >> 5, W, S);
      const int t1 = min(t0 + kBatchCols, m);
      const int tc = t0 < last_chk && last_chk < t1 ? last_chk : t1;
      if (whole) {
#pragma unroll
        for (int i = 0; i < kBatchCols; ++i) {
          band_update(fold_stream_slot<Wide>(b_slot, qs[t0 + i], i, mask), vp, vn, err, true);
        }
      } else {
        columns(t0, tc);
      }
      dead |= tc <= last_chk && err > max_err;
      if (!whole) columns(tc, t1);
      return !__all_sync(kFullWarp, dead);
    };

    // the lead's batches, the whole batches up to the one that holds
    // last_chk, then the rest
    bool live = true;
    int t0 = 0;
    for (; live && t0 < m && t0 < lead; t0 += kBatchCols) live = batch(t0, false);
    for (; live && t0 + kBatchCols <= m && (t0 + kBatchCols <= last_chk || t0 >= last_chk);
         t0 += kBatchCols) {
      live = batch(t0, true);
    }
    for (; live && t0 < m; t0 += kBatchCols) live = batch(t0, false);
    if (active) out[static_cast<size_t>(q) * S + s] = band_epilogue(vp, vn, err, dead, h);
  }
}

template <bool Dual, bool Wide>
int launch_stream(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o,
                  int Q, int m, int W, int S, int k, int h, int band_down, int max_err,
                  int last_chk) {
  const size_t smem = stream_smem_bytes(Dual, Wide, m);
  if (smem > 48 * 1024) {  // past the default: opt in (fails past the card's limit)
    const cudaError_t rc = cudaFuncSetAttribute(banded_stream_kernel<Dual, Wide>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  banded_stream_kernel<Dual, Wide><<<grid, kThreads, smem, cs>>>(st, qs, o, Q, m, W, S, k, h,
                                                                 band_down, max_err, last_chk);
  return static_cast<int>(cudaGetLastError());
}

// init_lo/init_hi: (5, S) uint32 halves of the initial Peq window; inj:
// (5, W, S) uint32 injection bits (bit t % 32 of word t / 32 is column t's).
__global__ void __launch_bounds__(kThreads)
banded_peq_kernel(const uint32_t* __restrict__ init_lo, const uint32_t* __restrict__ init_hi,
                  const uint32_t* __restrict__ inj, const uint8_t* __restrict__ queries,
                  const uint8_t* __restrict__ chk, int32_t* __restrict__ out, int Q, int m, int W,
                  int S, int k, int h, int band_down, int max_err, int last_chk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int sl = active ? s : S - 1;
  const int n_inj = m - k;  // injections happen while t < m - k
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const qrow = queries + static_cast<size_t>(q) * m;
    uint64_t peq[kChars];
#pragma unroll
    for (int c = 0; c < kChars; ++c) {
      peq[c] = (static_cast<uint64_t>(__ldg(init_hi + static_cast<size_t>(c) * S + sl)) << 32) |
               __ldg(init_lo + static_cast<size_t>(c) * S + sl);
    }
    uint64_t vp = 0, vn = 0;
    int err = k;
    bool dead = !active;
    for (int t0 = 0; t0 < m; t0 += kBatchCols) {
      const int t1 = min(t0 + kBatchCols, m);
      const int w = min(t0 >> 5, W - 1);
      uint32_t bits[kChars];
#pragma unroll
      for (int c = 0; c < kChars; ++c) {
        bits[c] = __ldg(inj + (static_cast<size_t>(c) * W + w) * S + sl);
      }
      for (int t = t0; t < t1; ++t) {
        const int c = __ldg(qrow + t);
        uint64_t eq = 0;
#pragma unroll
        for (int i = 0; i < kChars; ++i) eq = (i == c) ? peq[i] : eq;  // select, no local memory
        band_update(eq, vp, vn, err, t >= k);
        const bool inject = t < n_inj;
#pragma unroll
        for (int i = 0; i < kChars; ++i) {
          peq[i] >>= 1;
          if (inject) peq[i] |= static_cast<uint64_t>((bits[i] >> (t & 31)) & 1u) << band_down;
        }
        dead |= __ldg(chk + t) && err > max_err;
      }
      dead |= t1 <= last_chk && err > max_err;  // pseudo-checkpoint
      if (__all_sync(kFullWarp, dead)) break;
    }
    if (active) out[static_cast<size_t>(q) * S + s] = band_epilogue(vp, vn, err, dead, h);
  }
}

}  // namespace

extern "C" {

// dual = 0: stream (5, W, S); dual = 1: streams (2, 5, W, S).
int bgsa_banded_stream(const void* stream, const void* queries, void* out, int Q, int m, int W,
                       int S, int k, int h, int band_down, int max_err, int last_chk, int dual,
                       void* cuda_stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0 || band_down < 0 || band_down > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* st = static_cast<const uint32_t*>(stream);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  const dim3 grid = grid_for(S, Q);
  const bool wide = band_down >= 32;
#define BGSA_STREAM_LAUNCH(D, WIDE) \
  launch_stream<D, WIDE>(grid, cs, st, qs, o, Q, m, W, S, k, h, band_down, max_err, last_chk)
  if (dual) return wide ? BGSA_STREAM_LAUNCH(true, true) : BGSA_STREAM_LAUNCH(true, false);
  return wide ? BGSA_STREAM_LAUNCH(false, true) : BGSA_STREAM_LAUNCH(false, false);
#undef BGSA_STREAM_LAUNCH
}

int bgsa_banded_peq(const void* init_lo, const void* init_hi, const void* inj,
                    const void* queries, const void* chk, void* out, int Q, int m, int W, int S,
                    int k, int h, int band_down, int max_err, int last_chk, void* cuda_stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0 || band_down < 0 || band_down > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_peq_kernel<<<grid_for(S, Q), kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(init_lo), static_cast<const uint32_t*>(init_hi),
      static_cast<const uint32_t*>(inj), static_cast<const uint8_t*>(queries),
      static_cast<const uint8_t*>(chk), static_cast<int32_t*>(out), Q, m, W, S, k, h, band_down,
      max_err, last_chk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
