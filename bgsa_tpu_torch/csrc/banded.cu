// Banded Myers verification (error threshold k) for Hopper: the stream,
// dual-stream and Peq-carry kernels.
//
// Replaces three Pallas TPU kernels of bgsa_tpu/ops/banded.py:
//   * _stream_kernel with dual=False (launched by banded_stream) and with
//     dual=True (banded_stream_dual): here one template on `bool Dual`,
//     banded_stream_kernel<Dual, Wide> (Wide: band_down >= 32);
//   * _kernel (launched by banded, the Peq-carry kernel):
//     banded_peq_kernel<Wide>.
// Each computes the reference's banded recurrence (bgsa_tpu.banded_ref) per
// (query, subject) pair: a 64-bit band register, err counted from column k,
// early termination at the checkpoint columns (score 127), and the minimum
// over the last row's h + 1 band heights.
//
// What bounds it: a serial chain of 64-bit integer ALU operations per column
// (band_update: ~13 64-bit logic/add/shift operations, each two 32-bit
// instructions, plus the window's funnel shifts and the err/dead updates),
// i.e. int ALU issue rate and dependency latency. The kernels read two or
// three 4-byte words per code and stream once every 32 columns; a bucket's
// streams are reread by every query, so they are L2-resident. wgmma and TMA
// do not apply.
//
// Design (simple first), one body for all three (window_kernel):
//   * one thread per (query, subject): subjects contiguous across a warp
//     (coalesced stream reads), blockIdx.y walks the queries; the TPU's
//     sequential (row block, query) grid becomes that loop, and no state
//     crosses blocks;
//   * native uint64_t for the band register (no (lo, hi) pairs);
//   * the query row is staged once per query in shared memory (every thread
//     of the block reads the same row; the only block barriers are around
//     the staging, which every warp reaches); codes above 4 are clamped to
//     a zero slot there, so they match nothing without a check a column;
//   * the window fold (banded_common.cuh): at the top of each 32-column
//     batch, which is the stream's window w = t0 >> 5, a thread loads every
//     code's words w, w + 1 (and w + 2 where Wide) of the stream B into its
//     shared-memory slot; a column selects its code's words with one shared
//     load and funnel-shifts them by t & 31, masked to the band. The columns
//     t < head_end also read a preload stream A's whole window from a second
//     slot, loaded only in the windows those columns reach; the later
//     columns read B alone. A batch of 32 scored B-only columns that holds
//     no latch but its end runs unrolled, its funnel amounts constants;
//   * where the slots come from (a Source): the stream kernels load B (and
//     the dual kernel A, head_end = 2k + 1) from the packed streams; the
//     Peq-carry kernel takes A from the initial window (the words init_lo,
//     init_hi, zero past them: head_end = 64) and builds B at each batch's
//     top from the injection words, injection bit u at stream position
//     band_down + 1 + u (PeqSource). Unrolled, the reference's
//     peq_{t+1} = (peq_t >> 1) | (inj_t << band_down) while t < q_len - k
//     is (init >> t) | (B's window at t, masked to the band), so no plane
//     is shifted a column;
//   * early exit: dead is latched at every 32-column boundary <= the last
//     checkpoint and at the last checkpoint (err is nondecreasing, so "over
//     budget after some checkpoint" is "over budget after the last one");
//     a warp leaves the column loop when __all_sync says all its lanes are
//     dead; lanes past S follow their warp as dead lanes and write nothing.
// Launches use the caller's stream, allocate nothing (the slots and the
// query row are dynamic shared memory), and the C entry points return
// cudaGetLastError().

#include "banded_common.cuh"

namespace {

using namespace bgsa_banded;

// Dynamic shared memory of a window launch: the preload stream A's slots
// (has_a; whole windows), the slots of the stream B, then the query row.
__host__ __device__ constexpr size_t window_smem_bytes(bool has_a, bool wide, int m) {
  return (has_a ? kSlotCodes * kThreads * sizeof(StreamSlot<true>) : 0) +
         kSlotCodes * kThreads * (wide ? sizeof(StreamSlot<true>) : sizeof(StreamSlot<false>)) +
         m;
}

// The stream kernels' slots: B from the stream (5, W, S), A (dual) from the
// preload stream before it; base pointers at the thread's subject.
struct StreamSource {
  const uint32_t* a_base;
  const uint32_t* b_base;
  size_t plane;
  int W, S;

  template <bool Wide>
  __device__ __forceinline__ void load_b(StreamSlot<Wide>* slot, int w) const {
    load_stream_slot<Wide>(slot, b_base, plane, w, W, S);
  }
  __device__ __forceinline__ void load_a(StreamSlot<true>* slot, int w) const {
    load_stream_slot<true>(slot, a_base, plane, w, W, S);
  }
};

// The Peq-carry kernel's slots, pointers at the thread's subject: A is the
// initial window, the stream of words (init_lo, init_hi) and zero past them
// (read in windows 0 and 1 only); B is the injection stream shifted to
// band_down + 1: its word j holds injection bits [32j - band_down - 1,
// 32j - band_down + 30], one funnel shift of two injection words, bits
// below 0 and from n_inj = q_len - k on zero. Injection word i is inj's
// min(i, W - 1), the reference's clamp.
struct PeqSource {
  const uint32_t* init_lo;
  const uint32_t* init_hi;
  const uint32_t* inj;
  int W, S, n_inj, band_down;

  __device__ __forceinline__ uint32_t inj_word(int c, int i) const {
    return i < 0 ? 0u : __ldg(inj + (static_cast<size_t>(c) * W + min(i, W - 1)) * S);
  }

  // Word j of B: injection bits from 32j - band_down - 1, where the first
  // injection word read (i0 = j - 1, or j - 2 where Wide) holds bit 0 of
  // the funnel shift.
  __device__ __forceinline__ uint32_t b_word(uint32_t lo, uint32_t hi, int j, int sh) const {
    const int keep = n_inj + band_down + 1 - kBatchCols * j;  // bits below n_inj
    const uint32_t mask = keep >= 32 ? ~0u : keep <= 0 ? 0u : (1u << keep) - 1u;
    return __funnelshift_r(lo, hi, sh) & mask;
  }

  template <bool Wide>
  __device__ __forceinline__ void load_b(StreamSlot<Wide>* slot, int w) const {
    const int i0 = w - (Wide ? 2 : 1);
    const int sh = (Wide ? 63 : 31) - band_down;
#pragma unroll
    for (int c = 0; c < kChars; ++c) {
      const uint32_t x0 = inj_word(c, i0), x1 = inj_word(c, i0 + 1), x2 = inj_word(c, i0 + 2);
      if constexpr (Wide) {
        const uint32_t x3 = inj_word(c, i0 + 3);
        slot[c * kThreads] = make_uint4(b_word(x0, x1, w, sh), b_word(x1, x2, w + 1, sh),
                                        b_word(x2, x3, w + 2, sh), 0u);
      } else {
        slot[c * kThreads] = make_uint2(b_word(x0, x1, w, sh), b_word(x1, x2, w + 1, sh));
      }
    }
  }
  __device__ __forceinline__ void load_a(StreamSlot<true>* slot, int w) const {
#pragma unroll
    for (int c = 0; c < kChars; ++c) {
      const uint32_t hi = __ldg(init_hi + static_cast<size_t>(c) * S);
      slot[c * kThreads] = w == 0 ? make_uint4(__ldg(init_lo + static_cast<size_t>(c) * S), hi,
                                               0u, 0u)
                                  : make_uint4(hi, 0u, 0u, 0u);
    }
  }
};

// One thread per (query, subject) over queries (Q, m) uint8; out: (Q, S)
// int32. HasA: the columns t < head_end also read A's slot. Wide:
// band_down >= 32 (B's window's high half is read).
template <bool HasA, bool Wide, class Source>
__device__ __forceinline__ void window_kernel(const Source& src,
                                              const uint8_t* __restrict__ queries,
                                              int32_t* __restrict__ out, int Q, int m, int S,
                                              int k, int h, int band_down, int max_err,
                                              int last_chk, int head_end) {
  extern __shared__ uint4 smem[];
  uint4* const a_slot = smem + threadIdx.x;  // HasA only
  StreamSlot<Wide>* const b_slot =
      reinterpret_cast<StreamSlot<Wide>*>(smem + (HasA ? kSlotCodes * kThreads : 0)) +
      threadIdx.x;
  uint8_t* const qs = reinterpret_cast<uint8_t*>(smem) + window_smem_bytes(HasA, Wide, 0);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const uint64_t mask = band_mask(band_down);
  const int lead = max(k, head_end);  // columns unscored or in the head
  b_slot[kChars * kThreads] = StreamSlot<Wide>{};  // the zero slot
  if (HasA) a_slot[kChars * kThreads] = uint4{};
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

    // columns [ta, tb) of the loaded window: the head's (A | B), then B's
    auto columns = [&](int ta, int tb) {
      if constexpr (HasA) {
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
      src.template load_b<Wide>(b_slot, t0 >> 5);
      if (HasA && t0 < head_end) src.load_a(a_slot, t0 >> 5);
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

// stream: (5, W, S) uint32 bit-streams, or (2, 5, W, S) with the preload
// stream A first when Dual (its columns t <= 2k read A). Launch bounds: at
// least one block per SM, so ptxas may take the registers it needs: without
// the minimum the <true, true> instance took 56 registers and spilled.
template <bool Dual, bool Wide>
__global__ void __launch_bounds__(kThreads, 1)
banded_stream_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                     int32_t* __restrict__ out, int Q, int m, int W, int S, int k, int h,
                     int band_down, int max_err, int last_chk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const a_base = stream + (s < S ? s : S - 1);
  const StreamSource src{a_base, a_base + (Dual ? kChars * plane : 0), plane, W, S};
  window_kernel<Dual, Wide>(src, queries, out, Q, m, S, k, h, band_down, max_err, last_chk,
                            Dual ? min(2 * k + 1, m) : 0);
}

// init_lo/init_hi: (5, S) uint32 halves of the initial Peq window; inj:
// (5, W, S) uint32 injection bits (bit t % 32 of word t / 32 is column t's).
template <bool Wide>
__global__ void __launch_bounds__(kThreads, 1)
banded_peq_kernel(const uint32_t* __restrict__ init_lo, const uint32_t* __restrict__ init_hi,
                  const uint32_t* __restrict__ inj, const uint8_t* __restrict__ queries,
                  int32_t* __restrict__ out, int Q, int m, int W, int S, int k, int h,
                  int band_down, int max_err, int last_chk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const int sl = s < S ? s : S - 1;
  const PeqSource src{init_lo + sl, init_hi + sl, inj + sl, W, S, m - k, band_down};
  window_kernel<true, Wide>(src, queries, out, Q, m, S, k, h, band_down, max_err, last_chk,
                            min(64, m));  // A is two words: the columns t < 64 read it
}

// Opts in to dynamic shared memory past the default 48 KB where the query
// row needs it (fails past the card's limit), then launches.
template <class Kernel, class... Args>
int launch_window(Kernel kernel, size_t smem, dim3 grid, cudaStream_t cs, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<grid, kThreads, smem, cs>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int Q, int m, int W, int S, int band_down) {
  return Q <= 0 || S <= 0 || W <= 0 || m < 0 || band_down < 0 || band_down > 63;
}

}  // namespace

extern "C" {

// dual = 0: stream (5, W, S); dual = 1: streams (2, 5, W, S).
int bgsa_banded_stream(const void* stream, const void* queries, void* out, int Q, int m, int W,
                       int S, int k, int h, int band_down, int max_err, int last_chk, int dual,
                       void* cuda_stream) {
  if (bad_shape(Q, m, W, S, band_down)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const uint32_t*>(stream);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  const dim3 grid = grid_for(S, Q);
  const bool wide = band_down >= 32;
  const size_t smem = window_smem_bytes(dual, wide, m);
#define BGSA_STREAM_LAUNCH(D, WIDE)                                                              \
  launch_window(banded_stream_kernel<D, WIDE>, smem, grid, cs, st, qs, o, Q, m, W, S, k, h, \
                band_down, max_err, last_chk)
  if (dual) return wide ? BGSA_STREAM_LAUNCH(true, true) : BGSA_STREAM_LAUNCH(true, false);
  return wide ? BGSA_STREAM_LAUNCH(false, true) : BGSA_STREAM_LAUNCH(false, false);
#undef BGSA_STREAM_LAUNCH
}

int bgsa_banded_peq(const void* init_lo, const void* init_hi, const void* inj,
                    const void* queries, void* out, int Q, int m, int W, int S, int k, int h,
                    int band_down, int max_err, int last_chk, void* cuda_stream) {
  if (bad_shape(Q, m, W, S, band_down)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* lo = static_cast<const uint32_t*>(init_lo);
  const auto* hi = static_cast<const uint32_t*>(init_hi);
  const auto* in = static_cast<const uint32_t*>(inj);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  const dim3 grid = grid_for(S, Q);
  const bool wide = band_down >= 32;
  const size_t smem = window_smem_bytes(true, wide, m);
  return wide ? launch_window(banded_peq_kernel<true>, smem, grid, cs, lo, hi, in, qs, o, Q, m,
                              W, S, k, h, band_down, max_err, last_chk)
              : launch_window(banded_peq_kernel<false>, smem, grid, cs, lo, hi, in, qs, o, Q, m,
                              W, S, k, h, band_down, max_err, last_chk);
}

}  // extern "C"
