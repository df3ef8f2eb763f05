// Paired-query banded Myers and the banded column's cost probes, for Hopper.
//
// Replaces the two Pallas TPU kernels of scripts/exp_banded_pair.py:
//   * _stream_kernel_pair (launched by banded_stream_pair): two queries' band
//     recurrences in one grid cell; here banded_stream_pair_kernel<Wide>,
//     equal to banded_stream_kernel<false, Wide> (banded.cu) bit for bit;
//   * _probe_kernel (launched by banded_probe): the column with parts
//     switched off; here banded_probe_kernel<Mode>, one instance per mode.
// The experiment asks whether the stream kernel is bound by its one serial
// dependency chain a column (band_update: ~13 dependent 64-bit operations,
// each two 32-bit instructions) rather than by issue: the pair kernel gives
// each thread two independent chains through one column loop, and the
// probes price the per-column form of the column's query-code read (full -
// static_c) and its funnel load (static_c - noload).
//
// What bounds them: as banded.cu, int ALU issue and the band update's
// dependency latency. The pair kernel reads every code's two or three
// L2-resident stream words once per 32 columns, for both chains; a probe
// column reads three stream words and one query code byte.
//
// Design of the pair kernel: banded.cu's stream kernel (window_kernel
// without the preload stream A) with two states a thread:
//   * one thread per (query pair, subject), blockIdx.y walks the pairs (rows
//     2p and 2p + 1);
//   * both query rows are staged once per pair in shared memory (2m bytes;
//     every thread of the block reads the same rows), codes above 4 clamped
//     to the zero slot;
//   * the window fold (banded_common.cuh): at the top of each 32-column
//     batch, the stream's window w = t0 >> 5, a thread loads every code's
//     words w, w + 1 (and w + 2 where Wide: band_down >= 32) into its
//     shared-memory slot once; both chains read it, each selecting its own
//     code's words with one shared load and funnel-shifting them by t & 31.
//     One slot holds all five codes of the thread's subject, so one window
//     load serves both queries. A batch of 32 scored columns that holds no
//     latch but its end runs unrolled, its funnel amounts constants;
//   * the stream kernel's latch rule: dead is latched at the batch ends <=
//     the last checkpoint and at the last checkpoint (err is nondecreasing,
//     so this is the reference's outcome): no checkpoint byte is read;
//   * a warp leaves the column loop when __all_sync sees both states dead in
//     every lane (the JAX kernel's both_dead); lanes past S follow their warp
//     as dead lanes and write nothing.
// Design of the probes: one thread per (query, subject), every column run:
// no checkpoint load, no latch, no early exit, so a score is the band's
// minimum, never 127. kProbeFull is the stream column in its per-column form
// (stream_window: three stream words and the query code from global memory a
// column); kProbeStaticC reads no query code (plane 0 every column);
// kProbeNoLoad reads the subject's stream[0][0] word once, before the loop,
// as every column's window (unmasked, the high word 0). err counts from
// column k in every mode. The column loop is pinned at 16 columns a trip
// plus a one-column remainder loop, so the bound's SASS reader finds the
// column loop of the modes that load no query code
// (bgsa_tpu_torch/roofline.py). The JAX launchers' rows_per_block and unroll
// have no counterpart; query codes outside 0..4 match nothing.
// Launches use the caller's stream, allocate nothing (the pair kernel's
// slots and query rows are dynamic shared memory), and the C entry points
// return cudaGetLastError().

#include "banded_common.cuh"

namespace {

using namespace bgsa_banded;

constexpr int kProbeFull = 0, kProbeStaticC = 1, kProbeNoLoad = 2;
constexpr int kProbeUnroll = 16;  // columns a trip of the probe's main loop

// Column t's stream window for query code c (0 outside 0..4).
__device__ __forceinline__ uint64_t window_for(const uint32_t* __restrict__ base, size_t plane,
                                               int c, int t, int W, int S, uint64_t mask) {
  return c < kChars ? stream_window(base + c * plane, t >> 5, t & 31, W, S) & mask : 0ull;
}

// Dynamic shared memory of a pair launch: the slots, then the two query rows.
__host__ __device__ constexpr size_t pair_smem_bytes(bool wide, int m) {
  return kSlotCodes * kThreads * (wide ? sizeof(StreamSlot<true>) : sizeof(StreamSlot<false>)) +
         2 * static_cast<size_t>(m);
}

// stream: (5, W, S) uint32; queries: (2 * pairs, m) uint8; out: (2 * pairs,
// S) int32. Wide: band_down >= 32 (the window's high half is read). Launch
// bounds: at least one block per SM, as the stream kernel's, so ptxas may
// take the registers the two chains need.
template <bool Wide>
__global__ void __launch_bounds__(kThreads, 1)
banded_stream_pair_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                          int32_t* __restrict__ out, int pairs, int m, int W, int S, int k, int h,
                          int band_down, int max_err, int last_chk) {
  extern __shared__ uint4 smem[];
  StreamSlot<Wide>* const slot = reinterpret_cast<StreamSlot<Wide>*>(smem) + threadIdx.x;
  uint8_t* const qa = reinterpret_cast<uint8_t*>(smem) + pair_smem_bytes(Wide, 0);
  const uint8_t* const qb = qa + m;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const base = stream + (active ? s : S - 1);
  const uint64_t mask = band_mask(band_down);
  slot[kChars * kThreads] = StreamSlot<Wide>{};  // the zero slot
  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    __syncthreads();  // every warp is done with the previous pair's rows
    for (int i = threadIdx.x; i < 2 * m; i += blockDim.x) {  // rows 2p and 2p + 1
      const int c = queries[static_cast<size_t>(2 * p) * m + i];
      qa[i] = static_cast<uint8_t>(c < kChars ? c : kChars);
    }
    __syncthreads();
    uint64_t vpa = 0, vna = 0, vpb = 0, vnb = 0;
    int erra = k, errb = k;
    bool deada = !active, deadb = !active;

    // column t of both chains from the loaded window, at funnel amount b
    auto column = [&](int t, int b, bool scored) {
      band_update(fold_stream_slot<Wide>(slot, qa[t], b, mask), vpa, vna, erra, scored);
      band_update(fold_stream_slot<Wide>(slot, qb[t], b, mask), vpb, vnb, errb, scored);
    };
    auto columns = [&](int ta, int tb) {
      for (int t = ta; t < tb; ++t) column(t, t & 31, t >= k);
    };

    // The 32-column batch at t0, the stream's window t0 >> 5: the window's
    // load, then its columns (whole: 32 scored columns, unrolled). dead is
    // latched at the batch ends <= last_chk and at last_chk. False when
    // both states of every lane of the warp are dead.
    auto batch = [&](int t0, bool whole) {
      load_stream_slot<Wide>(slot, base, plane, t0 >> 5, W, S);
      const int t1 = min(t0 + kBatchCols, m);
      const int tc = t0 < last_chk && last_chk < t1 ? last_chk : t1;
      if (whole) {
#pragma unroll
        for (int i = 0; i < kBatchCols; ++i) column(t0 + i, i, true);
      } else {
        columns(t0, tc);
      }
      const bool latch = tc <= last_chk;
      deada |= latch && erra > max_err;
      deadb |= latch && errb > max_err;
      if (!whole) columns(tc, t1);
      return !__all_sync(kFullWarp, deada && deadb);
    };

    // the unscored lead's batches, the whole batches up to the one that
    // holds last_chk, then the rest
    bool live = true;
    int t0 = 0;
    for (; live && t0 < m && t0 < k; t0 += kBatchCols) live = batch(t0, false);
    for (; live && t0 + kBatchCols <= m && (t0 + kBatchCols <= last_chk || t0 >= last_chk);
         t0 += kBatchCols) {
      live = batch(t0, true);
    }
    for (; live && t0 < m; t0 += kBatchCols) live = batch(t0, false);
    if (active) {
      out[static_cast<size_t>(2 * p) * S + s] = band_epilogue(vpa, vna, erra, deada, h);
      out[static_cast<size_t>(2 * p + 1) * S + s] = band_epilogue(vpb, vnb, errb, deadb, h);
    }
  }
}

template <int Mode>
__device__ __forceinline__ uint64_t probe_window(const uint32_t* __restrict__ base, size_t plane,
                                                 const uint8_t* __restrict__ qrow, int t, int W,
                                                 int S, uint64_t mask, uint64_t hoisted) {
  if (Mode == kProbeNoLoad) return hoisted;
  return window_for(base, plane, Mode == kProbeFull ? __ldg(qrow + t) : 0, t, W, S, mask);
}

// stream: (5, W, S) uint32; queries: (Q, m) uint8; out: (Q, S) int32.
template <int Mode>
__global__ void __launch_bounds__(kThreads)
banded_probe_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                    int32_t* __restrict__ out, int Q, int m, int W, int S, int k, int h,
                    int band_down) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const base = stream + (active ? s : S - 1);
  const uint64_t mask = band_mask(band_down);
  const uint64_t hoisted = Mode == kProbeNoLoad ? __ldg(base) : 0ull;  // stream[0][0][s]
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const qrow = queries + static_cast<size_t>(q) * m;
    uint64_t vp = 0, vn = 0;
    int err = k;
    int t = 0;
#pragma unroll 1
    for (; t + kProbeUnroll <= m; t += kProbeUnroll) {
#pragma unroll
      for (int u = 0; u < kProbeUnroll; ++u) {
        band_update(probe_window<Mode>(base, plane, qrow, t + u, W, S, mask, hoisted), vp, vn,
                    err, t + u >= k);
      }
    }
#pragma unroll 1
    for (; t < m; ++t) {
      band_update(probe_window<Mode>(base, plane, qrow, t, W, S, mask, hoisted), vp, vn, err,
                  t >= k);
    }
    if (active) out[static_cast<size_t>(q) * S + s] = band_epilogue(vp, vn, err, false, h);
  }
}

template <int Mode>
void launch_probe(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o,
                  int Q, int m, int W, int S, int k, int h, int band_down) {
  banded_probe_kernel<Mode><<<grid, kThreads, 0, cs>>>(st, qs, o, Q, m, W, S, k, h, band_down);
}

// Opts in to dynamic shared memory past the default 48 KB where the query
// rows need it (fails past the card's limit), then launches.
template <bool Wide>
int launch_pair(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o,
                int pairs, int m, int W, int S, int k, int h, int band_down, int max_err,
                int last_chk) {
  const size_t smem = pair_smem_bytes(Wide, m);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        banded_stream_pair_kernel<Wide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  banded_stream_pair_kernel<Wide><<<grid, kThreads, smem, cs>>>(st, qs, o, pairs, m, W, S, k, h,
                                                                band_down, max_err, last_chk);
  return static_cast<int>(cudaGetLastError());
}

bool stream_args_ok(int Q, int m, int W, int S, int band_down) {
  return Q > 0 && S > 0 && W > 0 && m >= 0 && band_down >= 0 && band_down <= 63;
}

}  // namespace

extern "C" {

// stream: (5, W, S); Q even (pairs of rows 2p, 2p + 1).
int bgsa_banded_stream_pair(const void* stream, const void* queries, void* out, int Q, int m,
                            int W, int S, int k, int h, int band_down, int max_err, int last_chk,
                            void* cuda_stream) {
  if (!stream_args_ok(Q, m, W, S, band_down) || Q % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* st = static_cast<const uint32_t*>(stream);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  const dim3 grid = grid_for(S, Q / 2);
  return band_down >= 32
             ? launch_pair<true>(grid, cs, st, qs, o, Q / 2, m, W, S, k, h, band_down, max_err,
                                 last_chk)
             : launch_pair<false>(grid, cs, st, qs, o, Q / 2, m, W, S, k, h, band_down, max_err,
                                  last_chk);
}

// mode: 0 full, 1 static_c, 2 noload.
int bgsa_banded_probe(const void* stream, const void* queries, void* out, int Q, int m, int W,
                      int S, int k, int h, int band_down, int mode, void* cuda_stream) {
  if (!stream_args_ok(Q, m, W, S, band_down) || mode < kProbeFull || mode > kProbeNoLoad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* st = static_cast<const uint32_t*>(stream);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  const dim3 grid = grid_for(S, Q);
  if (mode == kProbeFull) {
    launch_probe<kProbeFull>(grid, cs, st, qs, o, Q, m, W, S, k, h, band_down);
  } else if (mode == kProbeStaticC) {
    launch_probe<kProbeStaticC>(grid, cs, st, qs, o, Q, m, W, S, k, h, band_down);
  } else {
    launch_probe<kProbeNoLoad>(grid, cs, st, qs, o, Q, m, W, S, k, h, band_down);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
