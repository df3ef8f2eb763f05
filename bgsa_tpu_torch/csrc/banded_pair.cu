// Paired-query banded Myers and the banded column's cost probes, for Hopper.
//
// Replaces the two Pallas TPU kernels of scripts/exp_banded_pair.py:
//   * _stream_kernel_pair (launched by banded_stream_pair): two queries' band
//     recurrences in one grid cell; here banded_stream_pair_kernel, equal to
//     banded_stream_kernel<false, Wide> (banded.cu) bit for bit;
//   * _probe_kernel (launched by banded_probe): the column with parts
//     switched off; here banded_probe_kernel<Mode>, one instance per mode.
// The experiment asks whether the stream kernel is bound by its one serial
// dependency chain a column (band_update: ~13 dependent 64-bit operations,
// each two 32-bit instructions) rather than by issue: the pair kernel gives
// each thread two independent chains through one column loop, and the
// probes price the column's query-code read (full - static_c) and its
// funnel load (static_c - noload).
//
// What bounds them: as banded.cu, int ALU issue and the band update's
// dependency latency. A column reads three 4-byte stream words and one query
// code byte per state (the pair kernel also one checkpoint byte), all
// L2-resident: a bucket's stream is reread by every query.
//
// Design (simple first, banded.cu's shape):
//   * pair: one thread per (query pair, subject), blockIdx.y walks the pairs
//     (rows 2p and 2p + 1). The two states run through one column loop built
//     from banded_common.cuh's stream_window, band_update and band_epilogue;
//     dead is latched at the checkpoints (chk) and at 32-column boundaries up
//     to the last checkpoint (the stream kernel's per-column form, before its
//     window fold: the same outcome), and a warp leaves
//     the loop when __all_sync sees both states dead in every lane (the JAX
//     kernel's both_dead). Lanes past S follow their warp as dead lanes.
//   * probe: one thread per (query, subject), every column run: no checkpoint
//     load, no latch, no early exit, so a score is the band's minimum, never
//     127. kProbeFull is the stream column; kProbeStaticC reads no query code
//     (plane 0 every column); kProbeNoLoad reads the subject's stream[0][0]
//     word once, before the loop, as every column's window (unmasked, the
//     high word 0). err counts from column k in every mode. The column loop
//     is pinned at 16 columns a trip plus a one-column remainder loop, so the
//     bound's SASS reader finds the column loop of the modes that load no
//     query code (bgsa_tpu_torch/roofline.py).
//   * the JAX launchers' rows_per_block and unroll have no counterpart;
//     query codes outside 0..4 match nothing.
// Launches use the caller's stream, allocate nothing, and the C entry points
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

// stream: (5, W, S) uint32; queries: (2 * pairs, m) uint8; chk: (m,) uint8
// (1 after a reference checkpoint column); out: (2 * pairs, S) int32.
__global__ void __launch_bounds__(kThreads)
banded_stream_pair_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                          const uint8_t* __restrict__ chk, int32_t* __restrict__ out, int pairs,
                          int m, int W, int S, int k, int h, int band_down, int max_err,
                          int last_chk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const base = stream + (active ? s : S - 1);
  const uint64_t mask = band_mask(band_down);
  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    const uint8_t* const qa = queries + static_cast<size_t>(2 * p) * m;
    const uint8_t* const qb = qa + m;
    uint64_t vpa = 0, vna = 0, vpb = 0, vnb = 0;
    int erra = k, errb = k;
    bool deada = !active, deadb = !active;
    for (int t0 = 0; t0 < m; t0 += kBatchCols) {
      const int t1 = min(t0 + kBatchCols, m);
      for (int t = t0; t < t1; ++t) {
        const uint64_t eqa = window_for(base, plane, __ldg(qa + t), t, W, S, mask);
        const uint64_t eqb = window_for(base, plane, __ldg(qb + t), t, W, S, mask);
        band_update(eqa, vpa, vna, erra, t >= k);
        band_update(eqb, vpb, vnb, errb, t >= k);
        const bool check = __ldg(chk + t);
        deada |= check && erra > max_err;
        deadb |= check && errb > max_err;
      }
      const bool mark = t1 <= last_chk;  // pseudo-checkpoint
      deada |= mark && erra > max_err;
      deadb |= mark && errb > max_err;
      if (__all_sync(kFullWarp, deada && deadb)) break;
    }
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

bool stream_args_ok(int Q, int m, int W, int S, int band_down) {
  return Q > 0 && S > 0 && W > 0 && m >= 0 && band_down >= 0 && band_down <= 63;
}

}  // namespace

extern "C" {

// stream: (5, W, S); Q even (pairs of rows 2p, 2p + 1).
int bgsa_banded_stream_pair(const void* stream, const void* queries, const void* chk, void* out,
                            int Q, int m, int W, int S, int k, int h, int band_down, int max_err,
                            int last_chk, void* cuda_stream) {
  if (!stream_args_ok(Q, m, W, S, band_down) || Q % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  banded_stream_pair_kernel<<<grid_for(S, Q / 2), kThreads, 0,
                              static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint32_t*>(stream), static_cast<const uint8_t*>(queries),
      static_cast<const uint8_t*>(chk), static_cast<int32_t*>(out), Q / 2, m, W, S, k, h,
      band_down, max_err, last_chk);
  return static_cast<int>(cudaGetLastError());
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
