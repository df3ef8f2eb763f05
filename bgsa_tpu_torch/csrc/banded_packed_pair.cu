// Paired-query packed banded Myers and the packed column's cost probes, for
// Hopper.
//
// Replaces scripts/exp_banded_packed_pair.py::_pair_kernel (the Pallas TPU
// kernel launched by banded_packed_pair): the packed banded kernel with two
// queries' packed states per thread, the experiment that asks whether a
// second independent chain lifts a kernel that one 64-bit register per
// column leaves short of issue. The probes (banded_packed_probe_kernel<Mode>,
// launched by ops/banded_packed_pair.py::banded_packed_probe) price the
// per-column form of the packed column, as banded_pair.cu's probes price the
// stream column: kProbeFull is that column (packed_window: the query code,
// the plane address, two stream words and a funnel shift per field);
// kProbeStaticC reads no query code (code 0 every column); kProbeNoLoad
// folds one window before the loop (code 0, column 0) and uses it every
// column, leaving the band update alone. Every column runs: no latch, no
// early exit, so a score is the band's minimum, never 127. err counts from
// column k in every mode. The column loop is pinned at 16 columns a trip
// plus a one-column remainder loop, so the bound's SASS reader finds the
// column loop of the modes that load no query code
// (bgsa_tpu_torch/roofline.py).
//
// What bounds them: as banded_packed.cu, the packed band update's serial
// chain of 64-bit integer operations (~16 per column for n_sub subjects;
// the pair: two chains a thread), plus n_sub funnel windows per state and
// column (two L2-resident 4-byte stream words each).
//
// Design of the pair kernel: one thread per (query pair, group of n_sub
// subjects), blockIdx.y walks the pairs (rows 2p and 2p + 1). Each state
// reads the subject words of its own query code, once a column
// (packed_window). Everything else is the packed kernel's, from
// banded_packed_common.cuh: the unscored head of min(k, m) columns, the
// SWAR latches at 32-column batch boundaries up to the last checkpoint and
// exactly at it, err = max(m, k) - matches and the threshold clamped at 0
// (where the JAX kernel takes q_len - matches, wrong when q_len < k). A warp
// leaves the column loop when every field of both states of every lane is
// dead. The JAX launcher's rows_per_block and unroll have no counterpart.
// Launches use the caller's stream, allocate nothing, and the C entry
// points return cudaGetLastError().

#include "banded_packed_common.cuh"

namespace {

using namespace bgsa_banded;

// streams: (n_sub, 5, W, S_sub) uint32; queries: (2 * pairs, m) uint8;
// out: (2 * pairs, n_sub * S_sub) int32. NSUB > 0 fixes n_sub at compile time.
template <int NSUB>
__global__ void __launch_bounds__(kThreads)
banded_packed_pair_kernel(const uint32_t* __restrict__ streams,
                          const uint8_t* __restrict__ queries, int32_t* __restrict__ out,
                          int pairs, int m, int W, int S_sub, int n_sub_rt, int k, int h,
                          int band_down, int last_chk, PackedConsts pc) {
  const int n_sub = NSUB > 0 ? NSUB : n_sub_rt;
  const int pitch = band_down + 2;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S_sub;
  const size_t plane = static_cast<size_t>(W) * S_sub;
  const uint32_t* const base = streams + (active ? s : S_sub - 1);
  const uint32_t wmask = (1u << (band_down + 1)) - 1u;  // band_down <= 30
  const int head_end = min(k, m);
  const int nb = max(0, (last_chk - head_end) / kBatchCols);
  for (int p = blockIdx.y; p < pairs; p += gridDim.y) {
    const uint8_t* const qa = queries + static_cast<size_t>(2 * p) * m;
    const uint8_t* const qb = qa + m;
    PackedState a, b;
    a.dead = b.dead = active ? 0ull : pc.tops;

    auto column = [&](int t) {
      const uint64_t eqa = packed_window<NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask,
                                               __ldg(qa + t), t);
      const uint64_t eqb = packed_window<NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask,
                                               __ldg(qb + t), t);
      packed_update(a, eqa, t >= k, pc);
      packed_update(b, eqb, t >= k, pc);
    };

    for (int t = 0; t < head_end; ++t) column(t);  // unscored head
    bool all_dead = false;
    for (int i = 0; i < nb && !all_dead; ++i) {
      const int t0 = head_end + i * kBatchCols;
      for (int t = t0; t < t0 + kBatchCols; ++t) column(t);
      const int thr = (i + 1) * kBatchCols - h - 1;  // pseudo-checkpoint
      latch(a.dead, a.matches, thr, pc);
      latch(b.dead, b.matches, thr, pc);
      all_dead = __all_sync(kFullWarp, a.dead == pc.tops && b.dead == pc.tops);
    }
    if (!all_dead) {
      for (int t = head_end + nb * kBatchCols; t < m; ++t) {  // tail holds last_chk
        column(t);
        if (t + 1 == last_chk) {
          latch(a.dead, a.matches, last_chk - k - h - 1, pc);
          latch(b.dead, b.matches, last_chk - k - h - 1, pc);
        }
      }
    }
    if (!active) continue;
    int32_t* const row = out + static_cast<size_t>(2 * p) * n_sub * S_sub + s;
    packed_epilogue(a, row, S_sub, n_sub, pitch, h, max(m, k));
    packed_epilogue(b, row + static_cast<size_t>(n_sub) * S_sub, S_sub, n_sub, pitch, h,
                    max(m, k));
  }
}

template <int NSUB>
void launch(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o,
            int pairs, int m, int W, int S_sub, int n_sub, int k, int h, int band_down,
            int last_chk, const PackedConsts& pc) {
  banded_packed_pair_kernel<NSUB><<<grid, kThreads, 0, cs>>>(st, qs, o, pairs, m, W, S_sub, n_sub,
                                                             k, h, band_down, last_chk, pc);
}

constexpr int kProbeFull = 0, kProbeStaticC = 1, kProbeNoLoad = 2;
constexpr int kProbeUnroll = 16;  // columns a trip of the probe's main loop

template <int Mode, int NSUB>
__device__ __forceinline__ uint64_t probe_window(const uint32_t* __restrict__ base, size_t plane,
                                                 int S_sub, int W, int n_sub, int pitch,
                                                 uint32_t wmask, const uint8_t* __restrict__ qrow,
                                                 int t, uint64_t hoisted) {
  if (Mode == kProbeNoLoad) return hoisted;
  return packed_window<NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask,
                             Mode == kProbeFull ? __ldg(qrow + t) : 0, t);
}

// streams: (n_sub, 5, W, S_sub) uint32; queries: (Q, m) uint8;
// out: (Q, n_sub * S_sub) int32. NSUB > 0 fixes n_sub at compile time.
template <int Mode, int NSUB>
__global__ void __launch_bounds__(kThreads)
banded_packed_probe_kernel(const uint32_t* __restrict__ streams,
                           const uint8_t* __restrict__ queries, int32_t* __restrict__ out, int Q,
                           int m, int W, int S_sub, int n_sub_rt, int k, int h, int band_down,
                           PackedConsts pc) {
  const int n_sub = NSUB > 0 ? NSUB : n_sub_rt;
  const int pitch = band_down + 2;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S_sub;
  const size_t plane = static_cast<size_t>(W) * S_sub;
  const uint32_t* const base = streams + (active ? s : S_sub - 1);
  const uint32_t wmask = (1u << (band_down + 1)) - 1u;  // band_down <= 30
  const uint64_t hoisted =
      Mode == kProbeNoLoad
          ? packed_window<NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask, 0, 0)
          : 0ull;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const qrow = queries + static_cast<size_t>(q) * m;
    PackedState st;
    int t = 0;
#pragma unroll 1
    for (; t + kProbeUnroll <= m; t += kProbeUnroll) {
#pragma unroll
      for (int u = 0; u < kProbeUnroll; ++u) {
        packed_update(st, probe_window<Mode, NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask,
                                                   qrow, t + u, hoisted),
                      t + u >= k, pc);
      }
    }
#pragma unroll 1
    for (; t < m; ++t) {
      packed_update(st, probe_window<Mode, NSUB>(base, plane, S_sub, W, n_sub, pitch, wmask, qrow,
                                                 t, hoisted),
                    t >= k, pc);
    }
    if (active) {
      packed_epilogue(st, out + static_cast<size_t>(q) * n_sub * S_sub + s, S_sub, n_sub, pitch,
                      h, max(m, k));
    }
  }
}

template <int Mode>
void launch_probe(dim3 grid, cudaStream_t cs, const uint32_t* st, const uint8_t* qs, int32_t* o,
                  int Q, int m, int W, int S_sub, int n_sub, int k, int h, int band_down,
                  const PackedConsts& pc) {
  // the experiments' geometry (n_sub = 3) unrolled, as the packed kernel
  // unrolls it; other field counts loop to n_sub
  if (n_sub == 3) {
    banded_packed_probe_kernel<Mode, 3><<<grid, kThreads, 0, cs>>>(st, qs, o, Q, m, W, S_sub,
                                                                   n_sub, k, h, band_down, pc);
  } else {
    banded_packed_probe_kernel<Mode, 0><<<grid, kThreads, 0, cs>>>(st, qs, o, Q, m, W, S_sub,
                                                                   n_sub, k, h, band_down, pc);
  }
}

}  // namespace

extern "C" {

// Q even (pairs of rows 2p, 2p + 1); otherwise bgsa_banded_packed's arguments.
int bgsa_banded_packed_pair(const void* streams, const void* queries, void* out, int Q, int m,
                            int W, int S_sub, int n_sub, int k, int h, int band_down, int last_chk,
                            void* cuda_stream) {
  if (!packed_args_ok(Q, m, W, S_sub, n_sub, band_down) || Q % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedConsts pc = packed_consts(n_sub, band_down);
  const dim3 grid = grid_for(S_sub, Q / 2);
  const auto* st = static_cast<const uint32_t*>(streams);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  // the packed kernel's instantiations: unrolled folds for 2..6 fields
#define BGSA_PAIR_LAUNCH(N) \
  launch<N>(grid, cs, st, qs, o, Q / 2, m, W, S_sub, n_sub, k, h, band_down, last_chk, pc)
  switch (n_sub) {
    case 2: BGSA_PAIR_LAUNCH(2); break;
    case 3: BGSA_PAIR_LAUNCH(3); break;
    case 4: BGSA_PAIR_LAUNCH(4); break;
    case 5: BGSA_PAIR_LAUNCH(5); break;
    case 6: BGSA_PAIR_LAUNCH(6); break;
    default: BGSA_PAIR_LAUNCH(0);
  }
#undef BGSA_PAIR_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// bgsa_banded_packed's arguments without last_chk, and the mode: 0 full,
// 1 static_c, 2 noload.
int bgsa_banded_packed_probe(const void* streams, const void* queries, void* out, int Q, int m,
                             int W, int S_sub, int n_sub, int k, int h, int band_down, int mode,
                             void* cuda_stream) {
  if (!packed_args_ok(Q, m, W, S_sub, n_sub, band_down) || mode < kProbeFull ||
      mode > kProbeNoLoad) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PackedConsts pc = packed_consts(n_sub, band_down);
  const dim3 grid = grid_for(S_sub, Q);
  const auto* st = static_cast<const uint32_t*>(streams);
  const auto* qs = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  if (mode == kProbeFull) {
    launch_probe<kProbeFull>(grid, cs, st, qs, o, Q, m, W, S_sub, n_sub, k, h, band_down, pc);
  } else if (mode == kProbeStaticC) {
    launch_probe<kProbeStaticC>(grid, cs, st, qs, o, Q, m, W, S_sub, n_sub, k, h, band_down, pc);
  } else {
    launch_probe<kProbeNoLoad>(grid, cs, st, qs, o, Q, m, W, S_sub, n_sub, k, h, band_down, pc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
