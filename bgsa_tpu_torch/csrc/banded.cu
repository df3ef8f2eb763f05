// Banded Myers verification (error threshold k) for Hopper: the stream,
// dual-stream and Peq-carry kernels.
//
// Replaces three Pallas TPU kernels of bgsa_tpu/ops/banded.py:
//   * _stream_kernel with dual=False (launched by banded_stream) and with
//     dual=True (banded_stream_dual): here one template on `bool Dual`,
//     banded_stream_kernel<Dual>;
//   * _kernel (launched by banded, the Peq-carry kernel): banded_peq_kernel.
// Each computes the reference's banded recurrence (bgsa_tpu.banded_ref) per
// (query, subject) pair: a 64-bit band register, err counted from column k,
// early termination at the checkpoint columns (score 127), and the minimum
// over the last row's h + 1 band heights.
//
// What bounds it: a serial chain of 64-bit integer ALU operations per column
// (band_update: ~13 64-bit logic/add/shift operations, each two 32-bit
// instructions, plus the window's funnel shifts and the err/dead updates),
// i.e. int ALU issue rate and dependency latency. A column reads three
// 4-byte stream words per stream (one Peq-carry injection word per character
// every 32 columns); a bucket's streams are reread by every query, so they
// are L2-resident. wgmma and TMA do not apply.
//
// Design (simple first):
//   * one thread per (query, subject): subjects contiguous across a warp
//     (coalesced stream reads), blockIdx.y walks the queries; the TPU's
//     sequential (row block, query) grid becomes that loop, and no state
//     crosses blocks;
//   * native uint64_t for the band register (no (lo, hi) pairs);
//   * stream kernels load each column's window with funnel shifts from the
//     flat bit-streams (words past the end read as 0); the Peq-carry kernel
//     keeps five Peq planes in registers and shifts/injects per column;
//   * early exit: dead is latched at the reference checkpoints (chk) and at
//     every 32-column boundary <= the last checkpoint (err is nondecreasing,
//     so such a latch changes no outcome), and a warp leaves the column loop
//     when __all_sync says all its lanes are dead. No shared memory and no
//     block barrier, so a warp that leaves early cannot strand the others;
//     lanes past S follow their warp as dead lanes and write nothing;
//   * query codes outside 0..4 match nothing.
// Launches use the caller's stream, allocate nothing, and the C entry points
// return cudaGetLastError().

#include "banded_common.cuh"

namespace {

using namespace bgsa_banded;

// stream: (5, W, S) uint32 bit-streams, or (2, 5, W, S) with the preload
// stream A first when Dual; queries: (Q, m) uint8; chk: (m,) uint8 (1 after
// a reference checkpoint column); out: (Q, S) int32.
template <bool Dual>
__global__ void __launch_bounds__(kThreads)
banded_stream_kernel(const uint32_t* __restrict__ stream, const uint8_t* __restrict__ queries,
                     const uint8_t* __restrict__ chk, int32_t* __restrict__ out, int Q, int m,
                     int W, int S, int k, int h, int band_down, int max_err, int last_chk) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const uint32_t* const a_base = stream + (active ? s : S - 1);
  const uint32_t* const b_base = a_base + (Dual ? kChars * plane : 0);
  const uint64_t mask = band_mask(band_down);
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const qrow = queries + static_cast<size_t>(q) * m;
    uint64_t vp = 0, vn = 0;
    int err = k;
    bool dead = !active;
    for (int t0 = 0; t0 < m; t0 += kBatchCols) {
      const int t1 = min(t0 + kBatchCols, m);
      for (int t = t0; t < t1; ++t) {
        const int c = __ldg(qrow + t);
        uint64_t eq = 0;
        if (c < kChars) {
          const int w = t >> 5, b = t & 31;
          // injections are real only at heights <= band_down
          eq = stream_window(b_base + c * plane, w, b, W, S) & mask;
          // the preload stream A is empty past position 2k
          if (Dual && t <= 2 * k) eq |= stream_window(a_base + c * plane, w, b, W, S);
        }
        band_update(eq, vp, vn, err, t >= k);
        dead |= __ldg(chk + t) && err > max_err;
      }
      dead |= t1 <= last_chk && err > max_err;  // pseudo-checkpoint
      if (__all_sync(kFullWarp, dead)) break;
    }
    if (active) out[static_cast<size_t>(q) * S + s] = band_epilogue(vp, vn, err, dead, h);
  }
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
int bgsa_banded_stream(const void* stream, const void* queries, const void* chk, void* out,
                       int Q, int m, int W, int S, int k, int h, int band_down, int max_err,
                       int last_chk, int dual, void* cuda_stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0 || band_down < 0 || band_down > 63) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* st = static_cast<const uint32_t*>(stream);
  const auto* qs = static_cast<const uint8_t*>(queries);
  const auto* ck = static_cast<const uint8_t*>(chk);
  auto* o = static_cast<int32_t*>(out);
  auto cs = static_cast<cudaStream_t>(cuda_stream);
  if (dual) {
    banded_stream_kernel<true><<<grid_for(S, Q), kThreads, 0, cs>>>(
        st, qs, ck, o, Q, m, W, S, k, h, band_down, max_err, last_chk);
  } else {
    banded_stream_kernel<false><<<grid_for(S, Q), kThreads, 0, cs>>>(
        st, qs, ck, o, Q, m, W, S, k, h, band_down, max_err, last_chk);
  }
  return static_cast<int>(cudaGetLastError());
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
