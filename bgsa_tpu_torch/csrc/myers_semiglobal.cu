// Full-word Myers block scoring (global and semi-global) for Hopper.
//
// Replaces bgsa_tpu/ops/myers_semiglobal.py::_kernel (the Pallas TPU kernel
// behind myers_semiglobal), and computes what it computes: Hyyro's block
// algorithm over W full 32-bit Eq words per subject, one query character per
// column, with the horizontal delta threaded between words as two 0/1 planes
// (hp = "h == +1", hn = "h == -1"). Global mode starts each column with
// h = +1 and returns the final last-row score; semi-global starts with h = 0
// and returns the running minimum of the last row. Scores are multiplied by
// `factor`.
//
// What bounds it: the column recurrence is a serial chain of integer ALU
// operations. myers_word() below is 20 operations per word per column as
// written (9 or, 3 and, 1 xor, 1 add, 2 not, 2 shl, 2 shr), plus the Eq
// load and its mask; the compiler may fold not/or/and triples into
// three-input LOP3s. One 4-byte Eq word (mostly an L2 hit: a bucket's Eq
// planes are reread by every query) feeds those ~20 operations, so the
// kernel is bound by int32 issue rate and dependency latency, not by bytes.
// wgmma and TMA do not apply. Speed will come from interleaving subjects
// per thread, ILP across queries, and Eq reuse across queries.
//
// Design (simple first):
//   * one thread per (query, subject) pair: blockIdx.y walks queries,
//     blockIdx.x * blockDim.x + threadIdx.x is the subject, masked at S;
//   * Eq is read as eq[c][w][s], so neighbouring threads read neighbouring
//     words;
//   * the query row is staged through shared memory in chunks of
//     kQueryChunk codes, so any query length fits;
//   * pv/mv live in registers for W <= kRegWords (myers_regs<MAXW>), and in
//     a caller-allocated device scratch (2, W, Q, S) for longer subjects
//     (myers_scratch);
//   * query codes outside 0..4 match nothing (no out-of-range Eq reads).
// The launch uses the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChars = 5;
constexpr int kWordBits = 32;
constexpr int kThreads = 128;
constexpr int kQueryChunk = 1024;
constexpr int kRegWords = 32;
constexpr int kMaxGridY = 65535;

// One word of one column. pv/mv: this word's vertical state; hp/hn: the
// incoming horizontal delta planes, replaced by the outgoing ones; ph/mh:
// the pre-shift horizontal vectors (the last word's feed the score).
__device__ __forceinline__ void myers_word(uint32_t eq, uint32_t& pv, uint32_t& mv,
                                           uint32_t& hp, uint32_t& hn,
                                           uint32_t& ph, uint32_t& mh) {
  const uint32_t xv = eq | mv;
  eq |= hn;
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  ph = ~(xh | pv) | mv;
  mh = pv & xh;
  const uint32_t hp_out = ph >> (kWordBits - 1);
  const uint32_t hn_out = mh >> (kWordBits - 1);
  const uint32_t phs = (ph << 1) | hp;
  const uint32_t mhs = (mh << 1) | hn;
  pv = ~(xv | phs) | mhs;
  mv = phs & xv;
  hp = hp_out;
  hn = hn_out;
}

// Stage queries[q][c0 : c0 + n] into shared memory (block-wide).
__device__ __forceinline__ void stage_query(uint8_t* qs, const uint8_t* __restrict__ query,
                                            int c0, int n) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = query[c0 + i];
  __syncthreads();
}

__device__ __forceinline__ int score_delta(uint32_t ph, uint32_t mh, int last_shift) {
  return static_cast<int>((ph >> last_shift) & 1u) - static_cast<int>((mh >> last_shift) & 1u);
}

template <int MAXW>
__global__ void __launch_bounds__(kThreads)
myers_regs(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
           int32_t* __restrict__ out, int Q, int m, int W, int S,
           int read_len, int factor, int is_global) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int last_shift = (read_len - 1) % kWordBits;
  const size_t plane = static_cast<size_t>(W) * S;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    uint32_t pv[MAXW], mv[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      pv[j] = 0xFFFFFFFFu;
      mv[j] = 0u;
    }
    int score = read_len;
    int min_score = read_len;
    for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
      const int n = min(kQueryChunk, m - c0);
      stage_query(qs, queries + static_cast<size_t>(q) * m, c0, n);
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
        const int c = qs[i];
        const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
        const uint32_t* eq_c = eq + static_cast<size_t>(min(c, kChars - 1)) * plane + s;
        uint32_t hp = is_global ? 1u : 0u, hn = 0u, ph = 0u, mh = 0u;
#pragma unroll
        for (int j = 0; j < MAXW; ++j) {
          if (j < W) {
            myers_word(eq_c[static_cast<size_t>(j) * S] & keep, pv[j], mv[j], hp, hn, ph, mh);
          }
        }
        score += score_delta(ph, mh, last_shift);  // ph/mh of word W-1
        if (!is_global) min_score = min(min_score, score);
      }
    }
    if (active) out[static_cast<size_t>(q) * S + s] = (is_global ? score : min_score) * factor;
  }
}

__global__ void __launch_bounds__(kThreads)
myers_scratch(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
              int32_t* __restrict__ out, uint32_t* __restrict__ scratch,
              int Q, int m, int W, int S, int read_len, int factor, int is_global) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int last_shift = (read_len - 1) % kWordBits;
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t word_stride = static_cast<size_t>(Q) * S;  // scratch[2][W][Q][S]
  uint32_t* const mv_base = scratch + static_cast<size_t>(W) * word_stride;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t qs_off = static_cast<size_t>(q) * S + s;
    if (active) {
      for (int j = 0; j < W; ++j) {
        scratch[j * word_stride + qs_off] = 0xFFFFFFFFu;
        mv_base[j * word_stride + qs_off] = 0u;
      }
    }
    int score = read_len;
    int min_score = read_len;
    for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
      const int n = min(kQueryChunk, m - c0);
      stage_query(qs, queries + static_cast<size_t>(q) * m, c0, n);
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
        const int c = qs[i];
        const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
        const uint32_t* eq_c = eq + static_cast<size_t>(min(c, kChars - 1)) * plane + s;
        uint32_t hp = is_global ? 1u : 0u, hn = 0u, ph = 0u, mh = 0u;
        for (int j = 0; j < W; ++j) {
          uint32_t* pvp = scratch + j * word_stride + qs_off;
          uint32_t* mvp = mv_base + j * word_stride + qs_off;
          uint32_t pv = *pvp, mv = *mvp;
          myers_word(eq_c[static_cast<size_t>(j) * S] & keep, pv, mv, hp, hn, ph, mh);
          *pvp = pv;
          *mvp = mv;
        }
        score += score_delta(ph, mh, last_shift);
        if (!is_global) min_score = min(min_score, score);
      }
    }
    if (active) out[qs_off] = (is_global ? score : min_score) * factor;
  }
}

template <int MAXW>
void launch_regs(dim3 grid, cudaStream_t stream, const uint32_t* eq, const uint8_t* queries,
                 int32_t* out, int Q, int m, int W, int S, int read_len, int factor,
                 int is_global) {
  myers_regs<MAXW><<<grid, kThreads, 0, stream>>>(eq, queries, out, Q, m, W, S, read_len,
                                                  factor, is_global);
}

}  // namespace

extern "C" {

// Largest W whose pv/mv stay in registers; longer subjects need `scratch`
// of 2 * W * Q * S words.
int bgsa_reg_words() { return kRegWords; }

const char* bgsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// eq: (5, W, S) uint32; queries: (Q, m) uint8; out: (Q, S) int32.
int bgsa_myers_semiglobal(const void* eq, const void* queries, void* out, void* scratch,
                          int Q, int m, int W, int S, int read_len, int factor,
                          int is_global, void* stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads, Q < kMaxGridY ? Q : kMaxGridY);
  const auto* e = static_cast<const uint32_t*>(eq);
  const auto* q = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (W <= 1) {
    launch_regs<1>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else if (W <= 2) {
    launch_regs<2>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else if (W <= 4) {
    launch_regs<4>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else if (W <= 8) {
    launch_regs<8>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else if (W <= 16) {
    launch_regs<16>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else if (W <= kRegWords) {
    launch_regs<kRegWords>(grid, st, e, q, o, Q, m, W, S, read_len, factor, is_global);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    myers_scratch<<<grid, kThreads, 0, st>>>(e, q, o, static_cast<uint32_t*>(scratch), Q, m, W,
                                             S, read_len, factor, is_global);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
