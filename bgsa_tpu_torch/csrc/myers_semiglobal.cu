// Full-word Myers block scoring (global and semi-global) for Hopper.
//
// Replaces bgsa_tpu/ops/myers_semiglobal.py::_kernel (the Pallas TPU kernel
// behind myers_semiglobal; past W = 320 its scan twin myers_semiglobal_xla),
// and computes what it computes: Hyyro's block algorithm over W full 32-bit
// Eq words per subject, one query character per column, with the
// horizontal delta threaded between words as two 0/1 planes (hp = "h ==
// +1", hn = "h == -1"). Global mode starts each column with h = +1 and
// returns the final last-row score; semi-global starts with h = 0 and
// returns the running minimum of the last row. Scores are multiplied by
// `factor`.
//
// What bounds it: the column recurrence is a serial chain of integer ALU
// operations. myers_word() below is 20 operations per word per column as
// written (9 or, 3 and, 1 xor, 1 add, 2 not, 2 shl, 2 shr), plus the Eq
// load and its mask; the compiler may fold not/or/and triples into
// three-input LOP3s. One 4-byte Eq word (mostly an L2 hit: a bucket's Eq
// planes are reread by every query) feeds those ~20 operations, so the
// kernel is bound by int32 issue rate and dependency latency, not by bytes.
// Past kRegWords words the bound is the same network's: the register
// instance's cost per word, for every word-column. wgmma and TMA do not
// apply.
//
// Design (simple first):
//   * one thread per (query, subject) pair: blockIdx.y walks queries,
//     blockIdx.x * blockDim.x + threadIdx.x is the subject, masked at S;
//   * Eq is read as eq[c][w][s], so neighbouring threads read neighbouring
//     words;
//   * the query row is staged through shared memory in chunks of
//     kQueryChunk codes, so any query length fits;
//   * pv/mv live in registers: for W <= kRegWords all W words
//     (myers_regs<MAXW>); past it the words run in strips of kRegWords
//     (the last may be narrower), one strip after another over every
//     column (myers_strips), each strip's pv/mv in registers from its first
//     column to its last. A column's horizontal carries out of a strip's
//     last word are the next strip's input at that column: every strip but
//     the last packs them into one hp and one hn word per 32 columns in a
//     caller-allocated carry buffer (2, ceil(m / 32), Q, S), which the next
//     strip reads back in place; only the last strip moves the score. On
//     few pairs (the caller's choice: where one warp a group of 32
//     subjects would leave the SMs thin) the strips of a group run as a
//     wavefront over a block's four warps (myers_strips_wave), one batch of
//     32 columns a step, a barrier after each step, its query codes read a
//     batch at a time, one a lane, and shuffled out;
//   * query codes outside 0..4 match nothing (no out-of-range Eq reads).
// The launch uses the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChars = 5;
constexpr int kWordBits = 32;
constexpr int kThreads = 128;
constexpr int kLanes = 32;  // threads a warp
constexpr int kWarps = kThreads / kLanes;
constexpr int kQueryChunk = 1024;
constexpr int kRegWords = 32;
constexpr int kBatch = 32;  // columns a carry word holds
static_assert(kBatch == kLanes, "a lane holds one column's query code of a batch");
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

// One strip's batch of nb <= 32 columns (b, the batch's index, picks its
// carry words): the strip's sw words from eq_s, pv/mv carried in registers
// from batch to batch. The first word takes column t's incoming carries at
// bit t of carries[0 / 1][b][q][s] (at points at this pair's word of plane 0;
// strip 0 takes the top boundary instead); the last word's outgoing ones are
// stored there in place (`store`: every strip but the last); only the last
// strip moves the score. code(t): the query code of the batch's column t.
template <typename Code>
__device__ __forceinline__ void strip_batch(const uint32_t* eq_s, size_t plane, int S, int sw,
                                            uint32_t (&pv)[kRegWords], uint32_t (&mv)[kRegWords],
                                            uint32_t* at, size_t carry_plane, bool first,
                                            bool last, bool store, int nb, Code code,
                                            int last_shift, int is_global, int& score,
                                            int& min_score) {
  const uint32_t hp_in = first ? (is_global ? 0xFFFFFFFFu : 0u) : at[0];
  const uint32_t hn_in = first ? 0u : at[carry_plane];
  uint32_t hp_out = 0u, hn_out = 0u;
  for (int t = 0; t < nb; ++t) {
    const int c = code(t);
    const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
    const uint32_t* eq_c = eq_s + static_cast<size_t>(min(c, kChars - 1)) * plane;
    uint32_t hp = (hp_in >> t) & 1u, hn = (hn_in >> t) & 1u, ph = 0u, mh = 0u;
#pragma unroll
    for (int j = 0; j < kRegWords; ++j) {
      if (j < sw) {
        myers_word(eq_c[static_cast<size_t>(j) * S] & keep, pv[j], mv[j], hp, hn, ph, mh);
      }
    }
    hp_out |= hp << t;
    hn_out |= hn << t;
    if (last) {
      score += score_delta(ph, mh, last_shift);  // ph/mh of word W-1
      if (!is_global) min_score = min(min_score, score);
    }
  }
  if (store) {
    at[0] = hp_out;
    at[carry_plane] = hn_out;
  }
}

__device__ __forceinline__ void reset_strip(uint32_t (&pv)[kRegWords],
                                            uint32_t (&mv)[kRegWords]) {
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) {
    pv[j] = 0xFFFFFFFFu;
    mv[j] = 0u;
  }
}

// Past kRegWords words: strips of kRegWords words, one after another, each
// over every column with its pv/mv in registers. Strip k's first word takes
// the carries that strip k - 1's last word gave out at the same column (the
// top boundary for strip 0), read as bits of carries[plane][column / 32]
// [q][s]; every strip but the last writes its own there in their place.
// At least one block per SM is all the launch bounds ask (as
// global31_regs found, a block minimum can spill the state arrays).
__global__ void __launch_bounds__(kThreads, 1)
myers_strips(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
             int32_t* __restrict__ out, uint32_t* __restrict__ carries, int Q, int m, int W,
             int S, int read_len, int factor, int is_global) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const int last_shift = (read_len - 1) % kWordBits;
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t pairs = static_cast<size_t>(Q) * S;
  const size_t carry_plane = static_cast<size_t>((m + kBatch - 1) / kBatch) * pairs;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t pair = static_cast<size_t>(q) * S + s;
    int score = read_len;
    int min_score = read_len;
    for (int w0 = 0; w0 < W; w0 += kRegWords) {
      const int sw = min(kRegWords, W - w0);
      const bool first = w0 == 0;
      const bool last = w0 + sw == W;
      const uint32_t* const eq_s = eq + static_cast<size_t>(w0) * S + s;
      uint32_t pv[kRegWords], mv[kRegWords];
      reset_strip(pv, mv);
      for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
        const int n = min(kQueryChunk, m - c0);
        stage_query(qs, queries + static_cast<size_t>(q) * m, c0, n);
        if (!active) continue;
        for (int b = 0; b < n; b += kBatch) {  // 32 columns: one carry word a plane
          const uint8_t* const row = qs + b;
          strip_batch(eq_s, plane, S, sw, pv, mv,
                      carries + static_cast<size_t>((c0 + b) / kBatch) * pairs + pair,
                      carry_plane, first, last, !last, min(kBatch, n - b),
                      [row](int t) { return static_cast<int>(row[t]); }, last_shift, is_global,
                      score, min_score);
        }
      }
    }
    if (active) out[pair] = (is_global ? score : min_score) * factor;
  }
}

// Past kRegWords words on few pairs (the caller's choice: where one warp a
// group of 32 subjects would leave the SMs thin): the same strips, with the
// strips of one group of 32 subjects spread over the kWarps warps of a
// block as a wavefront. Warp k runs strips k, k + kWarps, ...; strip
// s = j kWarps + k runs its batch b (32 columns) at step j B + k + b of the
// block's steps (B >= kWarps batches), one step after strip s - 1 ran
// batch b, and a barrier ends every step, so the carries pass through the
// same in-place buffer. A warp reads its batch's 32 query codes with one
// load a lane and takes each column's from its lane (lanes past S compute
// on subject S - 1 and store nothing).
__global__ void __launch_bounds__(kThreads, 1)
myers_strips_wave(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                  int32_t* __restrict__ out, uint32_t* carries, int Q, int m, int W, int S,
                  int read_len, int factor, int is_global) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int s = blockIdx.x * kLanes + lane;
  const bool active = s < S;
  const int sr = active ? s : S - 1;  // the subject a lane reads
  const int last_shift = (read_len - 1) % kWordBits;
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t pairs = static_cast<size_t>(Q) * S;
  const int strips = (W + kRegWords - 1) / kRegWords;
  const int batches = (m + kBatch - 1) / kBatch;
  const size_t carry_plane = static_cast<size_t>(batches) * pairs;
  const int steps = (strips - 1) / kWarps * batches + (strips - 1) % kWarps + batches;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const uint8_t* const query = queries + static_cast<size_t>(q) * m;
    const size_t pair = static_cast<size_t>(q) * S + sr;
    int score = read_len;
    int min_score = read_len;
    uint32_t pv[kRegWords], mv[kRegWords];
    for (int t = 0; t < steps; ++t) {
      const int j = t >= warp ? (t - warp) / batches : -1;
      const int b = t - warp - j * batches;
      const int strip = j * kWarps + warp;
      if (j >= 0 && strip < strips) {  // uniform across the warp
        const int w0 = strip * kRegWords;
        const bool last = strip == strips - 1;
        if (b == 0) reset_strip(pv, mv);
        const int c0 = b * kBatch;
        const int nb = min(kBatch, m - c0);
        const int codes = lane < nb ? query[c0 + lane] : 0;
        strip_batch(eq + static_cast<size_t>(w0) * S + sr, plane, S, min(kRegWords, W - w0), pv,
                    mv, carries + static_cast<size_t>(b) * pairs + pair, carry_plane,
                    strip == 0, last, !last && active, nb,
                    [codes](int i) { return __shfl_sync(0xFFFFFFFFu, codes, i); }, last_shift,
                    is_global, score, min_score);
      }
      __syncthreads();
    }
    if (active && (strips - 1) % kWarps == warp) {
      out[pair] = (is_global ? score : min_score) * factor;
    }
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

// Largest W of a register instance, and the strip width past it; longer
// subjects need `carries` of 2 * ceil(m / 32) * Q * S words.
int bgsa_reg_words() { return kRegWords; }

const char* bgsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// eq: (5, W, S) uint32; queries: (Q, m) uint8; out: (Q, S) int32; carries:
// (2, ceil(m / 32), Q, S) uint32 when W > kRegWords, else unused; wave: run
// the strips as a wavefront over a block's warps (needs ceil(m / 32) >=
// kWarps), else one warp a group of 32 subjects' strips.
int bgsa_myers_semiglobal(const void* eq, const void* queries, void* out, void* carries,
                          int Q, int m, int W, int S, int read_len, int factor,
                          int is_global, int wave, void* stream) {
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
    if ((carries == nullptr && m > 0) || (wave && (m + kBatch - 1) / kBatch < kWarps)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* c = static_cast<uint32_t*>(carries);
    if (wave) {
      const dim3 wave_grid((S + kLanes - 1) / kLanes, grid.y);  // a block a group
      myers_strips_wave<<<wave_grid, kThreads, 0, st>>>(e, q, o, c, Q, m, W, S, read_len,
                                                        factor, is_global);
    } else {
      myers_strips<<<grid, kThreads, 0, st>>>(e, q, o, c, Q, m, W, S, read_len, factor,
                                              is_global);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
