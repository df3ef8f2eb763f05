// Global unit-cost Myers in the reference's 31-bit reserved-carry layout, for Hopper.
//
// Replaces bgsa_tpu/ops/myers_pallas.py::_kernel (the Pallas TPU kernel behind
// myers_global, the reference-layout kernel the device mesh runs), and
// computes what it computes (its column body is _column_words): W words of 31
// usable bits per subject, the top bit of each word reserved for the add's
// carry, which is passed to the next word explicitly; the horizontal deltas
// cross words as hp/hn shift bits; VP starts at the 31-bit carry mask, VN at
// 0, the score at read_len, and the score bit is (read_len - 1) % 31 of the
// last word. The add result s is not masked: its bit 31 (the carry) leaks
// into d0 and hp, and every consumer masks it (vp', vn') or shifts it out
// (hp << 1), exactly as the JAX kernel has it. Scores are multiplied by
// `factor`.
//
// What bounds it: like myers_semiglobal.cu, a serial chain of integer ALU
// operations per word and column (the JAX column function counts 23 per word
// plus 7 per column; bgsa_tpu_torch/roofline.py) fed by one 4-byte Eq word,
// mostly an L2 hit (a subject block's Eq planes are reread by every query).
// It is bound by int32 issue rate and dependency latency, not by bytes; the
// 31-bit layout pays 32/31 more words than the full-word kernel and three
// more operations per word for the explicit carry. Past kRegWords words the
// bound is the same network's: the register instance's cost per word, for
// every word-column.
//
// Design (simple first, the same shape as myers_semiglobal.cu):
//   * one thread per (query, subject): blockIdx.y walks queries,
//     blockIdx.x * blockDim.x + threadIdx.x is the subject, masked at S;
//   * Eq is read as eq[c][w][s], so neighbouring threads read neighbouring
//     subjects' words (coalesced);
//   * the query is staged through shared memory in chunks of kQueryChunk codes;
//   * vp/vn live in registers: for W <= kRegWords all W words
//     (global31_regs<MAXW>); past it (where the TPU wrapper routes to its
//     XLA scan twin) the words run in strips of kRegWords, the last maybe
//     narrower, one strip after another over every column (global31_strips),
//     each strip's vp/vn in registers throughout. A column's three carries
//     out of a strip's last word (the add carry and the hp/hn shift bits)
//     are the next strip's input at that column: every strip but the last
//     packs them into one word each per 32 columns in a caller-allocated
//     carry buffer (3, ceil(m / 32), Q, S), which the next strip reads back
//     in place; only the last strip moves the score. On few pairs the
//     strips of a group of 32 subjects run as a wavefront over a block's
//     four warps (global31_strips_wave), as in myers_semiglobal.cu;
//   * query codes outside 0..4 match nothing.
// The launch uses the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChars = 5;
constexpr int kWordBits = 31;
constexpr uint32_t kCarryMask = (1u << kWordBits) - 1u;
constexpr int kThreads = 128;
constexpr int kLanes = 32;  // threads a warp
constexpr int kWarps = kThreads / kLanes;
constexpr int kQueryChunk = 1024;
constexpr int kRegWords = 32;
constexpr int kBatch = 32;  // columns a carry word holds
static_assert(kBatch == kLanes, "a lane holds one column's query code of a batch");
constexpr int kMaxGridY = 65535;

// The word-state of one column: the add carry and the hp/hn shift bits
// passed from word j to word j + 1.
struct Carries {
  uint32_t add = 0u, hp = 1u, hn = 0u;
};

// One word of one column (_column_words' loop body). `last`: word W-1, whose
// hp/hn bits at maskh move the score and whose outgoing carries are unused.
__device__ __forceinline__ void word31(uint32_t eq, uint32_t& vp, uint32_t& vn, Carries& c,
                                       bool last, uint32_t maskh, int& score) {
  const uint32_t pm = eq | vn;
  const uint32_t s = (vp & pm) + vp + c.add;
  const uint32_t d0 = (s ^ vp) | pm;
  uint32_t hp = ~(d0 | vp) | vn;
  uint32_t hn = d0 & vp;
  if (last) {
    const bool hn_hit = (hn & maskh) != 0u;
    const bool hp_hit = (hp & maskh) != 0u;
    score += (hp_hit && !hn_hit) ? 1 : (hn_hit ? -1 : 0);
  }
  hp = (hp << 1) | c.hp;
  hn = (hn << 1) | c.hn;
  c.add = s >> kWordBits;
  c.hp = hp >> kWordBits;
  c.hn = hn >> kWordBits;
  vp = (~(d0 | hp) | hn) & kCarryMask;
  vn = (d0 & hp) & kCarryMask;
}

// Stage queries[q][c0 : c0 + n] into shared memory (block-wide).
__device__ __forceinline__ void stage_query(uint8_t* qs, const uint8_t* __restrict__ query,
                                            int c0, int n) {
  __syncthreads();  // every thread is done with the previous chunk
  for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = query[c0 + i];
  __syncthreads();
}

// At least one block per SM is all the launch bounds ask: with no minimum,
// ptxas gave MAXW = 17 48 registers, a 16-byte stack frame and 20 bytes of
// spill stores in the column loop (as bitpal_common.cuh found for BitPAl).
template <int MAXW>
__global__ void __launch_bounds__(kThreads, 1)
global31_regs(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
              int32_t* __restrict__ out, int Q, int m, int W, int S, int read_len,
              int factor) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const uint32_t maskh = 1u << ((read_len - 1) % kWordBits);
  const size_t plane = static_cast<size_t>(W) * S;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    uint32_t vp[MAXW], vn[MAXW];
#pragma unroll
    for (int j = 0; j < MAXW; ++j) {
      vp[j] = kCarryMask;
      vn[j] = 0u;
    }
    int score = read_len;
    for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
      const int n = min(kQueryChunk, m - c0);
      stage_query(qs, queries + static_cast<size_t>(q) * m, c0, n);
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
        const int c = qs[i];
        const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
        const uint32_t* eq_c = eq + static_cast<size_t>(min(c, kChars - 1)) * plane + s;
        Carries carry;
#pragma unroll
        for (int j = 0; j < MAXW; ++j) {
          if (j < W) {
            word31(eq_c[static_cast<size_t>(j) * S] & keep, vp[j], vn[j], carry, j == W - 1,
                   maskh, score);
          }
        }
      }
    }
    if (active) out[static_cast<size_t>(q) * S + s] = score * factor;
  }
}

// One strip's batch of nb <= 32 columns: the strip's sw words from eq_s,
// vp/vn carried in registers from batch to batch. The first word takes
// column t's incoming carries at bit t of carries[0 / 1 / 2][b][q][s] (add,
// hp, hn; at points at this pair's word of plane 0; strip 0 takes the
// Carries defaults instead); the last word's outgoing ones are stored there
// in place (`store`: every strip but the last); only the last strip moves
// the score. code(t): the query code of the batch's column t.
template <typename Code>
__device__ __forceinline__ void strip_batch(const uint32_t* eq_s, size_t plane, int S, int sw,
                                            uint32_t (&vp)[kRegWords], uint32_t (&vn)[kRegWords],
                                            uint32_t* at, size_t carry_plane, bool first,
                                            bool last, bool store, int nb, Code code,
                                            uint32_t maskh, int& score) {
  const uint32_t add_in = first ? 0u : at[0];
  const uint32_t hp_in = first ? 0xFFFFFFFFu : at[carry_plane];
  const uint32_t hn_in = first ? 0u : at[2 * carry_plane];
  uint32_t add_out = 0u, hp_out = 0u, hn_out = 0u;
  for (int t = 0; t < nb; ++t) {
    const int c = code(t);
    const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
    const uint32_t* eq_c = eq_s + static_cast<size_t>(min(c, kChars - 1)) * plane;
    Carries carry;
    carry.add = (add_in >> t) & 1u;
    carry.hp = (hp_in >> t) & 1u;
    carry.hn = (hn_in >> t) & 1u;
#pragma unroll
    for (int j = 0; j < kRegWords; ++j) {
      if (j < sw) {
        word31(eq_c[static_cast<size_t>(j) * S] & keep, vp[j], vn[j], carry,
               last && j == sw - 1, maskh, score);
      }
    }
    add_out |= carry.add << t;
    hp_out |= carry.hp << t;
    hn_out |= carry.hn << t;
  }
  if (store) {
    at[0] = add_out;
    at[carry_plane] = hp_out;
    at[2 * carry_plane] = hn_out;
  }
}

__device__ __forceinline__ void reset_strip(uint32_t (&vp)[kRegWords],
                                            uint32_t (&vn)[kRegWords]) {
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) {
    vp[j] = kCarryMask;
    vn[j] = 0u;
  }
}

// Past kRegWords words: strips of kRegWords words, one after another, each
// over every column with its vp/vn in registers. Strip k's first word takes
// the carries that strip k - 1's last word gave out at the same column (for
// strip 0 the Carries defaults: add 0, hp 1, hn 0), read as bits of
// carries[plane][column / 32][q][s]; every strip but the last writes its
// own there in their place. Launch bounds as global31_regs.
__global__ void __launch_bounds__(kThreads, 1)
global31_strips(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                int32_t* __restrict__ out, uint32_t* __restrict__ carries, int Q, int m, int W,
                int S, int read_len, int factor) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const uint32_t maskh = 1u << ((read_len - 1) % kWordBits);
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t pairs = static_cast<size_t>(Q) * S;
  const size_t carry_plane = static_cast<size_t>((m + kBatch - 1) / kBatch) * pairs;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t pair = static_cast<size_t>(q) * S + s;
    int score = read_len;
    for (int w0 = 0; w0 < W; w0 += kRegWords) {
      const int sw = min(kRegWords, W - w0);
      const bool first = w0 == 0;
      const bool last = w0 + sw == W;
      const uint32_t* const eq_s = eq + static_cast<size_t>(w0) * S + s;
      uint32_t vp[kRegWords], vn[kRegWords];
      reset_strip(vp, vn);
      for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
        const int n = min(kQueryChunk, m - c0);
        stage_query(qs, queries + static_cast<size_t>(q) * m, c0, n);
        if (!active) continue;
        for (int b = 0; b < n; b += kBatch) {  // 32 columns: one carry word a plane
          const uint8_t* const row = qs + b;
          strip_batch(eq_s, plane, S, sw, vp, vn,
                      carries + static_cast<size_t>((c0 + b) / kBatch) * pairs + pair,
                      carry_plane, first, last, !last, min(kBatch, n - b),
                      [row](int t) { return static_cast<int>(row[t]); }, maskh, score);
        }
      }
    }
    if (active) out[pair] = score * factor;
  }
}

// Past kRegWords words on few pairs: the same strips as a wavefront over
// the kWarps warps of a block, one batch of 32 columns a step and a barrier
// after each, as myers_semiglobal.cu's myers_strips_wave.
__global__ void __launch_bounds__(kThreads, 1)
global31_strips_wave(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                     int32_t* __restrict__ out, uint32_t* carries, int Q, int m, int W, int S,
                     int read_len, int factor) {
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int s = blockIdx.x * kLanes + lane;
  const bool active = s < S;
  const int sr = active ? s : S - 1;  // the subject a lane reads
  const uint32_t maskh = 1u << ((read_len - 1) % kWordBits);
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
    uint32_t vp[kRegWords], vn[kRegWords];
    for (int t = 0; t < steps; ++t) {
      const int j = t >= warp ? (t - warp) / batches : -1;
      const int b = t - warp - j * batches;
      const int strip = j * kWarps + warp;
      if (j >= 0 && strip < strips) {  // uniform across the warp
        const int w0 = strip * kRegWords;
        const bool last = strip == strips - 1;
        if (b == 0) reset_strip(vp, vn);
        const int c0 = b * kBatch;
        const int nb = min(kBatch, m - c0);
        const int codes = lane < nb ? query[c0 + lane] : 0;
        strip_batch(eq + static_cast<size_t>(w0) * S + sr, plane, S, min(kRegWords, W - w0), vp,
                    vn, carries + static_cast<size_t>(b) * pairs + pair, carry_plane,
                    strip == 0, last, !last && active, nb,
                    [codes](int i) { return __shfl_sync(0xFFFFFFFFu, codes, i); }, maskh,
                    score);
      }
      __syncthreads();
    }
    if (active && (strips - 1) % kWarps == warp) out[pair] = score * factor;
  }
}

template <int MAXW>
void launch_regs(dim3 grid, cudaStream_t stream, const uint32_t* eq, const uint8_t* queries,
                 int32_t* out, int Q, int m, int W, int S, int read_len, int factor) {
  global31_regs<MAXW><<<grid, kThreads, 0, stream>>>(eq, queries, out, Q, m, W, S, read_len,
                                                     factor);
}

}  // namespace

extern "C" {

// Largest W of a register instance, and the strip width past it; longer
// subjects need `carries` of 3 * ceil(m / 32) * Q * S words.
int bgsa_myers_global_reg_words() { return kRegWords; }

// eq: (5, W, S) uint32 of 31 usable bits; queries: (Q, m) uint8; out: (Q, S)
// int32; carries: (3, ceil(m / 32), Q, S) uint32 when W > kRegWords, else
// unused; wave: run the strips as a wavefront over a block's warps (needs
// ceil(m / 32) >= kWarps), else one warp a group of 32 subjects' strips.
int bgsa_myers_global(const void* eq, const void* queries, void* out, void* carries, int Q,
                      int m, int W, int S, int read_len, int factor, int wave, void* stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0 || read_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kThreads - 1) / kThreads, Q < kMaxGridY ? Q : kMaxGridY);
  const auto* e = static_cast<const uint32_t*>(eq);
  const auto* q = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (W <= 1) {
    launch_regs<1>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else if (W <= 2) {
    launch_regs<2>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else if (W <= 5) {
    launch_regs<5>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else if (W <= 8) {
    launch_regs<8>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else if (W <= 17) {
    launch_regs<17>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else if (W <= kRegWords) {
    launch_regs<kRegWords>(grid, st, e, q, o, Q, m, W, S, read_len, factor);
  } else {
    if ((carries == nullptr && m > 0) || (wave && (m + kBatch - 1) / kBatch < kWarps)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* c = static_cast<uint32_t*>(carries);
    if (wave) {
      const dim3 wave_grid((S + kLanes - 1) / kLanes, grid.y);  // a block a group
      global31_strips_wave<<<wave_grid, kThreads, 0, st>>>(e, q, o, c, Q, m, W, S, read_len,
                                                           factor);
    } else {
      global31_strips<<<grid, kThreads, 0, st>>>(e, q, o, c, Q, m, W, S, read_len, factor);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
