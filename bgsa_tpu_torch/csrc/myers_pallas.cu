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
// more operations per word for the explicit carry.
//
// Design (simple first, the same shape as myers_semiglobal.cu):
//   * one thread per (query, subject): blockIdx.y walks queries,
//     blockIdx.x * blockDim.x + threadIdx.x is the subject, masked at S;
//   * Eq is read as eq[c][w][s], so neighbouring threads read neighbouring
//     subjects' words (coalesced);
//   * the query is staged through shared memory in chunks of kQueryChunk codes;
//   * vp/vn live in registers for W <= kRegWords (global31_regs<MAXW>), and
//     in a caller-allocated device scratch (2, W, Q, S) beyond
//     (global31_scratch), where the TPU wrapper routes to its XLA scan twin;
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
constexpr int kQueryChunk = 1024;
constexpr int kRegWords = 32;
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

__global__ void __launch_bounds__(kThreads)
global31_scratch(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                 int32_t* __restrict__ out, uint32_t* __restrict__ scratch, int Q, int m,
                 int W, int S, int read_len, int factor) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const uint32_t maskh = 1u << ((read_len - 1) % kWordBits);
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t word_stride = static_cast<size_t>(Q) * S;  // scratch[2][W][Q][S]
  uint32_t* const vn_base = scratch + static_cast<size_t>(W) * word_stride;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t qs_off = static_cast<size_t>(q) * S + s;
    if (active) {
      for (int j = 0; j < W; ++j) {
        scratch[j * word_stride + qs_off] = kCarryMask;
        vn_base[j * word_stride + qs_off] = 0u;
      }
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
        for (int j = 0; j < W; ++j) {
          uint32_t* vpp = scratch + j * word_stride + qs_off;
          uint32_t* vnp = vn_base + j * word_stride + qs_off;
          uint32_t vp = *vpp, vn = *vnp;
          word31(eq_c[static_cast<size_t>(j) * S] & keep, vp, vn, carry, j == W - 1, maskh,
                 score);
          *vpp = vp;
          *vnp = vn;
        }
      }
    }
    if (active) out[qs_off] = score * factor;
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

// Largest W whose vp/vn stay in registers; longer subjects need `scratch`
// of 2 * W * Q * S words.
int bgsa_myers_global_reg_words() { return kRegWords; }

// eq: (5, W, S) uint32 of 31 usable bits; queries: (Q, m) uint8; out: (Q, S) int32.
int bgsa_myers_global(const void* eq, const void* queries, void* out, void* scratch, int Q,
                      int m, int W, int S, int read_len, int factor, void* stream) {
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
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    global31_scratch<<<grid, kThreads, 0, st>>>(e, q, o, static_cast<uint32_t*>(scratch), Q,
                                                m, W, S, read_len, factor);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
