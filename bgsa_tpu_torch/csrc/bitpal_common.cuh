// The shared body of the two BitPAl kernels (bitpal.cu, bitpal_packed.cu).
//
// A kernel is this body over a column network `Net`, written once in C++
// over compile-time (M, I, G, word bits). Each library is built for one
// scheme: ops/build.py passes -DBGSA_M/-DBGSA_I/-DBGSA_G, so every plane
// index and loop bound of the network is a constant after unrolling and the
// planes stay in registers. A Net provides:
//   kPlanes                      state planes per word;
//   Carries                      the cross-word carries of one column (zeroed
//                                at each column, threaded from word to word);
//   init(pl, semi)               one word's boundary column;
//   word(pl, matches, carries)   one word of one column, pl updated in place;
//   global_base(m, n)            the global score before the final column's
//                                words are added;
//   word_score(pl, mask)         one word's share of the global score;
//   row_delta(pl, b)             the score change at row b of a word (the
//                                semi-global walk).
//
// Design, as the Myers kernel (myers_semiglobal.cu): one thread per (query,
// subject) pair, blockIdx.y walks the queries, Eq is read as eq[c][w][s] so
// that neighbouring threads read neighbouring words, the query row is staged
// through shared memory in chunks, and query codes outside 0..4 match
// nothing. The state lives in registers (RegState<P, MAXW>) for W up to the
// scheme's reg_words(), and in a caller-allocated device scratch of
// (planes, W, Q, S) words beyond that (ScratchState). The mode (global or
// semi-global) changes only the boundary column and the epilogue, so it is
// a runtime argument; the word layout changes the network and is a template
// parameter. Launches use the caller's stream, allocate nothing, and the C
// entry point returns cudaGetLastError().

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#if !defined(BGSA_M) || !defined(BGSA_I) || !defined(BGSA_G)
#error "build one scheme per library: -DBGSA_M=<match> -DBGSA_I=<mismatch> -DBGSA_G=<gap>"
#endif

namespace bitpal {

constexpr int kChars = 5;
constexpr int kThreads = 128;
constexpr int kQueryChunk = 1024;
constexpr int kMaxGridY = 65535;
// Register-resident instantiations: the word counts W rounds up to. A
// scheme keeps the steps whose state, planes * MAXW registers, fits
// kStateBudget and whose state and per-plane temporaries,
// planes * (MAXW + 4), fit kRegBudget; longer subjects take the scratch
// path. Both bounds are ptxas readings on sm_90a: 120 state registers
// compiled spill-free for 5, 10 and 13 planes, 128 (4 planes x 32 words)
// spilled.
constexpr int kWordSteps[] = {2, 5, 8, 12, 17, 24, 32};
constexpr int kNumSteps = sizeof(kWordSteps) / sizeof(kWordSteps[0]);
constexpr int kStateBudget = 120;
constexpr int kRegBudget = 160;

// The value lattice of a scheme (bgsa_tpu/ops/bitpal.py BitpalParams).
template <int M, int I, int G>
struct Scheme {
  static_assert(M > I && I > 2 * G, "BitPAl requires M > I > 2G");
  static constexpr int kMin = G;       // lowest delta value
  static constexpr int kMid = I - G;   // mismatch class
  static constexpr int kMax = M - G;   // highest delta value
  static constexpr int kValues = kMax - kMin + 1;
  static constexpr int kAdds = kMax - kMid;  // run-propagation adds per word
};

// A word layout: 31 usable bits (bit 31 reserved for the add carry) or 32
// (carry recovered by unsigned compares).
template <int WB>
struct Word {
  static_assert(WB == 31 || WB == 32, "31-bit or 32-bit words");
  static constexpr uint32_t kMask = WB == 32 ? 0xFFFFFFFFu : (1u << WB) - 1u;

  // a + b + carry; carry is replaced by the carry-out.
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b, uint32_t& carry) {
    if constexpr (WB == 32) {
      const uint32_t s1 = a + b;
      const uint32_t s = s1 + carry;
      carry = static_cast<uint32_t>(s1 < a) | static_cast<uint32_t>(s < s1);
      return s;
    } else {
      const uint32_t s = a + b + carry;
      carry = s >> WB;
      return s;
    }
  }

  // the highest subject-row bit, which leaves the word on a one-row shift
  static __device__ __forceinline__ uint32_t top_bit(uint32_t x) { return (x >> (WB - 1)) & 1u; }

  static __device__ __forceinline__ int valid_bits(int read_len, int w) {
    return max(min(read_len - w * WB, WB), 0);
  }

  static __device__ __forceinline__ uint32_t valid_mask(int read_len, int w) {
    const int bits = valid_bits(read_len, w);
    return bits >= 32 ? 0xFFFFFFFFu : (1u << bits) - 1u;
  }
};

// State in registers: MAXW words of P planes; words past W are untouched.
template <int P, int MAXW>
struct RegState {
  uint32_t v[MAXW][P];
  __device__ __forceinline__ RegState(uint32_t*, size_t) {}
  template <bool kWrite, class F>
  __device__ __forceinline__ void each(int W, F&& f) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < W) f(v[w], w);
    }
  }
};

// State in device memory: word w's plane p at base[(p * W + w) * stride],
// base pointing at this (query, subject) pair and stride = Q * S.
template <int P>
struct ScratchState {
  uint32_t* base;
  size_t stride;
  __device__ __forceinline__ ScratchState(uint32_t* b, size_t s) : base(b), stride(s) {}
  template <bool kWrite, class F>
  __device__ __forceinline__ void each(int W, F&& f) {
    for (int w = 0; w < W; ++w) {
      uint32_t pl[P];
#pragma unroll
      for (int p = 0; p < P; ++p) pl[p] = base[(static_cast<size_t>(p) * W + w) * stride];
      f(pl, w);
      if constexpr (kWrite) {
#pragma unroll
        for (int p = 0; p < P; ++p) base[(static_cast<size_t>(p) * W + w) * stride] = pl[p];
      }
    }
  }
};

template <int P, int MAXW>
struct StateOf {
  using type = RegState<P, MAXW>;
};
template <int P>
struct StateOf<P, 0> {
  using type = ScratchState<P>;
};

// MAXW == 0: state in scratch. The launch bounds ask for one block per SM:
// without the minimum, ptxas traded a few spilled words for occupancy at 64
// and 96 registers ((1,-1,-1) at W <= 12, packed (5,-4,-11) at W <= 8).
template <class Net, int WB, int MAXW>
__global__ void __launch_bounds__(kThreads, 1)
bitpal_kernel(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
              int32_t* __restrict__ out, uint32_t* __restrict__ scratch, int Q, int m, int W,
              int S, int read_len, int factor, int semi) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t pairs = static_cast<size_t>(Q) * S;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t qs_off = static_cast<size_t>(q) * S + s;
    typename StateOf<Net::kPlanes, MAXW>::type st(scratch + qs_off, pairs);
    if (active) st.template each<true>(W, [&](auto& pl, int) { Net::init(pl, semi); });
    for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
      const int n = min(kQueryChunk, m - c0);
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = threadIdx.x; i < n; i += blockDim.x) qs[i] = queries[static_cast<size_t>(q) * m + c0 + i];
      __syncthreads();
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
        const int c = qs[i];
        const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
        const uint32_t* eq_c = eq + static_cast<size_t>(min(c, kChars - 1)) * plane + s;
        typename Net::Carries carries{};
        st.template each<true>(W, [&](auto& pl, int w) {
          Net::word(pl, eq_c[static_cast<size_t>(w) * S] & keep, carries);
        });
      }
    }
    if (!active) continue;
    int result;
    if (semi) {
      int score = BGSA_G * m;
      int best = score;
      st.template each<false>(W, [&](auto& pl, int w) {
        const int bits = Word<WB>::valid_bits(read_len, w);
        for (int b = 0; b < bits; ++b) {
          score += Net::row_delta(pl, b);
          best = max(best, score);
        }
      });
      result = best;
    } else {
      int score = Net::global_base(m, read_len);
      st.template each<false>(W, [&](auto& pl, int w) {
        score += Net::word_score(pl, Word<WB>::valid_mask(read_len, w));
      });
      result = score;
    }
    out[qs_off] = result * factor;
  }
}

// Whether step k exists and its state fits the register budget.
template <class Net>
constexpr bool reg_step(int k) {
  return k < kNumSteps && Net::kPlanes * kWordSteps[k] <= kStateBudget &&
         Net::kPlanes * (kWordSteps[k] + 4) <= kRegBudget;
}

// Largest W whose state stays in registers (0: every W takes the scratch).
template <class Net>
constexpr int reg_words() {
  int best = 0;
  for (int k = 0; reg_step<Net>(k); ++k) best = kWordSteps[k];
  return best;
}

struct Args {
  const uint32_t* eq;
  const uint8_t* queries;
  int32_t* out;
  uint32_t* scratch;
  int Q, m, W, S, read_len, factor, semi;
};

// The smallest register instantiation that holds W words, else the scratch.
template <class Net, int WB, int K = 0>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + kThreads - 1) / kThreads, a.Q < kMaxGridY ? a.Q : kMaxGridY);
  if constexpr (reg_step<Net>(K)) {
    if (a.W <= kWordSteps[K]) {
      bitpal_kernel<Net, WB, kWordSteps[K]><<<grid, kThreads, 0, stream>>>(
          a.eq, a.queries, a.out, nullptr, a.Q, a.m, a.W, a.S, a.read_len, a.factor, a.semi);
      return static_cast<int>(cudaGetLastError());
    }
    return launch<Net, WB, K + 1>(a, stream);
  } else {
    if (a.scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    bitpal_kernel<Net, WB, 0><<<grid, kThreads, 0, stream>>>(
        a.eq, a.queries, a.out, a.scratch, a.Q, a.m, a.W, a.S, a.read_len, a.factor, a.semi);
    return static_cast<int>(cudaGetLastError());
  }
}

// The C entry point's body: validate, then dispatch on the word layout.
template <template <int, int, int, int> class Net>
int entry(const void* eq, const void* queries, void* out, void* scratch, int Q, int m, int W,
          int S, int read_len, int factor, int semi, int word_bits, void* stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(eq), static_cast<const uint8_t*>(queries),
               static_cast<int32_t*>(out), static_cast<uint32_t*>(scratch),
               Q, m, W, S, read_len, factor, semi};
  auto st = static_cast<cudaStream_t>(stream);
  if (word_bits == 31) return launch<Net<BGSA_M, BGSA_I, BGSA_G, 31>, 31>(a, st);
  if (word_bits == 32) return launch<Net<BGSA_M, BGSA_I, BGSA_G, 32>, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bitpal
