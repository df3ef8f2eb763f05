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
//   kCarryBits, each_carry(c, f) every carry bit the network reads, each
//                                with its index in the packed carry words;
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
// that neighbouring threads read neighbouring words, and query codes outside
// 0..4 match nothing. Up to the scheme's reg_words() all W words' planes live
// in registers (bitpal_kernel over RegState<P, MAXW>: one column of every
// word at a time, the query row staged through shared memory in chunks).
// Past it, bitpal_tiled_kernel runs word-major over tiles of T query columns
// and holds one word's planes in registers: for each word it runs the tile's
// columns, reading word w-1's carries of each column from a per-thread
// shared-memory slot and writing word w's there, then stores the planes to a
// caller-allocated (planes, W, Q, S) device scratch for the next tile (none
// is needed when the query fits one tile). The last tile folds the epilogue
// into its word loop, so no plane is read back. Word w at column c needs
// only its own planes at c-1 and word w-1's carries at c, so the order gives
// the same bits. The mode (global or semi-global) changes only the boundary
// column and the epilogue, so it is a runtime argument; the word layout
// changes the network and is a template parameter. Launches use the
// caller's stream, allocate nothing, and the C entry point returns
// cudaGetLastError().

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
// planes * (MAXW + 4), fit kRegBudget; longer subjects take the tiled
// kernel. Both bounds are ptxas readings on sm_90a: 120 state registers
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
  template <class F>
  __device__ __forceinline__ void each(int W, F&& f) {
#pragma unroll
    for (int w = 0; w < MAXW; ++w) {
      if (w < W) f(v[w], w);
    }
  }
};

// W <= MAXW words, every plane in registers. The launch bounds ask for one
// block per SM: without the minimum, ptxas traded a few spilled words for
// occupancy at 64 and 96 registers ((1,-1,-1) at W <= 12, packed (5,-4,-11)
// at W <= 8).
template <class Net, int WB, int MAXW>
__global__ void __launch_bounds__(kThreads, 1)
bitpal_kernel(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
              int32_t* __restrict__ out, int Q, int m, int W, int S, int read_len, int factor,
              int semi) {
  __shared__ uint8_t qs[kQueryChunk];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t qs_off = static_cast<size_t>(q) * S + s;
    RegState<Net::kPlanes, MAXW> st;
    if (active) st.each(W, [&](auto& pl, int) { Net::init(pl, semi); });
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
        st.each(W, [&](auto& pl, int w) {
          Net::word(pl, eq_c[static_cast<size_t>(w) * S] & keep, carries);
        });
      }
    }
    if (!active) continue;
    int result;
    if (semi) {
      int score = BGSA_G * m;
      int best = score;
      st.each(W, [&](auto& pl, int w) {
        const int bits = Word<WB>::valid_bits(read_len, w);
        for (int b = 0; b < bits; ++b) {
          score += Net::row_delta(pl, b);
          best = max(best, score);
        }
      });
      result = best;
    } else {
      int score = Net::global_base(m, read_len);
      st.each(W, [&](auto& pl, int w) {
        score += Net::word_score(pl, Word<WB>::valid_mask(read_len, w));
      });
      result = score;
    }
    out[qs_off] = result * factor;
  }
}

// A column's carries as ceil(kCarryBits / 32) words: carry bit i at bit
// i % 32 of word i / 32.
template <class Net>
struct CarryWords {
  static constexpr int kWords = (Net::kCarryBits + 31) / 32;

  static __device__ __forceinline__ void pack(typename Net::Carries& c, uint32_t (&w)[kWords]) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
    Net::each_carry(c, [&](uint32_t& bit, int i) { w[i >> 5] |= bit << (i & 31); });
  }

  static __device__ __forceinline__ void unpack(const uint32_t (&w)[kWords],
                                                typename Net::Carries& c) {
    Net::each_carry(c, [&](uint32_t& bit, int i) { bit = (w[i >> 5] >> (i & 31)) & 1u; });
  }
};

// Query columns a tile of the tiled kernel holds: 32, fewer where the
// carries take more than two words, so the carry slots stay within 32 KB a
// block. Tiles of 16 and 8 columns ran slower at the bench line (PERF.md).
template <class Net>
__host__ __device__ constexpr int tile_columns() {
  return CarryWords<Net>::kWords <= 2 ? 32 : 64 / CarryWords<Net>::kWords;
}

// Any W: word-major over tiles of tile_columns<Net>() query columns, one
// word's planes in registers. Column i's carry slot is
// slot[i][.][threadIdx.x]: each thread reads and writes only its own, so no
// barrier guards it, and word 0 reads the zeros each tile starts with. The
// column loop has no branch: word 0 unpacks zeros, and the last word packs
// carries that no word reads.
template <class Net, int WB>
__global__ void __launch_bounds__(kThreads, 1)
bitpal_tiled_kernel(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                    int32_t* __restrict__ out, uint32_t* __restrict__ scratch, int Q, int m, int W,
                    int S, int read_len, int factor, int semi) {
  constexpr int P = Net::kPlanes, T = tile_columns<Net>(), CW = CarryWords<Net>::kWords;
  __shared__ uint8_t qs[T];
  __shared__ uint32_t slot[T][CW][kThreads];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = s < S;
  const size_t plane = static_cast<size_t>(W) * S;
  const size_t pairs = static_cast<size_t>(Q) * S;
  const int tiles = max(1, (m + T - 1) / T);
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const size_t qs_off = static_cast<size_t>(q) * S + s;
    int score = semi ? BGSA_G * m : Net::global_base(m, read_len);
    int best = score;
    for (int k = 0; k < tiles; ++k) {
      const int t0 = k * T, n = min(T, m - t0);
      __syncthreads();  // every thread is done with the previous tile's codes
      if (threadIdx.x < n) qs[threadIdx.x] = queries[static_cast<size_t>(q) * m + t0 + threadIdx.x];
      __syncthreads();
      if (!active) continue;
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int j = 0; j < CW; ++j) slot[i][j][threadIdx.x] = 0u;
      }
      for (int w = 0; w < W; ++w) {
        // word w's plane p: scratch[p][w][q][s]
        uint32_t* const st = scratch + static_cast<size_t>(w) * pairs + qs_off;
        uint32_t pl[P];
        if (k == 0) {
          Net::init(pl, semi);
        } else {
#pragma unroll
          for (int p = 0; p < P; ++p) pl[p] = st[static_cast<size_t>(p) * W * pairs];
        }
        const uint32_t* const eq_w = eq + static_cast<size_t>(w) * S + s;
        for (int i = 0; i < n; ++i) {
          const int c = qs[i];
          const uint32_t keep = c < kChars ? 0xFFFFFFFFu : 0u;
          const uint32_t matches = eq_w[static_cast<size_t>(min(c, kChars - 1)) * plane] & keep;
          uint32_t words[CW];
#pragma unroll
          for (int j = 0; j < CW; ++j) words[j] = slot[i][j][threadIdx.x];
          typename Net::Carries carries{};
          CarryWords<Net>::unpack(words, carries);
          Net::word(pl, matches, carries);
          CarryWords<Net>::pack(carries, words);
#pragma unroll
          for (int j = 0; j < CW; ++j) slot[i][j][threadIdx.x] = words[j];
        }
        if (k + 1 < tiles) {
#pragma unroll
          for (int p = 0; p < P; ++p) st[static_cast<size_t>(p) * W * pairs] = pl[p];
        } else if (semi) {  // the last tile folds the epilogue, in word order
          const int bits = Word<WB>::valid_bits(read_len, w);
          for (int b = 0; b < bits; ++b) {
            score += Net::row_delta(pl, b);
            best = max(best, score);
          }
        } else {
          score += Net::word_score(pl, Word<WB>::valid_mask(read_len, w));
        }
      }
    }
    if (active) out[qs_off] = (semi ? best : score) * factor;
  }
}

// Whether step k exists and its state fits the register budget.
template <class Net>
constexpr bool reg_step(int k) {
  return k < kNumSteps && Net::kPlanes * kWordSteps[k] <= kStateBudget &&
         Net::kPlanes * (kWordSteps[k] + 4) <= kRegBudget;
}

// Largest W whose state stays in registers (0: every W takes the tiled kernel).
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

// The smallest register instantiation that holds W words, else the tiled
// kernel, which needs the scratch when the query spans more than one tile.
template <class Net, int WB, int K = 0>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.S + kThreads - 1) / kThreads, a.Q < kMaxGridY ? a.Q : kMaxGridY);
  if constexpr (reg_step<Net>(K)) {
    if (a.W <= kWordSteps[K]) {
      bitpal_kernel<Net, WB, kWordSteps[K]><<<grid, kThreads, 0, stream>>>(
          a.eq, a.queries, a.out, a.Q, a.m, a.W, a.S, a.read_len, a.factor, a.semi);
      return static_cast<int>(cudaGetLastError());
    }
    return launch<Net, WB, K + 1>(a, stream);
  } else {
    if (a.m > tile_columns<Net>() && a.scratch == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bitpal_tiled_kernel<Net, WB><<<grid, kThreads, 0, stream>>>(
        a.eq, a.queries, a.out, a.scratch, a.Q, a.m, a.W, a.S, a.read_len, a.factor, a.semi);
    return static_cast<int>(cudaGetLastError());
  }
}

// The C entry point's body: validate, then dispatch on the word layout.
template <template <int, int, int, int> class Net>
int entry(const void* eq, const void* queries, void* out, void* scratch, int Q, int m, int W,
          int S, int read_len, int factor, int semi, int word_bits, void* stream) {
  if (Q <= 0 || S <= 0 || W <= 0 || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint32_t*>(eq), static_cast<const uint8_t*>(queries),
               static_cast<int32_t*>(out), static_cast<uint32_t*>(scratch),
               Q, m, W, S, read_len, factor, semi};
  auto st = static_cast<cudaStream_t>(stream);
  if (word_bits == 31) return launch<Net<BGSA_M, BGSA_I, BGSA_G, 31>, 31>(a, st);
  if (word_bits == 32) return launch<Net<BGSA_M, BGSA_I, BGSA_G, 32>, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace bitpal
