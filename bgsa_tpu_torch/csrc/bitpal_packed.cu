// Packed BitPAl (general integer scoring M, I, G) for Hopper, one scheme per
// build (-DBGSA_M/-DBGSA_I/-DBGSA_G; see bitpal_common.cuh).
//
// Replaces bgsa_tpu/ops/bitpal_packed.py::_kernel (the Pallas TPU kernel
// behind bitpal_packed) and computes what it computes, bit for bit: each
// row's vertical-delta class is stored in nbits = bit_length(M - 2G) + 1
// two's-complement planes (value v as -(v - G) mod 2^nbits). Per word of a
// column (_packed_column): the phase-A classes are decoded from the planes,
// a run-propagation network with cross-word add carries gives the
// horizontal-delta classes, a plane ripple adder adds them, rows that
// overflowed are clamped, the sum shifts one row up (cross-word row
// carries), and a second adder subtracts the mapped horizontal delta. The
// JAX network's surgery is kept, as it gives the same bits: the DV
// encoding's top plane is zero and its adder and clamp ops are skipped; the
// last word's outgoing carries are computed but never read. The global
// score is a weighted popcount of the planes, the semi-global one a
// bit-serial prefix walk. Only for M <= 2I - 2G + 1 (the decode covers the
// classes [G, I - G]); the engine takes bitpal.cu elsewhere.
//
// What bounds it: integer logic, as in bitpal.cu, with far fewer planes
// (5 for (2,-3,-5) against 13) and so fewer operations and registers per
// word; the state is nbits x W words a pair, in registers up to the
// scheme's bound (24 words, 744 bp, for (2,-3,-5) in 31-bit words); beyond
// it the tiled kernel of bitpal_common.cuh holds one word's planes.

#include "bitpal_common.cuh"

namespace bitpal {
namespace {

constexpr int bit_length(int x) {
  int n = 0;
  for (; x > 0; x >>= 1) ++n;
  return n;
}

template <int M, int I, int G, int WB>
struct Packed {
  using Sc = Scheme<M, I, G>;
  using Wd = Word<WB>;
  static_assert(M <= 2 * I - 2 * G + 1, "packed BitPAl requires M <= 2I - 2G + 1");
  static constexpr int lo = Sc::kMin, mid = Sc::kMid, hi = Sc::kMax;
  static constexpr int kPlanes = bit_length(hi - lo) + 1 > 2 ? bit_length(hi - lo) + 1 : 2;
  static constexpr int NB = kPlanes, TOP = NB - 1;
  static constexpr int kDecoded = hi - mid;  // phase-A classes lo .. lo + kDecoded - 1
  static constexpr uint32_t CM = Wd::kMask;

  struct Carries {
    uint32_t add[Sc::kAdds];  // run-propagation add carries, key 0..kAdds-1
    uint32_t prev[Sc::kValues];  // one-row shift carries of phase A, by value - lo
    uint32_t row[TOP];        // one-row shift carries of the sum planes
  };

  // The add carries, the phase-A shift carries of the values mid+1 .. hi-1
  // (the network reads no other), then the row carries.
  static constexpr int kCarryBits = 2 * Sc::kAdds - 1 + TOP;
  template <class F>
  static __device__ __forceinline__ void each_carry(Carries& c, F&& f) {
#pragma unroll
    for (int k = 0; k < Sc::kAdds; ++k) f(c.add[k], k);
#pragma unroll
    for (int v = mid + 1; v < hi; ++v) f(c.prev[v - lo], Sc::kAdds + v - mid - 1);
#pragma unroll
    for (int i = 0; i < TOP; ++i) f(c.row[i], 2 * Sc::kAdds - 1 + i);
  }

  static __device__ __forceinline__ void init(uint32_t (&pl)[kPlanes], int semi) {
    // semi-global: stored(-(0 - G)) = G mod 2^nbits; global: 0 (DV = G)
    const int pattern = semi ? (lo & ((1 << NB) - 1)) : 0;
#pragma unroll
    for (int i = 0; i < NB; ++i) pl[i] = (pattern >> i) & 1 ? CM : 0u;
  }

  // Indicator of the rows whose planes hold `pattern`: AND, msb first, of
  // each plane or its complement.
  static __device__ __forceinline__ uint32_t decode(const uint32_t (&d)[NB], int pattern) {
    uint32_t t = (pattern >> TOP) & 1 ? d[TOP] : ~d[TOP];
#pragma unroll
    for (int i = TOP - 1; i >= 0; --i) t &= (pattern >> i) & 1 ? d[i] : ~d[i];
    return t;
  }

  static __device__ __forceinline__ void word(uint32_t (&pl)[kPlanes], uint32_t matches,
                                              Carries& c) {
    uint32_t d[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) d[i] = pl[i];
    const uint32_t not_matches = ~matches;

    uint32_t dh[kDecoded];  // class lo + k
#pragma unroll
    for (int k = 0; k < kDecoded; ++k) dh[k] = decode(d, (-k) & ((1 << NB) - 1));
    const uint32_t zero_class = dh[0];
    dh[0] &= CM;

    // Union of the low classes [lo, mid]: stored == 0 or stored >=
    // 2^nbits - (mid - lo), the >= as a plane comparator built lsb first.
    constexpr int thresh = (1 << NB) - (mid - lo);
    uint32_t ge = 0;
    bool have = false;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if ((thresh >> i) & 1) {
        ge = have ? d[i] & ge : d[i];
        have = true;
      } else if (have) {
        ge = d[i] | ge;
      }
    }
    const uint32_t lo_mid = (zero_class | ge) & not_matches;

    // Phase A: horizontal-delta classes (mid, hi].
    uint32_t dv[Sc::kValues];  // by value - lo, for mid < v < hi
    const uint32_t init_max = dh[0] & matches;
    const uint32_t s0 = Wd::add(init_max, dh[0], c.add[0]);
    const uint32_t dv_max = (s0 ^ dh[0] ^ init_max) & CM;
    const uint32_t remain = dh[0] ^ init_max;
    const uint32_t dv_max_or_match = dv_max | matches;
#pragma unroll
    for (int i = hi - 1; i > mid; --i) {
      uint32_t init = dh[hi - i] & dv_max_or_match;
#pragma unroll
      for (int x = 1; x < hi - i; ++x) init |= dh[hi - i - x] & dv[hi - x - lo];
      const uint32_t val = ((init << 1) | c.prev[i - lo]) & CM;
      c.prev[i - lo] = Wd::top_bit(init);
      const uint32_t s = Wd::add(val, remain, c.add[hi - i]);
      dv[i - lo] = (s ^ remain) & not_matches;
    }
    uint32_t acc = dv_max_or_match;
#pragma unroll
    for (int i = hi - 1; i > mid; --i) acc |= dv[i - lo];
    const uint32_t dv_not_hi = ~acc;

    // Encode the horizontal classes into planes (mapped = v - lo); the top
    // plane is identically zero.
    uint32_t dvb[TOP];
#pragma unroll
    for (int i = 0; i < TOP; ++i) {
      uint32_t a = 0;
#pragma unroll
      for (int v = mid; v <= hi; ++v) {
        if (((v - lo) >> i) & 1) a |= v == mid ? dv_not_hi : v == hi ? dv_max_or_match : dv[v - lo];
      }
      dvb[i] = a;
    }

    // mapped(DHin) + mapped(DV): ripple adder over the planes.
    uint32_t sum[NB];
    uint32_t carry = d[0] & dvb[0];
    sum[0] = d[0] ^ dvb[0];
#pragma unroll
    for (int i = 1; i < TOP; ++i) {
      const uint32_t x = d[i] ^ dvb[i];
      sum[i] = x ^ carry;
      carry = (d[i] & dvb[i]) | (x & carry);
    }
    const uint32_t comp = ~(d[TOP] ^ carry);

    // Clamp the rows whose sum overflowed, shift one row up.
    uint32_t shifted[TOP];
#pragma unroll
    for (int i = 0; i < TOP; ++i) {
      const uint32_t sb = sum[i] & comp;
      shifted[i] = (sb << 1) | c.row[i];
      c.row[i] = Wd::top_bit(sb);
    }

    // Subtract mapped(H) at the same row: add its negation, built from the
    // mark patterns.
    const uint32_t comp_lo_mid = ~lo_mid;
    constexpr int mark1 = mid - lo - 1;
    constexpr int mark2 = hi - lo - 1;
    uint32_t adj[NB];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      uint32_t b = d[i];
      b = (mark1 >> i) & 1 ? b & comp_lo_mid : b | lo_mid;
      b = (mark2 >> i) & 1 ? b & not_matches : b | matches;
      adj[i] = b;
    }
    carry = adj[0] & shifted[0];
    sum[0] = adj[0] ^ shifted[0];
#pragma unroll
    for (int i = 1; i < TOP; ++i) {
      const uint32_t x = adj[i] ^ shifted[i];
      sum[i] = x ^ carry;
      carry = (adj[i] & shifted[i]) | (x & carry);
    }
    const uint32_t top = adj[TOP] ^ carry;
#pragma unroll
    for (int i = 0; i < TOP; ++i) pl[i] = sum[i] & top;
    pl[TOP] = top;
  }

  static __host__ __device__ constexpr int weight(int i) { return i == TOP ? (1 << i) : -(1 << i); }

  static __device__ __forceinline__ int global_base(int m, int read_len) {
    return G * m + G * read_len;
  }

  static __device__ __forceinline__ int word_score(const uint32_t (&pl)[kPlanes],
                                                   uint32_t mask) {
    int score = 0;
#pragma unroll
    for (int i = 0; i < NB; ++i) score += weight(i) * __popc(pl[i] & mask);
    return score;
  }

  static __device__ __forceinline__ int row_delta(const uint32_t (&pl)[kPlanes], int b) {
    int delta = G;
#pragma unroll
    for (int i = 0; i < NB; ++i) delta += weight(i) * static_cast<int>((pl[i] >> b) & 1u);
    return delta;
  }
};

}  // namespace
}  // namespace bitpal

extern "C" {

// Largest W whose planes stay in registers; longer subjects take the tiled
// kernel, which needs `scratch` of nbits * W * Q * S words when the query
// spans more than one tile.
int bgsa_reg_words() {
  return bitpal::reg_words<bitpal::Packed<BGSA_M, BGSA_I, BGSA_G, 32>>();
}

// Query columns a tile of the tiled kernel holds.
int bgsa_tile_columns() {
  return bitpal::tile_columns<bitpal::Packed<BGSA_M, BGSA_I, BGSA_G, 32>>();
}

const char* bgsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// eq: (5, W, S) uint32 packed to word_bits (31 or 32); queries: (Q, m)
// uint8; out: (Q, S) int32, factor times the score.
int bgsa_bitpal_packed(const void* eq, const void* queries, void* out, void* scratch, int Q,
                       int m, int W, int S, int read_len, int factor, int semi, int word_bits,
                       void* stream) {
  return bitpal::entry<bitpal::Packed>(eq, queries, out, scratch, Q, m, W, S, read_len, factor,
                                        semi, word_bits, stream);
}

}  // extern "C"
