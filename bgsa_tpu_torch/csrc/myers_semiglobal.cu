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
// written (9 or, 3 and, 1 xor, 1 add, 2 not, 2 shl, 2 shr); the compiler
// may fold not/or/and triples into three-input LOP3s. Each word-column
// reads one 4-byte Eq word, and the same words are read at every column of
// every query: where that read is a global load (an L2 hit at a runtime
// stride, with its 64-bit address arithmetic) it adds issue slots and the
// chain waits on L2's latency. So up to kRegWords words (myers_regs<W>) a
// block stages its tile's Eq words in shared memory once and reads every
// word-column there, at an offset fixed at compile time, which leaves the
// kernel bound by int32 issue rate and dependency latency; past kRegWords
// words both schedules of the strips (myers_strips, myers_strips_wave) do
// the same a strip at a time. There the bound is the same network's: the
// register instance's cost per word, for every word-column. wgmma and TMA
// do not apply.
//
// Design (simple first):
//   * up to kRegWords words (myers_regs<W>, one instance for each W): a
//     block owns a tile of kTile = 32 subjects, one a lane. It copies their
//     (5, W, kTile) Eq words from the (5, W, S) input into shared memory
//     once, coalesced, with a sixth plane of zeros that query codes outside
//     0..4 read (lanes past S read zeros and store nothing). Then each of
//     its warps runs one query at a time over the tile, the block's warps
//     taking the queries of its chunk in turn: after the tile's one barrier
//     a warp stages its own query row in shared memory with warp
//     synchronization only. A column picks its plane once from the query
//     code; word j is then a shared-memory load at a fixed offset, with no
//     mask and no bound test. The chunk is the most whole kWarps queries
//     that still leave the grid kBlocksPerSm blocks on every SM (regs_chunk);
//   * past kRegWords, the words run in strips of kRegWords (the last may be
//     narrower), one strip after another over every column, each strip's
//     pv/mv in registers from its first column to its last. A column's
//     horizontal carries out of a strip's last word are the next strip's
//     input at that column: every strip but the last packs them into one hp
//     and one hn word per 32 columns in a caller-allocated carry buffer (2,
//     ceil(m / 32), Q, S), which the next strip reads back in place; only
//     the last strip moves the score. Each strip reads its Eq words from a
//     shared-memory tile of (5 + 1 planes of zeros) x 32 words x 32 lanes,
//     24,576 B, read as in myers_regs. On many pairs (myers_strips) the
//     block is myers_regs': a tile of 32 subjects whose four warps take the
//     queries of its chunk in turn; the strip loop is the block's, which
//     stages each strip's words between two barriers, and each warp runs its
//     queries over every column of the strip, its query row staged in
//     chunks of kQueryChunk codes, so any query length fits. The registers
//     set the residency (kStripBlocksPerSm). On few pairs (the caller's
//     choice: where one warp a group of 32 subjects would leave the SMs
//     thin) the strips of a group run as a wavefront over a block's four
//     warps (myers_strips_wave), one batch of 32 columns a step, a barrier
//     after each step, its query codes read a batch at a time, one a lane,
//     and shuffled out; each warp stages its strip's tile at the strip's
//     first batch, 98,304 B a block, so 2 blocks fit on an SM (264 on a
//     132-SM card, where the registers allowed 4): a grid of 672 blocks
//     runs as 3 rounds of 264 instead of 2 of 528, one of 192 as 0.73 of a
//     round instead of 0.36;
//   * query codes outside 0..4 match nothing (no out-of-range Eq reads).
// The launch uses the caller's stream, allocates nothing and does not
// synchronize; the C entry point returns cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <utility>

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
constexpr int kTile = kLanes;       // subjects a myers_regs or myers_strips block: one a lane
constexpr int kPlanes = kChars + 1; // the tile's planes: A, C, G, T, N, then zeros
constexpr int kBlocksPerSm = 128;   // myers_regs / myers_strips blocks a grid leaves every SM
constexpr int kStripPlane = kRegWords * kLanes;  // words a plane of a strip's tile
constexpr int kStripTile = kPlanes * kStripPlane;  // words a strip's tile: 24,576 B
constexpr int kStripBlocksPerSm = 4;  // myers_strips blocks an SM: at most 128 registers
constexpr int kWaveSmem = kWarps * kStripTile * 4;  // a wavefront block's tiles: 98,304 B
constexpr int kWaveBlocksPerSm = 2;  // wavefront blocks an SM: what its tiles leave room for

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

__device__ __forceinline__ int score_delta(uint32_t ph, uint32_t mh, int last_shift) {
  return static_cast<int>((ph >> last_shift) & 1u) - static_cast<int>((mh >> last_shift) & 1u);
}

// Up to kRegWords words: a block's warps run the queries q0 + warp,
// q0 + warp + kWarps, ... of its chunk [q0, q0 + chunk) (blockIdx.y picks
// it) over its tile of kTile subjects (blockIdx.x), all W words of a
// pair's pv/mv in registers. At least one block per SM is all the launch
// bounds ask: with no minimum, ptxas kept some instances under a register
// count by spilling a few bytes of the query loop's state.
template <int W>
__global__ void __launch_bounds__(kThreads, 1)
myers_regs(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
           int32_t* __restrict__ out, int Q, int m, int S, int read_len, int factor,
           int is_global, int chunk) {
  __shared__ uint32_t tile[kPlanes * W * kTile];  // [plane][word][lane]
  __shared__ uint8_t rows[kWarps][kQueryChunk];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int s0 = blockIdx.x * kTile;
  const int s = s0 + lane;
  const bool active = s < S;
  for (int i = threadIdx.x; i < kPlanes * W * kTile; i += kThreads) {
    const int row = i / kTile, t = s0 + i % kTile;  // row: plane * W + word
    tile[i] = row < kChars * W && t < S ? eq[static_cast<size_t>(row) * S + t] : 0u;
  }
  __syncthreads();  // the block's only barrier: a warp out of queries holds none
  const int last_shift = (read_len - 1) % kWordBits;
  uint8_t* const qs = rows[warp];
  const int q0 = blockIdx.y * chunk, end = q0 + min(chunk, Q - q0);
  for (int q = q0 + warp; q < end; q += kWarps) {
    const uint8_t* const query = queries + static_cast<size_t>(q) * m;
    uint32_t pv[W], mv[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      pv[j] = 0xFFFFFFFFu;
      mv[j] = 0u;
    }
    int score = read_len;
    int min_score = read_len;
    for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
      const int n = min(kQueryChunk, m - c0);
      __syncwarp();  // every lane is done with the previous row
      for (int i = lane; i < n; i += kLanes) qs[i] = query[c0 + i];
      __syncwarp();
      for (int i = 0; i < n; ++i) {
        const uint32_t* const eq_c = tile + min(static_cast<int>(qs[i]), kChars) * (W * kTile)
                                     + lane;
        uint32_t hp = is_global ? 1u : 0u, hn = 0u, ph = 0u, mh = 0u;
#pragma unroll
        for (int j = 0; j < W; ++j) myers_word(eq_c[j * kTile], pv[j], mv[j], hp, hn, ph, mh);
        score += score_delta(ph, mh, last_shift);  // ph/mh of word W-1
        if (!is_global) min_score = min(min_score, score);
      }
    }
    if (active) out[static_cast<size_t>(q) * S + s] = (is_global ? score : min_score) * factor;
  }
}

// One strip's batch of nb <= 32 columns (b, the batch's index, picks its
// carry words), pv/mv carried in registers from batch to batch, the strip's
// Eq words from a shared-memory tile. tile: this lane's column of the tile,
// word j of plane p at tile[(p * kRegWords + j) * kLanes]; code(t): the query
// code of the batch's column t. The first word takes column t's incoming
// carries at bit t of carries[0 / 1][b][q][s] (at points at this pair's word
// of plane 0; strip 0 takes the top boundary instead); the last word's
// outgoing ones are stored there in place (`store`: every strip but the
// last); only the last strip moves the score. kFull: the strip has all
// kRegWords words, so no word is guarded (else the first sw).
template <bool kFull, typename Code>
__device__ __forceinline__ void tile_batch(const uint32_t* tile, int sw,
                                           uint32_t (&pv)[kRegWords], uint32_t (&mv)[kRegWords],
                                           uint32_t* at, size_t carry_plane, bool first,
                                           bool last, bool store, int nb, Code code,
                                           int last_shift, int is_global, int& score,
                                           int& min_score) {
  const uint32_t hp_in = first ? (is_global ? 0xFFFFFFFFu : 0u) : at[0];
  const uint32_t hn_in = first ? 0u : at[carry_plane];
  uint32_t hp_out = 0u, hn_out = 0u;
  for (int t = 0; t < nb; ++t) {
    const uint32_t* const eq_c = tile + min(code(t), kChars) * kStripPlane;
    uint32_t hp = (hp_in >> t) & 1u, hn = (hn_in >> t) & 1u, ph = 0u, mh = 0u;
#pragma unroll
    for (int j = 0; j < kRegWords; ++j) {
      if (kFull || j < sw) myers_word(eq_c[j * kLanes], pv[j], mv[j], hp, hn, ph, mh);
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
//
// The block is myers_regs': a tile of kTile subjects (blockIdx.x), one a
// lane, and the queries q0 + warp, q0 + warp + kWarps, ... of its chunk
// [q0, q0 + chunk) (blockIdx.y) taken by its warps in turn. The strip loop
// is the block's: at each strip the block copies the strip's (5, sw, kTile)
// Eq words into shared memory, coalesced, between two barriers
// ([plane][word][lane], 20,480 B, and a sixth plane of zeros, written once,
// that query codes outside 0..4 read: 24,576 B), and each warp then runs
// each of its queries over every column of the strip, its pv/mv reset, its
// query row staged kQueryChunk codes at a time with warp synchronization
// only. A warp with no query still reaches every barrier. A column picks its
// plane once from the query code, and word j is a shared-memory load at a
// fixed offset: no mask, no clamp of the code per word, no bound test on a
// full strip and no 64-bit address arithmetic. Lanes past S compute on a
// column of zeros and subject S - 1's carries and store nothing.
// kStripBlocksPerSm blocks an SM are what the launch bounds ask: the
// registers, not the tile, set the residency. At 4, ptxas fits 128 registers
// with no spill; left at 1 it took 181 (2 blocks an SM), and a 5 kbp bucket
// ran 18 % longer.
__global__ void __launch_bounds__(kThreads, kStripBlocksPerSm)
myers_strips(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
             int32_t* __restrict__ out, uint32_t* __restrict__ carries, int Q, int m, int W,
             int S, int read_len, int factor, int is_global, int chunk) {
  __shared__ uint32_t tile[kStripTile];  // [plane][word][lane]
  __shared__ uint8_t rows[kWarps][kQueryChunk];
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int s0 = blockIdx.x * kTile;
  const int s = s0 + lane;
  const bool active = s < S;
  const int sr = active ? s : S - 1;  // the subject whose carries a lane reads
  for (int i = threadIdx.x; i < kStripPlane; i += kThreads) tile[kChars * kStripPlane + i] = 0u;
  const int last_shift = (read_len - 1) % kWordBits;
  const size_t pairs = static_cast<size_t>(Q) * S;
  const size_t carry_plane = static_cast<size_t>((m + kBatch - 1) / kBatch) * pairs;
  const int q0 = blockIdx.y * chunk, end = q0 + min(chunk, Q - q0);
  uint8_t* const qs = rows[warp];
  for (int w0 = 0; w0 < W; w0 += kRegWords) {
    const int sw = min(kRegWords, W - w0);
    const bool first = w0 == 0;
    const bool last = w0 + sw == W;
    __syncthreads();  // every warp is done with the previous strip's tile
    for (int i = threadIdx.x; i < kChars * kStripPlane; i += kThreads) {
      const int row = i / kTile, w = row % kRegWords, t = s0 + i % kTile;  // row: plane, word
      tile[i] = w < sw && t < S
                    ? eq[(static_cast<size_t>(row / kRegWords) * W + w0 + w) * S + t] : 0u;
    }
    __syncthreads();
    for (int q = q0 + warp; q < end; q += kWarps) {
      const uint8_t* const query = queries + static_cast<size_t>(q) * m;
      uint32_t* const at = carries + static_cast<size_t>(q) * S + sr;
      int score = read_len;
      int min_score = read_len;
      uint32_t pv[kRegWords], mv[kRegWords];
      reset_strip(pv, mv);
      for (int c0 = 0; c0 < m; c0 += kQueryChunk) {
        const int n = min(kQueryChunk, m - c0);
        __syncwarp();  // every lane is done with the previous row
        for (int i = lane; i < n; i += kLanes) qs[i] = query[c0 + i];
        __syncwarp();
        for (int b = 0; b < n; b += kBatch) {  // 32 columns: one carry word a plane
          const uint8_t* const row = qs + b;
          const auto code = [row](int t) { return static_cast<int>(row[t]); };
          uint32_t* const at_b = at + static_cast<size_t>((c0 + b) / kBatch) * pairs;
          const int nb = min(kBatch, n - b);
          if (sw == kRegWords) {
            tile_batch<true>(tile + lane, sw, pv, mv, at_b, carry_plane, first, last,
                             !last && active, nb, code, last_shift, is_global, score,
                             min_score);
          } else {
            tile_batch<false>(tile + lane, sw, pv, mv, at_b, carry_plane, first, last,
                              !last && active, nb, code, last_shift, is_global, score,
                              min_score);
          }
        }
      }
      if (last && active) {
        out[static_cast<size_t>(q) * S + s] = (is_global ? score : min_score) * factor;
      }
    }
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
//
// Eq comes from shared memory, as in myers_regs. Each warp owns a tile of
// kPlanes x kRegWords x kLanes words ([plane][word][lane], 24,576 B; the
// block's four 98,304 B of dynamic shared memory): at a strip's batch 0
// each lane copies its own subject's (5, sw) words of the strip into its
// column, coalesced across the warp, and a sixth plane of zeros, written
// once, is what query codes outside 0..4 read. A lane reads only its own
// column and the warp rewrites the tile only at its next strip's batch 0,
// so the tile needs no barrier and no warp synchronization. A column then
// picks its plane once from the query code, and word j is a shared-memory
// load at a fixed offset: no mask, no clamp of the code per word, no bound
// test on a full strip and no 64-bit address arithmetic, so ptxas may
// issue a column's loads ahead of its chain (the launch bounds leave it up
// to 255 registers). The tiles, not the registers, set the residency:
// kWaveBlocksPerSm blocks an SM, 264 on a 132-SM card, so a grid of 672
// blocks runs as 2.55 rounds (3) and one of 192 fills 0.73 of a round.
// myers_strips shares one such tile among its block's four warps, which
// run different queries over the same 32 subjects.
__global__ void __launch_bounds__(kThreads, kWaveBlocksPerSm)
myers_strips_wave(const uint32_t* __restrict__ eq, const uint8_t* __restrict__ queries,
                  int32_t* __restrict__ out, uint32_t* carries, int Q, int m, int W, int S,
                  int read_len, int factor, int is_global) {
  extern __shared__ uint32_t wave_tiles[];  // [warp][plane][word][lane]
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  const int s = blockIdx.x * kLanes + lane;
  const bool active = s < S;
  const int sr = active ? s : S - 1;  // the subject a lane reads
  uint32_t* const tile = wave_tiles + warp * kStripTile + lane;  // this lane's column
#pragma unroll
  for (int j = 0; j < kRegWords; ++j) tile[(kChars * kRegWords + j) * kLanes] = 0u;
  const int last_shift = (read_len - 1) % kWordBits;
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
        const int sw = min(kRegWords, W - w0);
        const bool last = strip == strips - 1;
        if (b == 0) {
          reset_strip(pv, mv);
          const uint32_t* const eq_s = eq + static_cast<size_t>(w0) * S + sr;
          for (int p = 0; p < kChars; ++p) {
            for (int w = 0; w < sw; ++w) {
              tile[(p * kRegWords + w) * kLanes] = eq_s[(static_cast<size_t>(p) * W + w) * S];
            }
          }
        }
        const int c0 = b * kBatch;
        const int nb = min(kBatch, m - c0);
        const int codes = lane < nb ? query[c0 + lane] : 0;
        const auto code = [codes](int t) { return __shfl_sync(0xFFFFFFFFu, codes, t); };
        uint32_t* const at = carries + static_cast<size_t>(b) * pairs + pair;
        if (sw == kRegWords) {
          tile_batch<true>(tile, sw, pv, mv, at, carry_plane, strip == 0, last, !last && active,
                           nb, code, last_shift, is_global, score, min_score);
        } else {
          tile_batch<false>(tile, sw, pv, mv, at, carry_plane, strip == 0, last,
                            !last && active, nb, code, last_shift, is_global, score, min_score);
        }
      }
      __syncthreads();
    }
    if (active && (strips - 1) % kWarps == warp) {
      out[pair] = (is_global ? score : min_score) * factor;
    }
  }
}

using RegsKernel = void (*)(const uint32_t*, const uint8_t*, int32_t*, int, int, int, int, int,
                            int, int);

// myers_regs<W>, for W = 1 .. kRegWords.
template <int... I>
RegsKernel regs_kernel(int W, std::integer_sequence<int, I...>) {
  static const RegsKernel kernels[] = {&myers_regs<I + 1>...};
  return kernels[W - 1];
}

// Queries a myers_regs or myers_strips block walks over its tile: the most
// whole kWarps queries that still leave the grid kBlocksPerSm blocks on
// every SM of the current device (all of Q where the tiles alone do, kWarps
// where even that falls short), and no fewer than keep the grid's rows of
// chunks within kMaxGridY.
int regs_chunk(int Q, int tiles) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 0;
  }
  const long long quads = (static_cast<long long>(Q) + kWarps - 1) / kWarps;
  const long long wanted = static_cast<long long>(kBlocksPerSm) * sms;
  const long long rows = std::min({quads, static_cast<long long>(kMaxGridY),
                                   std::max(1LL, (wanted + tiles - 1) / tiles)});
  return static_cast<int>(kWarps * ((quads + rows - 1) / rows));
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
  const auto* e = static_cast<const uint32_t*>(eq);
  const auto* q = static_cast<const uint8_t*>(queries);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int tiles = (S + kTile - 1) / kTile;
  const int chunk = regs_chunk(Q, tiles);
  const dim3 grid(tiles, (Q - 1) / chunk + 1);
  if (W <= kRegWords) {
    regs_kernel(W, std::make_integer_sequence<int, kRegWords>())<<<grid, kThreads, 0, st>>>(
        e, q, o, Q, m, S, read_len, factor, is_global, chunk);
  } else {
    if ((carries == nullptr && m > 0) || (wave && (m + kBatch - 1) / kBatch < kWarps)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto* c = static_cast<uint32_t*>(carries);
    if (wave) {
      // past the 48 KB default: set on every wave launch, as the attribute is
      // the current device's
      const cudaError_t smem = cudaFuncSetAttribute(
          myers_strips_wave, cudaFuncAttributeMaxDynamicSharedMemorySize, kWaveSmem);
      if (smem != cudaSuccess) {
        cudaGetLastError();  // returned here: leave no error for the next launch
        return static_cast<int>(smem);
      }
      const dim3 wave_grid(tiles, Q < kMaxGridY ? Q : kMaxGridY);  // a block a group
      myers_strips_wave<<<wave_grid, kThreads, kWaveSmem, st>>>(e, q, o, c, Q, m, W, S,
                                                                read_len, factor, is_global);
    } else {
      myers_strips<<<grid, kThreads, 0, st>>>(e, q, o, c, Q, m, W, S, read_len, factor,
                                              is_global, chunk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
