// Non-packed BitPAl (general integer scoring M, I, G) for Hopper, one scheme
// per build (-DBGSA_M/-DBGSA_I/-DBGSA_G; see bitpal_common.cuh).
//
// Replaces bgsa_tpu/ops/bitpal.py::_kernel (the Pallas TPU kernel behind
// bitpal) and computes what it computes, bit for bit: one indicator plane
// per vertical-delta value v in [G, M - G] (M - 2G + 1 planes), updated per
// query column by the value-class network of _bitpal_column (phase A: the
// horizontal-delta classes by run-propagation adds with cross-word carries;
// phase B: the new vertical-delta planes). The global score is
// G*m + sum_v v * popcount(plane v of the final column); semi-global starts
// from the zero boundary and takes the best prefix of a bit-serial walk down
// the final column. Words hold 31 subject rows (bit 31 reserved for the add
// carry) or 32 (carry by unsigned compares), as the Eq words were packed.
//
// What bounds it: the column network is a chain of integer logic and adds,
// hundreds of operations per word per column for (2,-3,-5) (13 planes, the
// value-class OR-chains grow with the square of the planes), fed by one
// 4-byte Eq word (mostly an L2 hit: a bucket's Eq planes are reread by every
// query). So the kernel is bound by int32 issue rate and dependency latency,
// not by bytes; the state (planes x W words a pair) is what limits the
// register-resident path. wgmma and TMA do not apply.
//
// Design: every plane index is a compile-time constant after unrolling, so
// the planes stay in registers up to the scheme's register bound; beyond it
// (e.g. (2,-3,-5) at 500 bp, 13 x 16 words) the tiled kernel holds one
// word's planes and passes each column's 5 add and 11 shift carries to the
// next word in one packed word (bitpal_common.cuh). The network is in
// bitpal_unpacked.cuh.

#include "bitpal_unpacked.cuh"

extern "C" {

// Largest W whose planes stay in registers; longer subjects take the tiled
// kernel, which needs `scratch` of (M - 2G + 1) * W * Q * S words when the
// query spans more than one tile.
int bgsa_reg_words() {
  return bitpal::reg_words<bitpal::Unpacked<BGSA_M, BGSA_I, BGSA_G, 32>>();
}

// Query columns a tile of the tiled kernel holds.
int bgsa_tile_columns() {
  return bitpal::tile_columns<bitpal::Unpacked<BGSA_M, BGSA_I, BGSA_G, 32>>();
}

const char* bgsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// eq: (5, W, S) uint32 packed to word_bits (31 or 32); queries: (Q, m)
// uint8; out: (Q, S) int32, factor times the score.
int bgsa_bitpal(const void* eq, const void* queries, void* out, void* scratch, int Q, int m,
                int W, int S, int read_len, int factor, int semi, int word_bits, void* stream) {
  return bitpal::entry<bitpal::Unpacked>(eq, queries, out, scratch, Q, m, W, S, read_len,
                                          factor, semi, word_bits, stream);
}

}  // extern "C"
