// The kernel-print fixture for Hopper.
//
// Replaces the inline Pallas kernel of tests/test_round2_fixes.py's
// test_debug_kprint_interpret, which prints "probe {}" of x[0, 0] through
// bgsa_tpu/debug.py::kprint and copies x to out: here kprint_probe_kernel,
// printing with BGSA_KPRINT (debug.cuh).
//
// What bounds it: nothing it computes. It moves 4 bytes in and 4 out per
// element and makes one device printf, so its time is the launch's latency
// and the print's.
//
// Design: one thread per element (a grid-stride loop past 1024 blocks);
// thread 0 of block 0 prints. The launch uses the caller's stream, allocates
// nothing, and the C entry point returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "debug.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads)
kprint_probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n) {
  BGSA_KPRINT("probe %d", x[0]);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = x[i];
  }
}

}  // namespace

extern "C" {

// x, out: n int32 each (x[0] is x[0, 0] of the row-major array).
int bgsa_kprint_probe(const void* x, void* out, int n, void* cuda_stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = need < kMaxBlocks ? need : kMaxBlocks;
  kprint_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
