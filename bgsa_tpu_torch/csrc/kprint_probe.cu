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
//
// Two reference kernels sit beside it, measurement tools with no TPU twin
// that give the fixture's row its floor: bgsa_empty_probe, one block that
// does nothing (the least device time of any launch on the card), and
// bgsa_copy_probe, the fixture's grid and copy loop without the print.

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

__global__ void __launch_bounds__(kThreads)
copy_probe_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    out[i] = x[i];
  }
}

__global__ void empty_probe_kernel() {}

int probe_blocks(int n) {
  const int need = (n + kThreads - 1) / kThreads;
  return need < kMaxBlocks ? need : kMaxBlocks;
}

}  // namespace

extern "C" {

// x, out: n int32 each (x[0] is x[0, 0] of the row-major array).
int bgsa_kprint_probe(const void* x, void* out, int n, void* cuda_stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  kprint_probe_kernel<<<probe_blocks(n), kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// The fixture's launch and copy without BGSA_KPRINT.
int bgsa_copy_probe(const void* x, void* out, int n, void* cuda_stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  copy_probe_kernel<<<probe_blocks(n), kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// One block of one thread that does nothing: a bare launch.
int bgsa_empty_probe(void* cuda_stream) {
  empty_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(cuda_stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
