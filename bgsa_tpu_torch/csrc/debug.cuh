// Printing from a kernel body, for the port's kernel authors: the
// counterpart of bgsa_tpu/debug.py::kprint (pl.debug_print in a Pallas
// kernel).
//
//   #include "debug.cuh"
//   BGSA_KPRINT("vp lane 0 = %llx", static_cast<unsigned long long>(vp));
//
// prints one line from one chosen thread, thread (0, 0, 0) of block
// (0, 0, 0). The format is printf's (%d, %u, %llx, ...) where kprint's is
// Python's "{}", and the line's newline is added, as pl.debug_print adds it.
//
// The line reaches the process's C stdout when the host next synchronises
// with the device (cudaDeviceSynchronize, a blocking copy), so on a pipe it
// may come after lines the host printed later: read it from a child
// process's stdout (chip_smoke.py phase 19 runs `python -m
// bgsa_tpu_torch.debug` for that). A device printf packs its arguments into
// a local buffer, so a kernel that prints has a stack frame of that size in
// ptxas's report, and no spill.

#pragma once

#include <cstdio>

namespace bgsa_debug {

__device__ __forceinline__ bool first_thread() {
  return (threadIdx.x | threadIdx.y | threadIdx.z | blockIdx.x | blockIdx.y | blockIdx.z) == 0;
}

}  // namespace bgsa_debug

#define BGSA_KPRINT(fmt, ...)                                      \
  do {                                                             \
    if (bgsa_debug::first_thread()) printf(fmt "\n", ##__VA_ARGS__); \
  } while (0)
