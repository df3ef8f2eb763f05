// int32 ALU issue-peak microbenchmark for Hopper.
//
// Replaces scripts/roofline.py::_peak_kernel (the Pallas TPU kernel that
// measure_peak launches: the VPU's practical issue rate for the op mix of the
// bit-vector kernels), and computes what it computes: `chains` independent
// dependency chains per element, each iteration of a chain being the 7-op
// mix add, shr, xor, or, shl, and, not
//
//     a = a + b;  a = a ^ (a >> 1);  a = a | b;  a = a & (a << 1);  a = ~a;
//
// over steps * unroll iterations, then the chains XOR-folded into the
// output, so no chain is dead. Each chain is serial (like one word of a Myers
// column) but the chains overlap (like the W words of a column), so the rate
// measured is the issue throughput of the mix, not a chain's latency.
//
// What bounds it: int32 issue, by construction; it reads 4 (chains + 1) bytes
// and writes 4 bytes per element, against 7 * chains * iterations
// operations. Design: one thread per element, the chains in registers, enough
// elements to fill every SM several times over (the wrapper picks the count).
// Each operation is one PTX instruction in its own `asm volatile`, so the
// front end can neither fold nor reorder the mix (for example turning
// `~x + b` into a subtraction); the chain stages are interleaved across
// chains so consecutive instructions are independent. ptxas still folds the
// `and`/`not` pair into one LOP3 and issues the add and the left shift as
// IMAD on the FMA pipe, beside the ALU pipe's LOP3/SHF: 6 SASS instructions
// per 7 operations, two pipes at once. bgsa_tpu_torch/roofline.py reads the
// SASS with cuobjdump and holds each pipe's measured rate against its 64
// int32 results per clock per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 16;

template <int CHAINS>
__device__ __forceinline__ void chain_step(uint32_t (&v)[CHAINS], uint32_t b) {
  uint32_t t[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("add.u32 %0, %0, %1;" : "+r"(v[j]) : "r"(b));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("shr.u32 %0, %1, 1;" : "=r"(t[j]) : "r"(v[j]));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("xor.b32 %0, %0, %1;" : "+r"(v[j]) : "r"(t[j]));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("or.b32 %0, %0, %1;" : "+r"(v[j]) : "r"(b));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("shl.b32 %0, %1, 1;" : "=r"(t[j]) : "r"(v[j]));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("and.b32 %0, %0, %1;" : "+r"(v[j]) : "r"(t[j]));
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) asm volatile("not.b32 %0, %0;" : "+r"(v[j]));
}

// x: (CHAINS + 1, n) uint32, row CHAINS being b; out: (n,) uint32.
template <int CHAINS>
__global__ void __launch_bounds__(kThreads)
int_peak_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int n, int iters) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  uint32_t v[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) v[j] = x[static_cast<size_t>(j) * n + e];
  const uint32_t b = x[static_cast<size_t>(CHAINS) * n + e];
  // the two loops are not unrolled further, so the compiled kernel holds
  // exactly kUnroll + 1 copies of the chain step (roofline.py counts them)
  int i = 0;
#pragma unroll 1
  for (; i + kUnroll <= iters; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) chain_step<CHAINS>(v, b);
  }
#pragma unroll 1
  for (; i < iters; ++i) chain_step<CHAINS>(v, b);
  uint32_t acc = v[0];
#pragma unroll
  for (int j = 1; j < CHAINS; ++j) acc ^= v[j];
  out[e] = acc;
}

template <int CHAINS>
void launch(const uint32_t* x, uint32_t* out, int n, int iters, cudaStream_t stream) {
  int_peak_kernel<CHAINS><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, out, n,
                                                                                 iters);
}

}  // namespace

extern "C" {

// Chain counts with a kernel instantiation.
int bgsa_int_peak_supports(int chains) {
  return chains == 1 || chains == 2 || chains == 4 || chains == 8 || chains == 16 ||
         chains == 32;
}

// x: (chains + 1, n) uint32; out: (n,) uint32; iters = steps * unroll.
int bgsa_int_peak(const void* x, void* out, int chains, int n, int iters, void* stream) {
  if (n <= 0 || iters < 0 || !bgsa_int_peak_supports(chains)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xi = static_cast<const uint32_t*>(x);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (chains) {
    case 1: launch<1>(xi, o, n, iters, st); break;
    case 2: launch<2>(xi, o, n, iters, st); break;
    case 4: launch<4>(xi, o, n, iters, st); break;
    case 8: launch<8>(xi, o, n, iters, st); break;
    case 16: launch<16>(xi, o, n, iters, st); break;
    default: launch<32>(xi, o, n, iters, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
