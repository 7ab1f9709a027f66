// K8 probe: out = x + 1 over an (8, 128) int32 tensor, the availability probe
// behind the backend fallback chains (kernels/backend.py _kernel_available).
//
// Replaces the Pallas TPU kernel launched by
// repro/kernels/__init__.py:_pallas_available (the x + 1 kernel at :107).
//
// Bound on an H100: neither; 4 KB in and 4 KB out take about 2.4 ns at
// 3.35 TB/s, so the launch itself is the whole cost. What it proves is that
// the library built for this card, loads, and that a kernel of it launches
// and writes back. Design: one thread per element, one block of 256 threads
// per 256 elements.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kProbeThreads = 256;

__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const int32_t* __restrict__ x, int n, int32_t* __restrict__ out) {
  const int i = blockIdx.x * kProbeThreads + threadIdx.x;
  if (i < n) out[i] = x[i] + 1;
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" int probe_launch(const int32_t* x, int n, int32_t* out, void* stream) {
  const int blocks = n > 0 ? (n + kProbeThreads - 1) / kProbeThreads : 1;
  probe_kernel<<<blocks, kProbeThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, n, out);
  return static_cast<int>(cudaGetLastError());
}
