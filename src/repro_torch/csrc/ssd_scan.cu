// K5 ssd_state_scan: the Mamba-2 SSD inter-chunk recurrence
//     h_{c+1} = decay_c * h_c + state_c      (c = 0 .. nc - 1, h_0 = 0)
// over state_c (b, nc, H, P, N) float32 and chunk_decay (b, nc, H) float32,
// emitting the state ENTERING each chunk: out (b, nc, H, P, N), chunk 0 = 0.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan/kernel.py:ssd_state_scan.
//
// Bound on an H100: memory. Each element is read once and written once and
// costs one multiply and one add per chunk (mamba2-130m at 2048 tokens, batch
// 8: 50.3 MB in and 50.3 MB out, about 30 us at 3.35 TB/s; the arithmetic is
// 25 M float operations). Design: one thread per (b, h, p, n) element,
// neighbouring threads on neighbouring n, so every load and store of a chunk
// is coalesced; the running state lives in a register (the TPU kernel kept it
// in VMEM) and the loop over the chunks runs inside the thread. The update is
// a multiply and an add, each rounded (__fmul_rn, __fadd_rn: never contracted
// into an FMA), the order of the plain version, so the two agree bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kScanThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
ssd_state_scan_kernel(const float* __restrict__ state, const float* __restrict__ decay,
                      int nc, int H, int64_t inner, int64_t total, float* __restrict__ out) {
  // inner = H * P * N elements per (batch, chunk); total = b * inner threads
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kScanThreads + threadIdx.x;
  if (t >= total) return;
  const int64_t bb = t / inner;
  const int64_t r = t - bb * inner;
  const int64_t hh = r / (inner / H);
  float h = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const int64_t row = bb * nc + c;
    const int64_t at = row * inner + r;
    out[at] = h;
    h = __fadd_rn(__fmul_rn(h, decay[row * H + hh]), state[at]);
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

extern "C" int ssd_state_scan_launch(const float* state, const float* decay, int b, int nc,
                                     int H, int PN, float* out, void* stream) {
  const int64_t inner = static_cast<int64_t>(H) * PN;
  const int64_t total = static_cast<int64_t>(b) * inner;
  const int64_t blocks = (total + kScanThreads - 1) / kScanThreads;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidConfiguration);
  ssd_state_scan_kernel<<<static_cast<unsigned>(blocks), kScanThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(state, decay, nc, H, inner,
                                                               total, out);
  return static_cast<int>(cudaGetLastError());
}
