// K2 pop_variation_kernel: child-frame parents a_rows/b_rows (P, G) int32, the
// per-row crossover gate do_rows (P,), the five (G,) GeneTable leaves, the (3, 2)
// uint32 slot keys and the float32 per-gene mutation rate -> (P, G) int32 children
// (uniform crossover -> bit-flip / reset mutation -> clip).
//
// Replaces the Pallas TPU kernel
// repro/kernels/pop_variation/kernel.py:pop_variation_kernel.
//
// Bound on an H100: at the GA's shapes (P = 256, G = 409) the kernel moves about
// 1.3 MB and runs ~0.13 M Threefry evaluations of 67 int32 ops each (40 of them
// shifts and xors on the ALU pipe), so both bounds are under half a microsecond
// and the launch itself dominates. Design: one
// thread per (row pair, gene); grid.y walks the row pairs and grid.x the genes,
// so no index is divided out. The two mutation draws of a row pair come from one
// Threefry evaluation (one output word per row), the random bits never leave
// registers, and neighbouring threads touch neighbouring genes (coalesced).
// The kernel does no division, and its float draws use __fmul_rn/__fadd_rn so
// floor(lo + u * (hi - lo)) rounds exactly like the reference.
#include "common.cuh"

namespace repro_torch {

constexpr int kGeneThreads = 128;

__global__ void __launch_bounds__(kGeneThreads)
pop_variation_kernel(const int32_t* __restrict__ a_rows, const int32_t* __restrict__ b_rows,
                     const int32_t* __restrict__ do_rows, Genes t,
                     const uint32_t* __restrict__ slot_keys, const float* __restrict__ pm,
                     int P, int G, int32_t* children) {
  const int j = blockIdx.x * kGeneThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (j >= G) return;
  uint32_t keys[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) keys[k] = slot_keys[k];
  int32_t c0, c1;
  child_pair(r, j, P, G, a_rows, b_rows, do_rows, t, keys, *pm, c0, c1);
  children[static_cast<size_t>(2 * r) * G + j] = c0;
  children[static_cast<size_t>(2 * r + 1) * G + j] = c1;
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_variation_launch(const int32_t* a_rows, const int32_t* b_rows,
                                    const int32_t* do_rows, const int32_t* low,
                                    const int32_t* high, const int32_t* is_mask,
                                    const int32_t* mask_bits, const int32_t* ids,
                                    const uint32_t* slot_keys, const float* pm, int P, int G,
                                    int32_t* children, void* stream) {
  const Genes t{low, high, is_mask, mask_bits, ids};
  const dim3 grid((G + kGeneThreads - 1) / kGeneThreads, P / 2);
  pop_variation_kernel<<<grid, kGeneThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a_rows, b_rows, do_rows, t, slot_keys, pm, P, G, children);
  return static_cast<int>(cudaGetLastError());
}
