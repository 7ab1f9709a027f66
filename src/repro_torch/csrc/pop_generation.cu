// K3 pop_generation_kernel (nominal branch): the K2 variation inputs plus the
// dataset -> ((P, G) int32 children, (P,) int32 correct counts), fused.
//
// Replaces the nominal branch of the Pallas TPU megakernel
// repro/kernels/pop_generation/kernel.py:pop_generation_kernel.
//
// Bound on an H100: integer operations, as for K1 (the fitness sweep needs
// 2 int32 ops per weight per (child, sample)); the variation adds about 2
// percent. Design: a block makes its kPopTile children with the K2 math
// straight into shared memory, so they never round-trip through HBM before
// they are scored, then sweeps one chunk of samples over them with the K1
// math. Blocks of one tile along grid.y each remake the same children (a few
// thousand Threefry evaluations, small beside the sample sweep) so the card
// fills; only the grid.y == 0 block writes them out. Every child is evaluated
// (no row bound); sample chunks past the device scalar n_valid_samples skip
// their sweep. P must be even (pairs never straddle a tile: kPopTile is even).
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
pop_generation_kernel(const int32_t* __restrict__ a_rows, const int32_t* __restrict__ b_rows,
                      const int32_t* __restrict__ do_rows, Genes t,
                      const uint32_t* __restrict__ slot_keys, const float* __restrict__ pm,
                      int P, int G, const int32_t* __restrict__ x,
                      const int32_t* __restrict__ labels, int S, int n_in,
                      const int32_t* __restrict__ n_valid_samples,
                      const int32_t* __restrict__ out_mask, Net net, int32_t* children,
                      int32_t* counts) {
  extern __shared__ int32_t smem[];
  int32_t* g_tile = smem;
  int32_t* om = g_tile + kPopTile * G;
  int32_t* red = om + kMaxWidth;

  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, P - row0);
  uint32_t keys[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) keys[k] = slot_keys[k];
  const float pm_v = *pm;
  for (int q = 0; q < n_rows / 2; ++q) {
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      int32_t c0, c1;
      child_pair((row0 >> 1) + q, j, P, G, a_rows, b_rows, do_rows, t, keys, pm_v, c0, c1);
      g_tile[(2 * q) * G + j] = c0;
      g_tile[(2 * q + 1) * G + j] = c1;
    }
  }
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  if (threadIdx.x < n_out) om[threadIdx.x] = out_mask[threadIdx.x];
  if (threadIdx.x < kPopTile) red[threadIdx.x] = 0;
  __syncthreads();
  if (blockIdx.y == 0)
    for (int k = threadIdx.x; k < n_rows * G; k += blockDim.x)
      children[static_cast<size_t>(row0) * G + k] = g_tile[k];

  const int s_begin = blockIdx.y * kSampleChunk;
  const int s_end = min(min(S, *n_valid_samples), s_begin + kSampleChunk);
  if (s_begin >= s_end) return;  // uniform across the block
  count_tile(g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, om, red, counts + row0);
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_generation_launch(const int32_t* a_rows, const int32_t* b_rows,
                                     const int32_t* do_rows, const int32_t* low,
                                     const int32_t* high, const int32_t* is_mask,
                                     const int32_t* mask_bits, const int32_t* ids,
                                     const uint32_t* slot_keys, const float* pm, int P, int G,
                                     const int32_t* x, const int32_t* labels, int S, int n_in,
                                     const int32_t* n_valid_samples, const int32_t* out_mask,
                                     const int32_t* net_desc, int32_t* children,
                                     int32_t* counts, void* stream) {
  const Genes t{low, high, is_mask, mask_bits, ids};
  const Net net = net_from_desc(net_desc);
  const int smem = fitness_smem_bytes(G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pop_generation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks);
  pop_generation_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a_rows, b_rows, do_rows, t, slot_keys, pm, P, G, x, labels, S, n_in, n_valid_samples,
      out_mask, net, children, counts);
  return static_cast<int>(cudaGetLastError());
}
