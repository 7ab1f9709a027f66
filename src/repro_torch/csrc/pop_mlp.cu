// K1 pop_mlp_correct: (P, G) int32 genomes x (S, n_in) int32 samples x (S,) int32
// labels -> (P,) int32 correct counts of the integer approximate MLP.
//
// Replaces the Pallas TPU kernel repro/kernels/pop_mlp/kernel.py:pop_mlp_correct.
//
// Bound on an H100: integer operations. Each (chromosome, sample) pair needs at
// least 2 int32 ops per weight through every layer (an AND on the ALU pipe and a
// multiply-add by the chromosome's sign << exp on the FMA pipe), while the inputs
// are about 1 MB, so the ALU pipe's 64 results per SM and clock bound it, not HBM.
// This kernel spends more (a shift and a sign multiply per weight as well). Design: a block holds kPopTile genomes in shared memory (409 int32 =
// 1.6 KB each at pendigits) and its threads stride over one chunk of samples
// (grid.y), so every gene read is a shared-memory broadcast and each sample is
// loaded once per tile. Counts reduce per block and land with one integer
// atomicAdd per genome: integer atomics are order independent, so the counts
// are exact and repeatable.
//
// The dedup bound n_valid_rows and the sample bound n_valid_samples are read
// from device int32 scalars (the dedup pass computes them on the device; a
// host read would synchronise every generation). Blocks wholly past either
// bound exit at once; rows >= n_valid_rows and samples >= n_valid_samples are
// never counted, so those rows keep the zeros the wrapper allocated.
#include "common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
pop_mlp_correct_kernel(const int32_t* __restrict__ pop, int P, int G,
                       const int32_t* __restrict__ x, const int32_t* __restrict__ labels,
                       int S, int n_in, const int32_t* __restrict__ n_valid_rows,
                       const int32_t* __restrict__ n_valid_samples,
                       const int32_t* __restrict__ out_mask, Net net, int32_t* counts) {
  extern __shared__ int32_t smem[];
  int32_t* g_tile = smem;
  int32_t* om = g_tile + kPopTile * G;
  int32_t* red = om + kMaxWidth;

  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, min(P, *n_valid_rows) - row0);
  const int s_begin = blockIdx.y * kSampleChunk;
  const int s_end = min(min(S, *n_valid_samples), s_begin + kSampleChunk);
  if (n_rows <= 0 || s_begin >= s_end) return;  // whole block past a bound

  for (int k = threadIdx.x; k < n_rows * G; k += blockDim.x)
    g_tile[k] = pop[static_cast<size_t>(row0) * G + k];
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  if (threadIdx.x < n_out) om[threadIdx.x] = out_mask[threadIdx.x];
  if (threadIdx.x < kPopTile) red[threadIdx.x] = 0;
  __syncthreads();
  count_tile(g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, om, red, counts + row0);
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_mlp_correct_launch(const int32_t* pop, int P, int G, const int32_t* x,
                                      const int32_t* labels, int S, int n_in,
                                      const int32_t* n_valid_rows,
                                      const int32_t* n_valid_samples,
                                      const int32_t* out_mask, const int32_t* net_desc,
                                      int32_t* counts, void* stream) {
  const Net net = net_from_desc(net_desc);
  const int smem = fitness_smem_bytes(G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pop_mlp_correct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks);
  pop_mlp_correct_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pop, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples, out_mask, net, counts);
  return static_cast<int>(cudaGetLastError());
}
