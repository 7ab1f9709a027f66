// K1 pop_mlp_correct: (P, G) int32 genomes x (S, n_in) int32 samples x (S,) int32
// labels -> (P,) int32 correct counts of the integer approximate MLP.
// K4 pop_mlp_correct_mc: the same over K device instances -> (P, K) int32 counts
// (at the end of this file).
//
// Replaces the Pallas TPU kernels repro/kernels/pop_mlp/kernel.py:pop_mlp_correct
// and :pop_mlp_correct_mc.
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
// Lanes: L independent problems of one layout (the lanes of a batched GA run:
// seeds, hyperparameter cells, padded datasets) share one launch; the lane is
// grid.z, and each lane reads its own genomes, samples, labels, output mask and
// sample bound at lane-strided offsets. A single problem is L = 1.
//
// The dedup bound n_valid_rows (one device scalar for every lane: the widest
// lane's count) and the per-lane sample bounds n_valid_samples[L] are read on
// the device (the dedup pass computes them there; a host read would
// synchronise every generation). Blocks wholly past either bound exit at once;
// rows >= n_valid_rows and samples >= n_valid_samples are never counted, so
// those rows keep the zeros the wrapper allocated.
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

  const int lane = blockIdx.z;
  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, min(P, *n_valid_rows) - row0);
  const int s_begin = blockIdx.y * kSampleChunk;
  const int s_end = min(min(S, n_valid_samples[lane]), s_begin + kSampleChunk);
  if (n_rows <= 0 || s_begin >= s_end) return;  // whole block past a bound
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  pop += static_cast<size_t>(lane) * P * G;
  x += static_cast<size_t>(lane) * S * n_in;
  labels += static_cast<size_t>(lane) * S;
  out_mask += lane * n_out;
  counts += static_cast<size_t>(lane) * P;

  for (int k = threadIdx.x; k < n_rows * G; k += blockDim.x)
    g_tile[k] = pop[static_cast<size_t>(row0) * G + k];
  if (threadIdx.x < n_out) om[threadIdx.x] = out_mask[threadIdx.x];
  if (threadIdx.x < kPopTile) red[threadIdx.x] = 0;
  __syncthreads();
  count_tile(g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, om, red, counts + row0);
}

// K4: device-variation Monte-Carlo counts. As K1, with the (K, G) delta table
// and the gene bounds beside the genome tile in shared memory (McSmem: 28 KB at
// pendigits, K = 8); each thread loads a sample once and runs the K perturbed
// forwards of the tile's genomes on it (count_tile_mc). Rows past n_valid_rows
// are skipped on every instance and keep their zeros.
__global__ void __launch_bounds__(kThreads)
pop_mlp_correct_mc_kernel(const int32_t* __restrict__ pop, int P, int G,
                          const int32_t* __restrict__ x, const int32_t* __restrict__ labels,
                          int S, int n_in, const int32_t* __restrict__ n_valid_rows,
                          const int32_t* __restrict__ n_valid_samples,
                          const int32_t* __restrict__ out_mask,
                          const int32_t* __restrict__ dev, const int32_t* __restrict__ high,
                          int n_dev, Net net, int32_t* counts) {
  extern __shared__ int32_t smem[];
  McSmem sm(smem, G, n_dev);

  const int lane = blockIdx.z;
  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, min(P, *n_valid_rows) - row0);
  const int s_begin = blockIdx.y * kSampleChunk;
  const int s_end = min(min(S, n_valid_samples[lane]), s_begin + kSampleChunk);
  if (n_rows <= 0 || s_begin >= s_end) return;  // whole block past a bound
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  pop += static_cast<size_t>(lane) * P * G;
  x += static_cast<size_t>(lane) * S * n_in;
  labels += static_cast<size_t>(lane) * S;
  out_mask += lane * n_out;
  dev += static_cast<size_t>(lane) * n_dev * G;
  high += static_cast<size_t>(lane) * G;
  counts += static_cast<size_t>(lane) * P * n_dev;

  for (int k = threadIdx.x; k < n_rows * G; k += blockDim.x)
    sm.g_tile[k] = pop[static_cast<size_t>(row0) * G + k];
  sm.load(dev, high, out_mask, n_dev, G, n_out);
  __syncthreads();
  count_tile_mc(sm.g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, sm.om, sm.dev,
                sm.high, n_dev, sm.red, counts + static_cast<size_t>(row0) * n_dev);
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_mlp_correct_launch(const int32_t* pop, int L, int P, int G, const int32_t* x,
                                      const int32_t* labels, int S, int n_in,
                                      const int32_t* n_valid_rows,
                                      const int32_t* n_valid_samples,
                                      const int32_t* out_mask, const int32_t* net_desc,
                                      int32_t* counts, void* stream) {
  const Net net = net_from_desc(net_desc);
  const int smem = fitness_smem_bytes(G);
  const cudaError_t e = allow_smem(pop_mlp_correct_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks, L);
  pop_mlp_correct_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pop, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples, out_mask, net, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pop_mlp_correct_mc_launch(const int32_t* pop, int L, int P, int G,
                                         const int32_t* x,
                                         const int32_t* labels, int S, int n_in,
                                         const int32_t* n_valid_rows,
                                         const int32_t* n_valid_samples,
                                         const int32_t* out_mask, const int32_t* dev,
                                         const int32_t* high, int n_dev,
                                         const int32_t* net_desc, int32_t* counts,
                                         void* stream) {
  const Net net = net_from_desc(net_desc);
  const int smem = fitness_mc_smem_bytes(G, n_dev);
  const cudaError_t e = allow_smem(pop_mlp_correct_mc_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks, L);
  pop_mlp_correct_mc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pop, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples, out_mask, dev, high, n_dev,
      net, counts);
  return static_cast<int>(cudaGetLastError());
}
