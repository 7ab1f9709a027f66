// K3 pop_generation_kernel: the K2 variation inputs plus the dataset -> ((P, G)
// int32 children, (P,) int32 correct counts), fused. Its n_dev branch (kMc)
// takes the (K, G) device-variation delta table too and counts each child on
// the K perturbed device instances -> (P, K) int32 counts; the children are the
// nominal branch's.
//
// Replaces the Pallas TPU megakernel
// repro/kernels/pop_generation/kernel.py:pop_generation_kernel, both branches.
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
// The n_dev branch keeps the delta table and the gene bounds in shared memory
// beside the children (McSmem) and sweeps with count_tile_mc.
//
// Lanes: L independent populations of one layout (the lanes of a batched GA
// run) share one launch on grid.z; each lane reads its own parents, gates, gene
// table, slot keys, mutation rate, samples, labels, sample bound, output mask
// and delta table at lane-strided offsets. A single population is L = 1.
#include "common.cuh"

namespace repro_torch {

template <bool kMc>
__global__ void __launch_bounds__(kThreads)
pop_generation_kernel(const int32_t* __restrict__ a_rows, const int32_t* __restrict__ b_rows,
                      const int32_t* __restrict__ do_rows, Genes t,
                      const uint32_t* __restrict__ slot_keys, const float* __restrict__ pm,
                      int P, int G, const int32_t* __restrict__ x,
                      const int32_t* __restrict__ labels, int S, int n_in,
                      const int32_t* __restrict__ n_valid_samples,
                      const int32_t* __restrict__ out_mask, const int32_t* __restrict__ dev,
                      int n_dev, Net net, int32_t* children, int32_t* counts) {
  extern __shared__ int32_t smem[];
  McSmem sm(smem, G, n_dev);   // kMc only; the nominal layout follows
  int32_t* g_tile = smem;
  int32_t* om = kMc ? sm.om : g_tile + kPopTile * G;
  int32_t* red = kMc ? sm.red : om + kMaxWidth;

  const int lane = blockIdx.z;
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  const size_t frame = static_cast<size_t>(lane) * P * G;
  a_rows += frame;
  b_rows += frame;
  children += frame;
  do_rows += static_cast<size_t>(lane) * P;
  x += static_cast<size_t>(lane) * S * n_in;
  labels += static_cast<size_t>(lane) * S;
  out_mask += lane * n_out;
  if (kMc) dev += static_cast<size_t>(lane) * n_dev * G;
  counts += static_cast<size_t>(lane) * P * (kMc ? n_dev : 1);
  const Genes tl = t.lane(lane, G);

  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, P - row0);
  uint32_t keys[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) keys[k] = slot_keys[lane * 6 + k];
  const float pm_v = pm[lane];
  for (int q = 0; q < n_rows / 2; ++q) {
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      int32_t c0, c1;
      child_pair((row0 >> 1) + q, j, P, G, a_rows, b_rows, do_rows, tl, keys, pm_v, c0, c1);
      g_tile[(2 * q) * G + j] = c0;
      g_tile[(2 * q + 1) * G + j] = c1;
    }
  }
  if (kMc) {
    sm.load(dev, tl.high, out_mask, n_dev, G, n_out);
  } else {
    if (threadIdx.x < n_out) om[threadIdx.x] = out_mask[threadIdx.x];
    if (threadIdx.x < kPopTile) red[threadIdx.x] = 0;
  }
  __syncthreads();
  if (blockIdx.y == 0)
    for (int k = threadIdx.x; k < n_rows * G; k += blockDim.x)
      children[static_cast<size_t>(row0) * G + k] = g_tile[k];

  const int s_begin = blockIdx.y * kSampleChunk;
  const int s_end = min(min(S, n_valid_samples[lane]), s_begin + kSampleChunk);
  if (s_begin >= s_end) return;  // uniform across the block
  if (kMc)
    count_tile_mc(g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, om, sm.dev, sm.high,
                  n_dev, red, counts + static_cast<size_t>(row0) * n_dev);
  else
    count_tile(g_tile, n_rows, G, x, labels, n_in, s_begin, s_end, net, om, red, counts + row0);
}

// Both branches' launch: n_dev == 0 (dev null) is the nominal branch.
int launch_generation(const int32_t* a_rows, const int32_t* b_rows, const int32_t* do_rows,
                      const Genes& t, const uint32_t* slot_keys, const float* pm, int L,
                      int P, int G, const int32_t* x, const int32_t* labels, int S, int n_in,
                      const int32_t* n_valid_samples, const int32_t* out_mask,
                      const int32_t* dev, int n_dev, const int32_t* net_desc,
                      int32_t* children, int32_t* counts, void* stream) {
  const Net net = net_from_desc(net_desc);
  const bool mc = n_dev > 0;
  const int smem = mc ? fitness_mc_smem_bytes(G, n_dev) : fitness_smem_bytes(G);
  const auto kernel = mc ? pop_generation_kernel<true> : pop_generation_kernel<false>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks, L);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a_rows, b_rows, do_rows, t, slot_keys, pm, P, G, x, labels, S, n_in, n_valid_samples,
      out_mask, dev, n_dev, net, children, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_generation_launch(const int32_t* a_rows, const int32_t* b_rows,
                                     const int32_t* do_rows, const int32_t* low,
                                     const int32_t* high, const int32_t* is_mask,
                                     const int32_t* mask_bits, const int32_t* ids,
                                     const uint32_t* slot_keys, const float* pm, int L, int P,
                                     int G, const int32_t* x, const int32_t* labels, int S,
                                     int n_in, const int32_t* n_valid_samples,
                                     const int32_t* out_mask, const int32_t* net_desc,
                                     int32_t* children, int32_t* counts, void* stream) {
  return launch_generation(a_rows, b_rows, do_rows, Genes{low, high, is_mask, mask_bits, ids},
                           slot_keys, pm, L, P, G, x, labels, S, n_in, n_valid_samples, out_mask,
                           nullptr, 0, net_desc, children, counts, stream);
}

// The n_dev branch: dev holds L (n_dev, G) delta tables, n_dev >= 1; counts (L, P, n_dev).
extern "C" int pop_generation_mc_launch(const int32_t* a_rows, const int32_t* b_rows,
                                        const int32_t* do_rows, const int32_t* low,
                                        const int32_t* high, const int32_t* is_mask,
                                        const int32_t* mask_bits, const int32_t* ids,
                                        const uint32_t* slot_keys, const float* pm, int L,
                                        int P, int G, const int32_t* x, const int32_t* labels,
                                        int S, int n_in, const int32_t* n_valid_samples,
                                        const int32_t* out_mask, const int32_t* dev, int n_dev,
                                        const int32_t* net_desc, int32_t* children,
                                        int32_t* counts, void* stream) {
  return launch_generation(a_rows, b_rows, do_rows, Genes{low, high, is_mask, mask_bits, ids},
                           slot_keys, pm, L, P, G, x, labels, S, n_in, n_valid_samples, out_mask,
                           dev, n_dev, net_desc, children, counts, stream);
}
