// K3 pop_generation_kernel: the K2 variation inputs plus the dataset -> ((P, G)
// int32 children, (P,) int32 correct counts), fused. Its n_dev branch takes the
// (K, G) device-variation delta table too and counts each child on the K
// perturbed device instances -> (P, K) int32 counts; the children are the
// nominal branch's.
//
// Replaces the Pallas TPU megakernel
// repro/kernels/pop_generation/kernel.py:pop_generation_kernel, both branches.
//
// Bound on an H100: integer operations, as for K1 and K4 (the fitness sweep
// needs 2 int32 ops per weight per (child, sample), per instance past layer 1's
// AND on the n_dev branch); the variation adds a few percent. Blocks of one
// tile along grid.y each remake the same children (Threefry evaluations,
// small beside the sample sweep) so the card fills; only the grid.y == 0
// block writes them out. Every child is evaluated (no row bound); sample
// chunks past the device scalar n_valid_samples skip their sweep. P must be
// even: a tile holds whole pairs of children (child_pair makes rows 2r and
// 2r + 1 together), so no child is made twice within a block.
//
// Nominal branch (pop_generation_kernel): a block of kThreads makes its
// kPopTile children with the K2 math straight into shared memory, so they
// never round-trip through HBM before they are scored, then sweeps one chunk
// of samples over them with the per-weight math of predict (count_tile).
//
// n_dev branch (pop_generation_mc_kernel<IN, HID, OUT>): K4's design
// (common.cuh, McTables; pop_mlp.cu's header) on children made in the block.
// A block of kMcThreads threads makes kK3Rows = 2 children, one pair,
// into shared memory, builds their tables of per-instance multipliers (the
// deltas and gene bounds read from global memory), then counts its
// kMcThreads x kK3Samples samples on the K instances with the forwards
// compiled for K4's widths (mc_plan picks them, or the general kernel on
// packed tables). Two children, not K4's three: a pair comes from one Threefry
// evaluation, so an odd tile would remake or split a pair; two, not four: the
// children's tile and the tables of two rows never need more shared memory
// than the layout this replaced (genome tile, delta table, bounds), so every K
// that launched still launches (kernels/pop_mlp/ref.py
// generation_mc_smem_bytes; a CPU test holds it). The samples per thread and
// the register cap were chosen by scripts/mc_tiles.py's timings (PERF.md
// section 6): remaking a pair costs about 1.25 Threefry evaluations per gene
// and child in every block of the tile's column, so a block that counts more
// samples remakes them less often.
//
// Lanes: L independent populations of one layout (the lanes of a batched GA
// run) share one launch on grid.z; each lane reads its own parents, gates, gene
// table, slot keys, mutation rate, samples, labels, sample bound, output mask
// and delta table at lane-strided offsets. A single population is L = 1.
#include <utility>

#include "common.cuh"

namespace repro_torch {

// The operands both branches share: every lane's (the kernels offset them by lane).
struct GenArgs {
  const int32_t *a_rows, *b_rows, *do_rows;
  Genes t;
  const uint32_t* slot_keys;
  const float* pm;
  int P, G;
  const int32_t *x, *labels;
  int S, n_in;
  const int32_t *n_valid_samples, *out_mask;
  int32_t* children;
};

// Makes the children rows [row0, row0 + n_rows) of lane `lane` (n_rows even)
// into tile (shared memory, row stride G), and has the grid.y == 0 block
// write them out; returns the lane's sample range [s_begin, s_end) of the
// block's chunk of `chunk` samples. The caller synchronises before reading
// the tile (the write-out below synchronises first).
static __device__ void make_children(const GenArgs& a, int lane, int row0, int n_rows,
                                     int32_t* tile, int chunk, int& s_begin, int& s_end) {
  const size_t frame = static_cast<size_t>(lane) * a.P * a.G;
  const Genes tl = a.t.lane(lane, a.G);
  uint32_t keys[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) keys[k] = a.slot_keys[lane * 6 + k];
  const float pm_v = a.pm[lane];
  const int32_t* do_rows = a.do_rows + static_cast<size_t>(lane) * a.P;
  for (int q = 0; q < n_rows / 2; ++q) {
    for (int j = threadIdx.x; j < a.G; j += blockDim.x) {
      int32_t c0, c1;
      child_pair((row0 >> 1) + q, j, a.P, a.G, a.a_rows + frame, a.b_rows + frame, do_rows, tl,
                 keys, pm_v, c0, c1);
      tile[(2 * q) * a.G + j] = c0;
      tile[(2 * q + 1) * a.G + j] = c1;
    }
  }
  __syncthreads();
  if (blockIdx.y == 0)
    for (int k = threadIdx.x; k < n_rows * a.G; k += blockDim.x)
      a.children[frame + static_cast<size_t>(row0) * a.G + k] = tile[k];
  s_begin = blockIdx.y * chunk;
  s_end = min(min(a.S, a.n_valid_samples[lane]), s_begin + chunk);
}

__global__ void __launch_bounds__(kThreads)
pop_generation_kernel(GenArgs a, Net net, int32_t* counts) {
  extern __shared__ int32_t smem[];
  int32_t* g_tile = smem;
  int32_t* om = g_tile + kPopTile * a.G;
  int32_t* red = om + kMaxWidth;

  const int lane = blockIdx.z;
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  const int row0 = blockIdx.x * kPopTile;
  const int n_rows = min(kPopTile, a.P - row0);
  if (threadIdx.x < n_out) om[threadIdx.x] = a.out_mask[lane * n_out + threadIdx.x];
  if (threadIdx.x < kPopTile) red[threadIdx.x] = 0;
  int s_begin, s_end;
  make_children(a, lane, row0, n_rows, g_tile, kSampleChunk, s_begin, s_end);
  if (s_begin >= s_end) return;  // uniform across the block
  count_tile(g_tile, n_rows, a.G, a.x + static_cast<size_t>(lane) * a.S * a.n_in,
             a.labels + static_cast<size_t>(lane) * a.S, a.n_in, s_begin, s_end, net, om, red,
             counts + static_cast<size_t>(lane) * a.P + row0);
}

// Words of the children's tile ahead of the n_dev branch's tables (a multiple
// of 4, so the tables keep their 16-byte alignment).
__host__ __device__ inline int gen_tile_words(int G) { return (kK3Rows * G + 3) / 4 * 4; }

template <int IN, int HID, int OUT>
__global__ void __launch_bounds__(kMcThreads, kK3BlocksPerSM)
pop_generation_mc_kernel(GenArgs a, const int32_t* __restrict__ dev, int n_dev, Net net,
                         McLayout lay, int32_t* counts) {
  extern __shared__ __align__(16) int32_t mc_smem[];
  int32_t* g_tile = mc_smem;
  const McTables t(mc_smem + gen_tile_words(a.G), lay, n_dev, kK3Rows);

  const int lane = blockIdx.z;
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  const int row0 = blockIdx.x * kK3Rows;
  const int n_rows = min(kK3Rows, a.P - row0);
  int s_begin, s_end;
  make_children(a, lane, row0, n_rows, g_tile, kMcThreads * kK3Samples, s_begin, s_end);
  if (s_begin >= s_end) return;  // uniform across the block
  mc_build<true, kK3Rows>(t, lay, net, g_tile, n_rows, a.G,
                          dev + static_cast<size_t>(lane) * n_dev * a.G,
                          a.t.high + static_cast<size_t>(lane) * a.G, n_dev,
                          a.out_mask + lane * n_out, n_out);
  __syncthreads();
  mc_count<IN, HID, OUT, kK3Samples>(t, lay, net, n_rows, n_dev,
                                     a.x + static_cast<size_t>(lane) * a.S * a.n_in,
                                     a.labels + static_cast<size_t>(lane) * a.S, a.n_in,
                                     s_begin, s_end);
  __syncthreads();
  counts += (static_cast<size_t>(lane) * a.P + row0) * n_dev;
  for (int i = threadIdx.x; i < n_rows * n_dev; i += blockDim.x)
    if (t.red[i]) atomicAdd(&counts[i], t.red[i]);
}

using GenMcKernel = void (*)(GenArgs, const int32_t*, int, Net, McLayout, int32_t*);

// (a plain local array, as pop_mlp.cu's tables_kernel says)
template <size_t... I>
GenMcKernel generation_mc_kernel(int b, std::index_sequence<I...>) {
  const GenMcKernel kernels[] = {
      pop_generation_mc_kernel<kMcBuckets[I].in, kMcBuckets[I].hid, kMcBuckets[I].out>...,
      pop_generation_mc_kernel<0, 0, 0>};
  return kernels[b < 0 ? kMcNumBuckets : b];
}

// The n_dev branch's kernel for net, G genes and n_dev instances, the layout
// of its tables (mc_plan, beside the children's tile) and its dynamic shared
// memory in bytes.
static GenMcKernel generation_mc_plan(const Net& net, int G, int n_dev, McLayout& lay,
                                      int& smem) {
  const int b = mc_plan(net, n_dev, kK3Rows, gen_tile_words(G), lay);
  smem = static_cast<int>(sizeof(int32_t)) *
         (gen_tile_words(G) + mc_smem_words(lay, n_dev, kK3Rows));
  return generation_mc_kernel(b, std::make_index_sequence<kMcNumBuckets>{});
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
  const GenArgs a{a_rows, b_rows, do_rows, Genes{low, high, is_mask, mask_bits, ids},
                  slot_keys, pm, P, G, x, labels, S, n_in, n_valid_samples, out_mask,
                  children};
  const int smem = fitness_smem_bytes(G);
  const cudaError_t e = allow_smem(pop_generation_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + kSampleChunk - 1) / kSampleChunk : 1;
  const dim3 grid((P + kPopTile - 1) / kPopTile, n_chunks, L);
  pop_generation_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, net_from_desc(net_desc), counts);
  return static_cast<int>(cudaGetLastError());
}

// The n_dev branch's dynamic shared memory in bytes for the topology of
// net_desc, G genes and n_dev instances on the current card: the size
// pop_generation_mc_launch asks for, which the wrapper checks against the
// card's limit.
extern "C" int pop_generation_mc_smem_bytes(const int32_t* net_desc, int G, int n_dev) {
  McLayout lay;
  int smem;
  generation_mc_plan(net_from_desc(net_desc), G, n_dev, lay, smem);
  return smem;
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
  const GenArgs a{a_rows, b_rows, do_rows, Genes{low, high, is_mask, mask_bits, ids},
                  slot_keys, pm, P, G, x, labels, S, n_in, n_valid_samples, out_mask,
                  children};
  const Net net = net_from_desc(net_desc);
  McLayout lay;
  int smem;
  const GenMcKernel kernel = generation_mc_plan(net, G, n_dev, lay, smem);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunk = kMcThreads * kK3Samples;
  const int n_chunks = S > 0 ? (S + chunk - 1) / chunk : 1;
  const dim3 grid((P + kK3Rows - 1) / kK3Rows, n_chunks, L);
  kernel<<<grid, kMcThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, dev, n_dev, net, lay,
                                                                         counts);
  return static_cast<int>(cudaGetLastError());
}
