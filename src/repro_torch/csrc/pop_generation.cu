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
// AND on the n_dev branch); the variation adds a few percent.
//
// Design: one kernel template runs both branches
// (pop_generation_tables_kernel<IN, HID, OUT, kDev>), as pop_mlp.cu's runs K1
// and K4: K4's tables (common.cuh McTables; pop_mlp.cu's header) on children
// made in the block. A block of kMcThreads threads makes its tile of children
// with the K2 math straight into shared memory, so they never round-trip
// through HBM before they are scored, builds their tables (the n_dev branch
// reads the deltas and gene bounds from global memory; the nominal branch is
// one instance with the deltas compiled out, as K1), then counts its chunk of
// samples with the forwards compiled for the widths mc_plan picks (or the
// general kernel on packed tables). The blocks of a tile's column along
// grid.y each remake the same children (Threefry evaluations) so the card
// fills; only the grid.y == 0 block writes them out. A tile holds whole pairs
// of children (child_pair makes rows 2r and 2r + 1 from one Threefry
// evaluation), so P must be even and no child is made twice within a block.
// Every child is evaluated (no row bound); sample chunks past the device
// scalar n_valid_samples skip their sweep.
//
// The tiles (common.cuh kK3*, kK3N*) were chosen by scripts/mc_tiles.py's
// timings (PERF.md section 6): remaking a pair costs about 1.25 Threefry
// evaluations per gene and child in every block of the column, so a block
// that counts more samples remakes them less often, most of all at the
// nominal branch's one instance. The n_dev branch takes one pair: the
// children's tile and the tables of two rows never need more shared memory
// than the layout this replaced (genome tile, delta table, bounds), so every
// K that launched still launches; the nominal branch's tile never needs more
// than the per-weight kernel's (8 genomes, the output mask, 8 counts)
// (kernels/pop_mlp/ref.py generation_mc_smem_bytes, generation_smem_bytes;
// CPU tests hold both).
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

// Each branch's tile: children per block, samples per thread, blocks per SM.
template <bool kDev>
struct GenTile {
  static constexpr int rows = kDev ? kK3Rows : kK3NRows;
  static constexpr int samples = kDev ? kK3Samples : kK3NSamples;
  static constexpr int blocks_per_sm = kDev ? kK3BlocksPerSM : kK3NBlocksPerSM;
  static_assert(rows % 2 == 0, "a tile holds whole pairs of children");
};

// Words of the children's tile ahead of the tables (a multiple of 4, so the
// tables keep their 16-byte alignment).
__host__ __device__ inline int gen_tile_words(int rows, int G) { return (rows * G + 3) / 4 * 4; }

// Makes the children rows [row0, row0 + n_rows) of lane `lane` (n_rows even)
// into tile (shared memory, row stride G), and has the grid.y == 0 block
// write them out; synchronises the block.
static __device__ void make_children(const GenArgs& a, int lane, int row0, int n_rows,
                                     int32_t* tile) {
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
}

// The n_dev branch (kDev: n_dev instances of dev, counts (L, P, n_dev)) or the
// nominal one (one instance, dev not read, counts (L, P)). IN > 0: the kernel
// compiled for 2-layer nets up to the widths (IN, HID, OUT); IN == 0: any net.
template <int IN, int HID, int OUT, bool kDev>
__global__ void __launch_bounds__(kMcThreads, GenTile<kDev>::blocks_per_sm)
pop_generation_tables_kernel(GenArgs a, const int32_t* __restrict__ dev, int n_dev, Net net,
                             McLayout lay, int32_t* counts) {
  using Tile = GenTile<kDev>;
  const int n_inst = kDev ? n_dev : 1;   // a constant for the nominal branch, folded
  extern __shared__ __align__(16) int32_t mc_smem[];
  int32_t* g_tile = mc_smem;
  const McTables t(mc_smem + gen_tile_words(Tile::rows, a.G), lay, n_inst, Tile::rows);

  const int lane = blockIdx.z;
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  const int row0 = blockIdx.x * Tile::rows;
  const int n_rows = min(Tile::rows, a.P - row0);
  make_children(a, lane, row0, n_rows, g_tile);
  const int chunk = kMcThreads * Tile::samples;
  const int s_begin = blockIdx.y * chunk;
  const int s_end = min(min(a.S, a.n_valid_samples[lane]), s_begin + chunk);
  if (s_begin >= s_end) return;  // uniform across the block
  mc_build<kDev, Tile::rows>(t, lay, net, g_tile, n_rows, a.G,
                             kDev ? dev + static_cast<size_t>(lane) * n_dev * a.G : nullptr,
                             kDev ? a.t.high + static_cast<size_t>(lane) * a.G : nullptr,
                             n_inst, a.out_mask + lane * n_out, n_out);
  __syncthreads();
  mc_count<IN, HID, OUT, Tile::samples>(t, lay, net, n_rows, n_inst,
                                        a.x + static_cast<size_t>(lane) * a.S * a.n_in,
                                        a.labels + static_cast<size_t>(lane) * a.S, a.n_in,
                                        s_begin, s_end);
  __syncthreads();
  counts += (static_cast<size_t>(lane) * a.P + row0) * n_inst;
  for (int i = threadIdx.x; i < n_rows * n_inst; i += blockDim.x)
    if (t.red[i]) atomicAdd(&counts[i], t.red[i]);
}

using GenKernel = void (*)(GenArgs, const int32_t*, int, Net, McLayout, int32_t*);

// (a plain local array, as pop_mlp.cu's tables_kernel says)
template <bool kDev, size_t... I>
GenKernel generation_kernel(int b, std::index_sequence<I...>) {
  const GenKernel kernels[] = {
      pop_generation_tables_kernel<kMcBuckets[I].in, kMcBuckets[I].hid, kMcBuckets[I].out,
                                   kDev>...,
      pop_generation_tables_kernel<0, 0, 0, kDev>};
  return kernels[b < 0 ? kMcNumBuckets : b];
}

// A branch's kernel for net, G genes and n_dev instances, the layout of its
// tables (mc_plan, beside the children's tile) and its dynamic shared memory
// in bytes.
template <bool kDev>
GenKernel generation_plan(const Net& net, int G, int n_dev, McLayout& lay, int& smem) {
  constexpr int rows = GenTile<kDev>::rows;
  const int tile = gen_tile_words(rows, G);
  const int b = mc_plan(net, n_dev, rows, tile, lay);
  smem = static_cast<int>(sizeof(int32_t)) * (tile + mc_smem_words(lay, n_dev, rows));
  return generation_kernel<kDev>(b, std::make_index_sequence<kMcNumBuckets>{});
}

// One launch for every lane: grid (tiles, sample chunks, L). A launch the card
// refuses returns its error.
template <bool kDev>
int launch_generation(const GenArgs& a, int L, const int32_t* dev, int n_dev,
                      const int32_t* net_desc, int32_t* counts, void* stream) {
  using Tile = GenTile<kDev>;
  const Net net = net_from_desc(net_desc);
  McLayout lay;
  int smem;
  const GenKernel kernel = generation_plan<kDev>(net, a.G, n_dev, lay, smem);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int chunk = kMcThreads * Tile::samples;
  const int n_chunks = a.S > 0 ? (a.S + chunk - 1) / chunk : 1;
  const dim3 grid((a.P + Tile::rows - 1) / Tile::rows, n_chunks, L);
  kernel<<<grid, kMcThreads, smem, static_cast<cudaStream_t>(stream)>>>(a, dev, n_dev, net, lay,
                                                                        counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

using namespace repro_torch;

// The nominal branch: counts (L, P).
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
  return launch_generation<false>(a, L, nullptr, 1, net_desc, counts, stream);
}

// The nominal branch's dynamic shared memory in bytes for the topology of
// net_desc and G genes on the current card: the size pop_generation_launch
// asks for, which the wrapper checks against the card's limit.
extern "C" int pop_generation_smem_bytes(const int32_t* net_desc, int G) {
  McLayout lay;
  int smem;
  generation_plan<false>(net_from_desc(net_desc), G, 1, lay, smem);
  return smem;
}

// The n_dev branch's, at n_dev instances: the size pop_generation_mc_launch
// asks for.
extern "C" int pop_generation_mc_smem_bytes(const int32_t* net_desc, int G, int n_dev) {
  McLayout lay;
  int smem;
  generation_plan<true>(net_from_desc(net_desc), G, n_dev, lay, smem);
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
  return launch_generation<true>(a, L, dev, n_dev, net_desc, counts, stream);
}
