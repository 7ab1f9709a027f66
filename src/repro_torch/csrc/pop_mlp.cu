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
// are about 1 MB, so the ALU pipe's 64 results per SM and clock bound it, not HBM;
// over K instances layer 1's AND is shared and the K multiply-adds per weight
// (the IMAD pipe, also 64) bound it.
//
// K1 spends more (a shift and a sign multiply per weight as well). Design: a
// block holds kPopTile genomes in shared memory (409 int32 = 1.6 KB each at
// pendigits) and its threads stride over one chunk of samples (grid.y), so every
// gene read is a shared-memory broadcast and each sample is loaded once per
// tile. Counts reduce per block and land with one integer atomicAdd per genome:
// integer atomics are order independent, so the counts are exact and repeatable.
//
// K4 is built for that bound (common.cuh, McTables). A block of kMcThreads
// threads takes kMcRows chromosomes and kMcThreads samples, one a thread. It
// first turns the chromosomes' genes into tables in shared memory: for each
// (chromosome, instance) the signed multiplier sign << clip(e + delta) of every
// weight (0 where shl would give 0), and per chromosome the masks, the shifted
// biases and the right shifts, all K instances at once (3 x 8 x 132 multiplier
// words, 15 KB at pendigits, K = 8). Each thread then runs the forwards of its
// sample: x & mask of layer 1 once per chromosome, then per instance one
// multiply-add per layer-1 weight and an AND and a multiply-add per later
// weight, the operands 16-byte broadcast reads of the tables. Kernels are
// compiled for the widths in kMcBuckets: a 2-layer net runs the one with the
// fewest weights that holds it, its tables laid out for those widths with
// zeros past its own, so the sample, layer 1's ANDs and the activations stay
// in registers. Pendigits' (16, 5, 10) and the padded suite's (21, 5, 10) are
// the widths themselves; the paper's other three datasets pad into them. Any
// other net, or one whose padded tables do not fit the card's shared memory,
// runs the general kernel, which reads packed tables with runtime widths. A
// warp ballot per (chromosome, instance) and shared-memory atomics reduce the
// counts, then one integer atomicAdd per (chromosome, instance) and block.
// The tables of all K instances sit in shared memory together: at every K and
// topology the earlier layout (genome tile, delta table, bounds) fitted, the
// packed tables need no more (kernels/pop_mlp/ref.py mc_smem_bytes; a CPU test
// holds it). The compiled kernels are held to 128 registers, four blocks per
// SM: the table build waits on memory, and the other blocks hide it. On the
// card K4 reaches about 37 % of its bound at pendigits: the forwards' table
// reads and the 16 warps an SM holds, not the IMAD pipe, set its pace.
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
#include <utility>

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

// K4: device-variation Monte-Carlo counts (see the header). IN > 0: the kernel
// compiled for 2-layer nets up to the widths (IN, HID, OUT); IN == 0: any net. Rows
// past n_valid_rows are skipped on every instance and keep their zeros.
template <int IN, int HID, int OUT>
__global__ void __launch_bounds__(kMcThreads, kMcBlocksPerSM)
pop_mlp_correct_mc_kernel(const int32_t* __restrict__ pop, int P, int G,
                          const int32_t* __restrict__ x, const int32_t* __restrict__ labels,
                          int S, int n_in, const int32_t* __restrict__ n_valid_rows,
                          const int32_t* __restrict__ n_valid_samples,
                          const int32_t* __restrict__ out_mask,
                          const int32_t* __restrict__ dev, const int32_t* __restrict__ high,
                          int n_dev, Net net, McLayout lay, int32_t* counts) {
  extern __shared__ __align__(16) int32_t mc_smem[];
  const McTables t(mc_smem, lay, n_dev);

  const int lane = blockIdx.z;
  const int row0 = blockIdx.x * kMcRows;
  const int n_rows = min(kMcRows, min(P, *n_valid_rows) - row0);
  const int s_begin = blockIdx.y * kMcThreads;
  const int s_end = min(min(S, n_valid_samples[lane]), s_begin + kMcThreads);
  if (n_rows <= 0 || s_begin >= s_end) return;  // whole block past a bound
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  pop += (static_cast<size_t>(lane) * P + row0) * G;
  x += static_cast<size_t>(lane) * S * n_in;
  labels += static_cast<size_t>(lane) * S;
  out_mask += lane * n_out;
  dev += static_cast<size_t>(lane) * n_dev * G;
  high += static_cast<size_t>(lane) * G;
  counts += (static_cast<size_t>(lane) * P + row0) * n_dev;

  mc_build(t, lay, net, pop, n_rows, G, dev, high, n_dev, out_mask, n_out);
  __syncthreads();
  // a thread past the samples runs the forwards of the block's first sample
  // and votes false
  const int s = s_begin + threadIdx.x;
  const bool live = s < s_end;
  const int32_t y = live ? labels[s] : -1;
  const int32_t* xs = x + static_cast<size_t>(live ? s : s_begin) * n_in;
  if constexpr (IN > 0)
    mc_forwards_fixed<IN, HID, OUT>(t, lay, n_rows, n_dev, net.act_max, n_in, xs, live,
                                    y);
  else
    mc_forwards_any(t, lay, net, n_rows, n_dev, xs, live, y);
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * n_dev; i += blockDim.x)
    if (t.red[i]) atomicAdd(&counts[i], t.red[i]);
}

using McKernel = void (*)(const int32_t*, int, int, const int32_t*, const int32_t*, int, int,
                          const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int, Net, McLayout, int32_t*);

// The widths K4 has kernels compiled for (kernels/pop_mlp/ref.py MC_BUCKETS
// lists the same): (input, hidden, output) of 2-layer nets.
struct McDims {
  int in, hid, out;
};
constexpr McDims kMcBuckets[] = {{16, 5, 10}, {21, 5, 10}};
constexpr int kMcNumBuckets = sizeof(kMcBuckets) / sizeof(kMcBuckets[0]);

template <size_t... I>
McKernel mc_bucket_kernel(int b, std::index_sequence<I...>) {
  static const McKernel kernels[] = {
      pop_mlp_correct_mc_kernel<kMcBuckets[I].in, kMcBuckets[I].hid, kMcBuckets[I].out>...};
  return kernels[b];
}

// The kernel for net at n_dev instances, and the layout of its tables: the
// compiled widths with the fewest weights that hold the net, if their tables
// fit the card's shared memory per block; else the general kernel on the
// net's own widths.
inline McKernel mc_kernel(const Net& net, int n_dev, McLayout& lay) {
  int widths[kMaxLayers + 1] = {net.layer[0].fan_in};
  for (int l = 0; l < net.n_layers; ++l) widths[l + 1] = net.layer[l].fan_out;
  int best = -1;
  if (net.n_layers == 2)
    for (int b = 0; b < kMcNumBuckets; ++b) {
      const McDims& d = kMcBuckets[b];
      if (widths[0] <= d.in && widths[1] <= d.hid && widths[2] <= d.out &&
          (best < 0 || d.in * d.hid + d.hid * d.out <
                           kMcBuckets[best].in * kMcBuckets[best].hid +
                               kMcBuckets[best].hid * kMcBuckets[best].out))
        best = b;
    }
  if (best >= 0) {
    const McDims& d = kMcBuckets[best];
    const int bucket[3] = {d.in, d.hid, d.out};
    const McLayout padded = mc_layout(bucket, 2, 4);
    int device = 0, optin = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (static_cast<int>(sizeof(int32_t)) * mc_smem_words(padded, n_dev) <= optin) {
      lay = padded;
      return mc_bucket_kernel(best, std::make_index_sequence<kMcNumBuckets>{});
    }
  }
  lay = mc_layout(widths, net.n_layers, 1);
  return pop_mlp_correct_mc_kernel<0, 0, 0>;
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

// K4's dynamic shared memory in bytes for the topology of net_desc and n_dev
// instances on the current card: the size pop_mlp_correct_mc_launch asks for,
// which the wrapper checks against the card's limit.
extern "C" int pop_mlp_correct_mc_smem_bytes(const int32_t* net_desc, int n_dev) {
  McLayout lay;
  mc_kernel(net_from_desc(net_desc), n_dev, lay);
  return static_cast<int>(sizeof(int32_t)) * mc_smem_words(lay, n_dev);
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
  McLayout lay;
  const McKernel kernel = mc_kernel(net, n_dev, lay);
  const int smem = static_cast<int>(sizeof(int32_t)) * mc_smem_words(lay, n_dev);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + kMcThreads - 1) / kMcThreads : 1;
  const dim3 grid((P + kMcRows - 1) / kMcRows, n_chunks, L);
  kernel<<<grid, kMcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pop, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples, out_mask, dev, high, n_dev,
      net, lay, counts);
  return static_cast<int>(cudaGetLastError());
}
