// K1 pop_mlp_correct: (P, G) int32 genomes x (S, n_in) int32 samples x (S,) int32
// labels -> (P,) int32 correct counts of the integer approximate MLP.
// K4 pop_mlp_correct_mc: the same over K device instances -> (P, K) int32 counts.
// One kernel template runs both (pop_mlp_tables_kernel; K1 is K4 at one
// instance with the deltas compiled out).
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
// Design (common.cuh, McTables): a block of kMcThreads threads takes a tile of
// chromosomes (kK4Rows, kK1Rows) and kMcThreads x samples of the samples. It
// first turns the chromosomes' genes into tables in shared memory: for each
// (chromosome, instance) the signed multiplier sign << clip(e + delta) of every
// weight (0 where shl would give 0), and per chromosome the masks, the shifted
// biases and the right shifts, all K instances at once (3 x 8 x 132 multiplier
// words, 15 KB at pendigits, K = 8); K1 builds one instance with e as it is and
// reads no delta. Each thread then runs the forwards of its samples: x & mask
// of layer 1 once per chromosome, then per instance one multiply-add per
// layer-1 weight and an AND and a multiply-add per later weight, the operands
// 16-byte broadcast reads of the tables. At K = 1 the build is amortised over
// one forward per (chromosome, sample), so K1's threads take several samples
// each (kK1Samples; scripts/mc_tiles.py measured the choice). Kernels are
// compiled for the widths in kMcBuckets: a 2-layer net runs the one with the
// fewest weights that holds it, its tables laid out for those widths with
// zeros past its own, so the sample, layer 1's ANDs and the activations stay
// in registers. Pendigits' (16, 5, 10) and the padded suite's (21, 5, 10) are
// the widths themselves; the paper's other three datasets pad into them. Any
// other net, or one whose padded tables do not fit the card's shared memory,
// runs the general kernel, which reads packed tables with runtime widths
// (mc_plan, the one rule of every table kernel). A warp ballot per
// (chromosome, instance) and shared-memory atomics reduce the counts, then
// one integer atomicAdd per (chromosome, instance) and block: integer atomics
// are order independent, so the counts are exact and repeatable. The tables
// of all K instances sit in shared memory together: at every K and topology
// the earlier layout (genome tile, delta table, bounds) fitted, the packed
// tables need no more (kernels/pop_mlp/ref.py mc_smem_bytes; a CPU test holds
// it). The compiled kernels are held to 128 registers, four blocks per SM:
// the table build waits on memory, and the other blocks hide it.
//
// Lanes: L independent problems of one layout (the lanes of a batched GA run:
// seeds, hyperparameter cells, padded datasets) share one launch; the lane is
// grid.z, and each lane reads its own genomes, samples, labels, output mask,
// delta table and sample bound at lane-strided offsets. A single problem is
// L = 1.
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

// K4 (kDev) or K1: see the header. IN > 0: the kernel compiled for 2-layer nets
// up to the widths (IN, HID, OUT); IN == 0: any net. Rows past n_valid_rows are
// skipped on every instance and keep their zeros. K1 passes n_dev = 1 and no
// deltas; its counts (L, P) are K4's layout at one instance.
template <int IN, int HID, int OUT, bool kDev>
__global__ void __launch_bounds__(kMcThreads, kDev ? kK4BlocksPerSM : kK1BlocksPerSM)
pop_mlp_tables_kernel(const int32_t* __restrict__ pop, int P, int G,
                      const int32_t* __restrict__ x, const int32_t* __restrict__ labels,
                      int S, int n_in, const int32_t* __restrict__ n_valid_rows,
                      const int32_t* __restrict__ n_valid_samples,
                      const int32_t* __restrict__ out_mask, const int32_t* __restrict__ dev,
                      const int32_t* __restrict__ high, int n_dev, Net net, McLayout lay,
                      int32_t* counts) {
  constexpr int kRows = kDev ? kK4Rows : kK1Rows, kSamples = kDev ? kK4Samples : kK1Samples;
  const int n_inst = kDev ? n_dev : 1;   // a constant for K1, folded into its forwards
  extern __shared__ __align__(16) int32_t mc_smem[];
  const McTables t(mc_smem, lay, n_inst, kRows);

  const int lane = blockIdx.z;
  const int row0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, min(P, *n_valid_rows) - row0);
  const int s_begin = blockIdx.y * kMcThreads * kSamples;
  const int s_end = min(min(S, n_valid_samples[lane]), s_begin + kMcThreads * kSamples);
  if (n_rows <= 0 || s_begin >= s_end) return;  // whole block past a bound
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  pop += (static_cast<size_t>(lane) * P + row0) * G;
  x += static_cast<size_t>(lane) * S * n_in;
  labels += static_cast<size_t>(lane) * S;
  out_mask += lane * n_out;
  if constexpr (kDev) {
    dev += static_cast<size_t>(lane) * n_dev * G;
    high += static_cast<size_t>(lane) * G;
  }
  counts += (static_cast<size_t>(lane) * P + row0) * n_inst;

  mc_build<kDev, kRows>(t, lay, net, pop, n_rows, G, dev, high, n_inst, out_mask, n_out);
  __syncthreads();
  mc_count<IN, HID, OUT, kSamples>(t, lay, net, n_rows, n_inst, x, labels, n_in, s_begin,
                                   s_end);
  __syncthreads();
  for (int i = threadIdx.x; i < n_rows * n_inst; i += blockDim.x)
    if (t.red[i]) atomicAdd(&counts[i], t.red[i]);
}

using McKernel = void (*)(const int32_t*, int, int, const int32_t*, const int32_t*, int, int,
                          const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, int, Net, McLayout, int32_t*);

// (a plain local array: a static one would be one symbol across every library
// loaded in the process that compiles this source, as the builds of
// scripts/mc_tiles.py do)
template <bool kDev, size_t... I>
McKernel tables_kernel(int b, std::index_sequence<I...>) {
  const McKernel kernels[] = {
      pop_mlp_tables_kernel<kMcBuckets[I].in, kMcBuckets[I].hid, kMcBuckets[I].out, kDev>...,
      pop_mlp_tables_kernel<0, 0, 0, kDev>};
  return kernels[b < 0 ? kMcNumBuckets : b];
}

// K4's (kDev) or K1's kernel for net at n_dev instances, the layout of its
// tables (mc_plan) and its dynamic shared memory in bytes.
template <bool kDev>
McKernel plan(const Net& net, int n_dev, McLayout& lay, int& smem) {
  constexpr int rows = kDev ? kK4Rows : kK1Rows;
  const int b = mc_plan(net, n_dev, rows, 0, lay);
  smem = static_cast<int>(sizeof(int32_t)) * mc_smem_words(lay, n_dev, rows);
  return tables_kernel<kDev>(b, std::make_index_sequence<kMcNumBuckets>{});
}

template <bool kDev>
int launch_tables(const int32_t* pop, int L, int P, int G, const int32_t* x,
                  const int32_t* labels, int S, int n_in, const int32_t* n_valid_rows,
                  const int32_t* n_valid_samples, const int32_t* out_mask, const int32_t* dev,
                  const int32_t* high, int n_dev, const int32_t* net_desc, int32_t* counts,
                  void* stream) {
  constexpr int rows = kDev ? kK4Rows : kK1Rows;
  constexpr int chunk = kMcThreads * (kDev ? kK4Samples : kK1Samples);
  const Net net = net_from_desc(net_desc);
  McLayout lay;
  int smem;
  const McKernel kernel = plan<kDev>(net, n_dev, lay, smem);
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_chunks = S > 0 ? (S + chunk - 1) / chunk : 1;
  const dim3 grid((P + rows - 1) / rows, n_chunks, L);
  kernel<<<grid, kMcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pop, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples, out_mask, dev, high, n_dev,
      net, lay, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

using namespace repro_torch;

extern "C" int pop_mlp_correct_launch(const int32_t* pop, int L, int P, int G, const int32_t* x,
                                      const int32_t* labels, int S, int n_in,
                                      const int32_t* n_valid_rows,
                                      const int32_t* n_valid_samples,
                                      const int32_t* out_mask, const int32_t* net_desc,
                                      int32_t* counts, void* stream) {
  return launch_tables<false>(pop, L, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples,
                              out_mask, nullptr, nullptr, 1, net_desc, counts, stream);
}

// K1's dynamic shared memory in bytes for the topology of net_desc on the
// current card: the size pop_mlp_correct_launch asks for, which the wrapper
// checks against the card's limit.
extern "C" int pop_mlp_correct_smem_bytes(const int32_t* net_desc) {
  McLayout lay;
  int smem;
  plan<false>(net_from_desc(net_desc), 1, lay, smem);
  return smem;
}

// K4's dynamic shared memory in bytes for the topology of net_desc and n_dev
// instances on the current card: the size pop_mlp_correct_mc_launch asks for,
// which the wrapper checks against the card's limit.
extern "C" int pop_mlp_correct_mc_smem_bytes(const int32_t* net_desc, int n_dev) {
  McLayout lay;
  int smem;
  plan<true>(net_from_desc(net_desc), n_dev, lay, smem);
  return smem;
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
  return launch_tables<true>(pop, L, P, G, x, labels, S, n_in, n_valid_rows, n_valid_samples,
                             out_mask, dev, high, n_dev, net_desc, counts, stream);
}
