// Device functions shared by the GA kernels (sm_90a):
//   * the counter-based Threefry-2x32 draw of repro_torch/core/genome.py,
//   * the per-gene variation of repro_torch/kernels/pop_variation/ref.py
//     (vary_gene, child_pair),
//   * the tables of per-instance weight multipliers and the forwards that read
//     them (McTables, mc_build, mc_forwards_fixed, mc_forwards_any, mc_count):
//     the integer forward pass + first-maximum argmax of repro_torch/core/mlp.py
//     as every fitness kernel runs it (K1, K4 and both branches of K3), with
//     the rule that picks the widths their forwards run in (kMcBuckets,
//     mc_plan) and each kernel's tile.
//
// Bit-identity rules (each one mirrors XLA, which the JAX reference runs on):
//   * all hashing is uint32_t with natural wraparound;
//   * shifts go through shl/sar: amounts outside [0, 31] give 0 (left) or the
//     sign fill (right), and a left shift of a negative value is done on the
//     unsigned bit pattern (a signed << is undefined in C++, XLA wraps);
//   * int32 sums accumulate in uint32_t (wrapping, order independent);
//   * float draws use __fmul_rn/__fadd_rn, which nvcc never contracts into an FMA;
//   * argmax keeps the first maximum (strict >).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxLayers = 4;
constexpr int kMaxWidth = 32;   // widest layer net_from_desc takes

struct Layer {
  int masks, signs, exps, bias, bshift, rshift, fan_in, fan_out;  // gene offsets and sizes
};

struct Net {
  Layer layer[kMaxLayers];
  int n_layers;
  int act_max;  // 2**act_bits - 1, the QReLU clamp
};

// Host side: net_desc = [n_layers, act_max, 8 ints per layer in Layer order].
inline Net net_from_desc(const int32_t* d) {
  Net net{};
  net.n_layers = d[0];
  net.act_max = d[1];
  for (int l = 0; l < net.n_layers; ++l) {
    const int32_t* v = d + 2 + 8 * l;
    net.layer[l] = Layer{v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]};
  }
  return net;
}

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t x1,
                                             uint32_t x2, uint32_t& y1, uint32_t& y2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t v0 = x1 + k1, v1 = x2 + k2;
#pragma unroll
  for (int d = 0; d < 5; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v0 += v1;
      v1 = rotl(v1, rot[d & 1][i]);
      v1 ^= v0;
    }
    v0 += ks[(d + 1) % 3];
    v1 += ks[(d + 2) % 3] + static_cast<uint32_t>(d + 1);
  }
  y1 = v0;
  y2 = v1;
}

// uint32 bits -> float32 in [0, 1), the bit cast of jax.random.uniform.
__device__ __forceinline__ float bits_to_open01(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ int32_t shl(int32_t x, int32_t s) {
  return (s < 0 || s > 31) ? 0 : static_cast<int32_t>(static_cast<uint32_t>(x) << s);
}

__device__ __forceinline__ int32_t sar(int32_t x, int32_t s) {
  return x >> ((s < 0 || s > 31) ? 31 : s);
}

struct Genes {
  const int32_t* low;
  const int32_t* high;
  const int32_t* is_mask;
  const int32_t* mask_bits;
  const int32_t* ids;

  // The table of lane `lane` of (L, G) tables.
  __device__ __forceinline__ Genes lane(int lane, int G) const {
    const size_t o = static_cast<size_t>(lane) * G;
    return Genes{low + o, high + o, is_mask + o, mask_bits + o, ids + o};
  }
};

// Crossover source select -> mutation -> clip for one gene of one child.
__device__ __forceinline__ int32_t vary_gene(int32_t a, int32_t b, bool swap, float u_do,
                                             float u_val, int32_t lo, int32_t hi,
                                             int32_t is_mask, int32_t mbits, float pm) {
  int32_t child = swap ? b : a;
  const int32_t bitpos =
      static_cast<int32_t>(floorf(__fmul_rn(u_val, static_cast<float>(max(mbits, 1)))));
  const int32_t flipped = child ^ shl(1, bitpos);
  const int32_t reset = static_cast<int32_t>(floorf(
      __fadd_rn(static_cast<float>(lo), __fmul_rn(u_val, static_cast<float>(hi - lo)))));
  const int32_t mutated = is_mask > 0 ? flipped : reset;
  if (u_do < pm) child = mutated;
  return min(max(child, lo), hi - 1);
}

// Gene j of the children in rows 2r and 2r+1 of the child frame (see
// pop_variation/kernel.py). The mutation draws of both rows come from one
// Threefry evaluation (counter (ids[j], r), one output word per row); the swap
// draw is addressed by the parent pair p mod P/2, which needs a second
// evaluation only when P/2 is odd and the two rows' pairs straddle a counter.
// keys: the (3, 2) slot keys; no division anywhere.
__device__ __forceinline__ void child_pair(int r, int j, int P, int G,
                                           const int32_t* __restrict__ a_rows,
                                           const int32_t* __restrict__ b_rows,
                                           const int32_t* __restrict__ do_rows, const Genes& t,
                                           const uint32_t* keys, float pm, int32_t& c0,
                                           int32_t& c1) {
  const int half = P >> 1;
  const uint32_t gid = static_cast<uint32_t>(t.ids[j]);
  const int p0 = 2 * r, p1 = 2 * r + 1;
  const int q0 = p0 < half ? p0 : p0 - half;
  const int q1 = p1 < half ? p1 : p1 - half;
  uint32_t w0, w1;
  threefry2x32(keys[0], keys[1], gid, static_cast<uint32_t>(q0 >> 1), w0, w1);
  const uint32_t s0 = (q0 & 1) ? w1 : w0;
  if ((q1 >> 1) != (q0 >> 1))
    threefry2x32(keys[0], keys[1], gid, static_cast<uint32_t>(q1 >> 1), w0, w1);
  const uint32_t s1 = (q1 & 1) ? w1 : w0;
  uint32_t d0, d1, v0, v1;
  threefry2x32(keys[2], keys[3], gid, static_cast<uint32_t>(r), d0, d1);
  threefry2x32(keys[4], keys[5], gid, static_cast<uint32_t>(r), v0, v1);
  const int32_t lo = t.low[j], hi = t.high[j], im = t.is_mask[j], mb = t.mask_bits[j];
  const size_t e0 = static_cast<size_t>(p0) * G + j, e1 = static_cast<size_t>(p1) * G + j;
  c0 = vary_gene(a_rows[e0], b_rows[e0], do_rows[p0] > 0 && bits_to_open01(s0) < 0.5f,
                 bits_to_open01(d0), bits_to_open01(v0), lo, hi, im, mb, pm);
  c1 = vary_gene(a_rows[e1], b_rows[e1], do_rows[p1] > 0 && bits_to_open01(s1) < 0.5f,
                 bits_to_open01(d1), bits_to_open01(v1), lo, hi, im, mb, pm);
}

// Raises a kernel's dynamic shared-memory limit to `smem` bytes where it needs
// more than the default 48 KB; the error of a size past the card's limit.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// -- the tables of per-instance weight multipliers (K1, K4, K3) -------------------
//
// Instance k's term of a weight is sign * shl(h & mask, e_k), e_k the exponent
// gene moved by the instance's delta and clipped into [0, high - 1] (a zero
// delta leaves it as it is; genome.apply_device_deltas). In wrapping uint32
// arithmetic that is (h & mask) * mult_k with mult_k = (2 sign - 1) << e_k, and 0
// where e_k leaves [0, 31] (shl's zero): the same bits. A block first builds,
// for its chromosomes, the tables its forwards read (McTables): each
// instance's multiplier of each weight, the masks, each neuron's shifted bias
// and each layer's right shift. A forward then costs an AND and a multiply-add
// per weight, its table operands broadcast loads. The nominal device (K1, K3's
// nominal branch) is one instance with e_k = e: the same tables and forwards
// with the deltas compiled out (kDev false).
// (kernels/pop_mlp/ref.py mc_tables builds the same tables on the CPU.)

constexpr int kMcThreads = 128;   // threads per block

// The tile of each table kernel: chromosomes per block (Rows), samples per
// thread (Samples: a block counts kMcThreads x Samples of them, grid.y), and
// the blocks per SM its compiled forwards are held to (BlocksPerSM, for
// __launch_bounds__: 4 is 128 registers a thread). A block's table build
// waits on memory and other blocks hide it; the registers this takes from the
// forwards cost them less (a few spilled words). K3's tiles hold whole pairs
// of children (pop_generation.cu's header says why). The samples a thread
// takes and K3's rows and caps were chosen by scripts/mc_tiles.py's timings
// (PERF.md section 6). (kernels/pop_mlp/ref.py MC_TILES lists the tiles.)
constexpr int kK4Rows = 3, kK4Samples = 1, kK4BlocksPerSM = 4;   // K4: K instances
constexpr int kK1Rows = 3, kK1Samples = 4, kK1BlocksPerSM = 4;   // K1: the nominal device
constexpr int kK3Rows = 2, kK3Samples = 4, kK3BlocksPerSM = 4;   // K3's n_dev branch
constexpr int kK3NRows = 2, kK3NSamples = 8, kK3NBlocksPerSM = 4;   // K3's nominal branch

// Where a row's weights and neurons sit in the tables, laid out for the widths
// fi[l] -> fo[l] of each layer: layer l's weight (i, j) at word woff[l] + i
// fo[l] + j of a (row, instance) multiplier block and of a row's mask block
// (wp words each), its neuron j at word noff[l] + j of a row's bias block (np
// words). The general kernel lays out the net's own widths, packed (pad 1); a
// kernel compiled for widths (IN, HID, OUT) lays out those, each layer padded
// to 4 words (16-byte vector reads), and the words past the net's own widths
// hold 0, so they add exact zeros.
struct McLayout {
  int woff[kMaxLayers], noff[kMaxLayers], fi[kMaxLayers], fo[kMaxLayers];
  int wp, np;
};

// widths: the n_layers + 1 layer widths the tables are laid out for.
inline McLayout mc_layout(const int* widths, int n_layers, int pad) {
  McLayout m{};
  for (int l = 0; l < n_layers; ++l) {
    m.fi[l] = widths[l];
    m.fo[l] = widths[l + 1];
    m.woff[l] = m.wp;
    m.noff[l] = m.np;
    m.wp += (m.fi[l] * m.fo[l] + pad - 1) / pad * pad;
    m.np += (m.fo[l] + pad - 1) / pad * pad;
  }
  return m;
}

// McTables' size in words for `rows` chromosomes (kernels/pop_mlp/ref.py
// mc_smem_bytes computes the same): per row the K multiplier blocks, the
// masks, the biases, the right shifts and the K counts, then the output mask.
inline int mc_smem_words(const McLayout& m, int n_dev, int rows) {
  return rows * (n_dev * m.wp + m.wp + m.np + kMaxLayers + n_dev) + kMaxWidth;
}

// The widths the table kernels have forwards compiled for (kernels/pop_mlp/
// ref.py MC_BUCKETS lists the same): (input, hidden, output) of 2-layer nets.
struct McDims {
  int in, hid, out;
};
constexpr McDims kMcBuckets[] = {{16, 5, 10}, {21, 5, 10}};
constexpr int kMcNumBuckets = sizeof(kMcBuckets) / sizeof(kMcBuckets[0]);

// The one rule of every table kernel's launcher and size query: the compiled
// widths with the fewest weights that hold the net (their index into
// kMcBuckets), if `extra` words of shared memory and their tables for `rows`
// chromosomes and n_dev instances fit the card's limit per block; else -1,
// the general kernel on the net's own widths, packed. `lay` gets the layout.
inline int mc_plan(const Net& net, int n_dev, int rows, int extra, McLayout& lay) {
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
    if (static_cast<int>(sizeof(int32_t)) * (extra + mc_smem_words(padded, n_dev, rows)) <=
        optin) {
      lay = padded;
      return best;
    }
  }
  lay = mc_layout(widths, net.n_layers, 1);
  return -1;
}

struct McTables {
  uint32_t *mult, *mask, *bias;   // [row][instance][wp], [row][wp], [row][np]
  int32_t *rsh, *om, *red;        // [row][kMaxLayers], [kMaxWidth], [row][instance]
  __device__ McTables(int32_t* smem, const McLayout& m, int n_dev, int rows)
      : mult(reinterpret_cast<uint32_t*>(smem)),
        mask(mult + rows * n_dev * m.wp),
        bias(mask + rows * m.wp),
        rsh(reinterpret_cast<int32_t*>(bias + rows * m.np)),
        om(rsh + rows * kMaxLayers),
        red(om + kMaxWidth) {}
};

// Fills the tables of the n_rows chromosomes g (global or shared memory, row
// stride G; at most kRows) for the n_dev delta rows of dev (global, n_dev x G;
// zero off the exponent genes) with the exclusive gene bounds high, copies
// the output mask (0 past n_out) and zeroes the counts. kDev false: the
// nominal device (n_dev 1, e_k = e; dev and high are not read). Slots of the
// layout past the net's widths get 0; the padding at a layer's end stays
// unwritten: no forward reads it. The caller synchronises.
// (Loops whose loads wait on each other leave the block idle here: with a
// few blocks per SM their latency is not hidden.)
template <bool kDev, int kRows>
static __device__ void mc_build(const McTables& t, const McLayout& m, const Net& net,
                                const int32_t* __restrict__ g, int n_rows, int G,
                                const int32_t* __restrict__ dev,
                                const int32_t* __restrict__ high, int n_dev,
                                const int32_t* __restrict__ out_mask, int n_out) {
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const int fo = m.fo[l], nw = m.fi[l] * fo;   // the layout's slots of the layer
    // slot s of the layer: its weight's gene offset wl, or out of the net
    const bool padded = fo != L.fan_out || m.fi[l] != L.fan_in;
    auto weight = [&](int s, int& wl) {
      if (!padded) {
        wl = s;
        return true;
      }
      const int a = s / fo, b = s % fo;
      wl = a * L.fan_out + b;
      return a < L.fan_in && b < L.fan_out;
    };
    // multipliers over (instance, slot): the delta and the bound once, then
    // each row's exponent and sign; every load of an iteration is independent
#pragma unroll 2
    for (int i = threadIdx.x; i < n_dev * nw; i += blockDim.x) {
      const int k = kDev ? i / nw : 0, s = kDev ? i % nw : i;
      int wl;
      const bool in = weight(s, wl);
      const int e_gene = L.exps + wl;
      const int32_t d = kDev && in ? dev[static_cast<size_t>(k) * G + e_gene] : 0;
      const int32_t hi = kDev && in ? high[e_gene] - 1 : 0;
      uint32_t* out = t.mult + k * m.wp + m.woff[l] + s;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < n_rows) {
          uint32_t w = 0;
          if (in) {
            const int32_t* gr = g + static_cast<size_t>(r) * G;
            const int32_t e = gr[e_gene];
            const int32_t ek = d == 0 ? e : min(max(e + d, 0), hi);
            const uint32_t sign = static_cast<uint32_t>(gr[L.signs + wl]) * 2u - 1u;
            w = (ek < 0 || ek > 31) ? 0u : sign << ek;
          }
          out[r * n_dev * m.wp] = w;
        }
      }
    }
    for (int i = threadIdx.x; i < n_rows * nw; i += blockDim.x) {
      const int r = i / nw, s = i % nw;
      int wl;
      t.mask[r * m.wp + m.woff[l] + s] =
          weight(s, wl) ? static_cast<uint32_t>(g[static_cast<size_t>(r) * G + L.masks + wl])
                        : 0u;
    }
    for (int i = threadIdx.x; i < n_rows * fo; i += blockDim.x) {
      const int r = i / fo, j = i % fo;
      const int32_t* gr = g + static_cast<size_t>(r) * G;
      t.bias[r * m.np + m.noff[l] + j] =
          j < L.fan_out ? static_cast<uint32_t>(shl(gr[L.bias + j], gr[L.bshift])) : 0u;
    }
  }
  for (int i = threadIdx.x; i < n_rows * net.n_layers; i += blockDim.x) {
    const int rr = i / net.n_layers, l = i % net.n_layers;
    const int32_t s = g[static_cast<size_t>(rr) * G + net.layer[l].rshift];
    t.rsh[rr * kMaxLayers + l] = (s < 0 || s > 31) ? 31 : s;   // sar's amount
  }
  const int c = threadIdx.x;
  if (c < kMaxWidth) t.om[c] = c < n_out ? out_mask[c] : 0;
  for (int i = threadIdx.x; i < n_rows * n_dev; i += blockDim.x) t.red[i] = 0;
}

// Lane 0 of each warp adds the warp's correct forwards of (row, instance)
// into the block's count (the sample loop is uniform: every lane votes).
__device__ __forceinline__ void mc_vote(const McTables& t, int slot, bool ok) {
  const unsigned votes = __ballot_sync(0xffffffffu, ok);
  if ((threadIdx.x & 31) == 0 && votes) atomicAdd(&t.red[slot], __popc(votes));
}

// The forwards of one sample xs (global, n_in ints) on the n_rows x n_dev
// (chromosome, instance) pairs of the tables, compiled for the widths (IN,
// HID, OUT) of a 2-layer net that holds the sample's (the tables laid out
// for them, zero past the net's own): every trip count is a constant, so the
// sample, layer 1's x & mask (computed once per chromosome, shared by the
// instances) and both layers' activations live in registers, and the tables
// come in as 16-byte broadcast reads (each layer padded to 4 words). Inputs
// past n_in read as 0; hidden neurons past the net's are 0 (a zero bias and
// zero multipliers); output columns past it have a zero output mask.
template <int IN, int HID, int OUT>
static __device__ __forceinline__ void mc_forwards_fixed(const McTables& t, const McLayout& m,
                                                         int n_rows, int n_dev, int act_max,
                                                         int n_in, const int32_t* __restrict__ xs,
                                                         bool live, int32_t y) {
  constexpr int kW1 = IN * HID, kW2 = HID * OUT;
  constexpr int kG1 = (kW1 + 3) / 4, kG2 = (kW2 + 3) / 4;   // 4-word groups per layer
  constexpr int kB2 = (HID + 3) / 4 * 4;                     // layer 2's first bias word
  uint32_t x[IN];
#pragma unroll
  for (int i = 0; i < IN; ++i) x[i] = i < n_in ? static_cast<uint32_t>(xs[i]) : 0u;
  uint32_t omb = 0;   // bit j: output column j is valid
#pragma unroll
  for (int j = 0; j < OUT; ++j) omb |= (t.om[j] > 0 ? 1u : 0u) << j;
  for (int r = 0; r < n_rows; ++r) {
    const uint4* mk = reinterpret_cast<const uint4*>(t.mask + r * m.wp);
    uint32_t a1[kW1];
#pragma unroll
    for (int q = 0; q < kG1; ++q) {
      const uint4 v = mk[q];
      const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < kW1) a1[4 * q + e] = x[(4 * q + e) / HID] & c[e];
    }
    const uint32_t* br = t.bias + r * m.np;
    uint32_t b1[HID], b2[OUT];
#pragma unroll
    for (int j = 0; j < HID; ++j) b1[j] = br[j];
#pragma unroll
    for (int j = 0; j < OUT; ++j) b2[j] = br[kB2 + j];
    const int rs = t.rsh[r * kMaxLayers];
    for (int k = 0; k < n_dev; ++k) {
      const uint4* mu = reinterpret_cast<const uint4*>(t.mult + (r * n_dev + k) * m.wp);
      uint32_t acc1[HID];
#pragma unroll
      for (int j = 0; j < HID; ++j) acc1[j] = b1[j];
#pragma unroll
      for (int q = 0; q < kG1; ++q) {
        const uint4 v = mu[q];
        const uint32_t c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < kW1) acc1[(4 * q + e) % HID] += a1[4 * q + e] * c[e];
      }
      uint32_t h[HID];
#pragma unroll
      for (int j = 0; j < HID; ++j)
        h[j] = static_cast<uint32_t>(min(max(static_cast<int32_t>(acc1[j]) >> rs, 0), act_max));
      uint32_t acc2[OUT];
#pragma unroll
      for (int j = 0; j < OUT; ++j) acc2[j] = b2[j];
#pragma unroll
      for (int q = 0; q < kG2; ++q) {
        const uint4 v = mu[kG1 + q], u = mk[kG1 + q];
        const uint32_t c[4] = {v.x, v.y, v.z, v.w}, mm[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < kW2) acc2[(4 * q + e) % OUT] += (h[(4 * q + e) / OUT] & mm[e]) * c[e];
      }
      int best = 0;
      int32_t best_v = (omb & 1u) ? static_cast<int32_t>(acc2[0]) : INT32_MIN;
#pragma unroll
      for (int j = 1; j < OUT; ++j) {
        const int32_t v = ((omb >> j) & 1u) ? static_cast<int32_t>(acc2[j]) : INT32_MIN;
        if (v > best_v) {
          best_v = v;
          best = j;
        }
      }
      mc_vote(t, r * n_dev + k, live && best == y);
    }
  }
}

// The same for any topology net_from_desc takes (up to kMaxLayers layers of
// width up to kMaxWidth): runtime widths, so the activations sit in local
// memory, and layer 1's AND is redone per instance.
static __device__ __forceinline__ void mc_forwards_any(const McTables& t, const McLayout& m,
                                                       const Net& net, int n_rows, int n_dev,
                                                       const int32_t* __restrict__ xs, bool live,
                                                       int32_t y) {
  const int n_in = net.layer[0].fan_in, n_out = net.layer[net.n_layers - 1].fan_out;
  int32_t x[kMaxWidth];
  for (int i = 0; i < n_in; ++i) x[i] = xs[i];
  for (int r = 0; r < n_rows; ++r) {
    for (int k = 0; k < n_dev; ++k) {
      int32_t h[kMaxWidth], o[kMaxWidth];
      for (int i = 0; i < n_in; ++i) h[i] = x[i];
      for (int l = 0; l < net.n_layers; ++l) {
        const Layer L = net.layer[l];
        const uint32_t* mu = t.mult + (r * n_dev + k) * m.wp + m.woff[l];
        const uint32_t* mk = t.mask + r * m.wp + m.woff[l];
        const uint32_t* b = t.bias + r * m.np + m.noff[l];
        const int rs = t.rsh[r * kMaxLayers + l];
        const bool last = l == net.n_layers - 1;
        for (int j = 0; j < L.fan_out; ++j) {
          uint32_t acc = b[j];
          for (int i = 0; i < L.fan_in; ++i) {
            const int w = i * L.fan_out + j;
            acc += (static_cast<uint32_t>(h[i]) & mk[w]) * mu[w];
          }
          int32_t a = static_cast<int32_t>(acc);
          if (!last) a = min(max(a >> rs, 0), net.act_max);
          o[j] = a;
        }
        for (int j = 0; j < L.fan_out; ++j) h[j] = o[j];
      }
      int best = 0;
      int32_t best_v = t.om[0] > 0 ? h[0] : INT32_MIN;
      for (int j = 1; j < n_out; ++j) {
        const int32_t v = t.om[j] > 0 ? h[j] : INT32_MIN;
        if (v > best_v) {
          best_v = v;
          best = j;
        }
      }
      mc_vote(t, r * n_dev + k, live && best == y);
    }
  }
}

// The forwards of the block's samples [s_begin, s_end) (at most kMcThreads x
// kSamples) on the n_rows x n_dev (chromosome, instance) pairs of the tables,
// voted into t.red: thread t takes samples s_begin + q kMcThreads + t, q <
// kSamples, reading each from x (global, n_in ints a sample) once. IN > 0:
// the forwards compiled for the widths (IN, HID, OUT); IN == 0: any net. The
// loop is uniform across the block: a thread past the samples runs the
// forwards of the block's first sample and votes false. n_dev may be a
// constant (K1's 1), which the inlined forwards fold.
template <int IN, int HID, int OUT, int kSamples>
static __device__ __forceinline__ void mc_count(const McTables& t, const McLayout& m,
                                                const Net& net, int n_rows, int n_dev,
                                                const int32_t* __restrict__ x,
                                                const int32_t* __restrict__ labels, int n_in,
                                                int s_begin, int s_end) {
  for (int q = 0; q < kSamples; ++q) {
    const int base = s_begin + q * kMcThreads;
    if (base >= s_end) break;
    const int s = base + threadIdx.x;
    const bool live = s < s_end;
    const int32_t y = live ? labels[s] : -1;
    const int32_t* xs = x + static_cast<size_t>(live ? s : s_begin) * n_in;
    if constexpr (IN > 0)
      mc_forwards_fixed<IN, HID, OUT>(t, m, n_rows, n_dev, net.act_max, n_in, xs, live, y);
    else
      mc_forwards_any(t, m, net, n_rows, n_dev, xs, live, y);
  }
}

}  // namespace repro_torch
