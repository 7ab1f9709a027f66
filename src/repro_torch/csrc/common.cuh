// Device functions shared by the three GA kernels (sm_90a):
//   * the counter-based Threefry-2x32 draw of repro_torch/core/genome.py,
//   * the integer forward pass + first-maximum argmax of repro_torch/core/mlp.py,
//   * the per-gene variation of repro_torch/kernels/pop_variation/ref.py,
//   * the tile counter that sweeps samples over genomes held in shared memory.
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
constexpr int kMaxWidth = 32;   // widest layer the forward pass holds in registers
constexpr int kPopTile = 8;     // chromosomes per block in the fitness kernels
constexpr int kThreads = 256;
constexpr int kSampleChunk = 512;  // samples per block along grid.y

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

// Predicted class of genome g (shared memory) for one sample x (registers).
// (static: every source includes this header and links into one library)
static __device__ int predict(const int32_t* __restrict__ g, const int32_t* x,
                              const Net& net, const int32_t* out_mask) {
  int32_t h[kMaxWidth];
  int32_t o[kMaxWidth];
  for (int i = 0; i < net.layer[0].fan_in; ++i) h[i] = x[i];
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer L = net.layer[l];
    const int32_t bsh = g[L.bshift];
    const int32_t rsh = g[L.rshift];
    const bool last = (l == net.n_layers - 1);
    for (int j = 0; j < L.fan_out; ++j) {
      uint32_t acc = 0;
      for (int i = 0; i < L.fan_in; ++i) {
        const int w = i * L.fan_out + j;
        const uint32_t term = static_cast<uint32_t>(shl(h[i] & g[L.masks + w], g[L.exps + w]));
        const uint32_t sign = static_cast<uint32_t>(g[L.signs + w]) * 2u - 1u;  // {0,1} -> {-1,+1}
        acc += sign * term;
      }
      acc += static_cast<uint32_t>(shl(g[L.bias + j], bsh));
      int32_t a = static_cast<int32_t>(acc);
      if (!last) a = min(max(sar(a, rsh), 0), net.act_max);
      o[j] = a;
    }
    for (int j = 0; j < L.fan_out; ++j) h[j] = o[j];
  }
  const int n_out = net.layer[net.n_layers - 1].fan_out;
  int best = 0;
  int32_t best_v = out_mask[0] > 0 ? h[0] : INT32_MIN;
  for (int j = 1; j < n_out; ++j) {
    const int32_t v = out_mask[j] > 0 ? h[j] : INT32_MIN;
    if (v > best_v) {
      best_v = v;
      best = j;
    }
  }
  return best;
}

// Adds the correct predictions of n_rows genomes (shared memory, row stride G)
// over samples [s_begin, s_end) into counts[0..n_rows). Threads stride over the
// samples; a warp shuffle and shared-memory atomics reduce per genome, then one
// integer atomicAdd per genome and block (order independent, so exact).
// `red` is kPopTile ints of shared memory, zeroed and synchronised by the caller.
static __device__ void count_tile(const int32_t* g_tile, int n_rows, int G,
                                  const int32_t* __restrict__ x,
                                  const int32_t* __restrict__ labels, int n_in, int s_begin,
                                  int s_end, const Net& net, const int32_t* out_mask,
                                  int32_t* red, int32_t* counts) {
  int local[kPopTile];
#pragma unroll
  for (int p = 0; p < kPopTile; ++p) local[p] = 0;
  for (int s = s_begin + threadIdx.x; s < s_end; s += blockDim.x) {
    int32_t xs[kMaxWidth];
    for (int i = 0; i < n_in; ++i) xs[i] = x[static_cast<size_t>(s) * n_in + i];
    const int32_t y = labels[s];
#pragma unroll
    for (int p = 0; p < kPopTile; ++p)
      if (p < n_rows) local[p] += (predict(g_tile + p * G, xs, net, out_mask) == y);
  }
#pragma unroll
  for (int p = 0; p < kPopTile; ++p) {
    int v = local[p];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(&red[p], v);
  }
  __syncthreads();
  if (threadIdx.x < n_rows && red[threadIdx.x]) atomicAdd(&counts[threadIdx.x], red[threadIdx.x]);
}

struct Genes {
  const int32_t* low;
  const int32_t* high;
  const int32_t* is_mask;
  const int32_t* mask_bits;
  const int32_t* ids;
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

inline int fitness_smem_bytes(int G) {
  return static_cast<int>(sizeof(int32_t)) * (kPopTile * G + kMaxWidth + kPopTile);
}

}  // namespace repro_torch
