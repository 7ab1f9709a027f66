// K6 flash_attention: causal attention forward, FlashAttention style.
// q, k (BH, S, D) and v (BH, S, Dv), all float32 or all bfloat16 -> out (BH, S, Dv)
// in q's type. Scores are float32 dot products scaled by `scale` (1/sqrt(D) of
// the caller's unpadded D); a key after the query is masked to -1e30; the
// softmax runs online over key tiles with a running maximum m, sum l and
// float32 accumulator acc per query row; p is cast to v's type before P.V;
// out = acc / max(l, 1e-30).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py:flash_attention (the reference's m, l,
// acc steps are its lines 48-56; the mask value its NEG_INF).
//
// Bound on an H100: operations. At qwen3-14b prefill (40 heads, S = 4096,
// D = Dv = 128, bf16) the causal half of Q.K^T and P.V is 172 GFLOP, 0.17 ms on
// the bf16 tensor cores, against 168 MB of operands (0.05 ms) and 336 M
// exponentials (0.08 ms on the special-function units). Two paths:
//
// * bfloat16: built for Hopper (flash_attention_sm90). One block of 384 threads
//   per (head, 128-query tile), heaviest tiles first: two consumer warpgroups,
//   each owning 64 query rows, and a producer warpgroup of which one thread
//   starts every load; setmaxnreg moves registers from the producer (24) to the
//   consumers (240). The producer copies the block's Q tile once, then K and V
//   tiles of 128 keys into a ring of 2 stages, all by TMA over 3-D tensor maps
//   of (BH, S, width): rows past S and columns past the width are zero-filled,
//   never read from the next head. Each stage has full barriers for K and V
//   (the TMA's byte count completes them) and an empty barrier that the 256
//   consumer threads arrive at once their wgmma reading the stage has
//   completed. Tiles are 64-column halves in 128-byte swizzled shared memory,
//   the layout wgmma reads: S = Q.K^T runs as wgmma m64n128k16 with both
//   operands in shared memory (K-major); the online softmax works on the
//   float32 accumulator fragment, where a row's values sit in a quad of 4
//   threads (two shuffles per reduction; the row sums are reduced once, at
//   the end), exp(s - m) taken as 2^(s log2e - m log2e) by ex2.approx on the
//   special-function unit; p is rounded to bf16 in registers and fed straight
//   back as the A operand of wgmma m64n{128,64}k16 for P.V, with V [key][dv]
//   in shared memory as the transposed (MN-major) B operand: p never goes
//   through shared memory. O is rescaled by alpha before each P.V. Only the diagonal
//   tile is masked; tiles past the block's last query are never loaded (by
//   position, so the function does not depend on the tiling). The epilogue
//   divides by max(l, 1e-30) and stores bf16 pairs row by row, masked at S.
//   Widths: D and Dv up to 128, multiples of 8 (TMA's 16-byte strides; the
//   wrapper pads other widths with zero columns); the kernel is compiled for
//   64 or 128 of each and the TMA zero fill makes up the rest.
//   Not yet here, the next steps: the two consumer warpgroups ping-ponging
//   their softmax against each other's wgmma, overlapping one tile's softmax
//   with the next tile's Q.K^T inside a warpgroup (FA3's intra-warpgroup
//   pipelining), clusters with TMA multicast of K and V, FP8, and a store
//   through shared memory and TMA.
// * float32: the SIMT pipe (flash_attention_f32). One block of 256 threads per
//   (head, 64-query tile), heaviest tiles first; the block keeps its queries in
//   shared memory (transposed) and loops over 32-key tiles up to the diagonal.
//   Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3: their scores against
//   keys tx and tx + 16, and their accumulator columns tx + 16 j. The 16
//   threads of a row group reduce the row maximum and sum with warp shuffles;
//   p goes through shared memory to the P.V step. Multiply-adds are explicit
//   __fmaf_rn; exponentials are expf.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxDv = 128;     // widest D and Dv either path takes
constexpr float kNegInf = -1e30f;

// -- float32: the SIMT kernel ---------------------------------------------------

constexpr int kFAThreads = 256;
constexpr int kBQ = 64;         // queries per block
constexpr int kBKV = 32;        // keys per tile
constexpr int kQStride = kBQ + 4;
constexpr int kKStride = kBKV + 1;

// max / sum over the 16 lanes that share a row group (xor offsets stay inside
// each half warp)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// dynamic shared memory, in floats: queries [D][kQStride], keys [D][kKStride]
// (rounded up to 4 floats, so the float4 reads of p stay 16-byte aligned),
// values [kBKV][Dv], p [kBKV][kQStride]
__host__ __device__ inline int keys_floats(int D) { return (D * kKStride + 3) / 4 * 4; }
inline int flash_smem_bytes(int D, int Dv) {
  return 4 * (D * kQStride + keys_floats(D) + kBKV * Dv + kBKV * kQStride);
}

__global__ void __launch_bounds__(kFAThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, int S, int D, int Dv, float scale,
                    float* __restrict__ out) {
  extern __shared__ __align__(16) float fa_smem[];
  float* qs = fa_smem;                      // [D][kQStride]
  float* ks = qs + D * kQStride;            // [D][kKStride]
  float* vs = ks + keys_floats(D);          // [kBKV][Dv]
  float* ps = vs + kBKV * Dv;               // [kBKV][kQStride]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;   // the longest tiles start first
  const int q0 = qi * kBQ;
  const size_t head = static_cast<size_t>(blockIdx.y) * S;

  for (int i = tid; i < kBQ * D; i += kFAThreads) {
    const int r = i / D, d = i % D;
    qs[d * kQStride + r] = q0 + r < S ? q[(head + q0 + r) * D + d] : 0.0f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_kv = q_last / kBKV + 1;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();   // the previous tile's keys, values and p are consumed
    for (int i = tid; i < kBKV * D; i += kFAThreads) {
      const int r = i / D, d = i % D;
      ks[d * kKStride + r] = k0 + r < S ? k[(head + k0 + r) * D + d] : 0.0f;
    }
    for (int i = tid; i < kBKV * Dv; i += kFAThreads) {
      const int r = i / Dv, c = i % Dv;
      vs[r * Dv + c] = k0 + r < S ? v[(head + k0 + r) * Dv + c] : 0.0f;
    }
    __syncthreads();

    // scores of rows 4 ty + i against keys k0 + tx + 16 j
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kQStride + ty * 4]);
      const float b0 = ks[d * kKStride + tx], b1 = ks[d * kKStride + tx + 16];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = __fmaf_rn(av[i], b0, s[i][0]);
        s[i][1] = __fmaf_rn(av[i], b1, s[i][1]);
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = qpos >= kpos ? __fmul_rn(s[i][j], scale) : kNegInf;
      }
      const float m_new = fmaxf(m[i], group_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(__fsub_rn(s[i][0], m_new));
      const float p1 = expf(__fsub_rn(s[i][1], m_new));
      alpha[i] = expf(__fsub_rn(m[i], m_new));
      l[i] = __fmaf_rn(l[i], alpha[i], group_sum(__fadd_rn(p0, p1)));
      m[i] = m_new;
      ps[tx * kQStride + ty * 4 + i] = p0;
      ps[(tx + 16) * kQStride + ty * 4 + i] = p1;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha[i]);
    for (int c = 0; c < kBKV; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[c * kQStride + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        if (col < Dv) {
          const float vv = vs[c * Dv + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv) out[(head + row) * Dv + col] = __fdiv_rn(acc[i][j], denom);
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
               float scale, void* out, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once, to the most any D, Dv <= 128
  // needs (so a later call, which may be under CUDA-graph capture, sets nothing)
  static cudaError_t raised = cudaFuncSetAttribute(
      flash_attention_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      flash_smem_bytes(kMaxDv, kMaxDv));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_f32<<<grid, kFAThreads, flash_smem_bytes(D, Dv), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      S, D, Dv, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: the Hopper kernel -------------------------------------------------

constexpr int kTile = 128;           // queries per block = keys per stage
constexpr int kStages = 2;           // K/V ring depth
constexpr int kSm90Threads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumers = 256;
constexpr int kHalf = kTile * 128;   // bytes of one 64-column half of a 128-row tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of flash_attention_sm90<DQK, DV>, in bytes from a 1024-aligned
// base: Q [DQK/64 halves][128][64], then per stage K [DQK/64][128][64] and
// V [DV/64][128][64], then the barriers (q_full; k_full, v_full, empty per
// stage); the allocation adds 1024 for the alignment.
template <int DQK, int DV>
struct Sm90Layout {
  static constexpr int kQ = DQK / 64 * kHalf;
  static constexpr int kK = DQK / 64 * kHalf;
  static constexpr int kV = DV / 64 * kHalf;
  static constexpr int kStage = kK + kV;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
};

template <int DV>
struct PV;
template <>
struct PV<128> {
  static __device__ __forceinline__ void mma(float (&o)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
    hopper::wgmma_m64n128k16_rs_tb(o, a, b);
  }
};
template <>
struct PV<64> {
  static __device__ __forceinline__ void mma(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
    hopper::wgmma_m64n64k16_rs_tb(o, a, b);
  }
};

// 2^x on the special-function unit (ex2.approx.ftz.f32): subnormal results
// flush to zero, and the rounding differs from expf's; the bf16 limit covers
// both (a p below 2^-126 is nothing beside the row's largest, which is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// DQK, DV: the widths the kernel is compiled for (64 or 128); the tensor maps
// carry the real widths, the TMA fills the rest of each tile with zeros. Dv:
// the output's row length.
template <int DQK, int DV>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_attention_sm90(__grid_constant__ const CUtensorMap tq,
                     __grid_constant__ const CUtensorMap tk,
                     __grid_constant__ const CUtensorMap tv, int S, int Dv, float scale,
                     __nv_bfloat16* __restrict__ out) {
  using L = Sm90Layout<DQK, DV>;
  using namespace hopper;
  extern __shared__ uint8_t sm90_smem[];
  const uint32_t base = (smem_addr(sm90_smem) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return base + L::kQ + s * L::kStage; };

  const int qi = gridDim.x - 1 - blockIdx.x;   // the longest tiles start first
  const int q0 = qi * kTile, bh = blockIdx.y;
  const int n_kv = qi + 1;                     // key tiles up to the diagonal
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread starts every copy, the rest leave
    regs_dec<24>();
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(q_full, L::kQ);
      for (int h = 0; h < DQK / 64; ++h)
        tma_load_3d(base + h * kHalf, &tq, q_full, 64 * h, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(empty(s), (round - 1) & 1);
        const uint32_t ks = k_tile(s), vs = ks + L::kK;
        mbar_arrive_expect_tx(k_full(s), L::kK);
        for (int h = 0; h < DQK / 64; ++h)
          tma_load_3d(ks + h * kHalf, &tk, k_full(s), 64 * h, t * kTile, bh);
        mbar_arrive_expect_tx(v_full(s), L::kV);
        for (int h = 0; h < DV / 64; ++h)
          tma_load_3d(vs + h * kHalf, &tv, v_full(s), 64 * h, t * kTile, bh);
      }
    }
  } else {
    // consumer warpgroup w: query rows q0 + 64 w .. q0 + 64 w + 63
    regs_inc<240>();
    const int w = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    // this thread's two rows of the accumulator fragments, and its first key column
    const int r0 = q0 + 64 * w + 16 * warp + lane / 4, r1 = r0 + 8;
    const int c0 = 2 * (lane % 4);
    // exp(x - m) = 2^(x log2e - m log2e): one explicit fma and ex2
    const float c = __fmul_rn(scale, kLog2e);
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
    float s[64];        // scores, then p: 64 x 128 per warpgroup
    float o[DV / 2];    // output accumulator: 64 x DV per warpgroup
#pragma unroll
    for (int j = 0; j < DV / 2; ++j) o[j] = 0.0f;
#pragma unroll
    for (int j = 0; j < 64; ++j) s[j] = 0.0f;
    const uint32_t qa = base + w * 64 * 128;   // this warpgroup's rows in each half

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int st = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      const uint32_t ks = k_tile(st), vs = ks + L::kK;
      const int k0 = t * kTile;

      // S = Q K^T (64 x 128), both operands K-major in shared memory
      mbar_wait(k_full(st), parity);
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        wgmma_m64n128k16_ss(s, sw128_desc(qa + off, 16, 1024), sw128_desc(ks + off, 16, 1024),
                            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      // s[j]: row (j & 2 ? r1 : r0), key k0 + 8 (j / 4) + c0 + (j & 1)
      if (t == n_kv - 1) {   // the diagonal tile: keys after the query masked
#pragma unroll
        for (int j = 0; j < 64; ++j) {
          const int key = k0 + 8 * (j / 4) + c0 + (j & 1);
          if (key > ((j & 2) ? r1 : r0)) s[j] = kNegInf;
        }
      }
      float x0 = m0, x1 = m1;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        if (j & 2) x1 = fmaxf(x1, s[j]);
        else x0 = fmaxf(x0, s[j]);
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, o_));
        x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o_));
      }
      // x = the new row maxima of the raw scores; scale > 0 keeps the order
      const float mc0 = __fmul_rn(x0, c), mc1 = __fmul_rn(x1, c);
      const float alpha0 = ex2(__fmaf_rn(m0, c, -mc0));
      const float alpha1 = ex2(__fmaf_rn(m1, c, -mc1));
      m0 = x0;
      m1 = x1;
      l0 = __fmul_rn(l0, alpha0);
      l1 = __fmul_rn(l1, alpha1);
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const float p = ex2(__fmaf_rn(s[j], c, (j & 2) ? -mc1 : -mc0));
        if (j & 2) l1 = __fadd_rn(l1, p);
        else l0 = __fadd_rn(l0, p);
        s[j] = p;
      }
#pragma unroll
      for (int j = 0; j < DV / 2; ++j) o[j] = __fmul_rn(o[j], (j & 2) ? alpha1 : alpha0);
      // p in bf16, in the A fragment of k16 slice kk: the accumulator's columns
      // 16 kk .. 16 kk + 15 are exactly that slice's A layout
      uint32_t pa[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

      // O += P V (64 x DV): P from registers, V [key][dv] MN-major in shared memory
      mbar_wait(v_full(st), parity);
      reg_fence(o);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        PV<DV>::mma(o, a, sw128_desc(vs + kk * 2048, kHalf, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty(st));   // this thread is done with the stage
    }

    // epilogue: the quad's partial row sums, then out = o / max(l, 1e-30) in bf16
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, o_));
      l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, o_));
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const size_t head = static_cast<size_t>(bh) * S;
#pragma unroll
    for (int j = 0; j < DV / 2; j += 2) {
      const int row = (j & 2) ? r1 : r0, col = 8 * (j / 4) + c0;
      const float den = (j & 2) ? d1 : d0;
      if (row < S && col < Dv)
        *reinterpret_cast<__nv_bfloat162*>(out + (head + row) * Dv + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[j], den), __fdiv_rn(o[j + 1], den));
    }
  }
}

template <int DQK, int DV>
int launch_sm90(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
                float scale, void* out, cudaStream_t stream) {
  using L = Sm90Layout<DQK, DV>;
  // once per instantiation, before any CUDA-graph capture can be running
  static cudaError_t raised = cudaFuncSetAttribute(
      flash_attention_sm90<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_bf16_3d(&tq, q, D, S, BH, kTile);
  if (!err) err = hopper::encode_bf16_3d(&tk, k, D, S, BH, kTile);
  if (!err) err = hopper::encode_bf16_3d(&tv, v, Dv, S, BH, kTile);
  if (err) return err;
  const dim3 grid((S + kTile - 1) / kTile, BH);
  flash_attention_sm90<DQK, DV><<<grid, kSm90Threads, L::kBytes, stream>>>(
      tq, tk, tv, S, Dv, scale, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
                float scale, void* out, cudaStream_t stream) {
  // TMA's global strides are multiples of 16 bytes: the wrapper pads D and Dv
  if (D % 8 || Dv % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return Dv <= 64 ? launch_sm90<64, 64>(q, k, v, BH, S, D, Dv, scale, out, stream)
                    : launch_sm90<64, 128>(q, k, v, BH, S, D, Dv, scale, out, stream);
  return Dv <= 64 ? launch_sm90<128, 64>(q, k, v, BH, S, D, Dv, scale, out, stream)
                  : launch_sm90<128, 128>(q, k, v, BH, S, D, Dv, scale, out, stream);
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// bf16: 0 for float32 q, k, v and out, 1 for bfloat16 (then D and Dv multiples
// of 8, the pointers 16-byte aligned). D, Dv <= 128, BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, int bf16,
                                      int BH, int S, int D, int Dv, float scale, void* out,
                                      void* stream) {
  if (D > kMaxDv || Dv > kMaxDv || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bf16(q, k, v, BH, S, D, Dv, scale, out, s)
              : launch_f32(q, k, v, BH, S, D, Dv, scale, out, s);
}
