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
// * float32: the float32 pipe (flash_attention_f32), explicit __fmaf_rn, no TF32.
//   Its bound is the FMA pipe's 67 TFLOP/s (2.56 ms for the 172 GFLOP at
//   qwen3-14b prefill), and shared memory serves a quarter of that pipe's lanes
//   a clock, so the thread tiles are sized for the products: one block of 256
//   threads per (head, 128-query tile), heaviest tiles first over all heads
//   (the grid's slow axis is the tile), key tiles of 64. Thread (rg, cg)
//   (rg = 2 warp + lane / 16, cg = lane % 16) owns query rows 8 rg .. 8 rg + 7:
//   in Q.K^T their scores against keys cg + 16 j (8 x 4), in P.V their output
//   columns 4 cg + 64 h .. + 3 (8 x 8 for Dv > 64, 8 x 4 else). Each d step of
//   Q.K^T reads 2 float4 of queries and 1 of keys for 32 products; each key of
//   P.V 2 float4 of p and 1 or 2 of values for 32 or 64. The block keeps its
//   queries transposed in shared memory ([d][query], loaded once), the key
//   tile [key][d] with a row stride of 4 times an odd number of words, the
//   value tile [key][Dv] and p [key][query]: every read is a broadcast or
//   conflict-free. K and V tiles come by cp.async (16-byte pieces, rows past S
//   zero-filled), K into two buffers and V into one: once K(t) has arrived,
//   V(t) and K(t + 1) are issued together; V(t) flies during Q.K^T(t) and the
//   softmax, K(t + 1) during the whole tile. Two __syncthreads a tile, 195 KB
//   of shared memory at D = Dv = 128, about 200 registers: one block (8 warps)
//   per SM. The online softmax works on the raw scores: a row's maximum
//   reduces over the 16 threads of its row group (four shuffles), p = 2^(s
//   log2e scale - m log2e scale) by ex2.approx, the row sums stay per thread
//   until the epilogue. Only the two key tiles that cross the diagonal are
//   masked, and in the upper one the warps whose rows all precede its keys
//   skip both products; tiles past the block's last query are never loaded.
//   D and Dv are multiples of 4 (the wrapper pads others with zero columns);
//   the kernel is compiled for 64 or 128 of each (a constant trip count over
//   d), and the zero-filled columns make up the rest. On the card it reaches
//   about 64 % of its bound: the shared-memory reads (12 a thread for 128
//   products of Q.K^T) take issue slots, and 8 warps hide little of their
//   latency.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxDv = 128;     // widest D and Dv either path takes
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz.f32): subnormal results
// flush to zero, and the rounding differs from expf's; the float32 tolerance
// (3e-4) and the bf16 limit cover both (a p below 2^-126 is nothing beside the
// row's largest, which is 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- float32: the SIMT kernel ---------------------------------------------------

constexpr int kFAThreads = 256;
constexpr int kFBQ = 128;              // queries per block
constexpr int kFBK = 64;               // keys per tile
constexpr int kFRows = 8;              // query rows a thread
constexpr int kFKeys = 4;              // keys a thread in Q.K^T: cg + 16 j
constexpr int kPStride = kFBQ + 4;     // p [key][query]: rows 4 banks apart

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

// Row stride of the key tile [key][d]: DQK + 4 or DQK + 8, whichever is 4 times
// an odd number, so the 16 keys cg + 16 j a warp reads at one d fall on 8
// distinct 16-byte bank groups twice (two wavefronts, the least for 256 bytes).
__host__ __device__ constexpr int key_stride(int dqk) { return dqk + ((dqk / 4) % 2 ? 8 : 4); }

// dynamic shared memory, in bytes: queries [DQK][kFBQ], two key tiles
// [kFBK][key_stride], values [kFBK][DV], p [kFBK][kPStride]
constexpr int f32_smem_bytes(int dqk, int dv) {
  return 4 * (dqk * kFBQ + 2 * kFBK * key_stride(dqk) + kFBK * dv + kFBK * kPStride);
}

// 16 bytes from global to shared memory, asynchronously; zeros where !valid
// (src is then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// DQK, DV: the widths the kernel is compiled for (64 or 128; D <= DQK,
// Dv <= DV); the query and key columns past D are zero in shared memory.
template <int DQK, int DV>
__global__ void __launch_bounds__(kFAThreads, 1)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, int S, int D, int Dv, float scale,
                    float* __restrict__ out) {
  constexpr int kNH = DV / 64;         // 64-column halves of a thread's output columns
  constexpr int kK4 = DQK / 4;         // 16-byte pieces of a key row
  constexpr int kV4 = DV / 4;          // 16-byte pieces of a value row
  constexpr int KS = key_stride(DQK);
  extern __shared__ __align__(16) float fa_smem[];
  float* const qs = fa_smem;                 // [DQK][kFBQ]
  float* const ks = qs + DQK * kFBQ;         // 2 x [kFBK][KS]
  float* const vs = ks + 2 * kFBK * KS;      // [kFBK][DV]
  float* const ps = vs + kFBK * DV;          // [kFBK][kPStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = 2 * warp + lane / 16, cg = lane % 16;
  const int qi = gridDim.y - 1 - blockIdx.y;   // the longest tiles start first
  const int q0 = qi * kFBQ, r0 = q0 + kFRows * rg;
  const size_t head = static_cast<size_t>(blockIdx.x) * S;
  const int n_kv = (min(q0 + kFBQ, S) - 1) / kFBK + 1;   // key tiles up to the diagonal

  // this thread's 16-byte pieces of a key (value) tile: column piece tid % kK4
  // (kV4) of rows tid / kK4 + (kFAThreads / kK4) i; pieces past D (Dv) or rows
  // past S are zero-filled
  auto load_k = [&](int t) {
    const int k0 = t * kFBK, c = tid % kK4;
    const bool col_in = 4 * c < D;
    float* const kt = ks + (t & 1) * kFBK * KS;
#pragma unroll
    for (int i = 0; i < kFBK * kK4 / kFAThreads; ++i) {
      const int r = tid / kK4 + (kFAThreads / kK4) * i;
      const bool in = col_in && k0 + r < S;
      cp_async16(kt + r * KS + 4 * c, k + (head + (in ? k0 + r : 0)) * D + (in ? 4 * c : 0), in);
    }
    cp_async_commit();
  };
  auto load_v = [&](int t) {
    const int k0 = t * kFBK, c = tid % kV4;
    const bool col_in = 4 * c < Dv;
#pragma unroll
    for (int i = 0; i < kFBK * kV4 / kFAThreads; ++i) {
      const int r = tid / kV4 + (kFAThreads / kV4) * i;
      const bool in = col_in && k0 + r < S;
      cp_async16(vs + r * DV + 4 * c, v + (head + (in ? k0 + r : 0)) * Dv + (in ? 4 * c : 0), in);
    }
    cp_async_commit();
  };

  load_k(0);
  // the queries, transposed: a warp takes 32 consecutive rows of one 16-byte
  // column piece, so its stores are conflict-free
  for (int i = tid; i < kFBQ * kK4; i += kFAThreads) {
    const int r = i % kFBQ, c = i / kFBQ;
    const float4 a = q0 + r < S && 4 * c < D
                         ? *reinterpret_cast<const float4*>(q + (head + q0 + r) * D + 4 * c)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    qs[(4 * c) * kFBQ + r] = a.x;
    qs[(4 * c + 1) * kFBQ + r] = a.y;
    qs[(4 * c + 2) * kFBQ + r] = a.z;
    qs[(4 * c + 3) * kFBQ + r] = a.w;
  }

  // exp(x - m) = 2^(x c - m c) with c = scale log2e, on the raw scores
  const float c = __fmul_rn(scale, kLog2e);
  float m[kFRows], l[kFRows], acc[kFRows][4 * kNH];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * kNH; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kFBK;
    cp_async_wait<0>();   // K(t), the only load in flight
    __syncthreads();      // K(t) (and the queries) visible; K(t - 1), V(t - 1), p consumed
    load_v(t);
    if (t + 1 < n_kv) load_k(t + 1);
    const float* const kt = ks + (t & 1) * kFBK * KS;
    // a warp whose 16 rows all precede this tile's keys (the upper of the two
    // tiles across the diagonal) has nothing to add: it skips both products,
    // and its masked scores leave m, l and acc as they are
    const bool idle = k0 > q0 + 16 * warp + 15;

    // scores of rows r0 + i against keys k0 + cg + 16 j
    float s[kFRows][kFKeys];
#pragma unroll
    for (int i = 0; i < kFRows; ++i)
#pragma unroll
      for (int j = 0; j < kFKeys; ++j) s[i][j] = 0.0f;
    if (!idle) {
#pragma unroll
      for (int d = 0; d < DQK; d += 4) {
        float4 kb[kFKeys];
#pragma unroll
        for (int j = 0; j < kFKeys; ++j)
          kb[j] = *reinterpret_cast<const float4*>(kt + (cg + 16 * j) * KS + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 a0 = *reinterpret_cast<const float4*>(qs + (d + e) * kFBQ + kFRows * rg);
          const float4 a1 =
              *reinterpret_cast<const float4*>(qs + (d + e) * kFBQ + kFRows * rg + 4);
          const float av[kFRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          float bv[kFKeys];
#pragma unroll
          for (int j = 0; j < kFKeys; ++j)
            bv[j] = e == 0 ? kb[j].x : e == 1 ? kb[j].y : e == 2 ? kb[j].z : kb[j].w;
#pragma unroll
          for (int i = 0; i < kFRows; ++i)
#pragma unroll
            for (int j = 0; j < kFKeys; ++j) s[i][j] = __fmaf_rn(av[i], bv[j], s[i][j]);
        }
      }
    }
    if (k0 + kFBK - 1 > q0) {   // a tile across the diagonal: keys after the query
#pragma unroll
      for (int i = 0; i < kFRows; ++i)
#pragma unroll
        for (int j = 0; j < kFKeys; ++j)
          if (k0 + cg + 16 * j > r0 + i) s[i][j] = kNegInf;
    }
    float alpha[kFRows];
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      // the new row maximum of the raw scores; scale > 0 keeps the order
      const float x = group_max(fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      const float m_new = fmaxf(m[i], x);
      const float mc = __fmul_rn(m_new, c);
      alpha[i] = ex2(__fmaf_rn(m[i], c, -mc));
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kFKeys; ++j) {
        s[i][j] = ex2(__fmaf_rn(s[i][j], c, -mc));
        sum = __fadd_rn(sum, s[i][j]);
      }
      l[i] = __fmaf_rn(l[i], alpha[i], sum);   // this thread's keys only
    }
#pragma unroll
    for (int j = 0; j < kFKeys; ++j) {
      float* row = ps + (cg + 16 * j) * kPStride + kFRows * rg;
      *reinterpret_cast<float4*>(row) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    if (t + 1 < n_kv)
      cp_async_wait<1>();   // V(t); K(t + 1) may still fly
    else
      cp_async_wait<0>();
    __syncthreads();        // V(t) and p visible

#pragma unroll
    for (int i = 0; i < kFRows; ++i)
#pragma unroll
      for (int j = 0; j < 4 * kNH; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha[i]);
    if (!idle) {
#pragma unroll 8
      for (int key = 0; key < kFBK; ++key) {
        const float4 p0 = *reinterpret_cast<const float4*>(ps + key * kPStride + kFRows * rg);
        const float4 p1 = *reinterpret_cast<const float4*>(ps + key * kPStride + kFRows * rg + 4);
        const float pv[kFRows] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        float vv[4 * kNH];
#pragma unroll
        for (int h = 0; h < kNH; ++h)
          *reinterpret_cast<float4*>(vv + 4 * h) =
              *reinterpret_cast<const float4*>(vs + key * DV + 64 * h + 4 * cg);
#pragma unroll
        for (int i = 0; i < kFRows; ++i)
#pragma unroll
          for (int j = 0; j < 4 * kNH; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  // epilogue: the row group's partial sums, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const float den = fmaxf(group_sum(l[i]), 1e-30f);
    const int row = r0 + i;
    if (row >= S) continue;
#pragma unroll
    for (int h = 0; h < kNH; ++h) {
      const int col = 64 * h + 4 * cg;
      if (col < Dv)
        *reinterpret_cast<float4*>(out + (head + row) * Dv + col) = make_float4(
            __fdiv_rn(acc[i][4 * h], den), __fdiv_rn(acc[i][4 * h + 1], den),
            __fdiv_rn(acc[i][4 * h + 2], den), __fdiv_rn(acc[i][4 * h + 3], den));
    }
  }
}

template <int DQK, int DV>
int launch_f32_for(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
                   float scale, void* out, cudaStream_t stream) {
  constexpr int kBytes = f32_smem_bytes(DQK, DV);
  // once per instantiation, before any CUDA-graph capture can be running
  static cudaError_t raised = cudaFuncSetAttribute(
      flash_attention_f32<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const dim3 grid(BH, (S + kFBQ - 1) / kFBQ);
  flash_attention_f32<DQK, DV><<<grid, kFAThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      S, D, Dv, scale, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
               float scale, void* out, cudaStream_t stream) {
  // 16-byte pieces: the wrapper pads D and Dv to multiples of 4 and aligns
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (any % 16 || D % 4 || Dv % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 64)
    return Dv <= 64 ? launch_f32_for<64, 64>(q, k, v, BH, S, D, Dv, scale, out, stream)
                    : launch_f32_for<64, 128>(q, k, v, BH, S, D, Dv, scale, out, stream);
  return Dv <= 64 ? launch_f32_for<128, 64>(q, k, v, BH, S, D, Dv, scale, out, stream)
                  : launch_f32_for<128, 128>(q, k, v, BH, S, D, Dv, scale, out, stream);
}

// -- bfloat16: the Hopper kernel -------------------------------------------------

constexpr int kTile = 128;           // queries per block = keys per stage
constexpr int kStages = 2;           // K/V ring depth
constexpr int kSm90Threads = 384;    // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kConsumers = 256;
constexpr int kHalf = kTile * 128;   // bytes of one 64-column half of a 128-row tile

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

// bf16: 0 for float32 q, k, v and out (then D and Dv multiples of 4), 1 for
// bfloat16 (then multiples of 8); the pointers 16-byte aligned. D, Dv <= 128,
// BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, int bf16,
                                      int BH, int S, int D, int Dv, float scale, void* out,
                                      void* stream) {
  if (D > kMaxDv || Dv > kMaxDv || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_bf16(q, k, v, BH, S, D, Dv, scale, out, s)
              : launch_f32(q, k, v, BH, S, D, Dv, scale, out, s);
}
