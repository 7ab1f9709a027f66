// K6 flash_attention: causal attention forward, FlashAttention-2 style.
// q, k (BH, S, D) and v (BH, S, Dv), all float32 or all bfloat16 -> out (BH, S, Dv)
// in q's type. Scores are float32 dot products scaled by 1/sqrt(D); a key after
// the query is masked to -1e30; the softmax runs online over key tiles with a
// running maximum m, sum l and float32 accumulator acc per query row; p is cast
// to v's type before P.V; out = acc / max(l, 1e-30).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py:flash_attention (the reference's m, l,
// acc steps are its lines 48-56; the mask value its NEG_INF).
//
// Bound on an H100: operations. At qwen3-14b prefill (40 heads, S = 4096,
// D = Dv = 128, bf16) the causal half of Q.K^T and P.V is 172 GFLOP, 0.17 ms on
// the bf16 tensor cores, against 168 MB of operands (0.05 ms) and 336 M
// exponentials (0.08 ms on the special-function units). Design, simple first
// (the SIMT pipe, not the tensor cores): one block of 256 threads per (head,
// 64-query tile), heaviest tiles first; the block keeps its queries in shared
// memory (float32, transposed) and loops over 32-key tiles up to the diagonal
// (tiles past the tile's last query are skipped by position, so the kernel's
// tiling is its own and any block size of the reference gives the same
// function). Thread (ty, tx) owns query rows 4 ty .. 4 ty + 3: their scores
// against keys tx and tx + 16, and their accumulator columns tx + 16 j. The 16
// threads of a row group reduce the row maximum and sum with warp shuffles, so
// m and l stay in registers; p goes through shared memory (rounded to v's type)
// to the P.V step. Multiply-adds are explicit __fmaf_rn; exponentials are expf.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kFAThreads = 256;
constexpr int kBQ = 64;         // queries per block
constexpr int kBKV = 32;        // keys per tile
constexpr int kMaxDv = 128;     // accumulator columns a thread can hold: 16 x 8; also the
                                // widest D the shared memory is sized for
constexpr int kQStride = kBQ + 4;
constexpr int kKStride = kBKV + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

template <typename T>
__global__ void __launch_bounds__(kFAThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int S, int D, int Dv, float scale,
                       T* __restrict__ out) {
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
    qs[d * kQStride + r] = q0 + r < S ? to_float(q[(head + q0 + r) * D + d]) : 0.0f;
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
      ks[d * kKStride + r] = k0 + r < S ? to_float(k[(head + k0 + r) * D + d]) : 0.0f;
    }
    for (int i = tid; i < kBKV * Dv; i += kFAThreads) {
      const int r = i / Dv, c = i % Dv;
      vs[r * Dv + c] = k0 + r < S ? to_float(v[(head + k0 + r) * Dv + c]) : 0.0f;
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
      // p in v's type for P.V
      ps[tx * kQStride + ty * 4 + i] = to_float(from_float<T>(p0));
      ps[(tx + 16) * kQStride + ty * 4 + i] = to_float(from_float<T>(p1));
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
      if (col < Dv) out[(head + row) * Dv + col] = from_float<T>(__fdiv_rn(acc[i][j], denom));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, int BH, int S, int D, int Dv,
           float scale, void* out, cudaStream_t stream) {
  // raise the kernel's shared-memory limit once, to the most any D, Dv <= 128
  // needs (so a later call, which may be under CUDA-graph capture, sets nothing)
  static cudaError_t raised = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      flash_smem_bytes(kMaxDv, kMaxDv));
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int smem = flash_smem_bytes(D, Dv);
  const dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_attention_kernel<T><<<grid, kFAThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), S, D, Dv,
      scale, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// bf16: 0 for float32 q, k, v and out, 1 for bfloat16. D, Dv <= 128, BH <= 65535.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, int bf16,
                                      int BH, int S, int D, int Dv, float scale, void* out,
                                      void* stream) {
  if (D > kMaxDv || Dv > kMaxDv || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, BH, S, D, Dv, scale, out, s)
              : launch<float>(q, k, v, BH, S, D, Dv, scale, out, s);
}
