// K7 pow2_matmul: x (M, K) float32 or bfloat16 times packed pow2 weights w (K, N)
// uint8 -> (M, N) float32. A weight byte is bit 7 the sign and bits 0..6 the
// exponent plus 63; code 0x7F is 0.
//
// Replaces the Pallas TPU kernel repro/kernels/pow2_matmul/kernel.py:pow2_matmul
// (decode: _decode_pow2 there).
//
// Bound on an H100: operations. At qwen3-14b's FFN projection (M = 4096 tokens,
// K = 5120, N = 17408) the product is 730 GFLOP against 200 MB of operands, far
// above the card's ridge; the least time is the bf16 tensor cores' (0.74 ms),
// or for float32 x the float32 pipe's (10.9 ms: TF32 would change the result).
// Both paths tile the output 128 x 128 per block of 256 threads and stage a K
// slice of x and of the weight bytes in shared memory, decoding each byte there
// by exponent insertion, exactly as _decode_pow2 (the sign from bit 7, code 0x7F
// -> 0): the decoded weight tensor never exists in device memory, one byte per
// weight is what the kernel is for. A product of x by a power of two is exact,
// so only the order of the float32 sums differs from the plain version.
//  * bfloat16 x: the decoded weights are bf16 too (every power of two the
//    format holds is one), and each warp runs mma.sync m16n8k16 (bf16 in,
//    float32 accumulators) over a 64 x 32 piece of the tile, its fragments
//    read from padded, conflict-free shared memory. No cp.async pipeline or
//    wgmma yet: loads and products do not overlap.
//  * float32 x: the SIMT pipe, each thread an 8 x 8 register tile (two 4-wide
//    strips in each direction, conflict-free 16-byte shared-memory reads),
//    explicit __fmaf_rn.
// Ragged edges (M, N or K not a multiple of the tile) are masked.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kMMThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kPad = 4;   // keeps rows 16-byte aligned, spreads the banks

// uint8 code -> the float32 power of two it packs (exact).
__device__ __forceinline__ float decode_pow2(uint32_t c) {
  if (c == 0x7Fu) return 0.0f;
  const float mag = __int_as_float(static_cast<int>(((c & 0x7Fu) + 127u - 63u) << 23));
  return (c & 0x80u) ? -mag : mag;
}

// uint8 code -> the bf16 bits of the same power of two: sign, then the exponent
// field e + 127 = (c & 0x7F) + 64 (code 0x7F -> +0)
__device__ __forceinline__ uint16_t decode_pow2_bf16(uint32_t c) {
  if (c == 0x7Fu) return 0;
  return static_cast<uint16_t>(((c & 0x80u) << 8) | (((c & 0x7Fu) + 64u) << 7));
}

constexpr int kTcBK = 32;            // K slice of the tensor-core path
constexpr int kTcStride = kTcBK + 8; // bf16 per shared row: 80 bytes, conflict-free fragments

// one m16n8k16 product: d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bfloat16 x on the tensor cores. Warp w computes rows 64 (w / 4) .. + 63 and
// columns 32 (w % 4) .. + 31 of the block's tile: 4 x 4 fragments of 16 x 8.
__global__ void __launch_bounds__(kMMThreads)
pow2_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                        int M, int N, int K, float* __restrict__ out) {
  __shared__ __align__(16) uint16_t xs[kBM][kTcStride];   // x slice: [m][k]
  __shared__ __align__(16) uint16_t ws[kBN][kTcStride];   // decoded weights: [n][k]
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(x);
  const bool x_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;                  // mma fragment coordinates
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kTcBK) {
    // x: 128 rows x 32 k, each thread 16 bf16 of one row (two 16-byte loads
    // where the row is aligned and whole, else one by one, masked)
    {
      const int m = tid / 2, kq = (tid % 2) * 16;
      const int gm = m0 + m, gk = k0 + kq;
      const uint16_t* src = xb + static_cast<size_t>(gm) * K + gk;
      if (x_vec && gm < M && gk + 16 <= K) {
        *reinterpret_cast<uint4*>(&xs[m][kq]) = reinterpret_cast<const uint4*>(src)[0];
        *reinterpret_cast<uint4*>(&xs[m][kq + 8]) = reinterpret_cast<const uint4*>(src)[1];
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) xs[m][kq + e] = (gm < M && gk + e < K) ? src[e] : 0;
      }
    }
    // weights: 32 k x 128 n bytes, each thread 16 bytes of one k row (one
    // 16-byte load where aligned and whole), stored transposed so that a
    // fragment's two k neighbours are one 32-bit word
    {
      const int k = tid / 8, nq = (tid % 8) * 16;
      const int gk = k0 + k, gn = n0 + nq;
      const uint8_t* src = w + static_cast<size_t>(gk) * N + gn;
      uint8_t bytes[16];
      if (w_vec && gk < K && gn + 16 <= N) {
        *reinterpret_cast<uint4*>(bytes) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) bytes[e] = (gk < K && gn + e < N) ? src[e] : 0x7F;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) ws[nq + e][k] = decode_pow2_bf16(bytes[e]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 2 * t + 8]);
        a[i][3] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 2 * t]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
  // accumulator e of fragment (i, j): row g (+ 8 for e >= 2), column 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm + i * 16 + g + (e / 2) * 8;
        const int gn = n0 + wn + j * 8 + 2 * t + e % 2;
        if (gm < M && gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j][e];
      }
}

// float32 x on the SIMT pipe.
__global__ void __launch_bounds__(kMMThreads)
pow2_matmul_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w, int M, int N,
                   int K, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kBK][kBM + kPad];   // x slice, transposed: [k][m]
  __shared__ __align__(16) float ws[kBK][kBN + kPad];   // decoded weight slice: [k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kMMThreads) {
      const int m = i / kBK, k = i % kBK;
      const int gm = m0 + m, gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.0f;
    }
    for (int i = tid; i < kBK * kBN; i += kMMThreads) {
      const int k = i / kBN, n = i % kBN;
      const int gk = k0 + k, gn = n0 + n;
      ws[k][n] = (gk < K && gn < N) ? decode_pow2(w[static_cast<size_t>(gk) * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&xs[k][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(&xs[k][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(&ws[k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i / 4) * 64 + ty * 4 + (i % 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j / 4) * 64 + tx * 4 + (j % 4);
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// x_bf16: 0 for float32 x, 1 for bfloat16 x.
extern "C" int pow2_matmul_launch(const void* x, int x_bf16, const uint8_t* w, int M, int N,
                                  int K, float* out, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    pow2_matmul_bf16_kernel<<<grid, kMMThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                         w, M, N, K, out);
  else
    pow2_matmul_f32_kernel<<<grid, kMMThreads, 0, s>>>(static_cast<const float*>(x), w, M, N,
                                                        K, out);
  return static_cast<int>(cudaGetLastError());
}
