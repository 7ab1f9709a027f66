// K7 pow2_matmul: x (M, K) float32 or bfloat16 times packed pow2 weights w (K, N)
// uint8 -> (M, N) float32, summed in float32. A weight byte is bit 7 the sign
// and bits 0..6 the exponent plus 63; only code 0x7F is 0 (0xFF is -2^64).
//
// Replaces the Pallas TPU kernel repro/kernels/pow2_matmul/kernel.py:pow2_matmul
// (decode: _decode_pow2 there). The decoded weight tensor never exists in
// device memory: one byte per weight is what the kernel is for. A product of x
// by a power of two is exact, so only the order of the float32 sums differs
// from the plain version.
//
// The launcher takes x (M, K) with K a multiple of 8 and w (K, N16) with N16
// = N rounded up to 16, both 16-byte aligned (TMA's strides and the 16-byte
// loads); the wrapper pads x with zero columns and w with 0x7F rows and
// columns where the caller's shapes are not so. The output is (M, N), masked
// at M and N.
//
// Bound on an H100: operations. bf16 at qwen3-14b's FFN projection (M = 4096,
// K = 5120, N = 17408): 730 GFLOP on the bf16 tensor cores, 0.74 ms, against
// 0.42 GB of operands and output (0.13 ms). float32 at M = 512: 91 GFLOP on
// the float32 pipe, 1.36 ms (TF32 would change the result).
//
// * bfloat16 (pow2_matmul_sm90): one block of 384 threads per 256 x 128
//   output tile, K slices 64 deep: two consumer warpgroups, each owning 128
//   rows (two wgmma m64n128k16 per k16 step, 128 float32 accumulators a
//   thread), and a producer warpgroup; setmaxnreg moves registers from the
//   producer (88) to the consumers (208). One producer thread issues the TMA
//   loads: x through a bf16 tensor map (a 64 x 256 box, 128-byte swizzle: the
//   K-major A operand as wgmma reads it) into a ring of 4 stages, and the
//   weight bytes through a uint8 tensor map (a 128 x 64 box, unswizzled) into
//   a ring of their own, 4 slots of 8 KB, refilled 3 slices ahead of the
//   decode. The decode stage: all four producer warps wait for a slice's
//   bytes and for its stage to be free, read the bytes 16 at a time
//   (conflict-free), decode four codes per 32-bit word (decode_word: about
//   3.5 integer instructions a code, no branch) and write the bf16 tile
//   into the stage as the 128-byte-swizzled MN-major B operand ([k][n], two
//   64-column halves), then fence.proxy.async and arrive on the stage's
//   "decoded" barrier. The consumers wait for x and the decoded tile, run
//   the SS product with B transposed, keep one wgmma group in flight and
//   release a stage once the group that read it has completed. Epilogue:
//   float32 pairs straight from the accumulator registers, masked (a quad of
//   threads writes 32 contiguous bytes of a row). Shared memory: 4 stages x
//   (x 32 KB + decoded 16 KB) + 4 x 8 KB of bytes + barriers = 230,528 bytes
//   with the 1024-byte alignment, one block per SM; 16 x 136 = 2176 tiles at
//   qwen3-14b, 16.5 waves on 132 SMs. The decode is the limit: on the card
//   the producer warps alone (no products) take about as long as the
//   products alone (no decode), and the two share the SM's issue slots and
//   shared-memory bandwidth.
//   TMA fills out-of-bounds bytes with 0x00, which is code +2^-63, not zero.
//   That is harmless only because x's out-of-bounds columns are zero-filled
//   at the same k (each such product is an exact 0), and columns past N and
//   rows past M are never stored.
//   Not yet here, the next steps: swapping A and B so that the weights are
//   decoded straight into registers as an RS wgmma A operand (the Hopper
//   mixed-input GEMM design), which removes the decoded tile's round trip
//   through shared memory and spreads the decode over the consumer warps; a
//   persistent scheduler that overlaps one tile's epilogue with the next
//   tile's loads; a TMA store through shared memory; clusters with TMA
//   multicast of x.
// * float32 (pow2_matmul_f32): the float32 pipe, explicit __fmaf_rn. Shared
//   memory serves 32 lanes x 4 bytes a clock and the FMA pipe 128 lanes, so
//   a thread tile of TM x TN loads TM + TN floats for TM TN products: 4 x 8
//   is bound by shared memory (0.375 clocks of loads against 0.25 of
//   products per thread and k), 8 x 12 by the products (0.625 against
//   0.75). One block of 256 threads per 128 x 192 output tile, each thread
//   8 x 12 (rows 4 ty.. and 64 + 4 ty.., columns 4 tx.., 64 + 4 tx.. and
//   128 + 4 tx..), K slices 32 deep. x comes in with 16-byte loads and is
//   stored transposed ([k][m], float4 groups swizzled by k & 4); the weight
//   bytes come in 8 at a time and are decoded in registers by the same word
//   decode (a bf16 is the top half of the float32 of the same value) into
//   [k][n] float4 groups swizzled inside each run of 8; every shared-memory
//   access is conflict-free. The next slice's loads are issued into
//   registers before the current slice's products and stored into the other
//   of two shared-memory buffers after them: one __syncthreads per slice.
//   80 KB of shared memory and about 220 registers a thread: one block per
//   SM, 4 x 91 = 364 tiles at M = 512, N = 17408, 2.76 waves on 132 SMs
//   (128 x 128 tiles of 8 x 8 at two blocks per SM give 2.06 waves, the
//   third nearly empty).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace repro_torch {
namespace {

// uint8 code -> the bf16 bits of the same power of two: sign, then the exponent
// field e + 127 = (c & 0x7F) + 64 (code 0x7F -> +0). The one-code form of
// decode_word.
[[maybe_unused]] __device__ __forceinline__ uint16_t decode_pow2_bf16(uint32_t c) {
  if (c == 0x7Fu) return 0;
  return static_cast<uint16_t>(((c & 0x80u) << 8) | (((c & 0x7Fu) + 64u) << 7));
}

// prmt.b32 in its default mode: result byte i is byte (sel >> 4 i) & 7 of
// {a, b}, or, where bit 3 of that nibble is set, that byte's sign bit
// replicated over all 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// The four codes of a 32-bit word -> two words of two bf16 each: codes (0, 1)
// in lo, (2, 3) in hi, the first of each pair in the low half; the float32
// of each is its half shifted to the top. With a pair u spread into 16-bit
// halves (prmt), (u + (u & 0x00800080) + 0x00400040) << 7 puts the sign at
// bit 15 and (c & 0x7F) + 64 at bits 7-14 of each half, that is
// ((u & 0x00800080) << 8) | (((u & 0x007F007F) + 0x00400040) << 7). A half
// is then cleared where its code is 0x7F: the msb of byte i of nz is set
// where code i is not 0x7F (with t = w ^ 0x7F7F7F7F, (t & 0x7F) + 0x7F
// carries into the msb where t's low bits are not all 0, and t's msb is
// w's), and prmt spreads it over the code's half. About 3.5 instructions a
// code, no branch.
__device__ __forceinline__ void decode_word(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t nz = (((~w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  const uint32_t u0 = prmt(w, 0u, 0x4140), u1 = prmt(w, 0u, 0x4342);
  lo = ((u0 + (u0 & 0x00800080u) + 0x00400040u) << 7) & prmt(nz, 0u, 0x9988);
  hi = ((u1 + (u1 & 0x00800080u) + 0x00400040u) << 7) & prmt(nz, 0u, 0xBBAA);
}

// -- bfloat16: the Hopper kernel -------------------------------------------------

constexpr int kBM = 256, kBN = 128, kBK = 64;
constexpr int kStages = 4;           // ring of x + decoded tiles
constexpr int kRaw = 4;              // ring of raw weight bytes
constexpr int kConsumers = 256;      // consumer warpgroups 0 and 1
constexpr int kProducers = 128;      // producer warpgroup 2
constexpr int kThreads = kConsumers + kProducers;
// setmaxnreg moves registers inside the block's allocation at entry, 168 a
// thread (65,536 / 384, rounded down to 8)
constexpr int kConsumerRegs = 208, kProducerRegs = 88;
static_assert(kConsumers * kConsumerRegs + kProducers * kProducerRegs <= kThreads * 168,
              "registers");
constexpr int kXBytes = kBM * kBK * 2;      // x tile [256][64] bf16
constexpr int kHalfB = kBK * 64 * 2;        // one 64-column half of the decoded tile
constexpr int kBBytes = 2 * kHalfB;         // decoded tile [k][n] bf16, two halves
constexpr int kWBytes = kBK * kBN;          // raw weight bytes [64][128]
constexpr int kStage = kXBytes + kBBytes;
constexpr int kRawBase = kStages * kStage;
constexpr int kBars = kRawBase + kRaw * kWBytes;   // x_full, decoded, empty; w_full
constexpr int kSmemBytes = kBars + 8 * (3 * kStages + kRaw) + 1024;
static_assert(kStage % 1024 == 0 && kXBytes % 1024 == 0, "tile alignment");
static_assert(kSmemBytes <= 232448, "one block's shared memory");

__global__ void __launch_bounds__(kThreads, 1)
pow2_matmul_sm90(__grid_constant__ const CUtensorMap tx, __grid_constant__ const CUtensorMap tw,
                 int M, int N, int K, float* __restrict__ out) {
  using namespace hopper;
  extern __shared__ uint8_t mm_smem[];
  const uint32_t sbase = smem_addr(mm_smem);
  const uint32_t base = (sbase + 1023u) & ~1023u;
  uint8_t* const gbase = mm_smem + (base - sbase);   // the same bytes, generic address
  auto stage = [&](int s) { return base + s * kStage; };
  auto x_full = [&](int s) { return base + kBars + 8u * s; };
  auto decoded = [&](int s) { return base + kBars + 8u * (kStages + s); };
  auto empty = [&](int s) { return base + kBars + 8u * (2 * kStages + s); };
  auto w_full = [&](int r) { return base + kBars + 8u * (3 * kStages + r); };

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(decoded(s), kProducers);
      mbar_init(empty(s), kConsumers);
    }
    for (int r = 0; r < kRaw; ++r) mbar_init(w_full(r), 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: its first thread issues the loads, all 128 decode
    regs_dec<kProducerRegs>();
    const int p = tid - kConsumers;
    auto issue_w = [&](int t) {
      const int r = t % kRaw;
      mbar_arrive_expect_tx(w_full(r), kWBytes);
      tma_load_2d(base + kRawBase + r * kWBytes, &tw, w_full(r), n0, t * kBK);
    };
    if (p == 0)
      for (int t = 0; t < kRaw && t < nk; ++t) issue_w(t);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages, r = t % kRaw;
      // the stage's x and decoded tiles are free once the consumers release
      // slice t - kStages
      if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
      if (p == 0) {
        mbar_arrive_expect_tx(x_full(s), kXBytes);
        tma_load_3d(stage(s), &tx, x_full(s), t * kBK, m0, 0);
        // the bytes of slice t - 1 are read (every decoder has arrived for
        // it): refill their slot, kRaw - 1 slices ahead of this decode
        if (t >= 1 && t - 1 + kRaw < nk) {
          mbar_wait(decoded((t - 1) % kStages), ((t - 1) / kStages) & 1);
          issue_w(t - 1 + kRaw);
        }
      }
      mbar_wait(w_full(r), (t / kRaw) & 1);
      const uint8_t* raw = gbase + kRawBase + r * kWBytes;
      uint8_t* dst = gbase + s * kStage + kXBytes;
      // 512 16-byte pieces of the [64 k][128 n] bytes, 4 a thread. A group of
      // 8 threads takes chunks 0-3 of row k and 4-7 of row k + 1 (or the
      // reverse): its 16-byte reads and its swizzled writes hit 8 distinct
      // bank groups.
      constexpr int kPieces = 512 / kProducers;
      const int j = p % 8;   // the piece's 16-byte chunk of its row
      auto row_of = [&](int it) {
        const int pr = (it * kProducers + p) / 8;
        return 2 * (pr / 2) + ((j / 4) ^ (pr % 2));
      };
      uint4 v[kPieces];
#pragma unroll
      for (int it = 0; it < kPieces; ++it)
        v[it] = *reinterpret_cast<const uint4*>(raw + row_of(it) * kBN + j * 16);
#pragma unroll
      for (int it = 0; it < kPieces; ++it) {
        const int k = row_of(it);
        uint4 a, b;
        decode_word(v[it].x, a.x, a.y);
        decode_word(v[it].y, a.z, a.w);
        decode_word(v[it].z, b.x, b.y);
        decode_word(v[it].w, b.z, b.w);
        // codes n = 16 j .. 16 j + 15: half j / 4, 16-byte chunks 2 (j % 4) and
        // the next, at row k of the half, swizzled by k % 8
        uint8_t* row = dst + (j / 4) * kHalfB + k * 128;
        const int c = 2 * (j % 4), sw = k % 8;
        *reinterpret_cast<uint4*>(row + ((c ^ sw) * 16)) = a;
        *reinterpret_cast<uint4*>(row + (((c + 1) ^ sw) * 16)) = b;
      }
      fence_proxy_async();   // the generic writes before the consumers' wgmma reads
      mbar_arrive(decoded(s));
    }
  } else {
    // consumer warpgroup w: rows m0 + 128 w .. + 127, two 64-row accumulators
    regs_inc<kConsumerRegs>();
    const int w = tid / 128;
    float acc0[64], acc1[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc0[j] = acc1[j] = 0.0f;
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      const uint32_t parity = (t / kStages) & 1;
      mbar_wait(x_full(s), parity);
      mbar_wait(decoded(s), parity);
      const uint32_t xa = stage(s) + w * 128 * 128, bs = stage(s) + kXBytes;
      reg_fence(acc0);
      reg_fence(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t b = sw128_desc(bs + kk * 2048, kHalfB, 1024);
        wgmma_m64n128k16_ss_tb(acc0, sw128_desc(xa + kk * 32, 16, 1024), b, 1);
        wgmma_m64n128k16_ss_tb(acc1, sw128_desc(xa + 64 * 128 + kk * 32, 16, 1024), b, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the group of slice t - 1 has completed
      reg_fence(acc0);
      reg_fence(acc1);
      if (t > 0) mbar_arrive(empty((t - 1) % kStages));
    }
    wgmma_wait<0>();
    reg_fence(acc0);
    reg_fence(acc1);

    // acc[j]: row 16 warp + lane / 4 (+ 8 where j & 2), column 8 (j / 4) +
    // 2 (lane % 4) + (j & 1) of the warpgroup's 64-row piece
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r0 = m0 + 128 * w + 16 * warp + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    const bool pairs = N % 2 == 0;   // then (row, even column) is 8-byte aligned
    auto store = [&](const float (&acc)[64], int rbase) {
#pragma unroll
      for (int j = 0; j < 64; j += 2) {
        const int row = rbase + ((j & 2) ? 8 : 0), col = c0 + 8 * (j / 4);
        if (row >= M) continue;
        float* o = out + static_cast<size_t>(row) * N + col;
        if (pairs && col + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[j], acc[j + 1]);
        } else {
          if (col < N) o[0] = acc[j];
          if (col + 1 < N) o[1] = acc[j + 1];
        }
      }
    };
    store(acc0, r0);
    store(acc1, r0 + 64);
  }
}

int launch_bf16(const void* x, const uint8_t* w, int M, int N, int K, float* out,
                cudaStream_t stream) {
  // once, before any CUDA-graph capture can be running
  static cudaError_t raised = cudaFuncSetAttribute(
      pow2_matmul_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const int n16 = (N + 15) / 16 * 16;
  CUtensorMap tx, tw;
  int err = hopper::encode_bf16_3d(&tx, x, K, M, 1, kBM);
  if (!err) err = hopper::encode_u8_2d(&tw, w, n16, K, kBN, kBK);
  if (err) return err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  pow2_matmul_sm90<<<grid, kThreads, kSmemBytes, stream>>>(tx, tw, M, N, K, out);
  return static_cast<int>(cudaGetLastError());
}

// -- float32: the SIMT kernel ------------------------------------------------------

constexpr int kFThreads = 256;      // 16 x 16 threads
constexpr int kFBK = 32;
constexpr int kFTM = 8;              // rows a thread: 64 h + 4 ty + (0..3), h < 2
constexpr int kFNG = 3;              // float4 column groups a thread: 64 h + 4 tx.., h < 3
constexpr int kFBM = 16 * kFTM, kFBN = 64 * kFNG;
constexpr int kXPieces = kFBM * kFBK / 4 / kFThreads;   // 16-byte pieces of x a thread
constexpr int kWPieces = kFBK * kFBN / 8 / kFThreads;   // 8-byte pieces of w a thread
constexpr int kFSmemBytes = 2 * 4 * kFBK * (kFBM + kFBN);

// x element (k, m) in a [k][kFBM] slice: float4 groups swizzled by k & 4; the
// float4 group g of a [k][n] weight slice: swizzled by g / 8 inside its
// aligned run of 8 groups
__device__ __forceinline__ int xs_at(int k, int m) {
  return k * kFBM + 4 * ((m / 4) ^ (k & 4)) + m % 4;
}
__device__ __forceinline__ int ws_group(int g) { return g ^ ((g >> 3) & 7); }

__global__ void __launch_bounds__(kFThreads, 1)
pow2_matmul_f32(const float* __restrict__ x, const uint8_t* __restrict__ w, int M, int N, int K,
                float* __restrict__ out) {
  extern __shared__ __align__(16) float f32_smem[];
  float* const xs0 = f32_smem;                     // x slices, transposed: 2 x [k][m]
  float* const ws0 = f32_smem + 2 * kFBK * kFBM;   // decoded weight slices: 2 x [k][n]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp computes 4 row groups x 8 column groups; thread (ty, tx) rows
  // 64 h + 4 ty + (0..3), columns 64 h + 4 tx + (0..3)
  const int ty = (warp / 2) * 4 + lane / 8, tx = (warp % 2) * 8 + lane % 8;
  const int m0 = blockIdx.x * kFBM, n0 = blockIdx.y * kFBN;
  const int n16 = (N + 15) / 16 * 16;
  const int nk = (K + kFBK - 1) / kFBK;

  // this thread's loads: kXPieces 16-byte pieces of x, all of row m0 + xm,
  // columns xk + kXStep i .. + 3 of the slice (stored at xoff + kXStep i kFBM
  // + kFBM e for e = 0..3: k & 4 is the same for all of them), and kWPieces
  // 8-byte pieces of the weights, piece p = tid + 256 i at row p / (kFBN / 8),
  // columns 8 (p % (kFBN / 8)).. (a row is a whole number of 8-thread groups,
  // so each group's float4 stores hit 8 distinct bank groups)
  constexpr int kXStep = 8 * kFThreads / (2 * kFBM);
  const int xm = tid % 16 + 16 * ((tid / 32) % (kFBM / 16));
  const int xk = 4 * ((tid / 16) % 2 + 2 * ((tid / (2 * kFBM)) % (kXStep / 8)));
  const int xoff = xs_at(xk, xm);
  const bool xin = m0 + xm < M;
  const float* xg = x + static_cast<size_t>(xin ? m0 + xm : 0) * K + xk;
  constexpr int kRowPieces = kFBN / 8;
  float4 xr[kXPieces];
  uint2 wr[kWPieces];
  auto load = [&](int t) {
    const int k0 = t * kFBK;
#pragma unroll
    for (int i = 0; i < kXPieces; ++i)
      xr[i] = xin && k0 + xk + kXStep * i < K
                  ? *reinterpret_cast<const float4*>(xg + k0 + kXStep * i)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < kWPieces; ++i) {
      const int p = tid + kFThreads * i, k = k0 + p / kRowPieces;
      const int n = n0 + 8 * (p % kRowPieces);
      wr[i] = k < K && n < n16
                  ? *reinterpret_cast<const uint2*>(w + static_cast<size_t>(k) * n16 + n)
                  : make_uint2(0x7F7F7F7Fu, 0x7F7F7F7Fu);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      float* d = xs0 + buf * kFBK * kFBM + xoff + kXStep * i * kFBM;
      d[0] = xr[i].x;
      d[kFBM] = xr[i].y;
      d[2 * kFBM] = xr[i].z;
      d[3 * kFBM] = xr[i].w;
    }
#pragma unroll
    for (int i = 0; i < kWPieces; ++i) {
      const int p = tid + kFThreads * i, c8 = p % kRowPieces;
      float* row = ws0 + buf * kFBK * kFBN + (p / kRowPieces) * kFBN;
      const uint32_t words[2] = {wr[i].x, wr[i].y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // codes 8 c8 + 4 e .. + 3: float4 group 2 c8 + e
        uint32_t lo, hi;
        decode_word(words[e], lo, hi);
        *reinterpret_cast<float4*>(row + 4 * ws_group(2 * c8 + e)) =
            make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xFFFF0000u),
                        __uint_as_float(hi << 16), __uint_as_float(hi & 0xFFFF0000u));
      }
    }
  };

  float acc[kFTM][4 * kFNG];
#pragma unroll
  for (int i = 0; i < kFTM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kFNG; ++j) acc[i][j] = 0.0f;

  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < nk; ++t) {
    const int buf = t & 1;
    if (t + 1 < nk) load(t + 1);   // in flight while this slice computes
    const float* xb = xs0 + buf * kFBK * kFBM;
    const float* wb = ws0 + buf * kFBK * kFBN;
#pragma unroll 8
    for (int k = 0; k < kFBK; ++k) {
      float av[kFTM], bv[4 * kFNG];
#pragma unroll
      for (int h = 0; h < kFTM / 4; ++h)
        *reinterpret_cast<float4*>(av + 4 * h) =
            *reinterpret_cast<const float4*>(&xb[xs_at(k, 64 * h + 4 * ty)]);
#pragma unroll
      for (int h = 0; h < kFNG; ++h)
        *reinterpret_cast<float4*>(bv + 4 * h) =
            *reinterpret_cast<const float4*>(&wb[k * kFBN + 4 * ws_group(16 * h + tx)]);
#pragma unroll
      for (int i = 0; i < kFTM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * kFNG; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read before the previous __syncthreads
    if (t + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kFTM; ++i) {
    const int gm = m0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4 * kFNG; ++j) {
      const int gn = n0 + 64 * (j / 4) + 4 * tx + j % 4;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

int launch_f32(const float* x, const uint8_t* w, int M, int N, int K, float* out,
               cudaStream_t stream) {
  // once, before any CUDA-graph capture can be running
  static cudaError_t raised = cudaFuncSetAttribute(
      pow2_matmul_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
  if (raised != cudaSuccess) return static_cast<int>(raised);
  const dim3 grid((M + kFBM - 1) / kFBM, (N + kFBN - 1) / kFBN);
  pow2_matmul_f32<<<grid, kFThreads, kFSmemBytes, stream>>>(x, w, M, N, K, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

using namespace repro_torch;

// x_bf16: 0 for float32 x, 1 for bfloat16 x. x is (M, K) with K a multiple of
// 8, w is (K, N rounded up to 16) bytes, both 16-byte aligned; out is (M, N).
extern "C" int pow2_matmul_launch(const void* x, int x_bf16, const uint8_t* w, int M, int N,
                                  int K, float* out, void* stream) {
  if (K <= 0 || K % 8 || (N + kBN - 1) / kBN > 65535 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_bf16(x, w, M, N, K, out, s)
                : launch_f32(static_cast<const float*>(x), w, M, N, K, out, s);
}
