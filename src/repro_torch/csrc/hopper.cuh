// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
//   * shared-memory addresses, the wgmma matrix descriptor for 128-byte
//     swizzled tiles (the layout a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
//     writes), and the register fence that keeps the compiler from touching an
//     accumulator or an A fragment while an asynchronous wgmma owns it;
//   * wgmma.fence / commit_group / wait_group and the bf16 wgmma.mma_async
//     forms: m64n128k16 with A and B in shared memory (SS), K-major B or
//     B transposed (MN-major), and m64n128k16 and m64n64k16 with A in
//     registers and B transposed (RS, MN-major B);
//   * mbarrier init, arrive, arrive.expect_tx and try_wait.parity, and the
//     fence that makes barrier inits visible to the TMA unit;
//   * the 2-D and 3-D TMA tile loads (cp.async.bulk.tensor) and
//     fence.proxy.async;
//   * setmaxnreg, which moves registers from a producer warpgroup to the
//     consumer warpgroups;
//   * host helpers that encode a 3-D bf16 CUtensorMap (128-byte swizzle) and a
//     2-D uint8 one (no swizzle). cuTensorMapEncodeTiled
//     lives in libcuda; it is fetched with cudaGetDriverEntryPoint, so the
//     library links against the runtime alone (no -lcuda). <cuda.h> is included
//     for the CUtensorMap type and its enums only.
//
// A tile in shared memory is [rows][64] bf16 per 64-column half: 128 bytes a
// row, swizzled in 1024-byte atoms of 8 rows (the TMA box of 64 columns writes
// exactly this). K-major operands (the reduction dimension contiguous) step
// along K by 32 bytes per k16 slice inside a half and by a half's size across
// halves; MN-major operands (the output dimension contiguous) step along K by
// 16 rows = 2048 bytes. Every tile base is 1024-byte aligned.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- wgmma -------------------------------------------------------------------

// Matrix descriptor of a 128-byte swizzled operand at shared address `addr`:
// bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45 stride
// byte offset >> 4, 62-63 layout (1 = 128-byte swizzle); base offset 0, so
// `addr` lies at a 1024-byte atom boundary plus the k-slice's byte offset.
// K-major: LBO unused (16), SBO = 1024, the step from one 8-row group to the
// next. MN-major: LBO = the step between 64-wide blocks of the M/N dimension,
// SBO = 1024, the step between 8-row groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFFu) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFFu) >> 4) << 32 | 1ull << 62;
}

// Orders the warpgroup's register accesses before the wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers: the compiler may neither read nor reuse them across this
// point, so an asynchronous wgmma's operands stay untouched until its
// wait_group, and its results are read only after it.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_R0_31                                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_R32_63                                                                     \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, " \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_ACC8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC32(i) HOPPER_ACC8(i), HOPPER_ACC8(i + 8), HOPPER_ACC8(i + 16), HOPPER_ACC8(i + 24)

// d (64 x 128, float32, the accumulator fragment) (+)= A (64 x 16) . B (16 x 128),
// A and B bf16 K-major in shared memory. `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R0_31 ", " HOPPER_R32_63
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC32(0), HOPPER_ACC32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with B transposed: B (16 x 128) bf16 MN-major in shared memory (the
// N dimension contiguous, 64-wide blocks LBO apart, 8-row groups along K 1024
// bytes apart, each k16 slice 2048 bytes on).
__device__ __forceinline__ void wgmma_m64n128k16_ss_tb(float (&d)[64], uint64_t a, uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R0_31 ", " HOPPER_R32_63
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : HOPPER_ACC32(0), HOPPER_ACC32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, bf16 pairs in registers: the m64k16 A fragment)
// . B (16 x 128, bf16 MN-major in shared memory: the B operand transposed).
__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_R0_31 ", " HOPPER_R32_63
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(0), HOPPER_ACC32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same for a 64-wide B (d is 64 x 64).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_R0_31
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_R0_31
#undef HOPPER_R32_63
#undef HOPPER_ACC8
#undef HOPPER_ACC32

// -- mbarrier ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the inits visible to the other threads and to the TMA unit.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival, and `bytes` more transaction bytes the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed (the barrier's
// current phase parity differs from it). A wait that lasts longer than
// kWaitCycles (about 10 s) traps: a pipeline fault then ends the kernel with
// an error at the next synchronize instead of hanging its caller.
constexpr long long kWaitCycles = 20000000000LL;
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.b32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// -- TMA ---------------------------------------------------------------------

// Copies the box at coordinates (c0 innermost, c1, c2) of the tensor `map`
// (a __grid_constant__ kernel parameter) to shared address `dst`; completion
// counts the box's bytes on the mbarrier `bar`. Out-of-bounds elements are
// zero-filled.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// The same for a 2-D tensor map: coordinates (c0 innermost, c1).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- registers ---------------------------------------------------------------

// All four warps of a warpgroup execute these together, in the one branch of
// the kernel that the warpgroup runs to its end.
template <uint32_t R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <uint32_t R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- host --------------------------------------------------------------------

// Encodes `map` over a row-major tensor of `rank` dimensions at `base`
// (`dims` innermost first, `strides` the byte steps of dims 1.., `box` the
// tile a load copies), zero fill out of bounds. TMA wants `base` 16-byte
// aligned and every stride a multiple of 16 bytes. Returns 0, or a
// cudaError_t code.
inline int encode_tiled(CUtensorMap* map, CUtensorMapDataType type, uint32_t rank,
                        const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A row-major bf16 tensor (outer, rows, cols): boxes of 64 columns x
// `box_rows` rows x 1, 128-byte swizzle, so a box past `rows` or `cols` never
// reads the next slice of `outer`. `cols` a multiple of 8.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                          uint64_t outer, uint32_t box_rows) {
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};   // bytes, dims 1 and 2
  const cuuint32_t box[3] = {64, box_rows, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
}

// A row-major uint8 tensor (rows, cols), unswizzled boxes of `box_cols` x
// `box_rows` (`box_cols` a multiple of 16). `cols` a multiple of 16.
inline int encode_u8_2d(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
                        uint32_t box_cols, uint32_t box_rows) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {box_cols, box_rows};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

}  // namespace hopper
}  // namespace repro_torch
