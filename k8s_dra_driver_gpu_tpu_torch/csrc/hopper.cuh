// Hopper (sm_90a) building blocks shared by the port's CUDA kernels:
// mbarriers, TMA tensor-map loads, wgmma descriptors and instructions,
// register rebalancing between warpgroups, the softmax's 2^x and bf16
// packing; for the fp32 kernels cp.async row copies and 3xTF32 mma.sync
// products; and on the host the tensor maps' encoding and checks and the
// C entries' error messages. Raw PTX, so a source that includes this
// header builds in seconds with nvcc alone (no CUTLASS).
//
// Shared-memory tiles that wgmma reads are TMA boxes 64 bf16 (128 bytes)
// wide, stored with the 128-byte swizzle: 8 rows of 128 bytes form one
// 1024-byte atom, and every tile starts on a 1024-byte boundary so that
// the descriptors' base offset is 0. A tile wider than 64 columns is a
// row of such panels, one after another.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace hopper {

// ------------------------------------------------------------ addresses

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// The producer's arrival: the phase completes once `bytes` have landed.
// A TMA box counts whole, including the zero-filled part past the edge.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of the given parity:
// the n-th completion of a barrier has parity n & 1 (n from 0). A fresh
// barrier counts its "previous" phase, parity 1, as complete. The wait
// has no timeout: a trap in the loop (for one) makes ptxas hold the
// consumer warpgroups to the launch's register count (they then spill
// and serialise their wgmma), so a launch whose loads cannot all land is
// refused on the host instead (the C entries check the geometry).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Named barriers 1..15 (0 is __syncthreads) over `threads` threads: some
// arrive without waiting, the others wait until all have come.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ TMA

// One box of a 4-D tensor map into shared memory at `dst`, counted on
// the barrier `bar`. Coordinates are innermost first, in elements.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ------------------------------------------------------------- softmax

// 2^x on the SFU (flushes results below 2^-126 to 0: p that small is 0
// after the bf16 rounding anyway).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to a bf16 pair, lo in the low half: one 32-bit
// register of a wgmma register-A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- register rebalancing

// Only honoured when each role is one branch of a single if/else at the
// top of the kernel that never reconverges (else ptxas warns C7508).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor for the 128-byte swizzle. In units of
// 16 bytes: start address, leading byte offset (LBO), stride byte offset
// (SBO); layout type 1 (B128) in bits 62-63.
//   K-major (Q, K): rows of 64 elements along K; SBO = 1024 (the next 8
//     rows), LBO unused. The k-th 16-wide slice starts 32*k bytes in.
//   MN-major (V read as B of P.V, with the transpose flag): 128-byte rows
//     along N, one row per K index; SBO = 1024 (the next 8 K rows), LBO =
//     the bytes from one 64-wide panel of N to the next.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

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

// Pins registers that an in-flight wgmma reads or writes: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Accumulator layout of m64nNk16 (fp32), thread i of the warpgroup, warp
// w = i / 32, g = (i % 32) / 4, t = i % 4: d[4j + e] is row 16w + g + 8*(e/2),
// column 8j + 2t + (e%2), the mma.sync m16n8 C layout of each warp stacked
// over the four warps. A from registers (bf16x2 pairs) is the mma.sync
// m16n8k16 A layout of each warp, rows 16w..16w+15.

// D (64 x 128, fp32) {=, +=} A (64 x 16, smem) . B (128 x 16, smem), both
// K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                          uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) {=, +=} A (64 x 16, smem) . B (64 x 16, smem), both
// K-major; scale_d = 0 overwrites D. The backward's S = Q.K^T over a
// 64-key tile and its transposed products K.Q^T, V.dO^T over a 64-row
// q tile.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, smem,
// MN-major: the transpose flag).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem,
// MN-major: the transpose flag).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ------------------------------------------------------ cp.async (fp32)

// 16 bytes from global to shared memory, asynchronously; `bytes` = 0
// lands zeros and reads nothing (rows past S).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, the same way (lse and D rows: S * 4 need not be 16-aligned).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [s0, s0 + ROWS) of one head of a [B, S, heads, HD] fp32 operand
// (`src` at that head, `stride_s` elements between positions) into a
// [ROWS][STRIDE] shared tile at `tile`, 16 bytes a copy spread over
// THREADS threads; rows past S land as zeros. Not committed.
template <int HD, int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void cp_async_rows(uint32_t tile, const float* src,
                                              long long stride_s, int s0,
                                              int S) {
  constexpr int kChunks = HD / 4;  // 16-byte copies a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
    const int row = c / kChunks, col = 4 * (c % kChunks), s = s0 + row;
    const bool in = s < S;
    cp_async16(tile + 4u * (row * STRIDE + col),
               src + (in ? s * stride_s + col : 0), in ? 16 : 0);
  }
}

// --------------------------------------------------------- 3xTF32 (fp32)

// fp32 products on the tensor cores: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32; on the bits of a finite fp32 value that is "add half
// a tf32 ulp to the magnitude, clear the 13 low bits"). x - hi is exact
// in fp32, and a.b ~ hi_a.hi_b + hi_a.lo_b + lo_a.hi_b keeps ~21 bits of
// each product (the dropped lo_a.lo_b is ~2^-22 of it); plain TF32 keeps
// ~11.
struct Tf32 {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Tf32 tf32_split(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

// D (16 x 8, fp32) += A (16 x 8, tf32) . B (8 x 8, tf32), one warp.
// Fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k t, n g), b1 (k t + 4, n g);
// D d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The A fragment of one 16 x 8 step, split, from its four fp32 values in
// fragment order.
struct FragA {
  Tf32 x[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  return {{tf32_split(a0), tf32_split(a1), tf32_split(a2), tf32_split(a3)}};
}

// D += A . B in 3xTF32: the two small cross terms first, then hi.hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           float b0, float b1) {
  const Tf32 x = tf32_split(b0), y = tf32_split(b1);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, x.lo, y.lo);
  mma_tf32(d, a.x[0].lo, a.x[1].lo, a.x[2].lo, a.x[3].lo, x.hi, y.hi);
  mma_tf32(d, a.x[0].hi, a.x[1].hi, a.x[2].hi, a.x[3].hi, x.hi, y.hi);
}

// ------------------------------------------------------ host: tensor maps

// cuTensorMapEncodeTiled is a driver API; the library links only the
// runtime, so the function is fetched from the driver once.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
    const bool ok = err == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(ptr) : nullptr;
  }();
  return fn;
}

// Errors of the encoding come back from the C entries as
// kTensorMapError + CUresult, apart from the cudaError_t range.
constexpr int kTensorMapError = 1 << 20;

// A 4-D bf16 tensor map with the 128-byte swizzle. `g` holds, innermost
// dimension first: dims[4], byte strides of dims 1..3, box[4] (elements),
// then the swizzle in bytes, which must be 128. Elements past the edge
// of the tensor land as zeros. Returns 0 or an error code.
inline int encode_bf16_map(CUtensorMap* map, const void* base,
                           const long long* g) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  if (g[11] != 128) return cudaErrorInvalidValue;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], element_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = static_cast<cuuint64_t>(g[i]);
    box[i] = static_cast<cuuint32_t>(g[7 + i]);
  }
  for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(g[4 + i]);
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, element_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(res);
}

// Whether the wrapper's map of a [B, S, heads, hd] operand is the one the
// kernel's barrier byte counts assume: the operand's own dims, and boxes
// 64 columns wide, one head and one batch deep, `rows` long.
inline bool bf16_map_ok(const long long* m, int hd, int heads, int S, int B,
                        int rows) {
  return m[0] == hd && m[1] == heads && m[2] == S && m[3] == B &&
         m[7] == 64 && m[8] == 1 && m[9] == rows && m[10] == 1;
}

// The message of a C entry's error code: a cudaError_t, or
// kTensorMapError + CUresult.
inline const char* error_string(int err) {
  if (err < kTensorMapError) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
  static thread_local char message[96];
  snprintf(message, sizeof(message),
           "cuTensorMapEncodeTiled failed (CUresult %d)",
           err - kTensorMapError);
  return message;
}

}  // namespace hopper
