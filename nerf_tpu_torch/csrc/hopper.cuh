// PTX helpers shared by the Hopper (sm_90a) kernels of fused_mlp.cu and
// fused_mlp_bwd.cu: mbarriers, 1-D bulk asynchronous copies in both
// directions, named barriers, shared-memory matrix descriptors and the
// wgmma products (bf16 x bf16 -> f32) with their fences.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// never ends (a fault in the ring's bookkeeping) traps rather than hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done, spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One 1-D bulk copy global -> shared; its bytes complete on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One 1-D bulk copy shared -> global, in this thread's current bulk group.
// The shared bytes must have been written before (fence_async_smem and a
// barrier); bulk_commit closes the group, bulk_wait_read<N> waits until at
// most N groups still read shared memory, bulk_wait_all until every group's
// writes are done.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy stores to shared memory, made visible to the async proxy
// (wgmma, bulk copies).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the asynchronous
// products' issue and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// As fence_acc, for a product that starts its sum at zero: the compiler may
// take d as written here, so its registers are free before this point.
template <int R>
__device__ __forceinline__ void fence_acc_start(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "=f"(d[i])::"memory");
}

// p, opaque to the compiler: addresses formed from it are formed where they
// are used, not once before a loop and kept (or spilled) across it.
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  asm volatile("" : "+l"(p));
  return p;
}
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// Shared-memory matrix descriptor, no swizzle (canonical "interleave"
// layout) of 8x16-byte core matrices. K-major operand: lbo = bytes between
// the two core matrices of one k16 step (K direction), sbo = bytes between
// core matrices 8 rows apart (M or N direction). MN-major operand
// (transposed, 8 M or N values in each 16 bytes): lbo = bytes between core
// matrices 8 K-values apart, sbo = bytes between core matrices 8 M or N
// values apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ACC16(i) ACC4(i), ACC4(i + 4), ACC4(i + 8), ACC4(i + 12)
#define ACC64(i) ACC16(i), ACC16(i + 16), ACC16(i + 32), ACC16(i + 48)

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 sums; scale_d = 0 starts
// the sum at zero. TA, TB = 1: that operand is MN-major (transposed). The
// fragment of N columns is d[0 .. N/2 - 1].
template <int N, int TA = 0, int TB = 0, int R>
__device__ __forceinline__ void wgmma_bf16(float (&d)[R], uint64_t da, uint64_t db, int scale_d);

template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma_n256(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert(R >= 128, "m64n256 needs 128 accumulator registers");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : ACC64(0), ACC64(64)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma_n128(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert(R >= 64, "m64n128 needs 64 accumulator registers");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : ACC64(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma_n64(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert(R >= 32, "m64n64 needs 32 accumulator registers");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : ACC16(0), ACC16(16)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma_n32(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert(R >= 16, "m64n32 needs 16 accumulator registers");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : ACC16(0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB, int R>
__device__ __forceinline__ void wgmma_bf16(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256) {
    wgmma_n256<TA, TB>(d, da, db, scale_d);
  } else if constexpr (N == 128) {
    wgmma_n128<TA, TB>(d, da, db, scale_d);
  } else if constexpr (N == 64) {
    wgmma_n64<TA, TB>(d, da, db, scale_d);
  } else {
    static_assert(N == 32, "wgmma widths used here: 256, 128, 64, 32");
    wgmma_n32<TA, TB>(d, da, db, scale_d);
  }
}

#undef ACC64
#undef ACC16
#undef ACC4

// Accumulator fragment of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16w + lane/4 (d[4j], d[4j+1]) and 16w + lane/4 + 8 (d[4j+2], d[4j+3]), at
// columns 8j + 2(lane%4) + {0, 1}.
//
// Two floats rounded to bf16 in one 32-bit word, lo in the low half; with
// RELU, negative values become 0 in the same instruction.
template <bool RELU>
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  if (RELU)
    asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Two bits of a packed bf16 pair: bit 0 when the low value is > 0, bit 1 when
// the high one is (a bf16 is > 0 exactly when its bits, read as a signed
// 16-bit integer, are > 0 and it is not a NaN: +0, -0 and negatives are not;
// the activations this reads are finite).
__device__ __forceinline__ uint32_t positive_bits(uint32_t v) {
  return static_cast<uint32_t>(static_cast<int16_t>(v & 0xffffu) > 0) |
         (static_cast<uint32_t>(static_cast<int32_t>(v) >> 16 > 0) << 1);
}

}  // namespace
