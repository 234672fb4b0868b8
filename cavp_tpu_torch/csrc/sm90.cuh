// Hopper (sm_90a) building blocks shared by the port's wgmma kernels: the
// fusion chain (fusion_chain_sm90.cuh, for fusion_kernel.cu and
// fusion_train_kernel.cu), the layer1 bottleneck (layer1_kernel.cu) and the
// mel frontend (mel_kernel.cu).
//
// - PTX wrappers: mbarriers, TMA tile loads (2-D and 4-D boxes) and bulk
//   copies of contiguous bytes, bf16 wgmma m64nNk16 with both operands in
//   shared memory, TF32 wgmma m64nNk8 with A from registers, and their
//   descriptors.
// - Host side: tensor maps over row-major bf16 matrices and channels-last
//   maps, 128-byte swizzle, boxes of kPanel (64) columns.
// - A ring of weight slabs in shared memory: one producer thread fills its
//   slots by TMA (full mbarriers count the bytes), the consumer warpgroups
//   free them (empty mbarriers, one arrival a warpgroup). `produce` and
//   `consume_slabs` walk a product's K in slabs in the same order, so the
//   two sides agree on the slot sequence by counting slabs.
//
// Operand layout: a tile buffer is a stack of 64-column panels, one
// 128-byte row per tile row, the 16-byte chunks of row r permuted by r % 8
// (what TMA's 128-byte swizzle writes and wgmma reads); panels start at
// multiples of 1024 bytes, so a K step of 16 columns is 32 bytes further
// in the row and an 8-row step of the M dimension 1024 bytes further.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int kPanel = 64;  // columns of a swizzled panel (128 bytes of bf16)

// Optional per-stage clock64() counters (build with -DCHAIN_STAMPS; see
// scripts/torch_chain_stamps.py): cycles of each consumer warpgroup's
// leader and of the producer warp's lane 0, summed over blocks.
enum Stamp { kTotal, kLoadX, kWaitFull, kMma, kBarrier, kProducer, kWaitEmpty, kStamps };
#ifdef CHAIN_STAMPS
__device__ unsigned long long g_stamps[3 * kStamps];
__shared__ long long s_stamps[3][kStamps];
#define STAMP_BEGIN(name) const long long name = clock64()
#define STAMP_END(k, name)                                        \
  do {                                                            \
    if ((threadIdx.x & 127) == 0) s_stamps[threadIdx.x >> 7][k] += clock64() - name; \
  } while (0)
#else
#define STAMP_BEGIN(name)
#define STAMP_END(k, name)
#endif

// ---- PTX ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// a wait that outlasts ~10 s of clock (a broken schedule) traps: the launch
// then fails instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// this thread's shared-memory writes, before the async proxy (wgmma) reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving other accesses of an accumulator across the
// asynchronous products that write it
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor, 128-byte swizzle: start, LBO, SBO
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// a K-major operand's descriptor: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const void* p) { return desc(p, 0, 1024); }
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// a 2-D box of a tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// a 4-D box (coordinates innermost first; out-of-range parts, negative
// coordinates included, come in as zeros)
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// contiguous bytes (a multiple of 16, 16-byte aligned at both ends) into
// shared memory, completing on bar: for operands laid out in global memory
// as they land, swizzle included
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// m64n176k16, A from shared memory (K-major), B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_ss_176(float (&d)[88], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %90, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68,"
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87}"
      ", %88, %89, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n128k16, A from shared memory (K-major), B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_ss_128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n64k16, A from shared memory (K-major), B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_ss_64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n48k16, A from shared memory (K-major), B from shared memory (MN-major)
__device__ __forceinline__ void wgmma_ss_48(float (&d)[24], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23}"
      ", %24, %25, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}
template <int W>
__device__ __forceinline__ void mma_ss(float (&d)[W / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (W == 176) wgmma_ss_176(d, a, b, acc);
  else if constexpr (W == 128) wgmma_ss_128(d, a, b, acc);
  else if constexpr (W == 64) wgmma_ss_64(d, a, b, acc);
  else {
    static_assert(W == 48, "no wgmma wrapper for this width");
    wgmma_ss_48(d, a, b, acc);
  }
}

// ---- TF32 (the mel frontend's split products) ------------------------------------
// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: the
// 32-bit pattern a .tf32 wgmma reads, low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A thread's A fragment of an m64nNk8 TF32 product from registers: a[0] and
// a[1] are rows r0 and r0 + 8 (Lane::r0) at column tq of the 8-deep step,
// a[2] and a[3] the same rows at column tq + 4. B is K-major: a .tf32 wgmma
// takes no transposed operand.
// m64n120k8 TF32, A from registers, B from shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_tf32_120(float (&d)[60], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %65, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59}"
      ", {%60, %61, %62, %63}, %64, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// m64n128k8 TF32, A from registers, B from shared memory (K-major)
__device__ __forceinline__ void wgmma_rs_tf32_128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void mma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
  if constexpr (N == 120) wgmma_rs_tf32_120(d, a, b, acc);
  else {
    static_assert(N == 128, "no TF32 wgmma wrapper for this width");
    wgmma_rs_tf32_128(d, a, b, acc);
  }
}

// ---- elementwise pieces --------------------------------------------------------
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
// element (row, col) of one swizzled panel (col < kPanel), in elements from
// the panel's start
__device__ __forceinline__ int swz(int row, int col) {
  return row * kPanel + ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}
// (v0, v1) rounded to bf16 at (row, col), (row, col + 1) of a swizzled panel
__device__ __forceinline__ void st2_panel(unsigned char* panel, int row, int col, float v0,
                                          float v1) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(panel) + swz(row, col)) =
      __floats2bfloat162_rn(v0, v1);
}

// A thread's place in an m64 accumulator: register 4j + 2h + e holds row
// r0 + 8h (r0 = 16 * warp + lane / 4) and column c0 + 8j + 2tq + e (tq =
// lane % 4, c0 the warpgroup's first column). A row's columns of one
// warpgroup are held by the four lanes of a quad.
struct Lane {
  int r0, tq, wg;
};
__device__ __forceinline__ Lane lane_of(int tid) {
  const int lane = tid & 31;
  return Lane{((tid & 127) >> 5) * 16 + (lane >> 2), lane & 3, tid >> 7};
}

// ---- the slab ring ---------------------------------------------------------------
__host__ __device__ constexpr int panels(int cols) { return (cols + kPanel - 1) / kPanel; }

template <int Stages, int SlotBytes> struct Ring {
  static constexpr int kStages = Stages, kSlotBytes = SlotBytes;
  unsigned char* slots;
  uint64_t* full;   // the slab has landed (TMA transaction count)
  uint64_t* empty;  // every consumer warpgroup is done with the slot

  // rows of a weight slab of `cols` columns: the most that fit a slot, in
  // steps of 16 (one wgmma K step); the TMA box of that matrix is this tall
  __host__ __device__ static constexpr int slab_rows(int cols) {
    return kSlotBytes / (panels(cols) * kPanel * 2) / 16 * 16;
  }
  // the mbarriers: full counts one arrival (the producer's), empty one a
  // consumer warpgroup
  __device__ void init(int consumer_warpgroups) const {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], consumer_warpgroups);
    }
  }
};

// ---- the producer: one thread ----------------------------------------------------
// rows [y0, y0 + K) and columns [x0, x0 + cols) of a weight matrix into the
// ring, slab after slab: slab s goes to slot s % kStages as panels(cols)
// swizzled panels of slab_rows(cols) rows x kPanel columns, one TMA box each
// (rows or columns past the matrix come in as zeros; rows past K are loaded
// and not read)
template <class R>
__device__ void produce(const R& ring, uint32_t& s, const CUtensorMap* map, int x0, int y0, int K,
                        int cols) {
  const int kd = R::slab_rows(cols), np = panels(cols);
  for (int k0 = 0; k0 < K; k0 += kd, ++s) {
    const int slot = s % R::kStages;
    STAMP_BEGIN(t0);
    mbar_wait(&ring.empty[slot], ((s / R::kStages) & 1) ^ 1);
    STAMP_END(kWaitEmpty, t0);
    mbar_expect_tx(&ring.full[slot], np * kd * kPanel * 2);
    unsigned char* dst = ring.slots + slot * R::kSlotBytes;
    for (int p = 0; p < np; ++p)
      tma_load(dst + p * kd * kPanel * 2, map, x0 + p * kPanel, y0 + k0, &ring.full[slot]);
  }
}

// ---- the consumers: warpgroups of 128 threads -------------------------------------
// the consumer warpgroups (kThreads threads) meet at named barrier 1
template <int kThreads> __device__ __forceinline__ void bar_sync() {
  STAMP_BEGIN(t0);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
  STAMP_END(kBarrier, t0);
}

template <class R> __device__ __forceinline__ void release(const R& ring, uint32_t s) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(&ring.empty[s % R::kStages]);
}

// A product of K rows of weights `cols` wide, slab after slab from the ring:
// per slab, issue(kk, b) issues the warpgroup's wgmmas of each of its K
// steps (kk counts K steps of 16 from the product's start; b is the
// descriptor of the slab's first panel at that step). The products of a
// slab are committed as one group and its slot is freed once they are done,
// one slab behind.
template <class R, class Issue>
__device__ void consume_slabs(const R& ring, uint32_t& s, int K, int cols, Issue issue) {
  const int kd = R::slab_rows(cols);
  STAMP_BEGIN(t0);
  long long waited = 0;
  for (int k0 = 0; k0 < K; k0 += kd, ++s) {
    const int kr = min(kd, K - k0);
    STAMP_BEGIN(t1);
    mbar_wait(&ring.full[s % R::kStages], (s / R::kStages) & 1);
#ifdef CHAIN_STAMPS
    waited += clock64() - t1;
#endif
    const unsigned char* B = ring.slots + (s % R::kStages) * R::kSlotBytes;
    wgmma_fence();
    for (int ks = 0; ks < kr / 16; ++ks) issue(k0 / 16 + ks, B + ks * 2048, kd * kPanel * 2);
    wgmma_commit();
    if (k0 > 0) {  // the products of the slab before are done
      wgmma_wait<1>();
      release(ring, s - 1);
    }
  }
  wgmma_wait<0>();
  release(ring, s - 1);
#ifdef CHAIN_STAMPS
  if ((threadIdx.x & 127) == 0) {
    s_stamps[threadIdx.x >> 7][kWaitFull] += waited;
    s_stamps[threadIdx.x >> 7][kMma] += clock64() - t0 - waited;
  }
#endif
  (void)waited;
}

// ---- host: tensor maps -------------------------------------------------------------
// a tensor map over a row-major bf16 matrix [rows, cols] with boxes of
// kPanel columns x box_rows rows, 128-byte swizzle
inline int make_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kPanel, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a tensor map over a channels-last bf16 map [B, H, W, C] with boxes of
// kPanel channels x box_w columns x box_h rows of one image, 128-byte
// swizzle: a box lands as box_h * box_w rows of one panel
inline int make_map_nhwc(CUtensorMap* map, const void* p, int B, int H, int W, int C, int box_w,
                         int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(bf16), (cuuint64_t)W * C * sizeof(bf16),
                                 (cuuint64_t)H * W * C * sizeof(bf16)};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the device's SM count, for a persistent grid
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

}  // namespace sm90
}  // namespace
