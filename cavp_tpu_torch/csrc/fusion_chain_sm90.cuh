// The bf16 token chain of the fusion kernels on Hopper (sm_90a): shared by
// the eval kernel (fusion_kernel.cu, `cavp_fused_visual_fusion`) and the
// train kernel's forward (fusion_train_kernel.cu, `cavp_fusion_train_fwd`).
// Per visual token, with the image's rank-1 gate factors (one pair for the
// eval chain, two for the train chain's dup = 2):
//
//   eval:  h = gelu(x @ W1 + b1);  a = LN1(h @ W2f + b2f)        (fc2 folded)
//   train: t1 = gelu(x @ W1 + b1); t2 = t1 @ W2 + b2; a = LN1(t2 @ Wpe + bpe)
//   for each gate pair d:
//     g  = sigmoid((a @ wqk[d]) * hd^-1/2);  t4 = a + (g @ m[d] + bp)
//     t5 = t4 + (gelu(LN2(t4) @ Wm1 + bm1) @ Wm2 + bm2);  y[d] = LN3(t5)
//
// Rounding points: those of the TPU bodies. The eval chain rounds to bf16
// after each product, each bias add, each GELU and each LayerNorm; the train
// chain takes fc1's and the MLP's GELU in float on the float sum plus bias
// and rounds once. LayerNorm statistics are float, on the rounded values.
//
// Bound on the H100: ~1.8 MFLOP (eval) or ~3.5 MFLOP (train) per token
// against ~1.2 KB of token IO, so the chain is bound by tensor-core
// operations. What held the earlier 32-token WMMA kernels far from that was
// re-reading the 1.8 MB of weights from L2 for every 32 tokens (21 GB per
// eval call), per warp and unstaged, and a float scratch round trip for
// every epilogue. The design:
//
// - Tiles of 64 tokens (kRows) on a persistent grid of one block per SM,
//   walking the (image, tile) pairs in order t = blockIdx.x + i * gridDim.x.
//   Two consumer warpgroups share each tile and split every product by
//   columns, at a 64-column boundary (C = 304: 128 and 176), so a 304-wide
//   float row costs a thread at most 88 registers. (A warpgroup per 64 rows
//   of a 128-token tile held the MLP's whole [64, 304] float sum, 152
//   registers, and ptxas spilled around every wgmma even at the 240 that
//   setmaxnreg can give.) The price: the weights are read once per 64
//   tokens (1.8 MB of L2 reads per tile, 10.5 GB per eval call, half of the
//   32-token kernels'), and the halves meet in shared memory for each
//   LayerNorm's statistics and the gate's dot products.
// - A producer warp streams every weight slab once per tile with TMA into
//   a ring of kStages shared-memory slots that both warpgroups read (full
//   and empty mbarriers). The ring runs across the chain's products: the
//   slab order is fixed (fc1, fc2 [, patch_embed_v], then per gate pair and
//   per C-column hidden chunk Wm1[:, chunk] and Wm2[chunk, :]), so the
//   producer walks it on its own, held back only by free slots, and loads
//   the next product's first slabs while the consumers run an epilogue. The
//   train chain's two gate pairs re-stream the MLP weights (1.5 MB do not
//   fit). The tile's x arrives by TMA too; the tensor maps are made per call
//   on the host (a few microseconds).
// - Products: wgmma m64nNk16 from shared memory with float accumulators in
//   registers. A (the tile's rows, K-major) and B (a weight slab, MN-major:
//   the weights are row-major [in, out]) are in 128-byte-swizzled panels of
//   64 columns, the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.
//   (Unswizzled 8x8 core matrices, tried first, ran the products at a tenth
//   of the tensor rate.)
// - Epilogues on the accumulator fragments: bias, rounding, GELU, the
//   residual, the LayerNorm statistics (sum, then the centred sum of
//   squares of the rounded values: quad shuffles, then the two halves'
//   partials added in a fixed order through shared memory), the gate's four
//   dot products the same way, and g @ m. Results go to shared memory only
//   where a later product reads them, as bf16 in its A layout. t4 is not
//   kept: it is rebuilt from a and the rounded gate, with the same
//   operations, where the residual needs it.
// - The ragged last tile of an image runs on whatever rows follow it (the
//   next image's, or zeros past the tensor's end) and is masked on store,
//   with no host padding.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
namespace chain {

typedef __nv_bfloat16 bf16;

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

constexpr int kRows = 64;              // tokens per tile
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and a producer warpgroup
// registers a thread after the hand-over: the producer warpgroup (one thread
// of it streams the ring, the others leave) gives its share to the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 4;        // ring slots
constexpr int kSlotBytes = 20480;  // bytes per slot
constexpr int kPanel = 64;        // columns of a swizzled panel (128 bytes of bf16)
constexpr int kHidden = 256;      // projector hidden width
constexpr int kHeads = 4;

struct Args {
  // x [B, N, C]; wqk [B, dup, C, heads]; m [B, dup, heads, C]. eval: w2 =
  // fc2 folded with patch_embed_v, b2 its bias, wpe/bpe unused; g1..c3 the
  // LayerNorm affines. x and the five matrices are read through tensor maps.
  const bf16 *x, *wqk, *m, *w1, *b1, *w2, *b2, *wpe, *bpe, *g1, *c1, *bp, *g2, *c2, *wm1, *bm1, *wm2, *bm2,
      *g3, *c3;
  bf16* y;  // [dup, B, N, C]
  int B, N, mh;
  float scale;
};

// the kernel's parameters: the arguments and the tensor maps of x [B * N, C]
// and of the five weight matrices (boxes of kPanel columns)
struct Params {
  CUtensorMap x, w1, w2, wpe, wm1, wm2;
  Args a;
};


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

// ---- shapes and shared memory ------------------------------------------------
// C with an instantiation: the DeepLab feature of the ResNet-50 model and of
// the ResNet-18 one. The MLP's hidden is walked in chunks of C columns.
constexpr int kWideC = 304;
constexpr int kNarrowC = 112;

// The shapes the bf16 chain takes: C in {kWideC, kNarrowC}, hidden kHidden,
// mlp_hidden a positive multiple of C, kHeads heads.
inline bool supported(int C, int hidden, int mlp_hidden, int heads) {
  return (C == kWideC || C == kNarrowC) && hidden == kHidden && mlp_hidden > 0 &&
         mlp_hidden % C == 0 && heads == kHeads;
}

__host__ __device__ constexpr int panels(int cols) { return (cols + kPanel - 1) / kPanel; }
// the first warpgroup's columns of a product `cols` wide: the panel boundary
// that leaves the larger half smallest
__host__ __device__ constexpr int split(int cols) {
  return cols / 2 / kPanel * kPanel > 0 && cols - cols / 2 / kPanel * kPanel <=
                                               cols / 2 / kPanel * kPanel + kPanel
             ? cols / 2 / kPanel * kPanel
             : cols / 2 / kPanel * kPanel + kPanel;
}
// rows of a weight slab of `cols` columns: the most that fit a slot, in
// steps of 16 (one wgmma K step); the TMA box of that matrix is this tall
__host__ __device__ constexpr int slab_rows(int cols) {
  return kSlotBytes / (panels(cols) * kPanel * 2) / 16 * 16;
}
constexpr int kPanelBytes = kRows * kPanel * 2;  // a [kRows, kPanel] panel of a tile buffer

// R1 [kRows, C], R2 [kRows, max(C, kHidden)], the hidden chunk [kRows, C]
// (bf16, swizzled panels); the ring; two exchange slots [2][kRows][kHeads]
// and the gate [kRows][kHeads] (float); 2 kStages + 1 mbarriers; and the
// slack to align the start to 1024 bytes (the swizzle's period)
__host__ __device__ constexpr size_t smem_bytes(int C) {
  return (size_t)kPanelBytes * (2 * panels(C) + panels(C > kHidden ? C : kHidden)) +
         (size_t)kStages * kSlotBytes + sizeof(float) * 5 * kRows * kHeads +
         sizeof(uint64_t) * (2 * kStages + 1) + 1024;
}

struct Ring {
  unsigned char* slots;
  uint64_t* full;   // the slab has landed (TMA transaction count)
  uint64_t* empty;  // both consumer warpgroups are done with the slot (2 arrivals)
};

// ---- the producer: one thread ----------------------------------------------------
// rows [y0, y0 + K) and columns [x0, x0 + cols) of a weight matrix into the
// ring, slab after slab: slab s goes to slot s % kStages as panels(cols)
// swizzled panels of slab_rows(cols) rows x kPanel columns, one TMA box each
// (rows or columns past the matrix come in as zeros; rows past K are loaded
// and not read)
__device__ void produce(const Ring& ring, uint32_t& s, const CUtensorMap* map, int x0, int y0,
                        int K, int cols) {
  const int kd = slab_rows(cols), np = panels(cols);
  for (int k0 = 0; k0 < K; k0 += kd, ++s) {
    const int slot = s % kStages;
    STAMP_BEGIN(t0);
    mbar_wait(&ring.empty[slot], ((s / kStages) & 1) ^ 1);
    STAMP_END(kWaitEmpty, t0);
    mbar_expect_tx(&ring.full[slot], np * kd * kPanel * 2);
    unsigned char* dst = ring.slots + slot * kSlotBytes;
    for (int p = 0; p < np; ++p)
      tma_load(dst + p * kd * kPanel * 2, map, x0 + p * kPanel, y0 + k0, &ring.full[slot]);
  }
}

// ---- the consumers: two warpgroups, one part of the columns each -----------------
__device__ __forceinline__ void consumer_barrier() {
  STAMP_BEGIN(t0);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
  STAMP_END(kBarrier, t0);
}

__device__ __forceinline__ void release(const Ring& ring, uint32_t s) {
  if ((threadIdx.x & 127) == 0) mbar_arrive(&ring.empty[s % kStages]);
}

// acc (+)= A[0:kRows, 0:K] @ W[0:K, n0 : n0 + Wd], W from the ring in slabs
// `cols` wide (n0 a multiple of kPanel); A a tile buffer of swizzled panels
template <int Wd>
__device__ void consume(const Ring& ring, uint32_t& s, float (&acc)[Wd / 2],
                        const unsigned char* A, int K, int cols, int n0, bool accumulate) {
  const int kd = slab_rows(cols);
  STAMP_BEGIN(t0);
  long long waited = 0;
  fence_regs(acc);
  for (int k0 = 0; k0 < K; k0 += kd, ++s) {
    const int kr = min(kd, K - k0);
    STAMP_BEGIN(t1);
    mbar_wait(&ring.full[s % kStages], (s / kStages) & 1);
#ifdef CHAIN_STAMPS
    waited += clock64() - t1;
#endif
    const unsigned char* B = ring.slots + (s % kStages) * kSlotBytes + (n0 / kPanel) * kd * kPanel * 2;
    wgmma_fence();
    for (int ks = 0; ks < kr / 16; ++ks) {
      const int kk = k0 / 16 + ks;  // the K step in A: panel kk / 4, 32 bytes a step
      mma_ss<Wd>(acc, desc(A + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 0, 1024),
                 desc(B + ks * 2048, kd * kPanel * 2, 1024), accumulate || kk > 0);
    }
    wgmma_commit();
    if (k0 > 0) {  // the products of the slab before are done
      wgmma_wait<1>();
      release(ring, s - 1);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(ring, s - 1);
#ifdef CHAIN_STAMPS
  if ((threadIdx.x & 127) == 0) {
    s_stamps[threadIdx.x >> 7][kWaitFull] += waited;
    s_stamps[threadIdx.x >> 7][kMma] += clock64() - t0 - waited;
  }
#endif
  (void)waited;
}

// ---- elementwise pieces --------------------------------------------------------
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }
// the eval body's GELU, on a rounded sum plus bias, and the train body's, on
// the float sum plus bias (each as its TPU body and plain version write it)
template <bool kTrain> __device__ __forceinline__ float hidden_act(float acc, float bias) {
  if constexpr (kTrain) {
    const float v = acc + bias;
    return rnd(v * (0.5f * (1.0f + erff(v * 0.7071067811865476f))));
  } else {
    const float v = rnd(rnd(acc) + bias);
    return rnd(0.5f * v * (1.0f + erff(v * 0.7071067811865476f)));
  }
}
// element (row, col) of a tile buffer: swizzled panels of kPanel columns,
// 128 bytes a row, the 16-byte chunks of a row permuted by row % 8 (what
// TMA's 128-byte swizzle writes and wgmma reads)
__device__ __forceinline__ int at(int row, int col) {
  return (col >> 6) * (kRows * kPanel) + row * kPanel + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}
__device__ __forceinline__ void st2(unsigned char* buf, int row, int col, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(buf) + at(row, col)) =
      __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 ls2(const unsigned char* buf, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const bf16*>(buf) + at(row, col)));
}

// A thread's place in an m64 accumulator: register 4j + 2h + e holds row
// r0 + 8h (r0 = 16 * warp + lane / 4) and column c0 + 8j + 2tq + e (tq =
// lane % 4, c0 the warpgroup's first column). A row's columns of one
// warpgroup are held by the four lanes of a quad.
struct Lane {
  int r0, tq, wg;
};

// a warpgroup's W columns of a product's [kRows, cols] result, from column c0
template <int W> struct Frag {
  float v[W / 2];
  int c0;
};

// fn(h, row, col, v0, v1) for each pair of neighbouring columns the thread
// holds, in rows r0 (h = 0) and r0 + 8 (h = 1)
template <int W, typename Fn>
__device__ __forceinline__ void each_pair(Frag<W>& f, const Lane& l, Fn fn) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fn(h, l.r0 + 8 * h, f.c0 + 8 * j + 2 * l.tq, f.v[4 * j + 2 * h], f.v[4 * j + 2 * h + 1]);
}

// v[h][k] <- the sum over the whole row r0 + 8h of the thread's partial
// v[h][k]: quad shuffles, then the two warpgroups' partials through shared
// memory, added in a fixed order. Two slots alternate, so a slot is
// rewritten only after a barrier that follows every read of it.
struct Exchange {
  float* slots;  // 2 x [2][kRows][kHeads]
  uint32_t n;
};
template <int K>
__device__ __forceinline__ void row_sums(Exchange& x, const Lane& l, float (&v)[2][K]) {
  float* slot = x.slots + (x.n++ & 1) * 2 * kRows * kHeads;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < K; ++k) v[h][k] = quad_sum(v[h][k]);
  if (l.tq == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < K; ++k) slot[(l.wg * kRows + l.r0 + 8 * h) * kHeads + k] = v[h][k];
  consumer_barrier();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = (l.r0 + 8 * h) * kHeads + k;
      v[h][k] = slot[r] + slot[kRows * kHeads + r];
    }
}

// v = rnd(rnd(v) + bias[col])
template <int W>
__device__ __forceinline__ void add_bias(Frag<W>& f, const Lane& l, const bf16* bias) {
  each_pair(f, l, [&](int, int, int c, float& v0, float& v1) {
    const float2 b = ld2(bias + c);
    v0 = rnd(rnd(v0) + b.x);
    v1 = rnd(rnd(v1) + b.y);
  });
}

// v = rnd(LN(v) * gamma + beta) over rows of C: the mean, then the centred
// sum of squares, of the (already rounded) values
template <int C, int W>
__device__ __forceinline__ void layernorm(Frag<W>& f, const Lane& l, Exchange& x,
                                          const bf16* gamma, const bf16* beta) {
  float s[2][1] = {{0.f}, {0.f}};
#pragma unroll
  for (int i = 0; i < W / 2; ++i) s[(i >> 1) & 1][0] += f.v[i];
  row_sums(x, l, s);
  const float mu[2] = {s[0][0] / C, s[1][0] / C};
  s[0][0] = s[1][0] = 0.f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float d = f.v[i] - mu[(i >> 1) & 1];
    s[(i >> 1) & 1][0] += d * d;
  }
  row_sums(x, l, s);
  const float r[2] = {rsqrtf(s[0][0] / C + 1e-5f), rsqrtf(s[1][0] / C + 1e-5f)};
  each_pair(f, l, [&](int h, int, int c, float& v0, float& v1) {
    const float2 gm = ld2(gamma + c), bt = ld2(beta + c);
    v0 = rnd((v0 - mu[h]) * r[h] * gm.x + bt.x);
    v1 = rnd((v1 - mu[h]) * r[h] * gm.y + bt.y);
  });
}

// the gate's output added to a: rnd(a + rnd(rnd(sum_h gt[h] m[h, c]) + bp[c]))
__device__ __forceinline__ float gated(float a, const float (&gt)[kHeads], const float (&m)[kHeads],
                                       float bp) {
  float o = 0.f;
#pragma unroll
  for (int hd = 0; hd < kHeads; ++hd) o = fmaf(gt[hd], m[hd], o);
  return rnd(a + rnd(rnd(o) + bp));
}

// gt[h] = rnd(sigmoid((a @ wqk) * scale)) for the thread's rows
template <int W>
__device__ __forceinline__ void gate_of(Frag<W>& f, const Lane& l, Exchange& x, const bf16* wqk,
                                        float scale, float (&gt)[2][kHeads]) {
  float s[2][kHeads] = {};
  each_pair(f, l, [&](int h, int, int c, float& v0, float& v1) {
    const float2 w0a = ld2(wqk + c * kHeads), w0b = ld2(wqk + c * kHeads + 2);
    const float2 w1a = ld2(wqk + (c + 1) * kHeads), w1b = ld2(wqk + (c + 1) * kHeads + 2);
    const float w0[kHeads] = {w0a.x, w0a.y, w0b.x, w0b.y}, w1[kHeads] = {w1a.x, w1a.y, w1b.x, w1b.y};
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) s[h][hd] += v0 * w0[hd] + v1 * w1[hd];
  });
  row_sums(x, l, s);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) gt[h][hd] = rnd(sigmoid(s[h][hd] * scale));
}

// v = gated(a, gt, m[:, c], bp[c]) with a in v; or, given A, t5 = t4 + v
// with t4 rebuilt from a in A
template <int C, int W>
__device__ __forceinline__ void add_gate(Frag<W>& f, const Lane& l, const float (&gt)[2][kHeads],
                                         const bf16* m, const bf16* bp, const unsigned char* A) {
  each_pair(f, l, [&](int h, int r, int c, float& v0, float& v1) {
    float m0[kHeads], m1[kHeads];
#pragma unroll
    for (int hd = 0; hd < kHeads; ++hd) {
      const float2 mv = ld2(m + hd * C + c);
      m0[hd] = mv.x;
      m1[hd] = mv.y;
    }
    const float2 b = ld2(bp + c);
    if (A == nullptr) {
      v0 = gated(v0, gt[h], m0, b.x);
      v1 = gated(v1, gt[h], m1, b.y);
    } else {
      const float2 av = ls2(A, r, c);
      v0 = rnd(gated(av.x, gt[h], m0, b.x) + v0);
      v1 = rnd(gated(av.y, gt[h], m1, b.y) + v1);
    }
  });
}

// the shared memory of a block
struct Smem {
  unsigned char *R1, *R2, *Hc;  // x, then eval: a; train: t2, then b4 | fc1's output, then
                                // eval: b4; train: a | the MLP's hidden chunk
  float *XS, *G;                // the exchange slots; the rounded gate [kRows][kHeads]
  uint64_t* xbar;               // the tile's x has landed
};

// One consumer warpgroup's walk over the tiles: Wc of the C-wide products'
// columns from c0, Wh of fc1's from h0.
template <bool kTrain, int C, int Wc, int Wh>
__device__ void consumer(const Params& P, const Ring& ring, const Smem& sm, const Lane& l, int c0,
                         int h0) {
  constexpr int kDup = kTrain ? 2 : 1, kH = kHidden;
  const Args& a = P.a;
  const int tiles = (a.N + kRows - 1) / kRows, total = a.B * tiles;
  unsigned char* Aw = kTrain ? sm.R2 : sm.R1;  // a
  unsigned char* Bw = kTrain ? sm.R1 : sm.R2;  // b4
  Exchange x{sm.XS, 0};
  uint32_t s = 0;  // slabs so far, the same count as the producer's
  STAMP_BEGIN(t_all);
  for (int t = blockIdx.x, i = 0; t < total; t += gridDim.x, ++i) {
    const int b = t / tiles, tok0 = (t % tiles) * kRows;

    // x -> R1 by TMA, rows [b N + tok0, + kRows) of x [B N, C]
    STAMP_BEGIN(t_x);
    fence_async_smem();
    consumer_barrier();  // the previous tile's readers of R1 are done
    if (threadIdx.x == 0) {
      mbar_expect_tx(sm.xbar, panels(C) * kPanelBytes);
      for (int p = 0; p < panels(C); ++p)
        tma_load(sm.R1 + p * kPanelBytes, &P.x, p * kPanel, b * a.N + tok0, sm.xbar);
    }
    mbar_wait(sm.xbar, i & 1);
    STAMP_END(kLoadX, t_x);

    // fc1 + GELU -> R2
    {
      Frag<Wh> h{{}, h0};
      consume<Wh>(ring, s, h.v, sm.R1, C, kH, h0, false);
      each_pair(h, l, [&](int, int r, int c, float& v0, float& v1) {
        const float2 bb = ld2(a.b1 + c);
        st2(sm.R2, r, c, hidden_act<kTrain>(v0, bb.x), hidden_act<kTrain>(v1, bb.y));
      });
    }
    fence_async_smem();
    consumer_barrier();

    // fc2 [+ patch_embed_v], LN1 -> a, kept in f and in Aw
    Frag<Wc> f{{}, c0};
    consume<Wc>(ring, s, f.v, sm.R2, kH, C, c0, false);
    add_bias(f, l, a.b2);
    if (kTrain) {
      each_pair(f, l, [&](int, int r, int c, float& v0, float& v1) { st2(sm.R1, r, c, v0, v1); });
      fence_async_smem();
      consumer_barrier();
      consume<Wc>(ring, s, f.v, sm.R1, C, C, c0, false);
      add_bias(f, l, a.bpe);
    }
    layernorm<C>(f, l, x, a.g1, a.c1);
    each_pair(f, l, [&](int, int r, int c, float& v0, float& v1) { st2(Aw, r, c, v0, v1); });

    for (int d = 0; d < kDup; ++d) {
      const size_t pair = (size_t)b * kDup + d;
      const bf16* m = a.m + pair * kHeads * C;
      if (d > 0)  // a, from the thread's own entries of Aw
        each_pair(f, l, [&](int, int r, int c, float& v0, float& v1) {
          const float2 v = ls2(Aw, r, c);
          v0 = v.x;
          v1 = v.y;
        });

      // the gate -> t4, LN2 -> b4 in Bw; the rounded gate in G for the residual
      float gt[2][kHeads];
      gate_of(f, l, x, a.wqk + pair * C * kHeads, a.scale, gt);
      add_gate<C>(f, l, gt, m, a.bp, nullptr);
      if (l.wg == 0 && l.tq == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int hd = 0; hd < kHeads; ++hd) sm.G[(l.r0 + 8 * h) * kHeads + hd] = gt[h][hd];
      layernorm<C>(f, l, x, a.g2, a.c2);
      each_pair(f, l, [&](int, int r, int c, float& v0, float& v1) { st2(Bw, r, c, v0, v1); });
      fence_async_smem();
      consumer_barrier();

      // the MLP, C hidden columns a pass; Wm2's float sums stay in f
      for (int k0 = 0; k0 < a.mh; k0 += C) {
        {
          Frag<Wc> h{{}, c0};
          consume<Wc>(ring, s, h.v, Bw, C, C, c0, false);
          if (k0 > 0) consumer_barrier();  // the other warpgroup is done reading Hc
          each_pair(h, l, [&](int, int r, int c, float& v0, float& v1) {
            const float2 bb = ld2(a.bm1 + k0 + c);
            st2(sm.Hc, r, c, hidden_act<kTrain>(v0, bb.x), hidden_act<kTrain>(v1, bb.y));
          });
        }
        fence_async_smem();
        consumer_barrier();
        consume<Wc>(ring, s, f.v, sm.Hc, C, C, c0, k0 > 0);
      }

      // t5 = t4 + rnd(rnd(mlp) + bm2), t4 rebuilt from a and the gate; LN3 -> y
      add_bias(f, l, a.bm2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int hd = 0; hd < kHeads; ++hd) gt[h][hd] = sm.G[(l.r0 + 8 * h) * kHeads + hd];
      add_gate<C>(f, l, gt, m, a.bp, Aw);
      layernorm<C>(f, l, x, a.g3, a.c3);
      bf16* y = a.y + ((size_t)d * a.B + b) * a.N * C;
      each_pair(f, l, [&](int, int r, int c, float& v0, float& v1) {
        if (tok0 + r < a.N)
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(tok0 + r) * C + c) =
              __floats2bfloat162_rn(v0, v1);
      });
    }
  }
  STAMP_END(kTotal, t_all);
}

// ---- the kernel -------------------------------------------------------------------
template <bool kTrain, int C>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(const __grid_constant__ Params P) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kDup = kTrain ? 2 : 1, kH = kHidden;
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Smem sm;
  sm.R1 = base;
  sm.R2 = sm.R1 + panels(C) * kPanelBytes;
  sm.Hc = sm.R2 + panels(C > kH ? C : kH) * kPanelBytes;
  unsigned char* slots = sm.Hc + panels(C) * kPanelBytes;
  sm.XS = reinterpret_cast<float*>(slots + kStages * kSlotBytes);
  sm.G = sm.XS + 4 * kRows * kHeads;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm.G + kRows * kHeads);
  const Ring ring{slots, bars, bars + kStages};
  sm.xbar = bars + 2 * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&ring.full[i], 1);
      mbar_init(&ring.empty[i], 2);
    }
    mbar_init(sm.xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#ifdef CHAIN_STAMPS
  if (threadIdx.x < 3 * kStamps) s_stamps[threadIdx.x / kStamps][threadIdx.x % kStamps] = 0;
#endif
  __syncthreads();

  const Args& a = P.a;
  const int tid = threadIdx.x;
  if (tid >= kConsumerThreads) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid > kConsumerThreads) return;
    STAMP_BEGIN(t0);
    const int total = a.B * ((a.N + kRows - 1) / kRows);
    uint32_t s = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      produce(ring, s, &P.w1, 0, 0, C, kH);
      produce(ring, s, &P.w2, 0, 0, kH, C);
      if (kTrain) produce(ring, s, &P.wpe, 0, 0, C, C);
      for (int d = 0; d < kDup; ++d)
        for (int k0 = 0; k0 < a.mh; k0 += C) {
          produce(ring, s, &P.wm1, k0, 0, C, C);
          produce(ring, s, &P.wm2, 0, k0, C, C);
        }
    }
    STAMP_END(kProducer, t0);
#ifdef CHAIN_STAMPS
    for (int k = 0; k < kStamps; ++k)
      atomicAdd(&g_stamps[2 * kStamps + k], (unsigned long long)s_stamps[2][k]);
#endif
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7, lane = tid & 31;
  const Lane l{((tid & 127) >> 5) * 16 + (lane >> 2), lane & 3, wg};
  constexpr int kSc = split(C), kSh = split(kH);
  if (wg == 0)
    consumer<kTrain, C, kSc, kSh>(P, ring, sm, l, 0, 0);
  else
    consumer<kTrain, C, C - kSc, kH - kSh>(P, ring, sm, l, kSc, kSh);
#ifdef CHAIN_STAMPS
  if ((tid & 127) == 0)
    for (int k = 0; k < kStamps; ++k)
      atomicAdd(&g_stamps[wg * kStamps + k], (unsigned long long)s_stamps[wg][k]);
#endif
}

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

// Launch the persistent chain on `stream`: one block per SM, or one per tile
// where there are fewer tiles. Returns a cudaError_t.
template <bool kTrain, int C> int launch_width(const Args& a, cudaStream_t stream) {
  const long long total = (long long)a.B * ((a.N + kRows - 1) / kRows);
  if (total == 0) return 0;
  Params P{};
  P.a = a;
  const int kd = slab_rows(C);
  int err = make_map(&P.x, a.x, a.B * a.N, C, kRows);
  if (!err) err = make_map(&P.w1, a.w1, C, kHidden, slab_rows(kHidden));
  if (!err) err = make_map(&P.w2, a.w2, kHidden, C, kd);
  if (!err && kTrain) err = make_map(&P.wpe, a.wpe, C, C, kd);
  if (!err) err = make_map(&P.wm1, a.wm1, C, a.mh, kd);
  if (!err) err = make_map(&P.wm2, a.wm2, a.mh, C, kd);
  if (err) return err;
  const auto kernel = chain_kernel<kTrain, C>;
  const size_t smem = smem_bytes(C);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  kernel<<<(unsigned)(total < sms ? total : sms), kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <bool kTrain> int launch(const Args& a, int C, cudaStream_t stream) {
  return C == kWideC ? launch_width<kTrain, kWideC>(a, stream)
                     : launch_width<kTrain, kNarrowC>(a, stream);
}

}  // namespace chain
}  // namespace
