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

#include "sm90.cuh"

namespace {
namespace chain {

using namespace sm90;

constexpr int kRows = 64;              // tokens per tile
constexpr int kConsumerThreads = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and a producer warpgroup
// registers a thread after the hand-over: the producer warpgroup (one thread
// of it streams the ring, the others leave) gives its share to the consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 4;        // ring slots
constexpr int kSlotBytes = 20480;  // bytes per slot
typedef sm90::Ring<kStages, kSlotBytes> Ring;
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

// the first warpgroup's columns of a product `cols` wide: the panel boundary
// that leaves the larger half smallest
__host__ __device__ constexpr int split(int cols) {
  return cols / 2 / kPanel * kPanel > 0 && cols - cols / 2 / kPanel * kPanel <=
                                               cols / 2 / kPanel * kPanel + kPanel
             ? cols / 2 / kPanel * kPanel
             : cols / 2 / kPanel * kPanel + kPanel;
}
__host__ __device__ constexpr int slab_rows(int cols) { return Ring::slab_rows(cols); }
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

// ---- the consumers: two warpgroups, one part of the columns each -----------------
__device__ __forceinline__ void consumer_barrier() { bar_sync<kConsumerThreads>(); }

// acc (+)= A[0:kRows, 0:K] @ W[0:K, n0 : n0 + Wd], W from the ring in slabs
// `cols` wide (n0 a multiple of kPanel); A a tile buffer of swizzled panels
template <int Wd>
__device__ void consume(const Ring& ring, uint32_t& s, float (&acc)[Wd / 2],
                        const unsigned char* A, int K, int cols, int n0, bool accumulate) {
  fence_regs(acc);
  consume_slabs(ring, s, K, cols, [&](int kk, const unsigned char* B, int lbo) {
    // the K step in A: panel kk / 4, 32 bytes a step
    mma_ss<Wd>(acc, desc(A + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 0, 1024),
               desc(B + (n0 / kPanel) * lbo, lbo, 1024), accumulate || kk > 0);
  });
  fence_regs(acc);
}

// ---- elementwise pieces --------------------------------------------------------
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
// element (row, col) of a tile buffer: swizzled panels of kPanel columns
// and kRows rows
__device__ __forceinline__ int at(int row, int col) {
  return (col >> 6) * (kRows * kPanel) + swz(row, col);
}
__device__ __forceinline__ void st2(unsigned char* buf, int row, int col, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(buf) + at(row, col)) =
      __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ float2 ls2(const unsigned char* buf, int row, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const bf16*>(buf) + at(row, col)));
}

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
    ring.init(2);
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
  const int wg = tid >> 7;
  const Lane l = lane_of(tid);
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
  int sms = 0;
  if ((err = sm_count(&sms)) != 0) return err;
  kernel<<<(unsigned)(total < sms ? total : sms), kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

template <bool kTrain> int launch(const Args& a, int C, cudaStream_t stream) {
  return C == kWideC ? launch_width<kTrain, kWideC>(a, stream)
                     : launch_width<kTrain, kNarrowC>(a, stream);
}

}  // namespace chain
}  // namespace
