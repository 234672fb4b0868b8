// One fused eval bottleneck of ResNet layer1, for Hopper (sm_90a).
//
// Replaces the TPU kernel cavp_tpu/ops/pallas/layer1_kernel.py
// (`fused_layer1`, body `_make_kernel`). Per bottleneck, channels last:
//
//   h1  = relu(bn1(in @ W1))                     1x1, cin -> 64
//   h2  = relu(bn2(sum_k shift_k(h1) @ W2[k]))   3x3 as 9 shifted products
//   o   = bn3(h2 @ W3)                           1x1, 64 -> cout
//   res = bn_d(in @ Wd) in block 0, else in      downsample branch
//   out = relu(o + res)
//
// with the kernel's rounding points: each eval BatchNorm is a folded
// per-channel affine applied to the float32 sums, then ReLU, then one
// rounding to the IO type; o and res are each rounded before the add; the
// 3x3's zero padding is zero after the affine.
//
// The TPU kernel keeps one image's whole stage in VMEM. One image's
// activation (56 x 56 x 256 bf16 = 1.6 MB) does not fit in the 227 KB of
// shared memory a block can have, so here the stage is one launch per
// bottleneck, and a block takes a tile of TH output rows x TW output
// columns of one image with a one-pixel halo on every side: it computes h1
// on the (TH + 2) x (TW + 2) halo'd positions (the halo's 1x1 is computed
// again by the neighbouring tiles), keeps h1 and h2 in shared memory and
// writes only the bottleneck's output. Because the tile has columns as well
// as rows, any map width fits; the wrapper's tile plan (`tile_plan` in
// ops/kernels/layer1.py) picks TH, TW and the tile's row pitch Wp >= TW + 2
// per map and bottleneck, the cheapest in products that fits shared memory.
// What the halo costs at the main path's 56 x 56 maps: every bottleneck
// takes tiles of 4 rows x 28 columns (Wp = 32, two column tiles a row band),
// so the first 1x1 runs on 192 positions for 112 outputs and the later
// products on 128 rows for 112. Against the products' own count that is
// 1.19x (block 0) and 1.28x (blocks 1, 2) of tensor-core work. Larger bands
// do not fit: a tile's input (cin channels of every halo'd position) and
// the three h1 copies below share a block's shared memory with the weight
// ring, and the products run in 64-row chunks, at most two a warpgroup.
// Bands of 6 rows fit block 0 but leave 56 rows ragged (10 bands for 9.3),
// which costs more than the smaller halo saves.
//
// Bound on the H100 at [120, 56, 56, 128] -> 256: 175 GFLOP over the three
// bottlenecks against 96 MB read and 193 MB written in bf16 (0.18 ms at the
// dense bf16 rate: bound by operations). Between launches the activation
// goes through device memory, about 1.06 GB for the stage, a byte floor of
// ~0.32 ms under this design.
//
// - bf16 (the eval and serving path), `l1::bottleneck_kernel`: the
//   machinery of sm90.cuh. A persistent grid of one block per SM walks the
//   tiles. A producer thread loads each tile's input (all cin channels of
//   the (TH + 2) x Wp box, zeros outside the image) with one 4-D TMA box a
//   64-channel panel, and streams the weights in 64 x 64 slabs (W1, the nine
//   taps of W2, then per 64 output columns W3 [and Wd]) through a ring that
//   both consumer warpgroups read. The products are wgmma m64n64k16 from
//   128-byte-swizzled shared memory, each warpgroup two 64-row chunks of
//   positions. The 3x3 is an implicit GEMM with K = 9 x 64 over shifted
//   views of h1: h1 is kept three times, shifted by one position each, so
//   that every tap's view starts on an 8-row boundary of the swizzle (the
//   row pitch Wp is a multiple of 8). h2 then takes the place of the first
//   copy. Epilogues run on the accumulator fragments, a column pair at a
//   time, so that each pair's BatchNorm affine is loaded once for all the
//   thread's rows, with two values rounded by one conversion. The next
//   tile's input is loaded as soon as this tile's last product that reads
//   it is done (the first 1x1; the downsample in block 0), so the load
//   overlaps the 3x3 and the last 1x1; the identity residual is therefore
//   read from global memory, issued before the last 1x1's products.
//   What holds it (scripts/torch_chain_stamps.py): the epilogues, which
//   both warpgroups run between the same barriers while the tensor cores
//   wait, take about two thirds of the consumers' cycles, wgmma about a
//   quarter.
// - float32, `simt::bottleneck_kernel`: the tensor cores have no full-float
//   mode, so the same tiles run on the CUDA cores (a warp owns 16 positions
//   x 64 columns, a lane two columns, with 16 x 2 sums in registers), one
//   block a tile. It serves float32 configurations and parity checks.
//
// Summation orders are fixed, so two launches on the same input are
// bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kPlanes = 64;  // bottleneck width of layer1
constexpr int kMaxSmem = 232448;

struct Weights {
  const void *w1, *w2, *w3, *wd;  // [cin,64] [9,64,64] [64,cout] [cin,cout]
  const float *s1, *t1, *s2, *t2, *s3, *t3, *sd, *td;  // folded BatchNorm
};

// the shape of one launch: the map and the tile plan
struct Shape {
  int B, H, W, cin, cout, TH, TW, Wp, tiles_y, tiles_x;
};
struct Tile {
  int b, r0, c0, rows, cols;  // image, first output row and column, valid rows and columns
};
__device__ __forceinline__ Tile tile_of(const Shape& q, int t) {
  const int per = q.tiles_y * q.tiles_x, rem = t % per;
  const int r0 = (rem / q.tiles_x) * q.TH, c0 = (rem % q.tiles_x) * q.TW;
  return Tile{t / per, r0, c0, min(q.TH, q.H - r0), min(q.TW, q.W - c0)};
}

// ============================================================================
// bf16: wgmma
// ============================================================================
namespace l1 {

using namespace sm90;

constexpr int kConsumerThreads = 256;              // two consumer warpgroups
constexpr int kThreads = kConsumerThreads + 128;   // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kStages = 6, kSlotBytes = 8192;      // a slot: one 64 x 64 weight slab
typedef sm90::Ring<kStages, kSlotBytes> Ring;
constexpr int kRowBytes = kPanel * 2;              // one position's 64 channels
constexpr int kChunkBytes = 64 * kRowBytes;        // a 64-row wgmma tile of a panel
constexpr int kMaxChunks = 4;                      // 64-row chunks of a product, two a warpgroup

// A tile's buffers in rows of kRowBytes, from TH and Wp: P halo'd positions
// (position p = i * Wp + j is image row r0 - 1 + i, column c0 - 1 + j); nc1
// chunks of them for the first 1x1, nci chunks of interior rows (from
// position Wp) for the later products; the input buffer's rows per panel
// (the box's P and what the chunks read past it) and the rows of each h1 copy.
struct Geometry {
  int P, nc1, nci, xrows, hrows;
};
__host__ __device__ inline Geometry geometry(int TH, int Wp) {
  Geometry g;
  g.P = (TH + 2) * Wp;
  g.nc1 = (g.P + 63) / 64;
  g.nci = (TH * Wp + 63) / 64;
  g.xrows = 64 * g.nc1 > Wp + 64 * g.nci ? 64 * g.nc1 : Wp + 64 * g.nci;
  const int h = 64 * g.nci + 2 * Wp > g.P + 1 ? 64 * g.nci + 2 * Wp : g.P + 1;
  g.hrows = (h + 7) / 8 * 8;
  return g;
}
// the input panels, three h1 copies, the ring, 2 kStages + 2 mbarriers and
// the slack to align the start to 1024 bytes (the swizzle's period)
__host__ __device__ inline size_t smem_bytes(int cin, int TH, int Wp) {
  const Geometry g = geometry(TH, Wp);
  return (size_t)kRowBytes * ((cin / kPanel) * g.xrows + 3 * g.hrows) +
         (size_t)kStages * kSlotBytes + sizeof(uint64_t) * (2 * kStages + 2) + 1024;
}

struct Params {
  CUtensorMap x, w1, w2, w3, wd;
  Weights w;
  const bf16* in;
  bf16* out;
  Shape q;
};

__device__ __forceinline__ void consumer_barrier() { bar_sync<kConsumerThreads>(); }

// the warpgroup's chunks of a product with n chunks: wg, wg + 2 (l.wg is
// read from lane 0, so the compiler sees a warp-uniform branch around the
// wgmmas and does not serialize them)
template <class F> __device__ __forceinline__ void my_chunks(const Lane& l, int n, F f) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    if (l.wg + 2 * j < n) f(j, l.wg + 2 * j);
}

// The epilogues walk the thread's columns of a 64-wide accumulator (col =
// 8k + 2 tq, col + 1: registers 4k + 2h, 4k + 2h + 1 in row r0 + 8h) column
// pair by column pair, so each pair's BatchNorm affine is loaded once for
// all the thread's rows.
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
// (a, b) rounded to bf16 by one conversion, back as floats
__device__ __forceinline__ float2 rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// the output pixel of interior row m (position Wp + m) of tile T, or -1
// where that row is a padding column or past the map
__device__ __forceinline__ long long out_pixel(const Shape& q, const Tile& T, int m) {
  const int p = q.Wp + m, iy = p / q.Wp, ix = p - iy * q.Wp;
  if (iy > T.rows || ix < 1 || ix > T.cols) return -1;
  return ((long long)T.b * q.H + T.r0 + iy - 1) * q.W + T.c0 + ix - 1;
}

template <bool FIRST>
__device__ void consumer(const Params& P, const Ring& ring, const Geometry& g, unsigned char* X,
                         unsigned char* H1, uint64_t* xfull, uint64_t* xempty) {
  const Shape& q = P.q;
  const Weights& w = P.w;
  Lane l = lane_of(threadIdx.x);
  l.wg = __shfl_sync(0xffffffffu, l.wg, 0);
  const int Wp = q.Wp, xpanel = g.xrows * kRowBytes, hcopy = g.hrows * kRowBytes;
  const int total = q.B * q.tiles_y * q.tiles_x;
  uint32_t s = 0;  // slabs so far, the producer's count
  float acc[2][32], accd[2][32];
  STAMP_BEGIN(t_all);
  for (int t = blockIdx.x, i = 0; t < total; t += gridDim.x, ++i) {
    const Tile T = tile_of(q, t);
    STAMP_BEGIN(t_x);
    mbar_wait(xfull, i & 1);
    STAMP_END(kLoadX, t_x);

    // the first 1x1 on the halo'd positions
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    consume_slabs(ring, s, q.cin, kPlanes, [&](int kk, const unsigned char* B, int lbo) {
      const uint64_t b = desc(B, lbo, 1024);
      const unsigned char* a = X + (kk >> 2) * xpanel + (kk & 3) * 32;
      my_chunks(l, g.nc1, [&](int j, int c) {
        mma_ss<64>(acc[j], desc_k(a + c * kChunkBytes), b, kk > 0);
      });
    });
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (!FIRST && (threadIdx.x & 127) == 0) mbar_arrive(xempty);  // the input is read
    consumer_barrier();  // the last tile's readers of h1 and h2 are done

    // h1, zero outside the image, into three copies: copy d holds at row u
    // the position u + d - 1, so tap (dy, dx) of the 3x3 reads copy dx
    {
      int prow[2][2];
      bool inside[2][2];
      my_chunks(l, g.nc1, [&](int j, int c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = 64 * c + l.r0 + 8 * h, y = T.r0 - 1 + p / Wp, x = T.c0 - 1 + p % Wp;
          prow[j][h] = p;
          inside[j][h] = p < g.P && y >= 0 && y < q.H && x >= 0 && x < q.W;
        }
      });
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * k + 2 * l.tq;
        const float2 sc = ldg2(w.s1 + col), sh = ldg2(w.t1 + col);
        my_chunks(l, g.nc1, [&](int j, int) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* v = acc[j] + 4 * k + 2 * h;
            const float h0 = inside[j][h] ? fmaxf(fmaf(v[0], sc.x, sh.x), 0.f) : 0.f;
            const float h1 = inside[j][h] ? fmaxf(fmaf(v[1], sc.y, sh.y), 0.f) : 0.f;
#pragma unroll
            for (int d = 0; d < 3; ++d) {
              const int u = prow[j][h] + 1 - d;
              if (u >= 0 && u < g.hrows) st2_panel(H1 + d * hcopy, u, col, h0, h1);
            }
          }
        });
      }
    }
    fence_async_smem();
    consumer_barrier();

    // the 3x3 on the interior rows: K step kk is tap kk / 4, 16 channels of
    // it; the rows of interior chunk c under tap (dy, dx) start at copy dx's
    // row 64 c + dy Wp
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    consume_slabs(ring, s, 9 * kPlanes, kPlanes, [&](int kk, const unsigned char* B, int lbo) {
      const uint64_t b = desc(B, lbo, 1024);
      const int tap = kk >> 2, dy = tap / 3, dx = tap - 3 * dy;
      const unsigned char* a = H1 + dx * hcopy + dy * Wp * kRowBytes + (kk & 3) * 32;
      my_chunks(l, g.nci, [&](int j, int c) {
        mma_ss<64>(acc[j], desc_k(a + c * kChunkBytes), b, kk > 0);
      });
    });
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    consumer_barrier();  // every read of h1 is done: copy 0 takes h2

    // h2 at interior row m (position Wp + m) of copy 0
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = 8 * k + 2 * l.tq;
      const float2 sc = ldg2(w.s2 + col), sh = ldg2(w.t2 + col);
      my_chunks(l, g.nci, [&](int j, int c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* v = acc[j] + 4 * k + 2 * h;
          st2_panel(H1, 64 * c + l.r0 + 8 * h, col, fmaxf(fmaf(v[0], sc.x, sh.x), 0.f),
                    fmaxf(fmaf(v[1], sc.y, sh.y), 0.f));
        }
      });
    }
    fence_async_smem();
    consumer_barrier();

    // the last 1x1 (and the downsample), 64 output columns at a time; the
    // residual, the add, the last ReLU, and the store
    long long pix[2][2];  // the output pixel of each of the thread's rows, or -1
    my_chunks(l, g.nci, [&](int j, int c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) pix[j][h] = out_pixel(q, T, 64 * c + l.r0 + 8 * h);
    });
    for (int n0 = 0; n0 < q.cout; n0 += kPanel) {
      // the identity residual of the thread's outputs, loaded before the
      // products so that its latency runs under them
      uint32_t res[2][2][8];
      if (!FIRST)
        my_chunks(l, g.nci, [&](int j, int) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t* in = reinterpret_cast<const uint32_t*>(
                P.in + (pix[j][h] < 0 ? 0 : pix[j][h]) * q.cout + n0 + 2 * l.tq);
#pragma unroll
            for (int k = 0; k < 8; ++k) res[j][h][k] = pix[j][h] < 0 ? 0u : __ldg(in + 4 * k);
          }
        });
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      consume_slabs(ring, s, kPlanes, kPanel, [&](int kk, const unsigned char* B, int lbo) {
        const uint64_t b = desc(B, lbo, 1024);
        my_chunks(l, g.nci, [&](int j, int c) {
          mma_ss<64>(acc[j], desc_k(H1 + c * kChunkBytes + (kk & 3) * 32), b, kk > 0);
        });
      });
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (FIRST) {
        fence_regs(accd[0]);
        fence_regs(accd[1]);
        consume_slabs(ring, s, q.cin, kPanel, [&](int kk, const unsigned char* B, int lbo) {
          const uint64_t b = desc(B, lbo, 1024);
          const unsigned char* a = X + (kk >> 2) * xpanel + Wp * kRowBytes + (kk & 3) * 32;
          my_chunks(l, g.nci, [&](int j, int c) {
            mma_ss<64>(accd[j], desc_k(a + c * kChunkBytes), b, kk > 0);
          });
        });
        fence_regs(accd[0]);
        fence_regs(accd[1]);
      }
      // out = relu(rnd(o) + rnd(res)), rounded once more (the ReLU of a
      // rounded sum is the rounded ReLU)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int col = 8 * k + 2 * l.tq, ch = n0 + col;
        const float2 sc = ldg2(w.s3 + ch), sh = ldg2(w.t3 + ch);
        float2 dsc, dsh;
        if (FIRST) dsc = ldg2(w.sd + ch), dsh = ldg2(w.td + ch);
        my_chunks(l, g.nci, [&](int j, int) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (pix[j][h] < 0) continue;
            const int r = 4 * k + 2 * h;
            const float2 o = rnd2(fmaf(acc[j][r], sc.x, sh.x), fmaf(acc[j][r + 1], sc.y, sh.y));
            const float2 rv =
                FIRST ? rnd2(fmaf(accd[j][r], dsc.x, dsh.x), fmaf(accd[j][r + 1], dsc.y, dsh.y))
                      : make_float2(__uint_as_float(res[j][h][k] << 16),
                                    __uint_as_float(res[j][h][k] & 0xffff0000u));
            *reinterpret_cast<__nv_bfloat162*>(P.out + pix[j][h] * q.cout + ch) =
                __floats2bfloat162_rn(fmaxf(o.x + rv.x, 0.f), fmaxf(o.y + rv.y, 0.f));
          }
        });
      }
    }
    if (FIRST && (threadIdx.x & 127) == 0) mbar_arrive(xempty);  // the input is read
  }
  STAMP_END(kTotal, t_all);
}

template <bool FIRST>
__global__ void __launch_bounds__(kThreads, 1) bottleneck_kernel(const __grid_constant__ Params P) {
  extern __shared__ unsigned char smem_raw[];
  const Shape& q = P.q;
  const Geometry g = geometry(q.TH, q.Wp);
  unsigned char* X = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int xpanels = q.cin / kPanel, xpanel = g.xrows * kRowBytes;
  unsigned char* H1 = X + xpanels * xpanel;
  unsigned char* slots = H1 + 3 * g.hrows * kRowBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(slots + kStages * kSlotBytes);
  const Ring ring{slots, bars, bars + kStages};
  uint64_t* xfull = bars + 2 * kStages;  // the tile's input has landed
  uint64_t* xempty = xfull + 1;          // both consumer warpgroups are done with it
  if (threadIdx.x == 0) {
    ring.init(2);
    mbar_init(xfull, 1);
    mbar_init(xempty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#ifdef CHAIN_STAMPS
  if (threadIdx.x < 3 * kStamps) s_stamps[threadIdx.x / kStamps][threadIdx.x % kStamps] = 0;
#endif
  __syncthreads();

  const int total = q.B * q.tiles_y * q.tiles_x;
  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x > kConsumerThreads) return;
    // the (TH + 2) x Wp box of tile t from image row r0 - 1, column c0 - 1,
    // one panel of 64 channels at a time
    const auto load_x = [&](int t) {
      const Tile T = tile_of(q, t);
      mbar_expect_tx(xfull, xpanels * g.P * kRowBytes);
      for (int p = 0; p < xpanels; ++p)
        tma_load_4d(X + p * xpanel, &P.x, p * kPanel, T.c0 - 1, T.r0 - 1, T.b, xfull);
    };
    STAMP_BEGIN(t0);
    uint32_t s = 0;
    load_x(blockIdx.x);
    for (int t = blockIdx.x, i = 0; t < total; t += gridDim.x, ++i) {
      const int next = t + gridDim.x;
      produce(ring, s, &P.w1, 0, 0, q.cin, kPlanes);
      if (!FIRST && next < total) {
        mbar_wait(xempty, i & 1);
        load_x(next);
      }
      produce(ring, s, &P.w2, 0, 0, 9 * kPlanes, kPlanes);
      for (int n0 = 0; n0 < q.cout; n0 += kPanel) {
        produce(ring, s, &P.w3, n0, 0, kPlanes, kPanel);
        if (FIRST) produce(ring, s, &P.wd, n0, 0, q.cin, kPanel);
      }
      if (FIRST && next < total) {
        mbar_wait(xempty, i & 1);
        load_x(next);
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
  consumer<FIRST>(P, ring, g, X, H1, xfull, xempty);
#ifdef CHAIN_STAMPS
  if ((threadIdx.x & 127) == 0)
    for (int k = 0; k < kStamps; ++k)
      atomicAdd(&g_stamps[(threadIdx.x >> 7) * kStamps + k], (unsigned long long)s_stamps[threadIdx.x >> 7][k]);
#endif
}

template <bool FIRST>
int launch(const void* in, void* out, const Weights& w, const Shape& q, cudaStream_t stream) {
  Params P{};
  P.w = w;
  P.in = (const bf16*)in;
  P.out = (bf16*)out;
  P.q = q;
  const int slab = Ring::slab_rows(kPanel);
  int err = make_map_nhwc(&P.x, in, q.B, q.H, q.W, q.cin, q.Wp, q.TH + 2);
  if (!err) err = make_map(&P.w1, w.w1, q.cin, kPlanes, slab);
  if (!err) err = make_map(&P.w2, w.w2, 9 * kPlanes, kPlanes, slab);
  if (!err) err = make_map(&P.w3, w.w3, kPlanes, q.cout, slab);
  if (!err && FIRST) err = make_map(&P.wd, w.wd, q.cin, q.cout, slab);
  if (err) return err;
  const auto kernel = bottleneck_kernel<FIRST>;
  const size_t smem = smem_bytes(q.cin, q.TH, q.Wp);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  if ((err = sm_count(&sms)) != 0) return err;
  const long long total = (long long)q.B * q.tiles_y * q.tiles_x;
  kernel<<<(unsigned)(total < sms ? total : sms), kThreads, smem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace l1

// ============================================================================
// float32: CUDA cores
// ============================================================================
namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kPlanes + 4;  // row stride of the shared tiles: 16-byte rows for float4

// The sums of 16 positions x 64 columns, owned by one warp: a lane owns
// columns lane and lane + 32.
struct Acc {
  float c[16][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 16; ++r) c[r][0] = c[r][1] = 0.f;
  }
  // c += A[16, K] @ B[K, 64] (B row stride ldb); row(r) gives A's row r, or
  // nullptr for a row of zeros
  template <class Row>
  __device__ __forceinline__ void mma(Row row, const float* B, int ldb, int K) {
    const int lane = threadIdx.x & 31;
    const float* a_rows[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) a_rows[r] = row(r);
    for (int k = 0; k < K; k += 4) {
      float b0[4], b1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        b0[i] = B[(size_t)(k + i) * ldb + lane];
        b1[i] = B[(size_t)(k + i) * ldb + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 a = a_rows[r] ? *reinterpret_cast<const float4*>(a_rows[r] + k)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        float u = c[r][0], v = c[r][1];
        u = fmaf(a.x, b0[0], u); v = fmaf(a.x, b1[0], v);
        u = fmaf(a.y, b0[1], u); v = fmaf(a.y, b1[1], v);
        u = fmaf(a.z, b0[2], u); v = fmaf(a.z, b1[2], v);
        u = fmaf(a.w, b0[3], u); v = fmaf(a.w, b1[3], v);
        c[r][0] = u; c[r][1] = v;
      }
    }
  }
  // columns [16n, 16n + 16) to scratch [16, 16]
  template <int N> __device__ __forceinline__ void store16(float* scratch) const {
    const int lane = threadIdx.x & 31;
    if ((lane >> 4) == (N & 1)) {
#pragma unroll
      for (int r = 0; r < 16; ++r) scratch[r * 16 + (lane & 15)] = c[r][N >> 1];
    }
  }
};

// f(row in the tile, column in [0, 64), sum, sum of `d`) for every entry,
// 16 columns at a time through the warp's scratch ([2][256] floats)
template <int N, bool HAS_D, class F>
__device__ __forceinline__ void epilogue16(const Acc& a, const Acc& d, float* scratch, F f) {
  const int lane = threadIdx.x & 31;
  a.template store16<N>(scratch);
  if (HAS_D) d.template store16<N>(scratch + 256);
  __syncwarp();
  for (int e = lane; e < 256; e += 32)
    f(e >> 4, N * 16 + (e & 15), scratch[e], HAS_D ? scratch[256 + e] : 0.f);
  __syncwarp();
}

template <bool HAS_D, class F>
__device__ __forceinline__ void epilogue(const Acc& a, const Acc& d, float* scratch, F f) {
  epilogue16<0, HAS_D>(a, d, scratch, f);
  epilogue16<1, HAS_D>(a, d, scratch, f);
  epilogue16<2, HAS_D>(a, d, scratch, f);
  epilogue16<3, HAS_D>(a, d, scratch, f);
}

__host__ __device__ inline int round_up16(int v) { return (v + 15) / 16 * 16; }
// rows of the h1 buffer: halo'd position p = i * Wp + j at row p, and what
// the 3x3's furthest tap of the last 16 output positions reaches
__host__ __device__ inline int h1_rows(int TH, int Wp) { return round_up16(TH * Wp) + 2 * Wp + 2; }
__host__ __device__ inline int h2_rows(int TH, int TW) { return round_up16(TH * TW); }
__host__ __device__ inline size_t smem_bytes(int TH, int TW, int Wp) {
  return sizeof(float) * ((size_t)(h1_rows(TH, Wp) + h2_rows(TH, TW)) * kLd + kWarps * 512);
}

template <bool FIRST>
__global__ void __launch_bounds__(kThreads)
bottleneck_kernel(const float* __restrict__ in, float* __restrict__ out, Weights p, Shape q) {
  extern __shared__ __align__(16) float smem[];
  const int TH = q.TH, TW = q.TW, Wp = q.Wp, cin = q.cin, cout = q.cout;
  float* h1 = smem;
  float* h2 = h1 + (size_t)h1_rows(TH, Wp) * kLd;
  float* scratch = h2 + (size_t)h2_rows(TH, TW) * kLd + (threadIdx.x >> 5) * 512;
  const int warp = threadIdx.x >> 5;
  const Tile T = tile_of(q, blockIdx.x);
  const float* w1 = (const float*)p.w1;
  const float* w2 = (const float*)p.w2;
  const float* w3 = (const float*)p.w3;
  const float* wd = (const float*)p.wd;
  // the input row of image pixel (y, x), or nullptr outside the image
  const auto pixel = [&](int y, int x) -> const float* {
    return y >= 0 && y < q.H && x >= 0 && x < q.W ? in + (((size_t)T.b * q.H + y) * q.W + x) * cin
                                                  : nullptr;
  };

  // h1 starts as zeros: the padding, the positions outside the image
  for (int i = threadIdx.x; i < h1_rows(TH, Wp) * kLd; i += kThreads) h1[i] = 0.f;
  __syncthreads();

  // the first 1x1 on the halo'd positions inside the image
  const int npos = (TH + 2) * Wp;
  for (int m0 = warp * 16; m0 < npos; m0 += kWarps * 16) {
    const auto at = [&](int r) -> const float* {
      const int pp = m0 + r;
      return pp < npos ? pixel(T.r0 - 1 + pp / Wp, T.c0 - 1 + pp % Wp) : nullptr;
    };
    Acc acc;
    acc.zero();
    acc.mma(at, w1, kPlanes, cin);
    epilogue<false>(acc, acc, scratch, [&](int i, int c, float v, float) {
      if (at(i) == nullptr) return;
      h1[(size_t)(m0 + i) * kLd + c] = fmaxf(fmaf(v, p.s1[c], p.t1[c]), 0.f);
    });
  }
  __syncthreads();

  // the 3x3 over the positions q = r * Wp + c of the output rows: tap (dy,
  // dx) of q is h1 row q + dy * Wp + dx
  for (int q0 = warp * 16; q0 < TH * Wp; q0 += kWarps * 16) {
    Acc acc;
    acc.zero();
    for (int k = 0; k < 9; ++k) {
      const float* A = h1 + (size_t)(q0 + (k / 3) * Wp + k % 3) * kLd;
      acc.mma([&](int r) { return A + r * kLd; }, w2 + (size_t)k * kPlanes * kPlanes, kPlanes,
              kPlanes);
    }
    epilogue<false>(acc, acc, scratch, [&](int i, int c, float v, float) {
      const int qq = q0 + i, r = qq / Wp, col = qq % Wp;
      if (r >= TH || col >= TW) return;
      h2[(size_t)(r * TW + col) * kLd + c] = fmaxf(fmaf(v, p.s2[c], p.t2[c]), 0.f);
    });
  }
  __syncthreads();

  // the last 1x1 over the output positions m = r * TW + c, the residual
  // branch, the add and the last ReLU
  const int col_groups = cout / kPlanes, tiles = h2_rows(TH, TW) / 16;
  for (int u = warp; u < tiles * col_groups; u += kWarps) {
    const int m0 = (u / col_groups) * 16, n0 = (u % col_groups) * kPlanes;
    const auto x_at = [&](int r) -> const float* {
      const int m = m0 + r, rr = m / TW, cc = m % TW;
      return rr < T.rows && cc < T.cols ? pixel(T.r0 + rr, T.c0 + cc) : nullptr;
    };
    Acc acc, accd;
    acc.zero();
    acc.mma([&](int r) { return h2 + (size_t)(m0 + r) * kLd; }, w3 + n0, cout, kPlanes);
    if (FIRST) {
      accd.zero();
      accd.mma(x_at, wd + n0, cout, cin);
    }
    epilogue<FIRST>(acc, accd, scratch, [&](int i, int c, float v, float vd) {
      const float* x = x_at(i);
      if (x == nullptr) return;
      const int ch = n0 + c;
      const float o = fmaf(v, p.s3[ch], p.t3[ch]);
      const float res = FIRST ? fmaf(vd, p.sd[ch], p.td[ch]) : x[ch];
      out[(size_t)(x - in) / cin * cout + ch] = fmaxf(o + res, 0.f);
    });
  }
}

template <bool FIRST>
int launch(const void* in, void* out, const Weights& w, const Shape& q, cudaStream_t stream) {
  const size_t smem = smem_bytes(q.TH, q.TW, q.Wp);
  cudaError_t err = cudaFuncSetAttribute(bottleneck_kernel<FIRST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)q.B * q.tiles_y * q.tiles_x;
  bottleneck_kernel<FIRST><<<(unsigned)total, kThreads, smem, stream>>>((const float*)in,
                                                                         (float*)out, w, q);
  return (int)cudaGetLastError();
}

}  // namespace simt
}  // namespace

extern "C" {

// One bottleneck. dtype: 0 = float32, 1 = bfloat16. in [B, H, W, cin] and
// out [B, H, W, cout] contiguous, of that type, as are w1 [cin, 64],
// w2 [9, 64, 64] (tap-major, [in, out] inside), w3 [64, cout] and, for the
// first bottleneck, wd [cin, cout]; wd null means the identity residual and
// needs cin == cout. s*/t* are the folded BatchNorm scale and shift,
// float32. The tile plan: output tiles of TH rows x TW columns with a row
// pitch of Wp >= TW + 2 positions (a multiple of 8), at most 256 halo'd
// positions and 256 interior ones a tile, within shared memory. Needs cin
// and cout multiples of 64. Returns the launch's cudaError_t (0 on success).
int cavp_layer1_bottleneck(int dtype, const void* in, void* out, const void* w1,
                           const void* s1, const void* t1, const void* w2, const void* s2,
                           const void* t2, const void* w3, const void* s3, const void* t3,
                           const void* wd, const void* sd, const void* td, int B, int H,
                           int W, int cin, int cout, int TH, int TW, int Wp, void* stream) {
  const l1::Geometry g = l1::geometry(TH, Wp);
  if (B <= 0 || H <= 0 || W <= 0 || cin <= 0 || cin % kPlanes || cout <= 0 || cout % kPlanes ||
      (wd == nullptr && cin != cout) || TH < 1 || TW < 1 || Wp % 8 || Wp < TW + 2 || Wp > 256 ||
      TH + 2 > 256 || g.nc1 > l1::kMaxChunks || g.nci > l1::kMaxChunks ||
      l1::smem_bytes(cin, TH, Wp) > kMaxSmem || simt::smem_bytes(TH, TW, Wp) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const Shape q{B, H, W, cin, cout, TH, TW, Wp, (H + TH - 1) / TH, (W + TW - 1) / TW};
  const Weights w{w1, w2, w3, wd, (const float*)s1, (const float*)t1, (const float*)s2,
                  (const float*)t2, (const float*)s3, (const float*)t3, (const float*)sd,
                  (const float*)td};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool first = wd != nullptr;
  if (dtype == 0)
    return first ? simt::launch<true>(in, out, w, q, s) : simt::launch<false>(in, out, w, q, s);
  if (dtype == 1)
    return first ? l1::launch<true>(in, out, w, q, s) : l1::launch<false>(in, out, w, q, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef CHAIN_STAMPS
// The bf16 kernel's stage counters (3 x sm90::kStamps), read and zeroed.
int cavp_layer1_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sm90::g_stamps, sizeof(sm90::g_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[3 * sm90::kStamps] = {};
  return (int)cudaMemcpyToSymbol(sm90::g_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
