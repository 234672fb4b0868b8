// Train fusion chain of CAVP at dup=2, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of cavp_tpu/ops/pallas/fusion_train_kernel.py
// (`fusion_train`; bodies `_fwd_kernel` and `_bwd_kernel`). Per visual token,
// with the image's two audio factor pairs (matched, shuffled):
//
//   t1 = gelu(x @ W1 + b1)                  projector fc1, GELU kept in float
//   t2 = t1 @ W2 + b2                       projector fc2
//   a  = LN1(t2 @ Wpe + bpe)                patch_embed_v, shared norm1
//   for d in {0, 1}:
//     g  = sigmoid((a @ wqk[d]) * hd^-1/2)  rank-1 gate, wqk[d] [C, heads]
//     t4 = a + (g @ m[d] + bp)              m[d] [heads, C]
//     t5 = t4 + (gelu(LN2(t4) @ Wm1 + bm1) @ Wm2 + bm2)
//     y[d] = LN3(t5)
//
// The backward kernel gets only the forward's inputs and dy. It recomputes
// the chain for its tile of tokens on chip and emits dx, the per-image
// d(wqk) and d(m), and the 17 weight, bias and LayerNorm-affine gradients,
// all accumulated in float. Values are rounded to the IO type (float or
// bf16) where the TPU kernel rounds them: after each product that it casts,
// each bias add in the IO type, each LayerNorm, and each cotangent that it
// feeds to a product; GELU, its derivative, the sigmoid and the LayerNorm
// statistics stay in float.
//
// Bound on the H100: the forward does ~3.5 MFLOP per token and the backward
// ~10 MFLOP against 0.6 to 2.4 KB of token IO, so both are bound by
// operations, and only the tensor cores give the rate they need.
//
// The bf16 forward (the train step's path) is the token chain of
// fusion_chain_sm90.cuh, shared with the eval kernel: tiles of 128 tokens
// on a persistent grid, each weight slab staged once per tile into a
// 3-slot shared-memory ring by a producer warp (cp.async, mbarriers) and
// read by two consumer warpgroups, wgmma products with register
// accumulators, epilogues and LayerNorm statistics on the accumulator
// fragments. The shared prefix (x -> t1 -> t2 -> t3 -> a) runs once per
// tile; the two gated halves then run one after the other on the same
// tile, each re-reading a from shared memory, and the ring re-streams the
// MLP weights for the second half (1.5 MB do not fit). That header's note
// gives the design and what bounds it.
//
// The float32 forward and the float32 backward. A block holds one tile of
// tokens and its intermediates in shared memory and streams the weights
// from global memory (L2). The products (x @ W, dy @ W^T, x^T @ dy) are
// block-wide routines with a per-element epilogue, `Mm::nn`, `Mm::nt` and
// `Mm::outer`, on the CUDA cores (one output column per thread, float4
// rows), since the tensor cores have no full-float mode. The 4C-wide MLP
// hidden is walked in chunks. The float32 backward (tiles of 16 tokens)
// serves float32 configurations and the parity checks: its grid is (blocks
// per image, B), each block adds the weight gradients of its tiles into its
// own float partial set in global memory, and the reduction sums the sets.
//
// The bf16 backward (the train step's path) is three launches, below
// `stage_a_kernel`. What bounded the single-kernel design it replaces was
// the weight gradients: contracted over 32 tokens at a time and added into
// global memory after each tile (13.8 MB of read-modify-write per tile,
// 43 GB per step at [32, 3136, 304]), at 8 FLOP per byte. Here stage A
// (tiles of 32 tokens, weight tiles staged in shared memory by cp.async and
// fed to mma.sync by ldmatrix, epilogues on the register fragments) writes
// the bf16 operands of those products once; stage B contracts them over
// token ranges of 12,544 in registers (128 x 128 output tiles, 4-stage
// cp.async pipeline), and the reduction sums the few partials in a fixed
// order. The bias and LayerNorm-affine gradients are column sums in stage
// A's epilogues and column passes, in float, into the block's own partial
// set. The ragged last tile is masked (zero x and dy rows add nothing to
// any sum), with no host-side padding. No float atomics: the result does
// not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fusion_chain_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Weights {
  const void *w1, *b1, *w2, *b2, *wpe, *bpe, *g1, *c1, *bp, *g2, *c2, *wm1, *bm1, *wm2,
      *bm2, *g3, *c3;
};

struct Dims {
  int B, N, C, hid, mh, heads;
  int chunk;  // hidden columns per pass
  float scale;
};

__device__ __forceinline__ float ldf(float v) { return v; }
__device__ __forceinline__ float ldf(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T cvt(float v);
template <> __device__ __forceinline__ float cvt<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cvt<bf16>(float v) { return __float2bfloat16_rn(v); }
template <typename T> __device__ __forceinline__ float rnd(float v) { return ldf(cvt<T>(v)); }

__device__ __forceinline__ float phi(float v) {
  return 0.5f * (1.0f + erff(v * 0.7071067811865476f));
}
__device__ __forceinline__ float gelu(float v) { return v * phi(v); }
__device__ __forceinline__ float dgelu(float v) {
  return phi(v) + v * 0.3989422804014327f * expf(-0.5f * v * v);
}
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// the three products. A, D: the tile's rows in shared memory; W: weights in
// global memory, row-major [in, out]; epi(t, j, sum) gets each result once.
//   nn:    sum_k A[t, k] * W[k, j]        j < N
//   nt:    sum_n D[t, n] * W[j, n]        j < K
//   outer: G[k, n] += sum_t A[t, k] * D[t, n]
// ---------------------------------------------------------------------------
template <typename T, int TOK> struct Mm;

template <int TOK> struct Mm<float, TOK> {
  template <typename Epi>
  static __device__ void nn(const float* A, int lda, int K, const float* W, int ldw, int N,
                            float*, Epi epi) {
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float acc[TOK];
#pragma unroll
      for (int t = 0; t < TOK; ++t) acc[t] = 0.f;
      const float* wcol = W + j;
      for (int k = 0; k < K; k += 4) {
        const float w0 = wcol[(size_t)(k + 0) * ldw];
        const float w1 = wcol[(size_t)(k + 1) * ldw];
        const float w2 = wcol[(size_t)(k + 2) * ldw];
        const float w3 = wcol[(size_t)(k + 3) * ldw];
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          const float4 a = *reinterpret_cast<const float4*>(A + t * lda + k);
          float s = acc[t];
          s = fmaf(a.x, w0, s);
          s = fmaf(a.y, w1, s);
          s = fmaf(a.z, w2, s);
          s = fmaf(a.w, w3, s);
          acc[t] = s;
        }
      }
#pragma unroll
      for (int t = 0; t < TOK; ++t) epi(t, j, acc[t]);
    }
  }

  template <typename Epi>
  static __device__ void nt(const float* D, int ldd, int N, const float* W, int ldw, int K,
                            float*, Epi epi) {
    for (int j = threadIdx.x; j < K; j += kThreads) {
      float acc[TOK];
#pragma unroll
      for (int t = 0; t < TOK; ++t) acc[t] = 0.f;
      const float* wrow = W + (size_t)j * ldw;
      for (int n = 0; n < N; n += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + n);
#pragma unroll
        for (int t = 0; t < TOK; ++t) {
          const float4 dv = *reinterpret_cast<const float4*>(D + t * ldd + n);
          float s = acc[t];
          s = fmaf(dv.x, wv.x, s);
          s = fmaf(dv.y, wv.y, s);
          s = fmaf(dv.z, wv.z, s);
          s = fmaf(dv.w, wv.w, s);
          acc[t] = s;
        }
      }
#pragma unroll
      for (int t = 0; t < TOK; ++t) epi(t, j, acc[t]);
    }
  }

  static __device__ void outer(const float* A, int lda, int K, const float* D, int ldd,
                               int N, float* G, int ldg) {
    for (int i = threadIdx.x; i < K * N; i += kThreads) {
      const int k = i / N, n = i % N;
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < TOK; ++t) s = fmaf(A[t * lda + k], D[t * ldd + n], s);
      G[(size_t)k * ldg + n] += s;
    }
  }
};

// ---------------------------------------------------------------------------
// shared memory layout, the same function on host and device
// ---------------------------------------------------------------------------
__host__ __device__ inline size_t take(size_t& at, size_t n, size_t align) {
  const size_t a = at;
  at += (n + align - 1) / align * align;
  return a;
}

struct Layout {
  size_t u[4], f0, f1, da, h0, h1, dh, scratch, g, gt, ds, mu, r, total;
  int ldu, ldf, ldh;
};

template <typename T>
__host__ __device__ inline Layout make_layout(int TOK, int C, int hid, int chunk, int heads,
                                              bool bwd) {
  const int pad = sizeof(T) == 2 ? 8 : 0;  // bf16 rows: off the bank stride
  const int W = C > hid ? C : hid;
  Layout l;
  l.ldu = W + pad;
  l.ldf = W;
  l.ldh = chunk + pad;
  size_t off = 0;
  for (int i = 0; i < 4; ++i) l.u[i] = take(off, (size_t)TOK * l.ldu * sizeof(T), 128);
  l.f1 = take(off, (size_t)TOK * l.ldf * 4, 128);
  l.h1 = take(off, (size_t)TOK * l.ldh * sizeof(T), 128);
  l.scratch = take(off, (size_t)kWarps * 256 * 4, 128);
  l.g = take(off, (size_t)TOK * heads * 4, 128);
  l.gt = take(off, (size_t)TOK * heads * 4, 128);
  l.mu = take(off, (size_t)3 * TOK * 4, 128);
  l.r = take(off, (size_t)3 * TOK * 4, 128);
  l.f0 = l.da = l.h0 = l.dh = l.ds = 0;
  if (bwd) {
    l.f0 = take(off, (size_t)TOK * l.ldf * 4, 128);
    l.da = take(off, (size_t)TOK * l.ldf * 4, 128);
    l.h0 = take(off, (size_t)TOK * chunk * 4, 128);
    l.dh = take(off, (size_t)TOK * l.ldh * sizeof(T), 128);
    l.ds = take(off, (size_t)TOK * heads * 4, 128);
  }
  l.total = off;
  return l;
}

template <typename T> struct Tile {
  T *U0, *U1, *U2, *U3, *H1, *DH;
  float *F0, *F1, *DA, *H0, *scratch, *G, *GT, *DS, *MU, *R;
  int ldu, ldf, ldh;
};

template <typename T>
__device__ inline Tile<T> carve(unsigned char* smem, const Layout& l) {
  Tile<T> s;
  s.U0 = reinterpret_cast<T*>(smem + l.u[0]);
  s.U1 = reinterpret_cast<T*>(smem + l.u[1]);
  s.U2 = reinterpret_cast<T*>(smem + l.u[2]);
  s.U3 = reinterpret_cast<T*>(smem + l.u[3]);
  s.H1 = reinterpret_cast<T*>(smem + l.h1);
  s.DH = reinterpret_cast<T*>(smem + l.dh);
  s.F0 = reinterpret_cast<float*>(smem + l.f0);
  s.F1 = reinterpret_cast<float*>(smem + l.f1);
  s.DA = reinterpret_cast<float*>(smem + l.da);
  s.H0 = reinterpret_cast<float*>(smem + l.h0);
  s.scratch = reinterpret_cast<float*>(smem + l.scratch);
  s.G = reinterpret_cast<float*>(smem + l.g);
  s.GT = reinterpret_cast<float*>(smem + l.gt);
  s.DS = reinterpret_cast<float*>(smem + l.ds);
  s.MU = reinterpret_cast<float*>(smem + l.mu);
  s.R = reinterpret_cast<float*>(smem + l.r);
  s.ldu = l.ldu;
  s.ldf = l.ldf;
  s.ldh = l.ldh;
  return s;
}

// ---------------------------------------------------------------------------
// row helpers: one warp per token row
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int C, float& mu, float& r) {
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
  for (int c = lane; c < C; c += 32) sum += ldf(row[c]);
  mu = warp_sum(sum) / C;
  float sq = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = ldf(row[c]) - mu;
    sq += d * d;
  }
  r = rsqrtf(warp_sum(sq) / C + 1e-5f);
}

// y[t, :] = LN(x[t, :]) * g + c; y may alias x. mu_out/r_out (may be null)
// keep the statistics.
template <typename T, int TOK>
__device__ void ln_rows(const T* x, int ldx, const T* g, const T* c, int C, T* y, int ldy,
                        float* mu_out, float* r_out) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < TOK; t += kWarps) {
    float mu, r;
    row_stats(x + t * ldx, C, mu, r);
    for (int i = lane; i < C; i += 32)
      y[t * ldy + i] = cvt<T>((ldf(x[t * ldx + i]) - mu) * r * ldf(g[i]) + ldf(c[i]));
    if (mu_out != nullptr && lane == 0) {
      mu_out[t] = mu;
      r_out[t] = r;
    }
  }
}

template <typename T, int TOK>
__device__ void stats_rows(const T* x, int ldx, int C, float* mu_out, float* r_out) {
  for (int t = threadIdx.x >> 5; t < TOK; t += kWarps) {
    float mu, r;
    row_stats(x + t * ldx, C, mu, r);
    if ((threadIdx.x & 31) == 0) {
      mu_out[t] = mu;
      r_out[t] = r;
    }
  }
}

// LayerNorm backward per row. up(t, c): the upstream cotangent; xpre: the
// LayerNorm's input; emit(t, c, dx) takes the float result.
template <typename T, int TOK, typename Up, typename Emit>
__device__ void ln_bwd_rows(Up up, const T* xpre, int ldx, const float* mu, const float* r,
                            const T* g, int C, Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < TOK; t += kWarps) {
    const float m = mu[t], rr = r[t];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dyf = up(t, c) * ldf(g[c]);
      s1 += dyf;
      s2 += dyf * ((ldf(xpre[t * ldx + c]) - m) * rr);
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float xh = (ldf(xpre[t * ldx + c]) - m) * rr;
      emit(t, c, rr * (up(t, c) * ldf(g[c]) - m1 - xh * m2));
    }
  }
}

// G[c] += sum_t fn(t, c), one thread per column
template <int TOK, typename Fn>
__device__ __forceinline__ void colsum(float* G, int n, Fn fn) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
#pragma unroll 4
    for (int t = 0; t < TOK; ++t) s += fn(t, c);
    G[c] += s;
  }
}

template <typename T, int TOK>
__device__ void load_rows(const T* src, int n_valid, int C, T* dst, int ld) {
  const T zero = cvt<T>(0.f);
  for (int i = threadIdx.x; i < TOK * C; i += kThreads) {
    const int t = i / C, c = i % C;
    dst[t * ld + c] = t < n_valid ? src[(size_t)t * C + c] : zero;
  }
}

// ---------------------------------------------------------------------------
// the chain's stages on one tile
// ---------------------------------------------------------------------------

// x in U0 -> t1 in U1 -> t2 in U0 -> t3 in U3
template <typename T, int TOK>
__device__ void prefix_forward(const Tile<T>& s, const Weights& w, const Dims& d) {
  using M = Mm<T, TOK>;
  const int ldu = s.ldu;
  const T *b1 = (const T*)w.b1, *b2 = (const T*)w.b2, *bpe = (const T*)w.bpe;
  T *U0 = s.U0, *U1 = s.U1, *U3 = s.U3;
  M::nn(U0, ldu, d.C, (const T*)w.w1, d.hid, d.hid, s.scratch, [=](int t, int j, float acc) {
    U1[t * ldu + j] = cvt<T>(gelu(acc + ldf(b1[j])));
  });
  __syncthreads();
  M::nn(U1, ldu, d.hid, (const T*)w.w2, d.C, d.C, s.scratch, [=](int t, int j, float acc) {
    U0[t * ldu + j] = cvt<T>(rnd<T>(acc) + ldf(b2[j]));
  });
  __syncthreads();
  M::nn(U0, ldu, d.C, (const T*)w.wpe, d.C, d.C, s.scratch, [=](int t, int j, float acc) {
    U3[t * ldu + j] = cvt<T>(rnd<T>(acc) + ldf(bpe[j]));
  });
  __syncthreads();
}

// a in U3 -> t4 in U0, b4 = LN2(t4) in U1 (statistics in MU/R[0..TOK)),
// t5 in U2; the gate in G (float) and GT (rounded). Uses F1 and H1.
template <typename T, int TOK>
__device__ void half_forward(const Tile<T>& s, const Weights& w, const Dims& d, const T* wqk,
                             const T* m) {
  using M = Mm<T, TOK>;
  const int ldu = s.ldu, ldf_ = s.ldf, ldh = s.ldh, C = d.C, heads = d.heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T *U0 = s.U0, *U1 = s.U1, *U2 = s.U2, *U3 = s.U3, *H1 = s.H1;
  float *F1 = s.F1, *G = s.G, *GT = s.GT;
  const T *bp = (const T*)w.bp, *bm1 = (const T*)w.bm1, *bm2 = (const T*)w.bm2;

  for (int o = warp; o < TOK * heads; o += kWarps) {
    const int t = o / heads, hh = o % heads;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += ldf(U3[t * ldu + c]) * ldf(wqk[c * heads + hh]);
    sum = warp_sum(sum);
    if (lane == 0) {
      const float gf = sigmoid(sum * d.scale);
      G[o] = gf;
      GT[o] = rnd<T>(gf);
    }
  }
  __syncthreads();
  for (int i = tid; i < TOK * C; i += kThreads) {
    const int t = i / C, c = i % C;
    float o = 0.f;
    for (int hh = 0; hh < heads; ++hh) o = fmaf(GT[t * heads + hh], ldf(m[hh * C + c]), o);
    o = rnd<T>(rnd<T>(o) + ldf(bp[c]));
    U0[t * ldu + c] = cvt<T>(ldf(U3[t * ldu + c]) + o);
    F1[t * ldf_ + c] = 0.f;
  }
  __syncthreads();
  ln_rows<T, TOK>(U0, ldu, (const T*)w.g2, (const T*)w.c2, C, U1, ldu, s.MU, s.R);
  __syncthreads();
  for (int c0 = 0; c0 < d.mh; c0 += d.chunk) {
    const int cw = min(d.chunk, d.mh - c0);
    auto to_h1 = [=](int t, int j, float acc) {
      H1[t * ldh + j] = cvt<T>(gelu(acc + ldf(bm1[c0 + j])));
    };
    M::nn(U1, ldu, C, (const T*)w.wm1 + c0, d.mh, cw, s.scratch, to_h1);
    __syncthreads();
    M::nn(H1, ldh, cw, (const T*)w.wm2 + (size_t)c0 * C, C, C, s.scratch,
          [=](int t, int j, float acc) { F1[t * ldf_ + j] += acc; });
    __syncthreads();
  }
  for (int i = tid; i < TOK * C; i += kThreads) {
    const int t = i / C, c = i % C;
    U2[t * ldu + c] =
        cvt<T>(ldf(U0[t * ldu + c]) + rnd<T>(rnd<T>(F1[t * ldf_ + c]) + ldf(bm2[c])));
  }
  __syncthreads();
}

template <typename T, int TOK>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ x, const T* __restrict__ wqk2, const T* __restrict__ m2,
           Weights w, T* __restrict__ y, Dims d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout lay = make_layout<T>(TOK, d.C, d.hid, d.chunk, d.heads, false);
  const Tile<T> s = carve<T>(smem_raw, lay);
  const int C = d.C, b = blockIdx.y, tile0 = blockIdx.x * TOK;
  const int n_valid = min(TOK, d.N - tile0);
  const size_t base = ((size_t)b * d.N + tile0) * C;

  load_rows<T, TOK>(x + base, n_valid, C, s.U0, s.ldu);
  __syncthreads();
  prefix_forward<T, TOK>(s, w, d);
  ln_rows<T, TOK>(s.U3, s.ldu, (const T*)w.g1, (const T*)w.c1, C, s.U3, s.ldu, nullptr,
                  nullptr);
  __syncthreads();
  for (int dd = 0; dd < 2; ++dd) {
    half_forward<T, TOK>(s, w, d, wqk2 + ((size_t)b * 2 + dd) * C * d.heads,
                         m2 + ((size_t)b * 2 + dd) * d.heads * C);
    ln_rows<T, TOK>(s.U2, s.ldu, (const T*)w.g3, (const T*)w.c3, C, s.U2, s.ldu, nullptr,
                    nullptr);
    __syncthreads();
    T* out = y + (size_t)dd * d.B * d.N * C + base;
    for (int i = threadIdx.x; i < n_valid * C; i += kThreads)
      out[i] = s.U2[(i / C) * s.ldu + i % C];
    __syncthreads();
  }
}

// offsets (in floats) of the 17 gradients inside one partial set, in the
// order of `Weights`
struct GradOffsets {
  size_t w1, b1, w2, b2, wpe, bpe, g1, c1, bp, g2, c2, wm1, bm1, wm2, bm2, g3, c3, total;
};

__host__ __device__ inline GradOffsets grad_offsets(int C, int hid, int mh) {
  GradOffsets o;
  size_t at = 0;
  o.w1 = take(at, (size_t)C * hid, 1);
  o.b1 = take(at, hid, 1);
  o.w2 = take(at, (size_t)hid * C, 1);
  o.b2 = take(at, C, 1);
  o.wpe = take(at, (size_t)C * C, 1);
  o.bpe = take(at, C, 1);
  o.g1 = take(at, C, 1);
  o.c1 = take(at, C, 1);
  o.bp = take(at, C, 1);
  o.g2 = take(at, C, 1);
  o.c2 = take(at, C, 1);
  o.wm1 = take(at, (size_t)C * mh, 1);
  o.bm1 = take(at, mh, 1);
  o.wm2 = take(at, (size_t)mh * C, 1);
  o.bm2 = take(at, C, 1);
  o.g3 = take(at, C, 1);
  o.c3 = take(at, C, 1);
  o.total = at;
  return o;
}

template <typename T, int TOK>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ x, const T* __restrict__ wqk2, const T* __restrict__ m2,
           Weights w, const T* __restrict__ dy, T* __restrict__ dx,
           float* __restrict__ dwqk_part, float* __restrict__ dm_part,
           float* __restrict__ dw_part, Dims d) {
  using M = Mm<T, TOK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Layout lay = make_layout<T>(TOK, d.C, d.hid, d.chunk, d.heads, true);
  const Tile<T> s = carve<T>(smem_raw, lay);
  const int C = d.C, hid = d.hid, mh = d.mh, heads = d.heads;
  const int ldu = s.ldu, ldf_ = s.ldf, ldh = s.ldh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const GradOffsets go = grad_offsets(C, hid, mh);
  float* gw = dw_part + blk * go.total;
  T *U0 = s.U0, *U1 = s.U1, *U2 = s.U2, *U3 = s.U3, *H1 = s.H1, *DH = s.DH;
  float *F0 = s.F0, *F1 = s.F1, *DA = s.DA, *H0 = s.H0, *G = s.G, *GT = s.GT, *DS = s.DS;
  float *mu2 = s.MU, *r2 = s.R, *mu3 = s.MU + TOK, *r3 = s.R + TOK, *mu1 = s.MU + 2 * TOK,
        *r1 = s.R + 2 * TOK;
  const T *g1 = (const T*)w.g1, *g2 = (const T*)w.g2, *g3 = (const T*)w.g3;
  const T *b1 = (const T*)w.b1, *bm1 = (const T*)w.bm1;
  const int tiles = (d.N + TOK - 1) / TOK;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tile0 = tile * TOK;
    const int n_valid = min(TOK, d.N - tile0);
    const size_t base = ((size_t)b * d.N + tile0) * C;

    // ---- recompute the shared prefix ----------------------------------
    load_rows<T, TOK>(x + base, n_valid, C, U0, ldu);
    for (int i = tid; i < TOK * ldf_; i += kThreads) DA[i] = 0.f;
    __syncthreads();
    prefix_forward<T, TOK>(s, w, d);
    ln_rows<T, TOK>(U3, ldu, g1, (const T*)w.c1, C, U3, ldu, nullptr, nullptr);
    __syncthreads();

    for (int dd = 0; dd < 2; ++dd) {
      const T* wqk = wqk2 + ((size_t)b * 2 + dd) * C * heads;
      const T* m = m2 + ((size_t)b * 2 + dd) * heads * C;
      float* gwqk = dwqk_part + (blk * 2 + dd) * C * heads;
      float* gm = dm_part + (blk * 2 + dd) * heads * C;
      const T* dyd = dy + (size_t)dd * d.B * d.N * C + base;
      auto dy_at = [=](int t, int c) {
        return t < n_valid ? ldf(dyd[(size_t)t * C + c]) : 0.f;
      };

      // ---- recompute this half: t4 in U0, b4 in U1, t5 in U2 ------------
      half_forward<T, TOK>(s, w, d, wqk, m);
      stats_rows<T, TOK>(U2, ldu, C, mu3, r3);
      __syncthreads();

      // ---- final norm, backward ------------------------------------------
      colsum<TOK>(gw + go.g3, C, [=](int t, int c) {
        return dy_at(t, c) * ((ldf(U2[t * ldu + c]) - mu3[t]) * r3[t]);
      });
      colsum<TOK>(gw + go.c3, C, dy_at);
      __syncthreads();
      ln_bwd_rows<T, TOK>(dy_at, U2, ldu, mu3, r3, g3, C, [=](int t, int c, float v) {
        F0[t * ldf_ + c] = v;        // dt5
        U2[t * ldu + c] = cvt<T>(v);  // dt5 in the IO type, over t5
      });
      __syncthreads();
      colsum<TOK>(gw + go.bm2, C, [=](int t, int c) { return F0[t * ldf_ + c]; });
      for (int i = tid; i < TOK * ldf_; i += kThreads) F1[i] = 0.f;  // db4
      __syncthreads();

      // ---- the MLP, backward, one hidden chunk at a time -------------------
      for (int c0 = 0; c0 < mh; c0 += d.chunk) {
        const int cw = min(d.chunk, mh - c0);
        M::nn(U1, ldu, C, (const T*)w.wm1 + c0, mh, cw, s.scratch,
              [=](int t, int j, float acc) {
                const float h0 = acc + ldf(bm1[c0 + j]);
                H0[t * d.chunk + j] = h0;
                H1[t * ldh + j] = cvt<T>(gelu(h0));
              });
        __syncthreads();
        M::nt(U2, ldu, C, (const T*)w.wm2 + (size_t)c0 * C, C, cw, s.scratch,
              [=](int t, int j, float acc) {
                const float dh0 = acc * dgelu(H0[t * d.chunk + j]);
                H0[t * d.chunk + j] = dh0;
                DH[t * ldh + j] = cvt<T>(dh0);
              });
        __syncthreads();
        M::outer(H1, ldh, cw, U2, ldu, C, gw + go.wm2 + (size_t)c0 * C, C);
        M::outer(U1, ldu, C, DH, ldh, cw, gw + go.wm1 + c0, mh);
        M::nt(DH, ldh, cw, (const T*)w.wm1 + c0, mh, C, s.scratch,
              [=](int t, int j, float acc) { F1[t * ldf_ + j] += acc; });
        colsum<TOK>(gw + go.bm1 + c0, cw, [=](int t, int j) { return H0[t * d.chunk + j]; });
        __syncthreads();
      }

      // ---- norm2 and the residual, backward --------------------------------
      colsum<TOK>(gw + go.g2, C, [=](int t, int c) {
        return F1[t * ldf_ + c] * ((ldf(U0[t * ldu + c]) - mu2[t]) * r2[t]);
      });
      colsum<TOK>(gw + go.c2, C, [=](int t, int c) { return F1[t * ldf_ + c]; });
      ln_bwd_rows<T, TOK>([=](int t, int c) { return rnd<T>(F1[t * ldf_ + c]); }, U0, ldu, mu2,
                          r2, g2, C, [=](int t, int c, float v) {
                            const float dt4 = F0[t * ldf_ + c] + v;
                            F0[t * ldf_ + c] = dt4;
                            U2[t * ldu + c] = cvt<T>(dt4);
                          });
      __syncthreads();

      // ---- the gate, backward ------------------------------------------------
      colsum<TOK>(gw + go.bp, C, [=](int t, int c) { return F0[t * ldf_ + c]; });
      for (int o = warp; o < TOK * heads; o += kWarps) {
        const int t = o / heads, hh = o % heads;
        float sum = 0.f;
        for (int c = lane; c < C; c += 32) sum += ldf(U2[t * ldu + c]) * ldf(m[hh * C + c]);
        sum = warp_sum(sum);
        if (lane == 0) {
          const float gf = G[o];
          DS[o] = rnd<T>(sum * gf * (1.f - gf) * d.scale);
        }
      }
      for (int i = tid; i < heads * C; i += kThreads) {
        const int hh = i / C, c = i % C;
        float sum = 0.f;
        for (int t = 0; t < TOK; ++t) sum = fmaf(GT[t * heads + hh], ldf(U2[t * ldu + c]), sum);
        gm[i] += sum;
      }
      __syncthreads();
      for (int i = tid; i < C * heads; i += kThreads) {
        const int c = i / heads, hh = i % heads;
        float sum = 0.f;
        for (int t = 0; t < TOK; ++t) sum = fmaf(ldf(U3[t * ldu + c]), DS[t * heads + hh], sum);
        gwqk[i] += sum;
      }
      for (int i = tid; i < TOK * C; i += kThreads) {
        const int t = i / C, c = i % C;
        float v = F0[t * ldf_ + c];
        for (int hh = 0; hh < heads; ++hh)
          v = fmaf(DS[t * heads + hh], ldf(wqk[c * heads + hh]), v);
        DA[t * ldf_ + c] += v;
      }
      __syncthreads();
    }

    // ---- the shared prefix, backward ----------------------------------------
    // x, t1, t2 and t3 are rebuilt (their buffers held the halves' tensors)
    for (int i = tid; i < TOK * C; i += kThreads) {
      const int t = i / C, c = i % C;
      U2[t * ldu + c] = cvt<T>(DA[t * ldf_ + c]);  // da in the IO type
    }
    load_rows<T, TOK>(x + base, n_valid, C, U0, ldu);
    __syncthreads();
    prefix_forward<T, TOK>(s, w, d);  // t1 in U1, t2 in U0, t3 in U3
    stats_rows<T, TOK>(U3, ldu, C, mu1, r1);
    __syncthreads();
    colsum<TOK>(gw + go.g1, C, [=](int t, int c) {
      return DA[t * ldf_ + c] * ((ldf(U3[t * ldu + c]) - mu1[t]) * r1[t]);
    });
    colsum<TOK>(gw + go.c1, C, [=](int t, int c) { return DA[t * ldf_ + c]; });
    ln_bwd_rows<T, TOK>([=](int t, int c) { return ldf(U2[t * ldu + c]); }, U3, ldu, mu1, r1,
                        g1, C, [=](int t, int c, float v) {
                          F0[t * ldf_ + c] = v;        // dt3
                          U2[t * ldu + c] = cvt<T>(v);  // dt3 in the IO type, over da
                        });
    __syncthreads();
    M::nt(U2, ldu, C, (const T*)w.wpe, C, C, s.scratch, [=](int t, int j, float acc) {
      F1[t * ldf_ + j] = acc;        // dt2
      U3[t * ldu + j] = cvt<T>(acc);  // dt2 in the IO type, over t3
    });
    M::outer(U0, ldu, C, U2, ldu, C, gw + go.wpe, C);
    colsum<TOK>(gw + go.bpe, C, [=](int t, int c) { return F0[t * ldf_ + c]; });
    __syncthreads();
    M::nt(U3, ldu, C, (const T*)w.w2, C, hid, s.scratch,
          [=](int t, int j, float acc) { F0[t * ldf_ + j] = acc; });  // dt1
    M::outer(U1, ldu, hid, U3, ldu, C, gw + go.w2, C);
    colsum<TOK>(gw + go.b2, C, [=](int t, int c) { return F1[t * ldf_ + c]; });
    __syncthreads();
    load_rows<T, TOK>(x + base, n_valid, C, U0, ldu);
    __syncthreads();
    M::nn(U0, ldu, C, (const T*)w.w1, hid, hid, s.scratch, [=](int t, int j, float acc) {
      const float dt0 = F0[t * ldf_ + j] * dgelu(acc + ldf(b1[j]));
      F0[t * ldf_ + j] = dt0;
      U1[t * ldu + j] = cvt<T>(dt0);  // over t1
    });
    __syncthreads();
    T* dxo = dx + base;
    M::nt(U1, ldu, hid, (const T*)w.w1, hid, C, s.scratch, [=](int t, int j, float acc) {
      if (t < n_valid) dxo[(size_t)t * C + j] = cvt<T>(acc);
    });
    M::outer(U0, ldu, C, U1, ldu, hid, gw + go.w1, hid);
    colsum<TOK>(gw + go.b1, hid, [=](int t, int j) { return F0[t * ldf_ + j]; });
    __syncthreads();
  }
}

// ===========================================================================
// The bf16 backward, in three launches:
//   stage A  recompute and cotangents: per token tile, dx, the per-image
//            d(wqk)/d(m) and the bias and LayerNorm-affine gradients into the
//            block's own float partial set, and the bf16 operands of the
//            weight-gradient products written to device memory;
//   stage B  the seven weight-gradient products dW = X^T dY as five GEMMs
//            (the two halves of wm1/wm2 contract over 2BN tokens), split over
//            token ranges into float partials;
//   reduce   every partial set summed in a fixed order.
// No float atomics anywhere: two launches give bit-equal gradients.
// ===========================================================================

// ---- PTX: cp.async, ldmatrix, mma.sync m16n8k16 (bf16 in, float sum) -------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void put2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ---- stage A ---------------------------------------------------------------
constexpr int TA = 32;          // tokens per tile
constexpr int KB = 32;          // contraction depth of one staged weight tile
constexpr int NP = kWarps * 16;  // output columns per pass, 16 per warp
constexpr int STAGES = 3;       // weight tiles in flight
constexpr int RING = NP * (KB + 8);  // bf16 per ring slot: >= KB * (NP + 8)

// A warp's share of one pass: all TA rows by 16 columns, as mma.sync
// accumulators v[row tile][n8 tile][c0..c3]; entry (r, q, e) is row
// r*16 + lane/4 + 8*(e/2), column j0 + q*8 + 2*(lane%4) + e%2.
struct Frag {
  float v[TA / 16][2][4];
};

// One pass of out[t, n0 + j] = sum_k A[t, k] W(k, n0 + j), j < ncols <= NP.
// A: the tile's rows in shared memory (bf16, row stride lda). W in global
// memory, row-major: NT false reads W[k * ldw + n] (x @ W), NT true reads
// W[n * ldw + k] (dy @ W^T). The weight tiles go through a ring of STAGES
// slots by cp.async, KB rows of the contraction at a time, and reach the
// tensor cores by ldmatrix (.trans for x @ W). Ends with a block barrier.
template <bool NT>
__device__ __forceinline__ void gemm_pass(Frag& f, const bf16* A, int lda, int K,
                                          const bf16* __restrict__ W, int ldw, int n0,
                                          int ncols, bf16* ring) {
  const int tid = threadIdx.x, lane = tid & 31, wc = (tid >> 5) * 16;
#pragma unroll
  for (int r = 0; r < TA / 16; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) f.v[r][q][e] = 0.f;
  const int nk = (K + KB - 1) / KB;
  auto load = [&](int kt) {
    bf16* dst = ring + (kt % STAGES) * RING;
    const int k0 = kt * KB, rows = min(KB, K - k0);
    for (int c = tid; c < NP * KB / 8; c += kThreads) {
      if (NT) {  // slot [NP][KB + 8]: output column j, contraction k
        const int j = c / (KB / 8), kk = (c % (KB / 8)) * 8;
        const bool ok = j < ncols && kk < rows;
        cp_async16(dst + j * (KB + 8) + kk, ok ? W + (size_t)(n0 + j) * ldw + k0 + kk : W, ok);
      } else {   // slot [KB][NP + 8]
        const int kk = c / (NP / 8), j = (c % (NP / 8)) * 8;
        const bool ok = kk < rows && j < ncols;
        cp_async16(dst + kk * (NP + 8) + j, ok ? W + (size_t)(k0 + kk) * ldw + n0 + j : W, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  const int q = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slot kt has landed; slot kt-1 is free again
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const bf16* tile = ring + (kt % STAGES) * RING;
    const int k0 = kt * KB, steps = min(KB, K - k0) / 16;
    if (wc < ncols) {
      for (int ks = 0; ks < steps; ++ks) {
        unsigned a[TA / 16][4], b[4];
#pragma unroll
        for (int r = 0; r < TA / 16; ++r)
          ldsm_x4(a[r], A + (r * 16 + (lane & 15)) * lda + k0 + ks * 16 + (lane >> 4) * 8);
        if (NT)
          ldsm_x4(b, tile + (wc + (q >> 1) * 8 + rr) * (KB + 8) + ks * 16 + (q & 1) * 8);
        else
          ldsm_x4_t(b, tile + (ks * 16 + (q & 1) * 8 + rr) * (NP + 8) + wc + (q >> 1) * 8);
#pragma unroll
        for (int r = 0; r < TA / 16; ++r) {
          mma16816(f.v[r][0], a[r], b[0], b[1]);
          mma16816(f.v[r][1], a[r], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// fn(t, j, v0, v1) for each pair of neighbouring columns the warp holds
template <typename Fn>
__device__ __forceinline__ void each_pair(const Frag& f, int j0, Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int r = 0; r < TA / 16; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(r * 16 + g + 8 * h, j0 + q * 8 + 2 * tq, f.v[r][q][2 * h], f.v[r][q][2 * h + 1]);
}

// G[j] += sum over the tile's rows of fn(t, j, v), for the warp's 16
// columns: the warp holds every row of them, so the sum is the warp's own
// (shuffles in a fixed order) and no other warp writes G[j].
template <typename Fn>
__device__ __forceinline__ void col_sums(const Frag& f, int j0, float* G, Fn fn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + q * 8 + 2 * tq + c;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < TA / 16; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) s += fn(r * 16 + g + 8 * h, j, f.v[r][q][2 * h + c]);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (g == 0) G[j] += s;
    }
}

// out[t, j] = A @ W (or A @ W^T), every pass handed to epi(frag, j0)
template <bool NT, typename Epi>
__device__ void gemm(const bf16* A, int lda, int K, const bf16* __restrict__ W, int ldw, int N,
                     bf16* ring, Epi epi) {
  const int wc = (threadIdx.x >> 5) * 16;
  for (int n0 = 0; n0 < N; n0 += NP) {
    Frag f;
    const int ncols = min(NP, N - n0);
    gemm_pass<NT>(f, A, lda, K, W, ldw, n0, ncols, ring);
    if (wc < ncols) epi(f, n0 + wc);
  }
  __syncthreads();
}

// A1 @ W1 and A2 @ W2^T over the same output columns, both handed to
// epi(f1, f2, j0): an elementwise product of the two stays in registers
template <typename Epi>
__device__ void gemm_pair(const bf16* A1, const bf16* __restrict__ W1, int ldw1, const bf16* A2,
                          const bf16* __restrict__ W2, int ldw2, int lda, int K, int N, bf16* ring,
                          Epi epi) {
  const int wc = (threadIdx.x >> 5) * 16;
  for (int n0 = 0; n0 < N; n0 += NP) {
    Frag f1, f2;
    const int ncols = min(NP, N - n0);
    gemm_pass<false>(f1, A1, lda, K, W1, ldw1, n0, ncols, ring);
    gemm_pass<true>(f2, A2, lda, K, W2, ldw2, n0, ncols, ring);
    if (wc < ncols) epi(f1, f2, n0 + wc);
  }
  __syncthreads();
}

// per-row LayerNorm-backward moments: m1[t] = mean_c up*g, m2[t] = mean_c up*g*xhat
template <typename Up, typename Xhat>
__device__ void ln_moments(Up up, Xhat xhat, const bf16* g, int C, float* m1, float* m2) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < TA; t += kWarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float u = up(t, c) * ldf(g[c]);
      s1 += u;
      s2 += u * xhat(t, c);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      m1[t] = s1 / C;
      m2[t] = s2 / C;
    }
  }
}

__device__ __forceinline__ float ln_bwd_at(float up, float g, float xhat, float r, float m1,
                                           float m2) {
  return r * (up * g - m1 - xhat * m2);
}

// the bf16 operands of stage B, row-major [tokens, width]; b4, h1, dt5
// and dh0 hold both halves, [2, B*N, width]
struct Operands {
  bf16 *t1, *t2, *dt3, *dt2, *dt0, *b4, *h1, *dt5, *dh0;
};

// offsets (in floats) of the 12 vector gradients inside stage A's per-block
// partial set
struct VecOffsets {
  int b1, b2, bpe, g1, c1, bp, g2, c2, bm1, bm2, g3, c3, total;
};

__host__ __device__ inline VecOffsets vec_offsets(int C, int hid, int mh) {
  VecOffsets o;
  o.b1 = 0;
  o.b2 = o.b1 + hid;
  o.bpe = o.b2 + C;
  o.g1 = o.bpe + C;
  o.c1 = o.g1 + C;
  o.bp = o.c1 + C;
  o.g2 = o.bp + C;
  o.c2 = o.g2 + C;
  o.bm1 = o.c2 + C;
  o.bm2 = o.bm1 + mh;
  o.g3 = o.bm2 + C;
  o.c3 = o.g3 + C;
  o.total = o.c3 + C;
  return o;
}

struct LayoutA {
  size_t u[5], hb, ring, stats, mom, gate, total;
  int ldu, ldh;
};

__host__ __device__ inline LayoutA layout_a(int C, int hid, int mh, int heads) {
  LayoutA l;
  l.ldu = (C > hid ? C : hid) + 8;  // +8: rows off the bank stride for ldmatrix
  l.ldh = mh + 8;
  size_t off = 0;
  for (int i = 0; i < 5; ++i) l.u[i] = take(off, (size_t)TA * l.ldu * 2, 128);
  l.hb = take(off, (size_t)TA * l.ldh * 2, 128);  // also [TA][C] float
  l.ring = take(off, (size_t)STAGES * RING * 2, 128);
  l.stats = take(off, (size_t)6 * TA * 4, 128);
  l.mom = take(off, (size_t)4 * TA * 4, 128);
  l.gate = take(off, (size_t)3 * TA * heads * 4, 128);
  l.total = off;
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
stage_a_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqk2,
               const bf16* __restrict__ m2, Weights w, const bf16* __restrict__ dy,
               bf16* __restrict__ dx, Operands ops, float* __restrict__ vec_part,
               float* __restrict__ dwqk_part, float* __restrict__ dm_part,
               float* __restrict__ da_scratch, Dims d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = d.C, hid = d.hid, mh = d.mh, H = d.heads;
  const LayoutA L = layout_a(C, hid, mh, H);
  const int ldu = L.ldu, ldh = L.ldh;
  bf16* U[5];
  for (int i = 0; i < 5; ++i) U[i] = reinterpret_cast<bf16*>(smem_raw + L.u[i]);
  bf16* HB = reinterpret_cast<bf16*>(smem_raw + L.hb);
  float* F = reinterpret_cast<float*>(smem_raw + L.hb);  // dt4 in float, [TA][C]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + L.ring);
  float* st = reinterpret_cast<float*>(smem_raw + L.stats);
  float *mu1 = st, *r1 = st + TA, *mu2 = st + 2 * TA, *r2 = st + 3 * TA, *mu3 = st + 4 * TA,
        *r3 = st + 5 * TA;
  float* mo = reinterpret_cast<float*>(smem_raw + L.mom);
  float *m1a = mo, *m2a = mo + TA, *m1b = mo + 2 * TA, *m2b = mo + 3 * TA;
  float* G = reinterpret_cast<float*>(smem_raw + L.gate);
  float *GT = G + TA * H, *DS = G + 2 * TA * H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const size_t BN = (size_t)d.B * d.N;
  const VecOffsets vo = vec_offsets(C, hid, mh);
  float* gv = vec_part + blk * vo.total;
  float* DA = da_scratch + blk * TA * C;
  const bf16 *W1 = (const bf16*)w.w1, *W2 = (const bf16*)w.w2, *Wpe = (const bf16*)w.wpe,
             *Wm1 = (const bf16*)w.wm1, *Wm2 = (const bf16*)w.wm2;
  const bf16 *b1 = (const bf16*)w.b1, *b2 = (const bf16*)w.b2, *bpe = (const bf16*)w.bpe,
             *g1 = (const bf16*)w.g1, *c1 = (const bf16*)w.c1, *bp = (const bf16*)w.bp,
             *g2 = (const bf16*)w.g2, *c2 = (const bf16*)w.c2, *bm1 = (const bf16*)w.bm1,
             *bm2 = (const bf16*)w.bm2, *g3 = (const bf16*)w.g3;
  bf16 *U0 = U[0], *U1 = U[1], *U2 = U[2], *U3 = U[3], *U4 = U[4];
  const int tiles = (d.N + TA - 1) / TA;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int nv = min(TA, d.N - tile * TA);
    const size_t row0 = (size_t)b * d.N + tile * TA;  // first token's row in [B*N, .]

    // ---- the shared prefix, forward: x in U0 -> t1 in U1 -> t2 in U0 -> t3 in U2
    load_rows<bf16, TA>(x + row0 * C, nv, C, U0, ldu);
    __syncthreads();
    gemm<false>(U0, ldu, C, W1, hid, hid, ring, [&](const Frag& f, int j0) {
      each_pair(f, j0, [&](int t, int j, float v0, float v1) {
        const float a0 = rnd<bf16>(gelu(v0 + ldf(b1[j]))), a1 = rnd<bf16>(gelu(v1 + ldf(b1[j + 1])));
        put2(U1 + t * ldu + j, a0, a1);
        if (t < nv) put2(ops.t1 + (row0 + t) * hid + j, a0, a1);
      });
    });
    gemm<false>(U1, ldu, hid, W2, C, C, ring, [&](const Frag& f, int j0) {
      each_pair(f, j0, [&](int t, int j, float v0, float v1) {
        const float a0 = rnd<bf16>(rnd<bf16>(v0) + ldf(b2[j]));
        const float a1 = rnd<bf16>(rnd<bf16>(v1) + ldf(b2[j + 1]));
        put2(U0 + t * ldu + j, a0, a1);
        if (t < nv) put2(ops.t2 + (row0 + t) * C + j, a0, a1);
      });
    });
    gemm<false>(U0, ldu, C, Wpe, C, C, ring, [&](const Frag& f, int j0) {
      each_pair(f, j0, [&](int t, int j, float v0, float v1) {
        put2(U2 + t * ldu + j, rnd<bf16>(v0) + ldf(bpe[j]), rnd<bf16>(v1) + ldf(bpe[j + 1]));
      });
    });
    stats_rows<bf16, TA>(U2, ldu, C, mu1, r1);
    __syncthreads();
    // a = LN1(t3), rebuilt where it is read
    auto a_at = [&](int t, int c) {
      return rnd<bf16>((ldf(U2[t * ldu + c]) - mu1[t]) * r1[t] * ldf(g1[c]) + ldf(c1[c]));
    };

    for (int dd = 0; dd < 2; ++dd) {
      const bf16* wqk = wqk2 + ((size_t)b * 2 + dd) * C * H;
      const bf16* m = m2 + ((size_t)b * 2 + dd) * H * C;
      float* gwqk = dwqk_part + (blk * 2 + dd) * C * H;
      float* gm = dm_part + (blk * 2 + dd) * H * C;
      const bf16* dyd = dy + (dd * BN + row0) * C;
      const size_t hrow0 = dd * BN + row0;  // row in the [2, B*N, .] operands
      auto dy_at = [&](int t, int c) { return t < nv ? ldf(dyd[(size_t)t * C + c]) : 0.f; };

      // ---- this half, forward: t4 in U0, b4 in U1, h1 in HB, t5 in U3
      for (int o = warp; o < TA * H; o += kWarps) {
        const int t = o / H, hh = o % H;
        float sum = 0.f;
        for (int c = lane; c < C; c += 32) sum += a_at(t, c) * ldf(wqk[c * H + hh]);
        sum = warp_sum(sum);
        if (lane == 0) {
          const float gf = sigmoid(sum * d.scale);
          G[o] = gf;
          GT[o] = rnd<bf16>(gf);
        }
      }
      __syncthreads();
      for (int i = tid; i < TA * C; i += kThreads) {
        const int t = i / C, c = i % C;
        float o = 0.f;
        for (int hh = 0; hh < H; ++hh) o = fmaf(GT[t * H + hh], ldf(m[hh * C + c]), o);
        o = rnd<bf16>(rnd<bf16>(o) + ldf(bp[c]));
        U0[t * ldu + c] = cvt<bf16>(a_at(t, c) + o);
      }
      __syncthreads();
      stats_rows<bf16, TA>(U0, ldu, C, mu2, r2);
      __syncthreads();
      for (int i = tid; i < TA * C; i += kThreads) {
        const int t = i / C, c = i % C;
        const bf16 v = cvt<bf16>((ldf(U0[t * ldu + c]) - mu2[t]) * r2[t] * ldf(g2[c]) + ldf(c2[c]));
        U1[t * ldu + c] = v;
        if (t < nv) ops.b4[(hrow0 + t) * C + c] = v;
      }
      __syncthreads();
      gemm<false>(U1, ldu, C, Wm1, mh, mh, ring, [&](const Frag& f, int j0) {
        each_pair(f, j0, [&](int t, int j, float v0, float v1) {
          const float a0 = rnd<bf16>(gelu(v0 + ldf(bm1[j])));
          const float a1 = rnd<bf16>(gelu(v1 + ldf(bm1[j + 1])));
          put2(HB + t * ldh + j, a0, a1);
          if (t < nv) put2(ops.h1 + (hrow0 + t) * mh + j, a0, a1);
        });
      });
      gemm<false>(HB, ldh, mh, Wm2, C, C, ring, [&](const Frag& f, int j0) {
        each_pair(f, j0, [&](int t, int j, float v0, float v1) {
          put2(U3 + t * ldu + j, ldf(U0[t * ldu + j]) + rnd<bf16>(rnd<bf16>(v0) + ldf(bm2[j])),
               ldf(U0[t * ldu + j + 1]) + rnd<bf16>(rnd<bf16>(v1) + ldf(bm2[j + 1])));
        });
      });
      stats_rows<bf16, TA>(U3, ldu, C, mu3, r3);
      __syncthreads();

      // ---- final norm, backward: dt5 in U4 (bf16); g3, c3, bm2
      auto xh3 = [&](int t, int c) { return (ldf(U3[t * ldu + c]) - mu3[t]) * r3[t]; };
      auto dt5_at = [&](int t, int c) {
        return ln_bwd_at(dy_at(t, c), ldf(g3[c]), xh3(t, c), r3[t], m1a[t], m2a[t]);
      };
      ln_moments(dy_at, xh3, g3, C, m1a, m2a);
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        float sg = 0.f, sc = 0.f, sb = 0.f;
        for (int t = 0; t < TA; ++t) {
          const float up = dy_at(t, c), v = dt5_at(t, c);
          sg += up * xh3(t, c);
          sc += up;
          sb += v;
          const bf16 vd = cvt<bf16>(v);
          U4[t * ldu + c] = vd;
          if (t < nv) ops.dt5[(hrow0 + t) * C + c] = vd;
        }
        gv[vo.g3 + c] += sg;
        gv[vo.c3 + c] += sc;
        gv[vo.bm2 + c] += sb;
      }
      __syncthreads();

      // ---- the MLP, backward, 128 hidden columns a pass: h0 = b4 @ Wm1 + bm1
      // is rebuilt beside dh1 = dt5 @ Wm2^T; dh0 = dh1 * gelu'(h0) in HB; bm1
      gemm_pair(U1, Wm1, mh, U4, Wm2, C, ldu, C, mh, ring,
                [&](const Frag& h0, const Frag& dh1, int j0) {
                  Frag dh;
                  const int tq = lane & 3;
#pragma unroll
                  for (int r = 0; r < TA / 16; ++r)
#pragma unroll
                    for (int q = 0; q < 2; ++q)
#pragma unroll
                      for (int e = 0; e < 4; ++e) {
                        const int j = j0 + q * 8 + 2 * tq + (e & 1);
                        dh.v[r][q][e] = dh1.v[r][q][e] * dgelu(h0.v[r][q][e] + ldf(bm1[j]));
                      }
                  col_sums(dh, j0, gv + vo.bm1, [](int, int, float v) { return v; });
                  each_pair(dh, j0, [&](int t, int j, float v0, float v1) {
                    put2(HB + t * ldh + j, v0, v1);
                    if (t < nv) put2(ops.dh0 + (hrow0 + t) * mh + j, v0, v1);
                  });
                });
      // db4 = dh0 @ Wm1^T, rounded into U1 (over b4); g2, c2 from the float sums
      gemm<true>(HB, ldh, mh, Wm1, mh, C, ring, [&](const Frag& f, int j0) {
        col_sums(f, j0, gv + vo.c2, [](int, int, float v) { return v; });
        col_sums(f, j0, gv + vo.g2, [&](int t, int j, float v) {
          return v * ((ldf(U0[t * ldu + j]) - mu2[t]) * r2[t]);
        });
        each_pair(f, j0, [&](int t, int j, float v0, float v1) { put2(U1 + t * ldu + j, v0, v1); });
      });

      // ---- norm2 and the residual, backward: dt4 = dt5 + LN2'(db4) in F
      // (float) and in U3 (bf16, over t5, read first by the same thread); bp
      auto xh2 = [&](int t, int c) { return (ldf(U0[t * ldu + c]) - mu2[t]) * r2[t]; };
      auto db4_at = [&](int t, int c) { return ldf(U1[t * ldu + c]); };
      ln_moments(db4_at, xh2, g2, C, m1b, m2b);
      __syncthreads();
      for (int c = tid; c < C; c += kThreads) {
        float sb = 0.f;
        for (int t = 0; t < TA; ++t) {
          const float v = dt5_at(t, c) +
                          ln_bwd_at(db4_at(t, c), ldf(g2[c]), xh2(t, c), r2[t], m1b[t], m2b[t]);
          sb += v;
          F[t * C + c] = v;
          U3[t * ldu + c] = cvt<bf16>(v);
        }
        gv[vo.bp + c] += sb;
      }
      __syncthreads();

      // ---- the gate, backward: ds; d(m), d(wqk); da += dt4 + ds @ wqk^T
      for (int o = warp; o < TA * H; o += kWarps) {
        const int t = o / H, hh = o % H;
        float sum = 0.f;
        for (int c = lane; c < C; c += 32) sum += ldf(U3[t * ldu + c]) * ldf(m[hh * C + c]);
        sum = warp_sum(sum);
        if (lane == 0) {
          const float gf = G[o];
          DS[o] = rnd<bf16>(sum * gf * (1.f - gf) * d.scale);
        }
      }
      for (int i = tid; i < H * C; i += kThreads) {
        const int hh = i / C, c = i % C;
        float sum = 0.f;
        for (int t = 0; t < TA; ++t) sum = fmaf(GT[t * H + hh], ldf(U3[t * ldu + c]), sum);
        gm[i] += sum;
      }
      __syncthreads();
      for (int i = tid; i < C * H; i += kThreads) {
        const int c = i / H, hh = i % H;
        float sum = 0.f;
        for (int t = 0; t < TA; ++t) sum = fmaf(a_at(t, c), DS[t * H + hh], sum);
        gwqk[i] += sum;
      }
      for (int i = tid; i < TA * C; i += kThreads) {
        const int t = i / C, c = i % C;
        float e = 0.f;
        for (int hh = 0; hh < H; ++hh) e = fmaf(DS[t * H + hh], ldf(wqk[c * H + hh]), e);
        const float v = F[i] + e;
        DA[i] = dd ? DA[i] + v : v;
      }
      __syncthreads();
    }

    // ---- the shared prefix, backward. norm1: dt3 in U0; g1, c1, bpe
    auto xh1 = [&](int t, int c) { return (ldf(U2[t * ldu + c]) - mu1[t]) * r1[t]; };
    auto dad_at = [&](int t, int c) { return rnd<bf16>(DA[t * C + c]); };
    ln_moments(dad_at, xh1, g1, C, m1a, m2a);
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float sg = 0.f, sc = 0.f, sb = 0.f;
      for (int t = 0; t < TA; ++t) {
        const float da = DA[t * C + c], xh = xh1(t, c);
        const float v = ln_bwd_at(rnd<bf16>(da), ldf(g1[c]), xh, r1[t], m1a[t], m2a[t]);
        sg += da * xh;
        sc += da;
        sb += v;
        const bf16 vd = cvt<bf16>(v);
        U0[t * ldu + c] = vd;
        if (t < nv) ops.dt3[(row0 + t) * C + c] = vd;
      }
      gv[vo.g1 + c] += sg;
      gv[vo.c1 + c] += sc;
      gv[vo.bpe + c] += sb;
    }
    __syncthreads();
    // dt2 = dt3 @ Wpe^T in U1; b2
    gemm<true>(U0, ldu, C, Wpe, C, C, ring, [&](const Frag& f, int j0) {
      col_sums(f, j0, gv + vo.b2, [](int, int, float v) { return v; });
      each_pair(f, j0, [&](int t, int j, float v0, float v1) {
        put2(U1 + t * ldu + j, v0, v1);
        if (t < nv) put2(ops.dt2 + (row0 + t) * C + j, v0, v1);
      });
    });
    // t0 = x @ W1 + b1 rebuilt beside dt1 = dt2 @ W2^T; dt0 = dt1 * gelu'(t0) in U4; b1
    load_rows<bf16, TA>(x + row0 * C, nv, C, U3, ldu);
    __syncthreads();
    gemm_pair(U3, W1, hid, U1, W2, C, ldu, C, hid, ring,
              [&](const Frag& t0, const Frag& dt1, int j0) {
                Frag g0;
                const int tq = lane & 3;
#pragma unroll
                for (int r = 0; r < TA / 16; ++r)
#pragma unroll
                  for (int q = 0; q < 2; ++q)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                      const int j = j0 + q * 8 + 2 * tq + (e & 1);
                      g0.v[r][q][e] = dt1.v[r][q][e] * dgelu(t0.v[r][q][e] + ldf(b1[j]));
                    }
                col_sums(g0, j0, gv + vo.b1, [](int, int, float v) { return v; });
                each_pair(g0, j0, [&](int t, int j, float v0, float v1) {
                  put2(U4 + t * ldu + j, v0, v1);
                  if (t < nv) put2(ops.dt0 + (row0 + t) * hid + j, v0, v1);
                });
              });
    // dx = dt0 @ W1^T
    gemm<true>(U4, ldu, hid, W1, hid, C, ring, [&](const Frag& f, int j0) {
      each_pair(f, j0, [&](int t, int j, float v0, float v1) {
        if (t < nv) put2(dx + (row0 + t) * C + j, v0, v1);
      });
    });
  }
}

// ---- stage B: dW[M, N] = X^T D over a token range -------------------------
constexpr int BT = 128;  // output tile: BT x BT, 8 warps as 2 x 4 of 64 x 32
constexpr int KT = 32;   // tokens per staged tile
constexpr int SB = 4;    // stages
constexpr int LDT = BT + 8;

struct Product {    // host-side description, one per weight matrix
  const void* X;    // [tokens, M] bf16
  const void* D;    // [tokens, N] bf16
  void* part;       // [splits, M, N] float
  int M, N;
  long long tokens, split;  // tokens per split
};

constexpr int kMaxProducts = 8;
struct ProductSet {
  Product p[kMaxProducts];
  int first[kMaxProducts + 1];  // first work item of each product
  int count;
};

__global__ void __launch_bounds__(kThreads, 2) stage_b_kernel(ProductSet ps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [SB][KT][LDT]
  bf16* sB = sA + SB * KT * LDT;
  int pi = 0;
  while (pi + 1 < ps.count && (int)blockIdx.x >= ps.first[pi + 1]) ++pi;
  const Product& P = ps.p[pi];
  const int M = P.M, N = P.N;
  const int splits = (int)((P.tokens + P.split - 1) / P.split);
  const int mt = (M + BT - 1) / BT;
  int item = blockIdx.x - ps.first[pi];
  const int s = item % splits;
  item /= splits;
  const int m0 = (item % mt) * BT, n0 = (item / mt) * BT;
  const long long t0 = (long long)s * P.split, t1 = min(t0 + P.split, P.tokens);
  const bf16* X = (const bf16*)P.X;
  const bf16* D = (const bf16*)P.D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int nk = (int)((t1 - t0 + KT - 1) / KT);

  auto load = [&](int kt) {
    const int slot = kt % SB;
    const long long base = t0 + (long long)kt * KT;
    for (int c = tid; c < 2 * KT * BT / 8; c += kThreads) {
      const int which = c / (KT * BT / 8), cc = c % (KT * BT / 8);
      const int r = cc / (BT / 8), col = (cc % (BT / 8)) * 8;
      const long long tok = base + r;
      if (which == 0) {
        const bool ok = tok < t1 && m0 + col < M;
        cp_async16(sA + (slot * KT + r) * LDT + col, ok ? X + tok * M + m0 + col : X, ok);
      } else {
        const bool ok = tok < t1 && n0 + col < N;
        cp_async16(sB + (slot * KT + r) * LDT + col, ok ? D + tok * N + n0 + col : D, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int st = 0; st < SB - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
  const int q = lane >> 3, rr = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<SB - 2>();
    __syncthreads();
    if (kt + SB - 1 < nk) load(kt + SB - 1);
    cp_async_commit();
    const bf16* a_t = sA + (kt % SB) * KT * LDT;
    const bf16* b_t = sB + (kt % SB) * KT * LDT;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      unsigned a[4][4], bb[2][4];
      // A = X^T: stored [token][m], so ldmatrix .trans gives the row-major fragment
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4_t(a[i], a_t + (ks * 16 + (q >> 1) * 8 + rr) * LDT + wm + i * 16 + (q & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4_t(bb[jj], b_t + (ks * 16 + (q & 1) * 8 + rr) * LDT + wn + jj * 16 + (q >> 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn)
          mma16816(acc[i][jn], a[i], bb[jn >> 1][(jn & 1) * 2], bb[jn >> 1][(jn & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  float* out = (float*)P.part + (size_t)s * M * N;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m0 + wm + i * 16 + g + 8 * h, nn = n0 + wn + jn * 8 + 2 * tq;
        if (mm < M && nn < N)
          *reinterpret_cast<float2*>(out + (size_t)mm * N + nn) =
              make_float2(acc[i][jn][2 * h], acc[i][jn][2 * h + 1]);
      }
}

// ---- the reduction ---------------------------------------------------------
struct Segment {  // out[g * n + e] = sum over p < nparts of part[g * gstride + p * pstride + e]
  const void* part;
  void* out;
  long long n, pstride, gstride;
  int nparts, groups;
};

constexpr int kMaxSegments = 24;
struct SegmentSet {
  Segment s[kMaxSegments];
  long long first[kMaxSegments + 1];  // first output element of each segment
  int count;
};

__global__ void reduce_kernel(SegmentSet ss) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ss.first[ss.count]) return;
  int k = 0;
  while (i >= ss.first[k + 1]) ++k;
  const Segment& S = ss.s[k];
  const long long local = i - ss.first[k], g = local / S.n, e = local % S.n;
  const float* p = (const float*)S.part + g * S.gstride + e;
  float sum = 0.f;
  for (int j = 0; j < S.nparts; ++j) sum += p[(long long)j * S.pstride];
  ((float*)S.out)[local] = sum;
}

Weights make_weights(const void* const* ws) {
  return Weights{ws[0], ws[1], ws[2],  ws[3],  ws[4],  ws[5],  ws[6],  ws[7], ws[8],
                 ws[9], ws[10], ws[11], ws[12], ws[13], ws[14], ws[15], ws[16]};
}

template <typename T, int TOK>
int launch_fwd(const void* x, const void* wqk2, const void* m2, const Weights& w, void* y,
               Dims d, cudaStream_t stream) {
  const size_t smem = make_layout<T>(TOK, d.C, d.hid, d.chunk, d.heads, false).total;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, TOK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.N + TOK - 1) / TOK, d.B);
  fwd_kernel<T, TOK><<<grid, kThreads, smem, stream>>>((const T*)x, (const T*)wqk2,
                                                       (const T*)m2, w, (T*)y, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// array of that type unless said otherwise: x [B, N, C], wqk2 [B, 2, C, heads],
// m2 [B, 2, heads, C], y [2, B, N, C]; ws: a host array of the 17 weight
// pointers in the order w1 [C, hidden], b1, w2 [hidden, C], b2, wpe [C, C],
// bpe, g1, c1, bp, g2, c2, wm1 [C, mlp_hidden], bm1, wm2 [mlp_hidden, C],
// bm2, g3, c3. float32 needs C, hidden and mlp_hidden to be multiples of 4;
// bf16 needs C = 304 or 112, hidden = 256, mlp_hidden a multiple of 64 and
// heads = 4 (chain::supported). Returns the launch's cudaError_t (0 on
// success).
int cavp_fusion_train_fwd(int dtype, const void* x, const void* wqk2, const void* m2,
                          const void* const* ws, void* y, int B, int N, int C, int hidden,
                          int mlp_hidden, int heads, float scale, void* stream) {
  const Weights w = make_weights(ws);
  Dims d{B, N, C, hidden, mlp_hidden, heads, 320, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && !(C % 4 || hidden % 4 || mlp_hidden % 4))
    return launch_fwd<float, 16>(x, wqk2, m2, w, y, d, s);
  if (dtype == 1 && chain::supported(C, hidden, mlp_hidden, heads)) {
    typedef const bf16* P;
    const chain::Args a{(P)x,     (P)wqk2,  (P)m2,    (P)w.w1,  (P)w.b1,  (P)w.w2,
                        (P)w.b2,  (P)w.wpe, (P)w.bpe, (P)w.g1,  (P)w.c1,  (P)w.bp,
                        (P)w.g2,  (P)w.c2,  (P)w.wm1, (P)w.bm1, (P)w.wm2, (P)w.bm2,
                        (P)w.g3,  (P)w.c3,  (bf16*)y, B,        N,        mlp_hidden,
                        scale};
    return chain::launch<true>(a, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef CHAIN_STAMPS
// The bf16 forward's stage counters (3 x chain::kStamps), read and zeroed.
int cavp_chain_stamps_train(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, chain::g_stamps, sizeof(chain::g_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[3 * chain::kStamps] = {};
  return (int)cudaMemcpyToSymbol(chain::g_stamps, zero, sizeof(zero));
}
#endif

// The float32 backward in one launch, tiles of 16 tokens: dy [2, B, N, C]
// and dx [B, N, C] float. The partial sets are float and zeroed by the
// caller: dw_part [B * per_image, total] (the 17 gradients back to back, in
// the order of ws), dwqk_part [B, per_image, 2, C, heads], dm_part [B,
// per_image, 2, heads, C]; per_image blocks walk each image's tiles.
int cavp_fusion_train_bwd_f32(const void* x, const void* wqk2, const void* m2,
                              const void* const* ws, const void* dy, void* dx, void* dwqk_part,
                              void* dm_part, void* dw_part, int per_image, int B, int N, int C,
                              int hidden, int mlp_hidden, int heads, float scale, void* stream) {
  if (per_image < 1 || C % 4 || hidden % 4 || mlp_hidden % 4) return (int)cudaErrorInvalidValue;
  const Dims d{B, N, C, hidden, mlp_hidden, heads, 128, scale};
  const size_t smem = make_layout<float>(16, C, hidden, d.chunk, heads, true).total;
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<float, 16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<float, 16><<<dim3(per_image, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wqk2, (const float*)m2, make_weights(ws), (const float*)dy,
      (float*)dx, (float*)dwqk_part, (float*)dm_part, (float*)dw_part, d);
  return (int)cudaGetLastError();
}

// Stage A of the bf16 backward. x, dy, dx as above in bf16; ops: a host
// array of the 9 operand pointers in the order t1 [B*N, hidden], t2, dt3,
// dt2 [B*N, C], dt0 [B*N, hidden], b4 [2, B*N, C], h1 [2, B*N, mlp_hidden],
// dt5 [2, B*N, C], dh0 [2, B*N, mlp_hidden]. Float, zeroed by the caller:
// vec_part [B * per_image, vec total] (b1, b2, bpe, g1, c1, bp, g2, c2, bm1,
// bm2, g3, c3 back to back), dwqk_part and dm_part as above; da_scratch
// [B * per_image, 32, C] float, no initial value. Needs C, hidden and
// mlp_hidden multiples of 16 and mlp_hidden >= 2 C - 8.
int cavp_fusion_train_bwd_a(const void* x, const void* wqk2, const void* m2,
                            const void* const* ws, const void* dy, void* dx,
                            void* const* ops, void* vec_part, void* dwqk_part, void* dm_part,
                            void* da_scratch, int per_image, int B, int N, int C, int hidden,
                            int mlp_hidden, int heads, float scale, void* stream) {
  if (per_image < 1 || C % 16 || hidden % 16 || mlp_hidden % 16 || mlp_hidden + 8 < 2 * C)
    return (int)cudaErrorInvalidValue;
  const Dims d{B, N, C, hidden, mlp_hidden, heads, 0, scale};
  const size_t smem = layout_a(C, hidden, mlp_hidden, heads).total;
  cudaError_t err = cudaFuncSetAttribute(stage_a_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bf16* const* o = (bf16* const*)ops;
  const Operands op{o[0], o[1], o[2], o[3], o[4], o[5], o[6], o[7], o[8]};
  stage_a_kernel<<<dim3(per_image, B), kThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wqk2, (const bf16*)m2, make_weights(ws), (const bf16*)dy,
      (bf16*)dx, op, (float*)vec_part, (float*)dwqk_part, (float*)dm_part, (float*)da_scratch,
      d);
  return (int)cudaGetLastError();
}

// Stage B: for each of `count` products (a host array of Product: X [tokens,
// M] and D [tokens, N] bf16, M and N multiples of 16; part [splits, M, N]
// float with splits = ceil(tokens / split)), part[s] = X[range s]^T D[range s].
int cavp_fusion_train_bwd_b(const void* products, int count, void* stream) {
  if (count < 1 || count > kMaxProducts) return (int)cudaErrorInvalidValue;
  ProductSet ps;
  ps.count = count;
  ps.first[0] = 0;
  for (int i = 0; i < count; ++i) {
    const Product& P = ((const Product*)products)[i];
    if (P.M % 16 || P.N % 16 || P.tokens < 1 || P.split < 1) return (int)cudaErrorInvalidValue;
    ps.p[i] = P;
    const long long splits = (P.tokens + P.split - 1) / P.split;
    ps.first[i + 1] = ps.first[i] + (int)(splits * ((P.M + BT - 1) / BT) * ((P.N + BT - 1) / BT));
  }
  const int smem = 2 * SB * KT * LDT * 2;
  cudaError_t err =
      cudaFuncSetAttribute(stage_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  stage_b_kernel<<<ps.first[count], kThreads, smem, (cudaStream_t)stream>>>(ps);
  return (int)cudaGetLastError();
}

// The fixed-order reduction of `count` segments (a host array of Segment).
int cavp_fusion_train_reduce(const void* segments, int count, void* stream) {
  if (count < 1 || count > kMaxSegments) return (int)cudaErrorInvalidValue;
  SegmentSet ss;
  ss.count = count;
  ss.first[0] = 0;
  for (int i = 0; i < count; ++i) {
    ss.s[i] = ((const Segment*)segments)[i];
    if (ss.s[i].n < 1 || ss.s[i].nparts < 1 || ss.s[i].groups < 1)
      return (int)cudaErrorInvalidValue;
    ss.first[i + 1] = ss.first[i] + ss.s[i].n * ss.s[i].groups;
  }
  const int threads = 256;
  const long long blocks = (ss.first[count] + threads - 1) / threads;
  reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(ss);
  return (int)cudaGetLastError();
}

}  // extern "C"
