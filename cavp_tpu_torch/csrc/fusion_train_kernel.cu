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
// Design. A block holds one tile of tokens and its intermediates in shared
// memory and streams the weights from global memory (L2), as the eval
// kernel does. The three kinds of product the TPU kernel has (x @ W,
// dy @ W^T, x^T @ dy) are three block-wide routines with a per-element
// epilogue, `Mm::nn`, `Mm::nt` and `Mm::outer`:
// - bf16: 16x16x16 WMMA tiles with float accumulators, one output column
//   tile per warp at a time, the epilogue through a per-warp float scratch;
//   W^T and x^T are read as column-major fragments, so no transpose is
//   stored.
// - float32: the tensor cores have no full-float mode, so these run on the
//   CUDA cores (one output column per thread, float4 rows). This path
//   serves float32 configurations and the parity checks.
// The 4C-wide MLP hidden is walked in chunks in both directions; the
// backward walks it twice per half (once to rebuild t5, once to propagate),
// which keeps its shared memory within 227 KB at a tile of 16 tokens
// (float32) or 32 tokens in chunks of 64 hidden columns (bf16).
//
// The TPU kernel adds all weight gradients into buffers that stay resident
// across a sequential grid. Here blocks run in parallel: the backward grid
// is (blocks per image, B), at most one block per SM so that all run in one
// wave, each block walks its own token tiles of one
// image and adds into its own float partial set in global memory (weight
// gradients, and that image's d(wqk), d(m)); `reduce_kernel` then sums the
// sets in a fixed order. No atomics: the result does not depend on
// scheduling. The ragged last tile is masked here (zero x and dy rows add
// nothing to any sum), with no host-side padding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

  // the CUDA-core routines have one thread per column: nothing to split
  template <typename Epi>
  static __device__ void nn_narrow(const float* A, int lda, int K, const float* W, int ldw,
                                   int N, float* scratch, Epi epi) {
    nn(A, lda, K, W, ldw, N, scratch, epi);
  }
  template <typename Epi>
  static __device__ void nt_narrow(const float* D, int ldd, int N, const float* W, int ldw,
                                   int K, float* scratch, Epi epi) {
    nt(D, ldd, N, W, ldw, K, scratch, epi);
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

template <int TOK> struct Mm<bf16, TOK> {
  static constexpr int RT = TOK / 16;  // row tiles
  using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                       nvcuda::wmma::row_major>;
  using FragAT = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                        nvcuda::wmma::col_major>;
  using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                       nvcuda::wmma::row_major>;
  using FragBT = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                        nvcuda::wmma::col_major>;
  using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

  template <typename Epi>
  static __device__ __forceinline__ void finish(const FragC (&acc)[RT], float* scratch,
                                                int j0, Epi epi) {
    const int lane = threadIdx.x & 31;
    float* mine = scratch + (threadIdx.x >> 5) * 256;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      nvcuda::wmma::store_matrix_sync(mine, acc[r], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) epi(r * 16 + e / 16, j0 + e % 16, mine[e]);
      __syncwarp();
    }
  }

  template <typename Epi>
  static __device__ void nn(const bf16* A, int lda, int K, const bf16* W, int ldw, int N,
                            float* scratch, Epi epi) {
    for (int ct = threadIdx.x >> 5; ct < N / 16; ct += kWarps) {
      FragC acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) nvcuda::wmma::fill_fragment(acc[r], 0.f);
      FragA a;
      FragB b;
      for (int k = 0; k < K; k += 16) {
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)k * ldw + ct * 16, ldw);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          nvcuda::wmma::load_matrix_sync(a, A + r * 16 * lda + k, lda);
          nvcuda::wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      }
      finish(acc, scratch, ct * 16, epi);
    }
  }

  template <typename Epi>
  static __device__ void nt(const bf16* D, int ldd, int N, const bf16* W, int ldw, int K,
                            float* scratch, Epi epi) {
    for (int ct = threadIdx.x >> 5; ct < K / 16; ct += kWarps) {
      FragC acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) nvcuda::wmma::fill_fragment(acc[r], 0.f);
      FragA a;
      FragBT b;  // b(n, j) = W[(ct*16 + j) * ldw + n0 + n]
      for (int n = 0; n < N; n += 16) {
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)ct * 16 * ldw + n, ldw);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          nvcuda::wmma::load_matrix_sync(a, D + r * 16 * ldd + n, ldd);
          nvcuda::wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      }
      finish(acc, scratch, ct * 16, epi);
    }
  }

  // one 16x16 result tile (row tile r, columns from j0) through the warp's scratch
  template <typename Epi>
  static __device__ __forceinline__ void finish_one(const FragC& acc, float* scratch, int r,
                                                    int j0, Epi epi) {
    const int lane = threadIdx.x & 31;
    float* mine = scratch + (threadIdx.x >> 5) * 256;
    nvcuda::wmma::store_matrix_sync(mine, acc, 16, nvcuda::wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(r * 16 + e / 16, j0 + e % 16, mine[e]);
    __syncwarp();
  }

  // nn and nt for a result with fewer column tiles than warps (a chunk of
  // the MLP hidden in the backward): a warp takes one row tile of one
  // column tile, so that none idles. The sums run in the same order.
  template <typename Epi>
  static __device__ void nn_narrow(const bf16* A, int lda, int K, const bf16* W, int ldw,
                                   int N, float* scratch, Epi epi) {
    for (int u = threadIdx.x >> 5; u < (N / 16) * RT; u += kWarps) {
      const int ct = u / RT, r = u % RT;
      FragC acc;
      nvcuda::wmma::fill_fragment(acc, 0.f);
      FragA a;
      FragB b;
      for (int k = 0; k < K; k += 16) {
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)k * ldw + ct * 16, ldw);
        nvcuda::wmma::load_matrix_sync(a, A + r * 16 * lda + k, lda);
        nvcuda::wmma::mma_sync(acc, a, b, acc);
      }
      finish_one(acc, scratch, r, ct * 16, epi);
    }
  }

  template <typename Epi>
  static __device__ void nt_narrow(const bf16* D, int ldd, int N, const bf16* W, int ldw,
                                   int K, float* scratch, Epi epi) {
    for (int u = threadIdx.x >> 5; u < (K / 16) * RT; u += kWarps) {
      const int ct = u / RT, r = u % RT;
      FragC acc;
      nvcuda::wmma::fill_fragment(acc, 0.f);
      FragA a;
      FragBT b;
      for (int n = 0; n < N; n += 16) {
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)ct * 16 * ldw + n, ldw);
        nvcuda::wmma::load_matrix_sync(a, D + r * 16 * ldd + n, ldd);
        nvcuda::wmma::mma_sync(acc, a, b, acc);
      }
      finish_one(acc, scratch, r, ct * 16, epi);
    }
  }

  static __device__ void outer(const bf16* A, int lda, int K, const bf16* D, int ldd,
                               int N, float* G, int ldg) {
    // a warp takes U result tiles at a time: their accumulators come from
    // global memory, and U loads in flight hide what one would wait for
    constexpr int U = 4;
    const int nts = N / 16, tiles = (K / 16) * nts, warp = threadIdx.x >> 5;
    for (int first = warp; first < tiles; first += kWarps * U) {
      FragC acc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tile = first + u * kWarps;
        if (tile < tiles)
          nvcuda::wmma::load_matrix_sync(
              acc[u], G + (size_t)(tile / nts) * 16 * ldg + (tile % nts) * 16, ldg,
              nvcuda::wmma::mem_row_major);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tile = first + u * kWarps;
        if (tile >= tiles) continue;
        const int kt = tile / nts, nt_ = tile % nts;
        FragAT a;  // a(k, t) = A[t * lda + kt*16 + k]
        FragB b;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          nvcuda::wmma::load_matrix_sync(a, A + r * 16 * lda + kt * 16, lda);
          nvcuda::wmma::load_matrix_sync(b, D + r * 16 * ldd + nt_ * 16, ldd);
          nvcuda::wmma::mma_sync(acc[u], a, b, acc[u]);
        }
        nvcuda::wmma::store_matrix_sync(G + (size_t)kt * 16 * ldg + nt_ * 16, acc[u], ldg,
                                        nvcuda::wmma::mem_row_major);
      }
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
template <typename T, int TOK, bool NARROW>
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
    if (NARROW)  // the backward's 64-column chunks
      M::nn_narrow(U1, ldu, C, (const T*)w.wm1 + c0, d.mh, cw, s.scratch, to_h1);
    else
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
    half_forward<T, TOK, false>(s, w, d, wqk2 + ((size_t)b * 2 + dd) * C * d.heads,
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
      half_forward<T, TOK, true>(s, w, d, wqk, m);
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
        M::nn_narrow(U1, ldu, C, (const T*)w.wm1 + c0, mh, cw, s.scratch,
              [=](int t, int j, float acc) {
                const float h0 = acc + ldf(bm1[c0 + j]);
                H0[t * d.chunk + j] = h0;
                H1[t * ldh + j] = cvt<T>(gelu(h0));
              });
        __syncthreads();
        M::nt_narrow(U2, ldu, C, (const T*)w.wm2 + (size_t)c0 * C, C, cw, s.scratch,
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

// out[g, i] = sum_p part[g, p, i], p in stored order
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int nparts, long long n, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long g = i / n, e = i % n;
  const float* p = part + g * nparts * n + e;
  float s = 0.f;
  for (int k = 0; k < nparts; ++k) s += p[(long long)k * n];
  out[i] = s;
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

template <typename T, int TOK>
int launch_bwd(const void* x, const void* wqk2, const void* m2, const Weights& w,
               const void* dy, void* dx, float* dwqk_part, float* dm_part, float* dw_part,
               int per_image, Dims d, cudaStream_t stream) {
  const size_t smem = make_layout<T>(TOK, d.C, d.hid, d.chunk, d.heads, true).total;
  cudaError_t err = cudaFuncSetAttribute(bwd_kernel<T, TOK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(per_image, d.B);
  bwd_kernel<T, TOK><<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const T*)wqk2, (const T*)m2, w, (const T*)dy, (T*)dx, dwqk_part, dm_part,
      dw_part, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// array of that type unless said otherwise: x [B, N, C], wqk2 [B, 2, C, heads],
// m2 [B, 2, heads, C], y [2, B, N, C]; ws: a host array of the 17 weight
// pointers in the order w1 [C, hidden], b1, w2 [hidden, C], b2, wpe [C, C],
// bpe, g1, c1, bp, g2, c2, wm1 [C, mlp_hidden], bm1, wm2 [mlp_hidden, C],
// bm2, g3, c3. float32 needs C, hidden and mlp_hidden to be multiples of 4,
// bf16 multiples of 16. Returns the launch's cudaError_t (0 on success).
int cavp_fusion_train_fwd(int dtype, const void* x, const void* wqk2, const void* m2,
                          const void* const* ws, void* y, int B, int N, int C, int hidden,
                          int mlp_hidden, int heads, float scale, void* stream) {
  const Weights w = make_weights(ws);
  Dims d{B, N, C, hidden, mlp_hidden, heads, 320, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && !(C % 4 || hidden % 4 || mlp_hidden % 4))
    return launch_fwd<float, 16>(x, wqk2, m2, w, y, d, s);
  if (dtype == 1 && !(C % 16 || hidden % 16 || mlp_hidden % 16))
    return launch_fwd<bf16, 32>(x, wqk2, m2, w, y, d, s);
  return (int)cudaErrorInvalidValue;
}

// dy [2, B, N, C] and dx [B, N, C] in the IO type. The partial sets are
// float and zeroed by the caller: dw_part [B * per_image, total] (the 17
// gradients back to back, in the order of ws), dwqk_part [B, per_image, 2,
// C, heads], dm_part [B, per_image, 2, heads, C]. per_image blocks walk each
// image's token tiles of `tokens` tokens (float32: 16, bf16: 32).
int cavp_fusion_train_bwd(int dtype, const void* x, const void* wqk2, const void* m2,
                          const void* const* ws, const void* dy, void* dx, void* dwqk_part,
                          void* dm_part, void* dw_part, int per_image, int tokens, int B,
                          int N, int C, int hidden, int mlp_hidden, int heads, float scale,
                          void* stream) {
  const Weights w = make_weights(ws);
  Dims d{B, N, C, hidden, mlp_hidden, heads, 128, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  float *pq = (float*)dwqk_part, *pm = (float*)dm_part, *pw = (float*)dw_part;
  if (per_image < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && tokens == 16 && !(C % 4 || hidden % 4 || mlp_hidden % 4))
    return launch_bwd<float, 16>(x, wqk2, m2, w, dy, dx, pq, pm, pw, per_image, d, s);
  if (dtype == 1 && !(C % 16 || hidden % 16 || mlp_hidden % 16)) {
    if (tokens == 32) {
      d.chunk = 64;  // what 32 tokens leave room for
      return launch_bwd<bf16, 32>(x, wqk2, m2, w, dy, dx, pq, pm, pw, per_image, d, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// out[g, i] = sum over p < nparts of part[g, p, i], i < n; float arrays.
int cavp_fusion_train_reduce(const void* part, void* out, int groups, int nparts,
                             long long n, void* stream) {
  const long long total = (long long)groups * n;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, nparts, n, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
