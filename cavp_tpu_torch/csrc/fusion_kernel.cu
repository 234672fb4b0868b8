// Fused visual-fusion chain of the CAVP eval path, for Hopper (sm_90a).
//
// Replaces the TPU kernel cavp_tpu/ops/pallas/fusion_kernel.py
// (`fused_visual_fusion`, body `_fusion_kernel`). Per visual token:
//
//   h1 = gelu(x @ W1 + b1)                       projector fc1, C -> 256
//   p  = h1 @ W2f + b2f                          fc2 folded with patch_embed_v
//   a  = LN1(p)
//   g  = sigmoid((a @ wqk) * hd^-1/2)            rank-1 gate, per-image wqk [C, heads]
//   t4 = a + (g @ m + bp)                        per-image m [heads, C]
//   t5 = t4 + (gelu(LN2(t4) @ Wm1 + bm1) @ Wm2 + bm2)    MLP C -> 4C -> C
//   out = LN3(t5)
//
// Values are rounded to the IO type (float or bf16) at the same points as
// `_fusion_kernel`: after each product, each bias add, each GELU and each
// LayerNorm; products and LayerNorm statistics accumulate in float.
//
// Bound on the H100: about 1.8 MFLOP per token against about 1.2 KB of
// token IO in bf16, so the chain is compute-bound, and only the tensor
// cores give the rate it needs. The TPU kernel keeps all ~1.8 MB of bf16
// weights resident in VMEM; that does not fit in the 227 KB of shared
// memory a block can have, so both kernels here keep only a tile of tokens
// and its intermediates on chip and stream the weights from global memory,
// where they stay resident in L2. One block runs one tile of one image;
// the grid is (tiles, B) and the ragged last tile is masked here, with no
// host-side padding.
//
// - bf16 (the serving and eval path), `tc::fusion_kernel`: tiles of 32
//   tokens; every product runs on the tensor cores as 16x16x16 WMMA tiles
//   with float accumulators. The tile's intermediates live in shared memory
//   as bf16 (exact: they are rounded to bf16 at those points anyway), so a
//   block needs ~70 KB; at 128 registers a thread, two blocks run on an
//   SM. Each warp owns output column tiles, loads their 16x16 weight tiles
//   straight from global memory (L2) and uses each for both row tiles;
//   the 4C-wide MLP hidden is processed in chunks of 320 columns, with the
//   second product's accumulators held in registers across the chunks.
//   Each accumulator tile goes through a per-warp float scratch for the
//   bias, rounding, GELU and residual epilogue.
// - float32, `simt::fusion_kernel`: the tensor cores have no full-float
//   mode (TF32 keeps ~3 digits), so this path runs on the CUDA cores:
//   tiles of 16 tokens, each thread owns one output column and keeps the
//   tile's 16 sums in registers, reading token rows from shared memory as
//   float4 broadcasts. It serves float32 configurations and parity checks.
//
// Each LayerNorm is a per-token warp reduction over the C channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

typedef __nv_bfloat16 bf16;

struct Weights {
  const void *w1, *b1, *w2f, *b2f, *bp, *wm1, *bm1, *wm2, *bm2;
  const void *n1s, *n1b, *n2s, *n2b, *n3s, *n3b;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) { return bf(__float2bfloat16_rn(v)); }

enum Epilogue { kBias, kBiasGelu, kBiasResidual };

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using namespace nvcuda;

constexpr int kTokens = 32;                 // tokens per block
constexpr int kRowTiles = kTokens / 16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 320;                  // C <= 320: at most 20 column tiles
constexpr int kUnits = (kMaxC / 16 + kWarps - 1) / kWarps;  // column tiles per warp
constexpr int kChunk = 320;                 // hidden columns per pass
constexpr int kPad = 8;                     // row padding (bf16) against bank conflicts

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// acc[r] += in[16r : 16r+16, 0:K] @ W[0:K, n0 : n0+16]; in: shared, row
// stride in_ld; W: global, row stride w_ld. One weight tile feeds both
// row tiles.
__device__ __forceinline__ void mma_cols(FragC (&acc)[kRowTiles], const bf16* in,
                                         int in_ld, const bf16* W, int w_ld, int K,
                                         int n0) {
  FragA a;
  FragB b;
  for (int k = 0; k < K; k += 16) {
    wmma::load_matrix_sync(b, W + (size_t)k * w_ld + n0, w_ld);
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) {
      wmma::load_matrix_sync(a, in + r * 16 * in_ld + k, in_ld);
      wmma::mma_sync(acc[r], a, b, acc[r]);
    }
  }
}

// out[:, n0:n0+16] = epilogue(acc) through the warp's float scratch;
// res may alias out (each element is read and written by one lane).
template <int EPI>
__device__ __forceinline__ void store_cols(const FragC (&acc)[kRowTiles], float* scratch,
                                           const bf16* bias, int n0, bf16* out,
                                           int out_ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRowTiles; ++r) {
    wmma::store_matrix_sync(scratch, acc[r], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = r * 16 + e / 16, col = n0 + e % 16;
      bf16* o = out + row * out_ld + col;
      float v = rnd(rnd(scratch[e]) + bf(bias[col]));
      if (EPI == kBiasGelu) v = gelu(v);
      if (EPI == kBiasResidual) v = bf(*o) + v;
      *o = __float2bfloat16_rn(v);
    }
    __syncwarp();
  }
}

// out[:, 0:n_out] = epilogue(in[:, 0:K] @ W[0:K, 0:n_out] + bias)
template <int EPI>
__device__ void gemm(const bf16* in, int in_ld, int K, const bf16* W, int w_ld,
                     const bf16* bias, int n_out, bf16* out, int out_ld, float* scratch) {
  for (int ct = threadIdx.x >> 5; ct < n_out / 16; ct += kWarps) {
    FragC acc[kRowTiles];
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) wmma::fill_fragment(acc[r], 0.f);
    mma_cols(acc, in, in_ld, W, w_ld, K, ct * 16);
    store_cols<EPI>(acc, scratch, bias, ct * 16, out, out_ld);
  }
}

// y[t, :] = LN(x[t, :]) * s + b, one warp per token row; y may alias x.
__device__ void layernorm(const bf16* x, const bf16* s, const bf16* b, int C, int ld,
                          bf16* y) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < kTokens; t += kWarps) {
    const bf16* row = x + t * ld;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += bf(row[c]);
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = bf(row[c]) - mean;
      sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / C + 1e-5f);
    for (int c = lane; c < C; c += 32)
      y[t * ld + c] = __float2bfloat16_rn((bf(row[c]) - mean) * r * bf(s[c]) + bf(b[c]));
  }
}

__global__ void __launch_bounds__(kThreads)
fusion_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqk,
              const bf16* __restrict__ m, Weights w, bf16* __restrict__ out, int N,
              int C, int hidden, int mlp_hidden, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = C + kPad, hld = kChunk + kPad;
  bf16* X = reinterpret_cast<bf16*>(smem);  // x, then LN2's output
  bf16* A = X + kTokens * ld;               // p -> a -> t4 -> t5 -> out
  bf16* H = A + kTokens * ld;               // hidden chunk
  float* scratch = reinterpret_cast<float*>(H + kTokens * hld) + (threadIdx.x >> 5) * 256;
  float* G = reinterpret_cast<float*>(H + kTokens * hld) + kWarps * 256;  // [kTokens, heads]

  const int b = blockIdx.y, tile0 = blockIdx.x * kTokens;
  const int n_valid = min(kTokens, N - tile0);
  const size_t base = ((size_t)b * N + tile0) * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int i = tid; i < kTokens * C; i += kThreads) {
    const int t = i / C, c = i % C;
    X[t * ld + c] = t < n_valid ? x[base + i] : zero;
  }
  __syncthreads();

  gemm<kBiasGelu>(X, ld, C, (const bf16*)w.w1, hidden, (const bf16*)w.b1, hidden, H,
                  hld, scratch);
  __syncthreads();
  gemm<kBias>(H, hld, hidden, (const bf16*)w.w2f, C, (const bf16*)w.b2f, C, A, ld,
              scratch);
  __syncthreads();
  layernorm(A, (const bf16*)w.n1s, (const bf16*)w.n1b, C, ld, A);
  __syncthreads();

  // rank-1 sigmoid gate: one warp per (token, head) dot product
  const bf16* wqk_b = wqk + (size_t)b * C * heads;
  for (int o = warp; o < kTokens * heads; o += kWarps) {
    const int t = o / heads, hh = o % heads;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += bf(A[t * ld + c]) * bf(wqk_b[c * heads + hh]);
    s = warp_sum(s);
    if (lane == 0) G[o] = rnd(sigmoid(s * scale));
  }
  __syncthreads();
  const bf16* m_b = m + (size_t)b * heads * C;
  const bf16* bp = (const bf16*)w.bp;
  for (int i = tid; i < kTokens * C; i += kThreads) {
    const int t = i / C, c = i % C;
    float o = 0.f;
    for (int hh = 0; hh < heads; ++hh) o = fmaf(G[t * heads + hh], bf(m_b[hh * C + c]), o);
    o = rnd(rnd(o) + bf(bp[c]));
    A[t * ld + c] = __float2bfloat16_rn(bf(A[t * ld + c]) + o);  // t4
  }
  __syncthreads();
  layernorm(A, (const bf16*)w.n2s, (const bf16*)w.n2b, C, ld, X);
  __syncthreads();

  // MLP: fc1 + GELU one hidden chunk at a time; fc2's sums stay in registers
  FragC acc[kUnits][kRowTiles];
#pragma unroll
  for (int u = 0; u < kUnits; ++u)
#pragma unroll
    for (int r = 0; r < kRowTiles; ++r) wmma::fill_fragment(acc[u][r], 0.f);
  const bf16* wm2 = (const bf16*)w.wm2;
  for (int c0 = 0; c0 < mlp_hidden; c0 += kChunk) {
    const int cw = min(kChunk, mlp_hidden - c0);
    gemm<kBiasGelu>(X, ld, C, (const bf16*)w.wm1 + c0, mlp_hidden,
                    (const bf16*)w.bm1 + c0, cw, H, hld, scratch);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int ct = warp + u * kWarps;
      if (ct < C / 16) mma_cols(acc[u], H, hld, wm2 + (size_t)c0 * C, C, cw, ct * 16);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int ct = warp + u * kWarps;
    if (ct < C / 16)
      store_cols<kBiasResidual>(acc[u], scratch, (const bf16*)w.bm2, ct * 16, A, ld);
  }
  __syncthreads();
  layernorm(A, (const bf16*)w.n3s, (const bf16*)w.n3b, C, ld, A);
  __syncthreads();

  for (int i = tid; i < n_valid * C; i += kThreads) out[base + i] = A[(i / C) * ld + i % C];
}

size_t smem_bytes(int C, int heads) {
  return sizeof(bf16) * (2 * kTokens * (C + kPad) + kTokens * (kChunk + kPad)) +
         sizeof(float) * (kWarps * 256 + kTokens * heads);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kTokens = 16;   // tokens per block
constexpr int kThreads = 320; // 10 warps: one pass over C = 304 columns

// out[t, j] = epilogue(sum_k in[t, k] * W[k, j]) for the tile's rows.
// in: [kTokens, K] shared; W: [K, n_out] row-major global; out and res:
// [kTokens, n_out] shared. K is a multiple of 4.
template <int EPI>
__device__ void tile_matmul(const float* __restrict__ in, int K, const float* __restrict__ W,
                            const float* __restrict__ bias, int n_out,
                            const float* __restrict__ res, float* __restrict__ out) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kTokens];
#pragma unroll
    for (int t = 0; t < kTokens; ++t) acc[t] = 0.f;
    const float* wcol = W + j;
    for (int k = 0; k < K; k += 4) {
      const float w0 = wcol[(size_t)(k + 0) * n_out];
      const float w1 = wcol[(size_t)(k + 1) * n_out];
      const float w2 = wcol[(size_t)(k + 2) * n_out];
      const float w3 = wcol[(size_t)(k + 3) * n_out];
#pragma unroll
      for (int t = 0; t < kTokens; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(in + t * K + k);
        float s = acc[t];
        s = fmaf(a.x, w0, s);
        s = fmaf(a.y, w1, s);
        s = fmaf(a.z, w2, s);
        s = fmaf(a.w, w3, s);
        acc[t] = s;
      }
    }
#pragma unroll
    for (int t = 0; t < kTokens; ++t) {
      float v = acc[t] + bias[j];
      if (EPI == kBiasGelu) v = gelu(v);
      if (EPI == kBiasResidual) v = res[t * n_out + j] + v;
      out[t * n_out + j] = v;
    }
  }
}

// y[t, :] = LN(x[t, :]) * s + b, one warp per token row; y may alias x.
__device__ void tile_layernorm(const float* x, const float* __restrict__ s,
                               const float* __restrict__ b, int C, float* y) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x >> 5; t < kTokens; t += nwarps) {
    const float* row = x + t * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += row[c];
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mean;
      sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / C + 1e-5f);
    for (int c = lane; c < C; c += 32) y[t * C + c] = (row[c] - mean) * r * s[c] + b[c];
  }
}

__global__ void __launch_bounds__(kThreads)
fusion_kernel(const float* __restrict__ x, const float* __restrict__ wqk,
              const float* __restrict__ m, Weights w, float* __restrict__ out, int N,
              int C, int hidden, int mlp_hidden, int heads, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  const int h_width = hidden > mlp_hidden ? hidden : mlp_hidden;
  float* X = fsmem;                      // x, then LN2 output
  float* A = X + kTokens * C;            // p -> a -> t5 -> out
  float* T4 = A + kTokens * C;           // residual after the gate
  float* H = T4 + kTokens * C;           // projector / MLP hidden
  float* G = H + kTokens * h_width;      // gate [kTokens, heads]

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * kTokens;
  const int n_valid = min(kTokens, N - tile0);
  const size_t base = ((size_t)b * N + tile0) * C;
  const int tid = threadIdx.x;

  for (int i = tid; i < kTokens * C; i += blockDim.x)
    X[i] = (i / C) < n_valid ? x[base + i] : 0.f;
  __syncthreads();

  tile_matmul<kBiasGelu>(X, C, (const float*)w.w1, (const float*)w.b1, hidden, nullptr, H);
  __syncthreads();
  tile_matmul<kBias>(H, hidden, (const float*)w.w2f, (const float*)w.b2f, C, nullptr, A);
  __syncthreads();
  tile_layernorm(A, (const float*)w.n1s, (const float*)w.n1b, C, A);
  __syncthreads();

  // rank-1 sigmoid gate: one warp per (token, head) dot product
  const float* wqk_b = wqk + (size_t)b * C * heads;
  const int lane = tid & 31;
  for (int o = tid >> 5; o < kTokens * heads; o += blockDim.x >> 5) {
    const int t = o / heads, hh = o % heads;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += A[t * C + c] * wqk_b[c * heads + hh];
    s = warp_sum(s);
    if (lane == 0) G[o] = sigmoid(s * scale);
  }
  __syncthreads();

  const float* m_b = m + (size_t)b * heads * C;
  for (int i = tid; i < kTokens * C; i += blockDim.x) {
    const int t = i / C, c = i % C;
    float o = 0.f;
    for (int hh = 0; hh < heads; ++hh) o = fmaf(G[t * heads + hh], m_b[hh * C + c], o);
    T4[i] = A[i] + (o + ((const float*)w.bp)[c]);
  }
  __syncthreads();

  tile_layernorm(T4, (const float*)w.n2s, (const float*)w.n2b, C, X);
  __syncthreads();
  tile_matmul<kBiasGelu>(X, C, (const float*)w.wm1, (const float*)w.bm1, mlp_hidden, nullptr, H);
  __syncthreads();
  tile_matmul<kBiasResidual>(H, mlp_hidden, (const float*)w.wm2, (const float*)w.bm2, C, T4, A);
  __syncthreads();
  tile_layernorm(A, (const float*)w.n3s, (const float*)w.n3b, C, A);
  __syncthreads();

  for (int i = tid; i < n_valid * C; i += blockDim.x) out[base + i] = A[i];
}

size_t smem_bytes(int C, int hidden, int mlp_hidden, int heads) {
  const int h_width = hidden > mlp_hidden ? hidden : mlp_hidden;
  return sizeof(float) * ((size_t)kTokens * (3 * C + h_width + heads));
}

}  // namespace simt

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, Weights, T*, int, int, int, int,
                          int, float),
           int tokens, int threads, size_t smem, const void* x, const void* wqk,
           const void* m, const Weights& w, void* out, int B, int N, int C, int hidden,
           int mlp_hidden, int heads, float scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + tokens - 1) / tokens, B);
  kernel<<<grid, threads, smem, stream>>>((const T*)x, (const T*)wqk, (const T*)m, w,
                                          (T*)out, N, C, hidden, mlp_hidden, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// array of that type: x/out [B, N, C], wqk [B, C, heads], m [B, heads, C],
// w1 [C, hidden], w2f [hidden, C], wm1 [C, mlp_hidden], wm2 [mlp_hidden, C]
// and the vectors. float32 needs C, hidden and mlp_hidden to be multiples
// of 4; bf16 needs multiples of 16 and C, hidden <= 320. Returns the
// launch's cudaError_t (0 on success).
int cavp_fused_visual_fusion(int dtype, const void* x, const void* wqk, const void* m,
                             const void* w1, const void* b1, const void* w2f,
                             const void* b2f, const void* bp, const void* wm1,
                             const void* bm1, const void* wm2, const void* bm2,
                             const void* n1s, const void* n1b, const void* n2s,
                             const void* n2b, const void* n3s, const void* n3b,
                             void* out, int B, int N, int C, int hidden,
                             int mlp_hidden, int heads, float scale, void* stream) {
  const Weights w{w1, b1, w2f, b2f, bp, wm1, bm1, wm2, bm2, n1s, n1b, n2s, n2b, n3s, n3b};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch(simt::fusion_kernel, simt::kTokens, simt::kThreads,
                  simt::smem_bytes(C, hidden, mlp_hidden, heads), x, wqk, m, w, out, B, N,
                  C, hidden, mlp_hidden, heads, scale, s);
  if (dtype == 1) {
    if (C % 16 || hidden % 16 || mlp_hidden % 16 || C > tc::kMaxC || hidden > tc::kChunk)
      return (int)cudaErrorInvalidValue;
    return launch(tc::fusion_kernel, tc::kTokens, tc::kThreads, tc::smem_bytes(C, heads), x,
                  wqk, m, w, out, B, N, C, hidden, mlp_hidden, heads, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* cavp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
