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
// memory a block can have, so a block keeps a tile of tokens and its
// intermediates on chip and streams the weights, which stay in L2.
//
// - bf16 (the serving and eval path): the token chain of
//   fusion_chain_sm90.cuh, shared with the train kernel's forward. Tiles of
//   128 tokens on a persistent grid; each weight slab is staged once per
//   tile into a 3-slot shared-memory ring by a producer warp (cp.async,
//   mbarriers) and read by two consumer warpgroups; the products are wgmma
//   with register accumulators, the epilogues and LayerNorm statistics run
//   on the accumulator fragments, and the MLP's hidden chunk goes from one
//   product to the next in registers. That header's note gives the design
//   and what bounds it. It takes C = 304 or 112, hidden 256, mlp_hidden a
//   multiple of C and 4 heads; C = 720 and 512 (the HRNet and OCR features)
//   go to that header's `wide` chain: tiles of 32 tokens, bf16 mma.sync
//   products, the MLP's hidden walked in chunks.
// - float32, `simt::fusion_kernel`: the tensor cores have no full-float
//   mode (TF32 keeps ~3 digits), so this path runs on the CUDA cores:
//   tiles of 16 tokens, each thread owns one output column and keeps the
//   tile's 16 sums in registers, reading token rows from shared memory as
//   float4 broadcasts; a grid of (tiles, B), the ragged last tile masked
//   here. The MLP walks its hidden kChunk columns a pass, so its shared
//   memory stays inside a block's at C = 720 (155 KB); the second product's
//   sums carry over the passes in shared memory, in the same order as one
//   pass would add them. It serves float32 configurations and parity checks.
//
// In the float32 kernel each LayerNorm is a per-token warp reduction over
// the C channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fusion_chain_sm90.cuh"

namespace {

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

enum Epilogue { kBias, kBiasGelu, kBiasResidual, kSum };

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kTokens = 16;   // tokens per block
constexpr int kThreads = 320; // 10 warps: one pass over C = 304 columns
constexpr int kChunk = 256;   // the MLP's hidden columns a pass

// out[t, j] = epilogue(sum_k in[t, k] * W[k, j]) for the tile's rows, the
// sum started from out[t, j] where `carry` (a later pass of a K walked in
// parts). in: [kTokens, K] shared; W: [K, n_out] global, rows ldw apart;
// out and res: [kTokens, n_out] shared. K is a multiple of 4.
template <int EPI>
__device__ void tile_matmul(const float* __restrict__ in, int K, const float* __restrict__ W,
                            int ldw, const float* __restrict__ bias, int n_out,
                            const float* __restrict__ res, float* __restrict__ out,
                            bool carry = false) {
  for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
    float acc[kTokens];
#pragma unroll
    for (int t = 0; t < kTokens; ++t) acc[t] = carry ? out[t * n_out + j] : 0.f;
    const float* wcol = W + j;
    for (int k = 0; k < K; k += 4) {
      const float w0 = wcol[(size_t)(k + 0) * ldw];
      const float w1 = wcol[(size_t)(k + 1) * ldw];
      const float w2 = wcol[(size_t)(k + 2) * ldw];
      const float w3 = wcol[(size_t)(k + 3) * ldw];
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
      if (EPI == kSum) {
        out[t * n_out + j] = acc[t];
        continue;
      }
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
  const int chunk = mlp_hidden < kChunk ? mlp_hidden : kChunk;
  const int h_width = hidden > chunk ? hidden : chunk;
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

  tile_matmul<kBiasGelu>(X, C, (const float*)w.w1, hidden, (const float*)w.b1, hidden, nullptr,
                         H);
  __syncthreads();
  tile_matmul<kBias>(H, hidden, (const float*)w.w2f, C, (const float*)w.b2f, C, nullptr, A);
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
  // the MLP, `chunk` hidden columns a pass; Wm2's sums carry over in A
  for (int k0 = 0; k0 < mlp_hidden; k0 += chunk) {
    const int kc = mlp_hidden - k0 < chunk ? mlp_hidden - k0 : chunk;
    tile_matmul<kBiasGelu>(X, C, (const float*)w.wm1 + k0, mlp_hidden, (const float*)w.bm1 + k0,
                           kc, nullptr, H);
    __syncthreads();
    const float* wm2 = (const float*)w.wm2 + (size_t)k0 * C;
    if (k0 + kc < mlp_hidden)
      tile_matmul<kSum>(H, kc, wm2, C, nullptr, C, nullptr, A, k0 > 0);
    else
      tile_matmul<kBiasResidual>(H, kc, wm2, C, (const float*)w.bm2, C, T4, A, k0 > 0);
    __syncthreads();
  }
  tile_layernorm(A, (const float*)w.n3s, (const float*)w.n3b, C, A);
  __syncthreads();

  for (int i = tid; i < n_valid * C; i += blockDim.x) out[base + i] = A[i];
}

size_t smem_bytes(int C, int hidden, int mlp_hidden, int heads) {
  const int chunk = mlp_hidden < kChunk ? mlp_hidden : kChunk;
  const int h_width = hidden > chunk ? hidden : chunk;
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
// of 4; bf16 needs C = 304, 112, 720 or 512, hidden = 256, mlp_hidden a
// multiple of C and heads = 4 (chain::supported). Returns the launch's cudaError_t (0
// on success).
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
    if (!chain::supported(C, hidden, mlp_hidden, heads)) return (int)cudaErrorInvalidValue;
    typedef chain::bf16 T;
    const chain::Args a{(const T*)x,   (const T*)wqk, (const T*)m,   (const T*)w1,  (const T*)b1,
                        (const T*)w2f, (const T*)b2f, nullptr,       nullptr,       (const T*)n1s,
                        (const T*)n1b, (const T*)bp,  (const T*)n2s, (const T*)n2b, (const T*)wm1,
                        (const T*)bm1, (const T*)wm2, (const T*)bm2, (const T*)n3s, (const T*)n3b,
                        (T*)out,       B,             N,             mlp_hidden,    scale};
    return chain::launch<false>(a, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

#ifdef CHAIN_STAMPS
// The bf16 chain's stage counters (3 x chain::kStamps), read and zeroed.
int cavp_chain_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, chain::g_stamps, sizeof(chain::g_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[3 * chain::kStamps] = {};
  return (int)cudaMemcpyToSymbol(chain::g_stamps, zero, sizeof(zero));
}
#endif

const char* cavp_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
