// Fused bilinear upsample + argmax over classes of the CAVP eval path, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel cavp_tpu/ops/pallas/upsample_argmax_kernel.py
// (`upsample_argmax`). logits [B, h, w, C] (channels last) -> int32
// [B, H, W]: the argmax over C of the separable bilinear resize, H pass
// then W pass, each rounded to the IO type, first maximum on ties. The
// full-resolution logits are never written.
//
// Every output position has at most two taps per axis. The wrapper hands
// them over as (lo, hi, weight of lo, weight of hi) per output row and per
// output column, the weights already rounded to the IO type, as the TPU
// kernel rounds its interpolation matrices. A pass is then
//   round(w_lo * x[lo] + w_hi * x[hi])
// with float32 products and sum. For bf16 inputs each product is exact in
// float32, so this is the float32 sum of the matrix product rounded once,
// bit for bit what the plain PyTorch version computes (and a fused
// multiply-add of one exact product onto the other rounds the same sum
// once: the W pass uses it); for float32 the plain version's matrix
// product may fuse a multiply-add, so there the masks agree away from
// near-ties.
//
// Bound on the H100: 53 MB of bf16 logits in and 24 MB of int32 out at
// [120, 56, 56, 71] -> 224 x 224 (0.023 ms at 3.35 TB/s), against 2 x 3
// operations per class and output pixel (0.002 ms at the dense bf16 rate
// of the operands' type): bound by bytes. What the kernel spends its time
// on is instructions, in the W pass: 71 classes for each of 50176 output
// pixels an image, each a product, a multiply-add, a rounding and a
// compare. The design cuts what surrounds those:
//
// - One block takes one image and a tile of output rows. The H pass for
//   those rows goes to shared memory as [rows, w, Cp] in the IO type (it
//   is rounded to it, so nothing is lost), C padded to Cp, a multiple of 8,
//   so each source column's classes start on a 16-byte boundary; the
//   padding never enters the maximum. Its global loads are 16-byte vectors
//   where the rows allow it.
// - At an upsampling ratio r, about r neighbouring output columns share
//   one (lo, hi) source pair (4 at the eval path's 4x). The wrapper lists
//   those runs (column groups of at most kGroup columns); a thread takes
//   one group of one row, loads each source class vector once for all its
//   columns in 16-byte loads, rounds two classes by one conversion, and
//   keeps a running strict maximum per column. The per-class instructions
//   that remain (a product, a multiply-add, half a conversion, the
//   unpacking and the compare) still hold it at ~13x its bound.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // output columns of a group, at most
constexpr int kVec = 8;    // classes a vector: 16 bytes of bf16

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T> __device__ __forceinline__ float round_io(float v);
template <> __device__ __forceinline__ float round_io<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_io<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one pass of two taps: the products and the sum in float32, rounded once
template <typename T>
__device__ __forceinline__ float lerp2(float wl, float a, float wh, float b) {
  return round_io<T>(__fadd_rn(__fmul_rn(wl, a), __fmul_rn(wh, b)));
}
// two classes of the W pass: the same numbers as lerp2 (for bf16, wh * b
// is exact, so the multiply-add rounds the exact sum once, as the add of the
// two exact products does), the two bf16 roundings in one conversion
template <typename T>
__device__ __forceinline__ float2 lerp2_pair(float wl, float wh, float a0, float b0, float a1,
                                             float b1) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(__fmaf_rn(wl, a0, __fmul_rn(wh, b0)),
                                                   __fmaf_rn(wl, a1, __fmul_rn(wh, b1)));
    return __bfloat1622float2(v);
  } else {
    return make_float2(lerp2<T>(wl, a0, wh, b0), lerp2<T>(wl, a1, wh, b1));
  }
}

// a class count known at compile time
template <int N> struct Count {
  __device__ constexpr operator int() const { return N; }
};

// kVec classes from 16-byte aligned shared memory, as floats
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the H pass of elements [e0, e0 + kVec) of one output row's w * C source
// elements, from a 16-byte aligned global vector of bf16 each side
__device__ __forceinline__ void h_pass_vec(const bf16* lo, const bf16* hi, float wl, float wh,
                                           bf16* dst_row, int e0, int C, int Cp) {
  float a[kVec], b[kVec];
  const uint4 ua = __ldg(reinterpret_cast<const uint4*>(lo + e0));
  const uint4 ub = __ldg(reinterpret_cast<const uint4*>(hi + e0));
  const unsigned wa[4] = {ua.x, ua.y, ua.z, ua.w}, wb[4] = {ub.x, ub.y, ub.z, ub.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __uint_as_float(wa[i] << 16);
    a[2 * i + 1] = __uint_as_float(wa[i] & 0xffff0000u);
    b[2 * i] = __uint_as_float(wb[i] << 16);
    b[2 * i + 1] = __uint_as_float(wb[i] & 0xffff0000u);
  }
  int j = e0 / C, c = e0 - j * C;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    // one rounding of the float32 sum (the products are exact)
    dst_row[j * Cp + c] = __float2bfloat16_rn(__fmaf_rn(wl, a[k], __fmul_rn(wh, b[k])));
    if (++c == C) {
      c = 0;
      ++j;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ x, const int* __restrict__ row_lo,
                       const int* __restrict__ row_hi, const float* __restrict__ row_wl,
                       const float* __restrict__ row_wh, const float* __restrict__ col_wl,
                       const float* __restrict__ col_wh, const int4* __restrict__ groups,
                       int n_groups, int* __restrict__ out, int h, int w, int C, int Cp, int H,
                       int W, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tmp = reinterpret_cast<T*>(smem);  // [tile_rows, w, Cp]
  const int b = blockIdx.y, y0 = blockIdx.x * tile_rows;
  const int rows = min(tile_rows, H - y0);
  const int wc = w * C;
  const T* img = x + (size_t)b * h * wc;

  // H pass: 16-byte vectors where every source row starts on 16 bytes
  if (sizeof(T) == 2 && wc % kVec == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int nv = wc / kVec;
    for (int i = threadIdx.x; i < rows * nv; i += kThreads) {
      const int r = i / nv, y = y0 + r;
      h_pass_vec(reinterpret_cast<const bf16*>(img) + (size_t)row_lo[y] * wc,
                 reinterpret_cast<const bf16*>(img) + (size_t)row_hi[y] * wc, row_wl[y],
                 row_wh[y], reinterpret_cast<bf16*>(tmp) + (size_t)r * w * Cp,
                 (i - r * nv) * kVec, C, Cp);
    }
  } else {
    for (int i = threadIdx.x; i < rows * wc; i += kThreads) {
      const int r = i / wc, e = i - r * wc, y = y0 + r, j = e / C;
      const float a = load(img + (size_t)row_lo[y] * wc + e);
      const float c = load(img + (size_t)row_hi[y] * wc + e);
      store(tmp + ((size_t)r * w + j) * Cp + e - j * C, lerp2<T>(row_wl[y], a, row_wh[y], c));
    }
  }
  __syncthreads();

  // W pass: a thread takes one column group of one row, every class vector
  // of its two source columns loaded once for all the group's columns
  for (int it = threadIdx.x; it < rows * n_groups; it += kThreads) {
    const int r = it / n_groups;
    const int4 g = groups[it - r * n_groups];  // first column, columns, lo, hi
    const T* lo = tmp + ((size_t)r * w + g.z) * Cp;
    const T* hi = tmp + ((size_t)r * w + g.w) * Cp;
    float wl[kGroup], wh[kGroup], best[kGroup];
    int arg[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int X = g.x + (k < g.y ? k : 0);
      wl[k] = col_wl[X];
      wh[k] = col_wh[X];
      best[k] = __int_as_float(0xff800000);  // -inf
      arg[k] = 0;
    }
    // the running maximum of each column over classes c0 .. c0 + n - 1
    const auto visit = [&](int c0, auto n) {
      float a[kVec], bv[kVec];
      load_vec(lo + c0, a);
      load_vec(hi + c0, bv);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (k < g.y) {
#pragma unroll
          for (int q = 0; q < kVec; q += 2) {
            const float2 v = lerp2_pair<T>(wl[k], wh[k], a[q], bv[q], a[q + 1], bv[q + 1]);
            if (q < n && v.x > best[k]) {
              best[k] = v.x;
              arg[k] = c0 + q;
            }
            if (q + 1 < n && v.y > best[k]) {
              best[k] = v.y;
              arg[k] = c0 + q + 1;
            }
          }
        }
      }
    };
    const int whole = C / kVec * kVec;
    for (int c0 = 0; c0 < whole; c0 += kVec) visit(c0, Count<kVec>());
    if (whole < C) visit(whole, C - whole);
    int* dst = out + ((size_t)b * H + y0 + r) * W + g.x;
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (k < g.y) dst[k] = arg[k];
  }
}

template <typename T>
int launch(const void* x, const int* taps_i, const float* taps_f, const int4* groups,
           int n_groups, void* out, int B, int h, int w, int C, int H, int W, int tile_rows,
           cudaStream_t stream) {
  const int Cp = (C + kVec - 1) / kVec * kVec;
  const size_t smem = sizeof(T) * (size_t)tile_rows * w * Cp;
  cudaError_t err = cudaFuncSetAttribute(upsample_argmax_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + tile_rows - 1) / tile_rows, B);
  // taps_i: row lo [H], row hi [H]; taps_f: row w_lo [H], row w_hi [H],
  // column w_lo [W], column w_hi [W]
  upsample_argmax_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, taps_i, taps_i + H, taps_f, taps_f + H, taps_f + 2 * H, taps_f + 2 * H + W,
      groups, n_groups, (int*)out, h, w, C, Cp, H, W, tile_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [B, h, w, C] contiguous; out [B, H, W]
// int32. taps_i is int32 [2H]: the lower and the upper source row of each
// output row; taps_f float32 [2H + 2W] holds their weights, then those of
// the columns' lower and upper taps. groups is int32 [n_groups, 4]: runs of
// at most 4 output columns (first column, count, lo, hi) that share their
// source columns, covering every output column once. tile_rows output rows
// of one image go to one block, which needs tile_rows * w * Cp values of
// the IO type in shared memory (Cp: C rounded up to a multiple of 8).
// Returns the launch's cudaError_t (0 on success).
int cavp_upsample_argmax(int dtype, const void* x, const void* taps_i, const void* taps_f,
                         const void* groups, int n_groups, void* out, int B, int h, int w,
                         int C, int H, int W, int tile_rows, void* stream) {
  if (B <= 0 || B > 65535 || tile_rows <= 0 || C <= 0 || n_groups <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int4* g = (const int4*)groups;
  if (dtype == 0)
    return launch<float>(x, (const int*)taps_i, (const float*)taps_f, g, n_groups, out, B, h, w,
                         C, H, W, tile_rows, s);
  if (dtype == 1)
    return launch<bf16>(x, (const int*)taps_i, (const float*)taps_f, g, n_groups, out, B, h, w,
                        C, H, W, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
