// Fused log-mel frontend of the CAVP trainer mel, for Hopper (sm_90a).
//
// Replaces the TPU kernel cavp_tpu/ops/pallas/mel_kernel.py (`fused_log_mel`,
// body `_mel_kernel`). Per 512-sample frame of a 16 kHz waveform (hop 160,
// centre reflect padding, a periodic Hann window of 400 centred in the
// frame):
//
//   re, im = frame @ wcos, frame @ wsin          real DFT
//   mel    = (re^2 + im^2) @ fb                  power -> 64 mel bands
//   out    = (20 * log10(max(mel, 1e-5)) - mid) / half_range
//
// Only the bins the filterbank uses are computed: the host plan
// (`mel_plan` in ops/kernels/mel.py) keeps the bins [k_lo, k_hi) of the
// filterbank's nonzero rows (5-121 at the main path's 125-3800 Hz: 117 of
// 257), their windowed cos and sin bases side by side (column 2i is bin i's
// cos, 2i + 1 its sin), in chunks of 240 columns (one chunk) or of 256, and
// each band as one contiguous bin range with its weights. Dropping the
// zero-weight bins and the zero products of the mel is exact.
//
// Bound on the H100 at [120, 16000] -> 96 frames: the DFT of 11,520 frames
// against 240 columns is 2 x 11,520 x 400 x 240 = 2.2 GFLOP a product,
// against ~11 MB of waveform, output and bases. The products run on the
// tensor cores in TF32, split so that they keep float32 accuracy: each
// operand x is hi = rna_tf32(x) plus lo = rna_tf32(x - hi), and a product is
// hi.hi + hi.lo + lo.hi (three TF32 products, 6.6 GFLOP: 0.0134 ms at 495
// TFLOP/s; the bytes take 0.0034 ms), so the kernel is bound by operations.
// A single TF32 product would not do: it keeps 11 bits, and the dB of a
// power spectrum is far more sensitive than that.
//
// Design. A persistent grid walks tiles of F (64 on the main path)
// consecutive frames of the flattened [rows x n_frames] frame index; a tile
// may span rows, and the ragged last tile is masked. A block is two
// consumer warpgroups and a producer warpgroup (one thread of it works; it
// gives its registers to the consumers).
// - Staging: the consumers copy the tile's waveform span into shared memory
//   once by cp.async (64 x 160 + 240 samples a row the tile touches, reflect
//   padding as index arithmetic); frames overlap 2.5x and are never
//   materialised. Four floats of skew every 160 samples put the eight frames
//   a lane group reads on different banks.
// - Products: wgmma m64nNk8 TF32 with A from registers: each thread builds
//   its A fragment (two frames, four samples of an 8-deep step) straight
//   from the span and splits it into hi and lo there. B, the hi and lo bases,
//   streams in slabs of 32 samples through the ring of sm90.cuh (two slots
//   of 60 KB): the host stores each slab as it lands, slab-major and in the
//   128-byte swizzle (`slab_layout` in ops/kernels/mel.py), so a slab is two
//   contiguous bulk copies (TMA boxes of 240 rows of 128 bytes, rows 1600
//   bytes apart, streamed at half the rate). The 0.77 MB of bases stay in
//   L2 across tiles. The two warpgroups split a chunk's columns (120 | 120
//   at the main band).
// - Accuracy: the tensor cores round each sum toward zero, so a long chain
//   of products into one sum loses several times float32's accuracy. Each
//   slab's products start their own sum, which is then added to the frame's
//   sums in float32, and within a slab the hi.lo and lo.hi products go
//   before the hi.hi ones, while the sum is still small.
// - Epilogue: power from each thread's (re, im) pairs, which the
//   accumulator fragment holds side by side, into a shared power tile; then
//   the sparse mel, each band summing its bins in ascending order with fmaf
//   (the dense order without the exact zeros), held in registers across
//   chunks; then dB, normalisation and coalesced stores.
//
// Summation orders are fixed, so two launches on the same input are
// bit-equal. The tensor cores sum each 8-deep step in their own order, so
// the result is not the float32 plain version's bits: on inputs whose bands
// come from the cancellation of large terms, two float32 orders differ by
// more than 2e-6 on the [-1, 1] scale. The tests and chip_smoke.py hold it
// against the function in float64, within 2e-6 or within twice the plain
// version's own distance.

#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kWin = 400, kHop = 160;
constexpr int kLead = 200;           // frame t's window starts at sample 160 t - 200
constexpr int kMels = 64;
constexpr int kRows = 64;            // frames a tile: wgmma's M
constexpr int kSlabK = 32;           // samples a slab: one 128-byte row of a K-major panel
constexpr int kSlabs = (kWin + kSlabK - 1) / kSlabK;  // 13; the last holds 16 samples
constexpr int kStages = 2;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;  // + a producer warpgroup
// registers a thread: the producer warpgroup gives its share to the
// consumers (two sums of 60 a thread, the A fragments, the mel sums)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kSpanFloats = 16384;       // the staged span, with its skew
constexpr int kSpanLogical = 99 * kHop;  // samples of it a tile may use (csrc and mel.py)
constexpr int kMaxSmem = 232448;
constexpr float kLn10 = 2.302585092994046f;

// where sample q of the span sits: 4 floats of skew every 160
__device__ __forceinline__ int skew(int q) { return q + 4 * (q / kHop); }

// one float from global to shared memory, asynchronously (all of a thread's
// staging loads are in flight at once; cp.async.wait_all ends them)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

struct Params {
  const float* hi;     // TF32 bases by slab: [13, columns, 32], swizzled as they land
  const float* lo;
  const float* wave;   // [rows, L]
  float* out;          // [rows, n_frames, 64]
  const int* bands;    // [3, 64]: each band's first plan bin, bin count, weight offset
  const float* weights;
  int rows, L, n_frames, F, tiles, chunks;
  float mid, inv_half_range;
};

template <int WN> struct Shape {
  static constexpr int kCols = 2 * WN;           // a chunk's columns: WN bins
  static constexpr int kSlot = 2 * kCols * 128;  // a slab of hi and of lo
  static constexpr int kPld = WN + 4;            // power tile row stride
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kSlot + kSpanFloats * 4 +
                                  (size_t)kRows * kPld * 4 + 2 * kStages * 8;
  static_assert(kSmem <= kMaxSmem, "the mel kernel's shared memory");
  using Ring = sm90::Ring<kStages, kSlot>;
};

// The tile's waveform span, one segment a row the tile touches: segment i
// holds row r_first + i from frame t_i on (t_0 = t_first, then 0), cnt_i
// frames of it, at span offset off_i (a multiple of 160).
struct Span {
  int r_first, t_first, n_frames;
  // offset of frame t of segment i
  __device__ __forceinline__ int at(int i, int t) const {
    const int off = i == 0 ? 0 : (n_frames - t_first + 2) * kHop + (i - 1) * (n_frames + 2) * kHop;
    return off + (t - (i == 0 ? t_first : 0)) * kHop;
  }
};

template <int WN>
__device__ void consumer(const Params& P, const typename Shape<WN>::Ring& ring, float* span,
                         float* pw) {
  using S = Shape<WN>;
  const int tid = threadIdx.x;
  const Lane ln = lane_of(tid);
  const long long total = (long long)P.rows * P.n_frames;
  // the mel: band tid % 64 of frames tid / 64 + 4 i
  const int band = tid & (kMels - 1), fq = tid >> 6;
  const int b_first = __ldg(P.bands + band), b_count = __ldg(P.bands + kMels + band);
  const float* bw = P.weights + __ldg(P.bands + 2 * kMels + band);
  uint32_t s = 0;
  STAMP_BEGIN(t_all);
  for (int tile = blockIdx.x; tile < P.tiles; tile += gridDim.x) {
    const long long g0 = (long long)tile * P.F;
    const int nf = (int)min((long long)P.F, total - g0);
    const Span sp{(int)(g0 / P.n_frames), (int)(g0 % P.n_frames), P.n_frames};

    // stage the span: samples 160 t_i - 200 .. 160 (t_i + cnt_i - 1) + 199
    // of each segment's row, reflected at the row's ends
    STAMP_BEGIN(t_x);
    for (int i = 0, done = 0; done < nf; ++i) {
      const int t0 = i == 0 ? sp.t_first : 0, cnt = min(P.n_frames - t0, nf - done);
      const float* row = P.wave + (size_t)(sp.r_first + i) * P.L;
      const int off = sp.at(i, t0), x0 = t0 * kHop - kLead, len = cnt * kHop + kWin - kHop;
      for (int q = tid; q < len; q += kConsumers) {
        int x = x0 + q;
        x = x < 0 ? -x : (x >= P.L ? 2 * (P.L - 1) - x : x);
        cp_async4(span + skew(off + q), row + x);
      }
      done += cnt;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    bar_sync<kConsumers>();
    STAMP_END(kLoadX, t_x);

    // this thread's two frames of the A fragment (rows past the tile read
    // staged samples of frame 0 and are not stored)
    const auto frame_at = [&](int m) {
      if (m >= nf) return 0;
      const long long g = g0 + m;
      const int r = (int)(g / P.n_frames), t = (int)(g % P.n_frames);
      return skew(sp.at(r - sp.r_first, t));
    };
    const int fa = frame_at(ln.r0), fb = frame_at(ln.r0 + 8);
    // A of slab sl: hi and lo of the thread's four values of each 8-deep step
    const auto load_a = [&](int sl, uint32_t(&hi)[4][4], uint32_t(&lo)[4][4]) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int k = sl * kSlabK + 8 * ks;
        if (k >= kWin) break;
        const int o = skew(k) + ln.tq;
        const float x[4] = {span[fa + o], span[fb + o], span[fa + o + 4], span[fb + o + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[ks][e] = tf32_rna(x[e]);
          lo[ks][e] = tf32_rna(x[e] - __uint_as_float(hi[ks][e]));
        }
      }
    };

    float mel[kRows / 4];
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) mel[i] = 0.f;
    for (int c = 0; c < P.chunks; ++c) {
      // a slab's products start their own sum (part) in the tensor cores,
      // which then goes into acc by a float32 add: the tensor cores' sums
      // of a long chain of products lose more than float32 rounding
      float acc[WN / 2], part[WN / 2] = {};
      uint32_t ah[4][4], al[4][4];
      STAMP_BEGIN(t_mma);
      long long waited = 0;
      load_a(0, ah, al);
      for (int sl = 0; sl < kSlabs; ++sl, ++s) {
        const int slot = s % kStages;
        STAMP_BEGIN(t_w);
        mbar_wait(&ring.full[slot], (s / kStages) & 1);
#ifdef CHAIN_STAMPS
        waited += clock64() - t_w;
#endif
        const unsigned char* B = ring.slots + slot * S::kSlot + ln.wg * WN * 128;
        wgmma_fence();
        // the small products first, while the sum is small: each wgmma
        // rounds its sum toward zero, so a small addend costs little then
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (sl * kSlabK + 8 * ks >= kWin) break;
          mma_rs_tf32<WN>(part, ah[ks], desc_k(B + S::kSlot / 2 + 32 * ks), ks > 0);
          mma_rs_tf32<WN>(part, al[ks], desc_k(B + 32 * ks), 1);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (sl * kSlabK + 8 * ks >= kWin) break;
          mma_rs_tf32<WN>(part, ah[ks], desc_k(B + 32 * ks), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
        release(ring, s);
        if (sl + 1 < kSlabs) load_a(sl + 1, ah, al);
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) acc[i] = sl == 0 ? part[i] : acc[i] + part[i];
      }
#ifdef CHAIN_STAMPS
      if ((threadIdx.x & 127) == 0) {
        s_stamps[threadIdx.x >> 7][kWaitFull] += waited;
        s_stamps[threadIdx.x >> 7][kMma] += clock64() - t_mma - waited;
      }
#endif
      (void)waited;

      // power of the thread's bins (register 4j + 2h + e: frame r0 + 8h,
      // column 8j + 2tq + e of the warpgroup's, so e = 0 is re and 1 im)
      float* pa = pw + ln.r0 * S::kPld + ln.wg * (WN / 2) + ln.tq;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        pa[4 * j] = __fadd_rn(__fmul_rn(acc[4 * j], acc[4 * j]),
                              __fmul_rn(acc[4 * j + 1], acc[4 * j + 1]));
        pa[8 * S::kPld + 4 * j] = __fadd_rn(__fmul_rn(acc[4 * j + 2], acc[4 * j + 2]),
                                            __fmul_rn(acc[4 * j + 3], acc[4 * j + 3]));
      }
      bar_sync<kConsumers>();
      // the band's bins in this chunk, ascending
      const int b0 = max(b_first, c * WN), b1 = min(b_first + b_count, (c + 1) * WN);
      for (int b = b0; b < b1; ++b) {
        const float w = __ldg(bw + b - b_first);
        const float* col = pw + b - c * WN;
#pragma unroll
        for (int i = 0; i < kRows / 4; ++i) mel[i] = fmaf(col[(fq + 4 * i) * S::kPld], w, mel[i]);
      }
      bar_sync<kConsumers>();
    }
#pragma unroll
    for (int i = 0; i < kRows / 4; ++i) {
      const int f = fq + 4 * i;
      if (f < nf) {
        const float db = 20.f * (logf(fmaxf(mel[i], 1e-5f)) / kLn10);
        P.out[(size_t)(g0 + f) * kMels + band] = (db - P.mid) * P.inv_half_range;
      }
    }
  }
  STAMP_END(kTotal, t_all);
}

template <int WN>
__global__ void __launch_bounds__(kThreads, 1) log_mel_kernel(const __grid_constant__ Params P) {
  using S = Shape<WN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* slots = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* span = reinterpret_cast<float*>(slots + kStages * S::kSlot);
  float* pw = span + kSpanFloats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(pw + kRows * S::kPld);
  const typename S::Ring ring{slots, bars, bars + kStages};
  if (threadIdx.x == 0) {
    ring.init(2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#ifdef CHAIN_STAMPS
  if (threadIdx.x < 3 * kStamps) s_stamps[threadIdx.x / kStamps][threadIdx.x % kStamps] = 0;
#endif
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x > kConsumers) return;
    STAMP_BEGIN(t0);
    uint32_t s = 0;
    const size_t slab_floats = (size_t)P.chunks * S::kCols * kSlabK;
    for (int tile = blockIdx.x; tile < P.tiles; tile += gridDim.x)
      for (int c = 0; c < P.chunks; ++c)
        for (int sl = 0; sl < kSlabs; ++sl, ++s) {
          const int slot = s % kStages;
          STAMP_BEGIN(t1);
          mbar_wait(&ring.empty[slot], ((s / kStages) & 1) ^ 1);
          STAMP_END(kWaitEmpty, t1);
          unsigned char* dst = slots + slot * S::kSlot;
          const size_t at = sl * slab_floats + (size_t)c * S::kCols * kSlabK;
          mbar_expect_tx(&ring.full[slot], S::kSlot);
          bulk_load(dst, P.hi + at, S::kSlot / 2, &ring.full[slot]);
          bulk_load(dst + S::kSlot / 2, P.lo + at, S::kSlot / 2, &ring.full[slot]);
        }
    STAMP_END(kProducer, t0);
#ifdef CHAIN_STAMPS
    for (int k = 0; k < kStamps; ++k)
      atomicAdd(&g_stamps[2 * kStamps + k], (unsigned long long)s_stamps[2][k]);
#endif
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  consumer<WN>(P, ring, span, pw);
#ifdef CHAIN_STAMPS
  if ((threadIdx.x & 127) == 0)
    for (int k = 0; k < kStamps; ++k)
      atomicAdd(&g_stamps[(threadIdx.x >> 7) * kStamps + k],
                (unsigned long long)s_stamps[threadIdx.x >> 7][k]);
#endif
}

template <int WN>
int launch(const Params& P, cudaStream_t stream) {
  using S = Shape<WN>;
  cudaError_t e = cudaFuncSetAttribute(log_mel_kernel<WN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)S::kSmem);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, err = sm_count(&sms);
  if (err) return err;
  log_mel_kernel<WN><<<(unsigned)(P.tiles < sms ? P.tiles : sms), kThreads, S::kSmem, stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// wave [rows, L] float32 -> out [rows, n_frames, 64] float32. hi and lo are
// the plan's TF32 bases by slab of 32 samples, [13, chunks * chunk_cols, 32]
// (chunk_cols 240 or 256), each 128-byte row's 16-byte pieces swizzled as
// TMA's 128-byte swizzle puts them (piece j of column n at j ^ (n % 8));
// bands [3, 64] int32 and weights float32 its sparse filterbank. F frames
// a tile (1..64) such that F * 160 plus 320 for every row a tile can touch
// fits 15,840 samples. Needs L > 256 and n_frames <= 1 + L / 160. Returns
// the launch's cudaError_t (0 on success).
int cavp_fused_log_mel(const void* wave, const void* hi, const void* lo, const void* bands,
                       const void* weights, void* out, int rows, int L, int n_frames, int F,
                       int chunks, int chunk_cols, float mid, float inv_half_range,
                       void* stream) {
  if (rows <= 0 || n_frames <= 0 || L <= 256 || n_frames > 1 + L / kHop || F < 1 ||
      F > kRows || chunks < 1 || (chunk_cols != 240 && chunk_cols != 256))
    return (int)cudaErrorInvalidValue;
  const int reach = 1 + (F - 1 + n_frames - 1) / n_frames, segs = reach < F ? reach : F;
  if (F * kHop + segs * 2 * kHop > kSpanLogical) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)rows * n_frames + F - 1) / F;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  Params P{};
  P.hi = (const float*)hi;
  P.lo = (const float*)lo;
  P.wave = (const float*)wave;
  P.out = (float*)out;
  P.bands = (const int*)bands;
  P.weights = (const float*)weights;
  P.rows = rows;
  P.L = L;
  P.n_frames = n_frames;
  P.F = F;
  P.tiles = (int)tiles;
  P.chunks = chunks;
  P.mid = mid;
  P.inv_half_range = inv_half_range;
  const cudaStream_t s = (cudaStream_t)stream;
  return chunk_cols == 240 ? launch<120>(P, s) : launch<128>(P, s);
}

#ifdef CHAIN_STAMPS
// The kernel's stage counters (3 x sm90::kStamps), read and zeroed.
int cavp_mel_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sm90::g_stamps, sizeof(sm90::g_stamps));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zero[3 * sm90::kStamps] = {};
  return (int)cudaMemcpyToSymbol(sm90::g_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"
