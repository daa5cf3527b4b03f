// DownsamplerBlock inference: cat[conv3x3 s2 p1 (Cin -> Cc), maxpool 2x2]
// -> BatchNorm (running statistics) -> ReLU, in one launch.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/downsampler.py:
// _down_eval_kernel_blocked (via downsampler_packed_eval).  Same function,
// same rounding points: bf16 input and conv weights, f32 accumulation,
// conv bias and BN scale/shift in f32 and not folded into the weights, the
// pool value the max of the four bf16 inputs, one bf16 rounding at the end.
//
// Layout: NHWC in, NHWC out with channels [0, Cc) the conv and [Cc, Cout)
// the pool, which is the concatenation order.  Cin in {3, 16, 64}.
//
// bf16: the train forward's kernel (down_fwd.cuh, EVAL) with the BatchNorm
// and ReLU in its epilogue.  A tile of TH x 32 output pixels of one image
// (TH = 2 at Cin = 64, 4 at 16, 8 at 3) stages its (2 TH + 1) x 65 input
// pixels once with cp.async straight into four parity planes, where each
// of the nine taps is a shifted, unit-stride ldmatrix view (at Cin = 3 the
// patch rows are runs of 65 x 3 values and the taps an im2col tile of K =
// 27); the (9 Cin x Cc) tap stack, read from w as it is, stays resident;
// mma.sync with f32 accumulators; the pool is taps 4, 5, 7 and 8 of the
// same patch.  Persistent CTAs, the next tile's patch in flight while this
// one multiplies; whole output pixels staged and written 16 bytes a
// thread.  Each input pixel crosses L2 once per tile (its halo row and
// column once more), where the implicit GEMM this replaced gathered each
// output pixel's 3x3 window, reading every input pixel up to four times.
// Bound on this card: bytes (9 Cin Cc MACs per output pixel against 4 Cin
// + 2 Cout bytes read and written: at most 72 operations per byte, under
// the card's 295).  What is left: the copies, the product and the
// epilogue run in turn in each CTA (one CTA an SM at Cin = 64), mma.sync
// and not wgmma.
//
// The f32 form (the JAX package's default compute dtype; the eval CLIs
// without --bf16): the same function at f32 maps and f32 weights, every
// sum an f32 FMA chain on the CUDA cores (no TF32), one f32 result.  The
// product is an FFMA micro-tile (each thread a TM x 8 block of output
// pixels x conv channels) over K = 9 Cin, staged in K chunks of whole taps
// (all nine taps for Cin 3 and 16, three for Cin 64, whose f32 window and
// weights would not fit in shared memory together); the pool reads its
// 2x2 window straight from device memory (each input element once).
// Bound on this card at f32: operations for the 16 -> 64 and 64 -> 128
// blocks (144 x 48 and 576 x 64 MACs per output pixel against 67 TFLOP/s),
// bytes for the stem.
#include "down_fwd.cuh"

using namespace erfk;

namespace {

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <int CIN, int CC>
int launch(const void* x, const void* w, const void* bias, const void* scale,
           const void* shift, void* out, int B, int H, int W,
           cudaStream_t stream) {
  using G = Fwd<CIN, CC, false>;
  const auto kernel = down_fwd_kernel<CIN, CC, false, false, true>;
  static bool smem_ok = false;
  static int grid_max = 0;
  cudaError_t e = allow_smem(kernel, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(kernel, G::THREADS, G::smem, &grid_max)) !=
          cudaSuccess)
    return e;
  if ((long long)B * H * W * CIN >= (1LL << 31)) return cudaErrorInvalidValue;
  const int Ho = H / 2, Wo = W / 2;
  const int tiles =
      B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  kernel<<<tiles < grid_max ? tiles : grid_max, G::THREADS, G::smem,
           stream>>>(x, nullptr, static_cast<const bf16*>(w),
                     static_cast<const float*>(bias), static_cast<bf16*>(out),
                     nullptr, nullptr, B, Ho, Wo,
                     static_cast<const float*>(scale),
                     static_cast<const float*>(shift));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 form
// ---------------------------------------------------------------------------

// TPC taps per K chunk of KC (padded to 4) columns; the threads form a
// grid of (BM / TM) row groups x (NP / TN) column groups: thread t owns
// rows rg, rg + RS, ... (rg = t / TC) and the columns 4 cg + g CS + q, q <
// 4, of its TN / 4 groups g (cg = t % TC, CS = 4 TC; see ffma_tile).
template <int CIN, int CC>
struct Cfg32 {
  static constexpr int BM = 64, TN = 8;
  static constexpr int COUT = CIN + CC, NP = round16(CC);
  static constexpr int TPC = CIN == 64 ? 3 : 9, NCHUNK = 9 / TPC;
  static constexpr int KC = (TPC * CIN + 3) / 4 * 4;
  static constexpr int LDA = pitch4(KC), LDB = NP;
  static constexpr int TC = NP / TN, THREADS = CC == 48 ? 192 : 128;
  static constexpr int RS = THREADS / TC, TM = BM / RS, CS = 4 * TC;
  static_assert(NP % TN == 0 && THREADS % TC == 0 && BM % RS == 0 &&
                    KC % 4 == 0,
                "f32 downsampler tile");
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + (size_t)KC * LDB * 4;
};

// Stage the chunk of taps [t0, t0 + TPC) of output pixels [m0, m0 + BM):
// row r, column tq * CIN + ci = input (2 ho - 1 + kh, 2 wo - 1 + kw)
// channel ci of tap t0 + tq = kh * 3 + kw, zero outside the map and in the
// K padding.  Completes at cp_async_wait_all() + __syncthreads().
template <int CIN, int CC>
__device__ __forceinline__ void gather_f32(float* As, const float* x, int m0,
                                           int M, int Ho, int Wo, int t0) {
  using G = Cfg32<CIN, CC>;
  const int H = 2 * Ho, W = 2 * Wo;
  if constexpr (CIN % 4 == 0) {
    constexpr int VPT = CIN / 4;  // 16-byte vectors per (pixel, tap)
    for (int v = threadIdx.x; v < G::BM * G::TPC * VPT; v += blockDim.x) {
      const int r = v / (G::TPC * VPT), tq = (v / VPT) % G::TPC,
                j = v % VPT;
      const int tap = t0 + tq, m = m0 + r;
      const int b = m / (Ho * Wo), rem = m % (Ho * Wo);
      const int hi = 2 * (rem / Wo) - 1 + tap / 3;
      const int wi = 2 * (rem % Wo) - 1 + tap % 3;
      const bool valid = m < M && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const long long pix = valid ? ((long long)b * H + hi) * W + wi : 0;
      cp_async16(As + r * G::LDA + tq * CIN + j * 4, x + pix * CIN + j * 4,
                 valid);
    }
  } else {
    // CIN = 3 (one chunk of all nine taps): 12-byte rows, too narrow for
    // 16-byte copies.  Every load of this thread is issued before the
    // first store, so the loads are in flight together.
    constexpr int PER = G::BM * G::KC / G::THREADS;
    static_assert(G::BM * G::KC % G::THREADS == 0, "tile / threads");
    float val[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      const int r = e / G::KC, k = e % G::KC;
      const int m = m0 + r, tap = k / CIN, ci = k % CIN;
      const int b = m / (Ho * Wo), rem = m % (Ho * Wo);
      const int hi = 2 * (rem / Wo) - 1 + tap / 3;
      const int wi = 2 * (rem % Wo) - 1 + tap % 3;
      val[i] = 0.0f;
      if (m < M && k < 9 * CIN && hi >= 0 && hi < H && wi >= 0 && wi < W)
        val[i] = __ldg(x + (((long long)b * H + hi) * W + wi) * CIN + ci);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      As[(e / G::KC) * G::LDA + e % G::KC] = val[i];
    }
  }
}

// Each CTA walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...; with one
// K chunk it stages the weights once, else each chunk's rows per tile.
template <int CIN, int CC>
__global__ void __launch_bounds__(Cfg32<CIN, CC>::THREADS)
down_eval_f32_kernel(const float* __restrict__ x,
                     const float* __restrict__ wmat,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, float* __restrict__ out,
                     int M, int Ho, int Wo) {
  using G = Cfg32<CIN, CC>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + G::a_bytes);
  const int tiles = (M + G::BM - 1) / G::BM;
  const int cg = threadIdx.x % G::TC, rg = threadIdx.x / G::TC;
  const int W = 2 * Wo;

  if constexpr (G::NCHUNK == 1) load_matrix(Ws, G::LDB, wmat, G::KC, G::NP);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * G::BM;
    float acc[G::TM][G::TN];
    zero_tile(acc);
    for (int c = 0; c < G::NCHUNK; ++c) {
      gather_f32<CIN, CC>(As, x, m0, M, Ho, Wo, c * G::TPC);
      if constexpr (G::NCHUNK > 1)
        load_matrix(Ws, G::LDB, wmat + (size_t)c * G::KC * G::NP, G::KC,
                    G::NP);
      cp_async_wait_all();
      __syncthreads();
      ffma_tile<G::TM, G::TN, G::KC, G::CS>(acc, As + rg * G::LDA,
                                            G::RS * G::LDA, Ws + 4 * cg,
                                            G::LDB);
      __syncthreads();  // every thread is done with the chunk
    }
    // conv channels: + bias, then BN (a product, then a sum, each rounded:
    // no fma contraction, as in the plain version), ReLU
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int m = m0 + rg + i * G::RS;
      if (m >= M) break;  // rows grow with i
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int c = 4 * cg + (j / 4) * G::CS + j % 4;
        if (c >= CC) break;  // c grows with j
        float v = acc[i][j] + __ldg(bias + c);
        v = __fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c));
        out[(long long)m * G::COUT + c] = fmaxf(v, 0.0f);
      }
    }
    // pool channels: the max of the 2x2 window (always inside the map)
    for (int e = threadIdx.x; e < G::BM * CIN; e += blockDim.x) {
      const int r = e / CIN, ci = e % CIN;
      const int m = m0 + r;
      if (m >= M) break;  // e grows with m
      const int b = m / (Ho * Wo), rem = m % (Ho * Wo);
      const float* p = x + (((long long)b * 2 * Ho + 2 * (rem / Wo)) * W +
                            2 * (rem % Wo)) * CIN + ci;
      float v = fmaxf(fmaxf(__ldg(p), __ldg(p + CIN)),
                      fmaxf(__ldg(p + (long long)W * CIN),
                            __ldg(p + (long long)W * CIN + CIN)));
      const int c = CC + ci;
      v = __fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c));
      out[(long long)m * G::COUT + c] = fmaxf(v, 0.0f);
    }
  }
}

template <int CIN, int CC>
int launch_f32(const void* x, const void* wmat, const void* bias,
               const void* scale, const void* shift, void* out, int B, int H,
               int W, cudaStream_t stream) {
  using G = Cfg32<CIN, CC>;
  static bool smem_ok = false;
  static int grid_max = 0;
  cudaError_t e = allow_smem(down_eval_f32_kernel<CIN, CC>, G::smem,
                             &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(down_eval_f32_kernel<CIN, CC>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  const int Ho = H / 2, Wo = W / 2;
  const long long M = (long long)B * Ho * Wo;
  if ((long long)B * H * W * CIN >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long tiles = (M + G::BM - 1) / G::BM;
  const unsigned grid = (unsigned)(tiles < grid_max ? tiles : grid_max);
  down_eval_f32_kernel<CIN, CC><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wmat),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<float*>(out), (int)M, Ho,
      Wo);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16, H and W even; w: (3, 3, Cin, Cc) bf16, the tap
// stack as it is (row (kh * 3 + kw) Cin + ci, column co), 16-byte aligned;
// bias: (Cc,) f32; scale, shift: (Cin + Cc,) f32; out: (B, H/2, W/2, Cin +
// Cc) bf16.
extern "C" int erf_downsampler_eval(const void* x, const void* w,
                                    const void* bias, const void* scale,
                                    const void* shift, void* out, int B,
                                    int H, int W, int cin, int cc,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2) return cudaErrorInvalidValue;
  if (cin == 3 && cc == 13)
    return launch<3, 13>(x, w, bias, scale, shift, out, B, H, W, s);
  if (cin == 16 && cc == 48)
    return launch<16, 48>(x, w, bias, scale, shift, out, B, H, W, s);
  if (cin == 64 && cc == 64)
    return launch<64, 64>(x, w, bias, scale, shift, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

// The f32 form: x (B, H, W, Cin) f32; wmat (KP, NP) f32, row (kh * 3 +
// kw) Cin + ci, column co, zero padded to multiples of 16; out (B, H/2,
// W/2, Cin + Cc) f32.
extern "C" int erf_downsampler_eval_f32(const void* x, const void* wmat,
                                        const void* bias, const void* scale,
                                        const void* shift, void* out, int B,
                                        int H, int W, int cin, int cc,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 3 && cc == 13)
    return launch_f32<3, 13>(x, wmat, bias, scale, shift, out, B, H, W, s);
  if (cin == 16 && cc == 48)
    return launch_f32<16, 48>(x, wmat, bias, scale, shift, out, B, H, W, s);
  if (cin == 64 && cc == 64)
    return launch_f32<64, 64>(x, wmat, bias, scale, shift, out, B, H, W, s);
  return cudaErrorInvalidValue;
}
