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
// the pool, which is the concatenation order.  Cin in {3, 16, 64}.  One CTA
// computes 64 consecutive output pixels as an implicit GEMM: the 3x3 input
// window of each output pixel is gathered into shared memory (K = 9 Cin,
// padded to 16; cp.async for Cin 16 and 64), the (K x Cc) weight matrix
// comes pre-padded from the wrapper, mma.sync multiplies into a separate
// f32 buffer, and the epilogue takes the pool from the staged window,
// applies BN and ReLU and writes each output pixel's Cout channels once.
// The grid holds as many CTAs as are resident; each stages the weights
// once and walks its share of the tiles.
//
// Bound on this card: bytes.  The stem reads 3 channels and writes 16 per
// output pixel, so its products are few; the 16 -> 64 and 64 -> 128 blocks
// are byte-bound too at these widths.  This version reads each input pixel
// up to four times through L2 (the overlapping 3x3 windows); staging a band
// of input rows per CTA is the next step.
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <int CIN, int CC>
struct Cfg {
  static constexpr int BM = 64, THREADS = 128;
  static constexpr int COUT = CIN + CC;
  static constexpr int K = 9 * CIN, KP = round16(K), NP = round16(CC);
  static constexpr int LDA = KP + 8, LDB = NP + 8, LDC = NP + 4;
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 2 + 127) / 128 * 128;
  static constexpr size_t c_bytes = ((size_t)BM * LDC * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + c_bytes + (size_t)KP * LDB * 2;
};

// Start staging the A tile of output pixels [m0, m0 + BM): row r = the 3x3
// window of pixel m0 + r, column tap * CIN + ci with tap = kh * 3 + kw,
// input (2 ho - 1 + kh, 2 wo - 1 + kw), zero outside the map and in the
// K padding.  Completes at cp_async_wait_all() + __syncthreads().
template <int CIN, int CC>
__device__ __forceinline__ void gather(bf16* As, const bf16* x, int m0, int M,
                                       int Ho, int Wo) {
  using G = Cfg<CIN, CC>;
  const int H = 2 * Ho, W = 2 * Wo;
  if constexpr (CIN % 8 == 0) {
    constexpr int VPT = CIN / 8;  // K == KP here
    for (int v = threadIdx.x; v < G::BM * 9 * VPT; v += blockDim.x) {
      const int r = v / (9 * VPT), tap = (v / VPT) % 9, j = v % VPT;
      const int m = m0 + r;
      const int b = m / (Ho * Wo), rem = m % (Ho * Wo);
      const int hi = 2 * (rem / Wo) - 1 + tap / 3;
      const int wi = 2 * (rem % Wo) - 1 + tap % 3;
      const bool valid = m < M && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const long long pix = valid ? ((long long)b * H + hi) * W + wi : 0;
      cp_async16(As + r * G::LDA + tap * CIN + j * 8, x + pix * CIN + j * 8,
                 valid);
    }
  } else {
    // CIN = 3: rows are 6 bytes, too narrow for 16-byte copies.  Issue
    // every load of this thread before the first store, so the loads are
    // in flight together.
    constexpr int PER = G::BM * G::KP / G::THREADS;
    static_assert(G::BM * G::KP % G::THREADS == 0, "tile / threads");
    bf16 val[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      const int r = e / G::KP, k = e % G::KP;
      const int m = m0 + r;
      const int tap = k / CIN, ci = k % CIN;
      const int b = m / (Ho * Wo), rem = m % (Ho * Wo);
      const int hi = 2 * (rem / Wo) - 1 + tap / 3;
      const int wi = 2 * (rem % Wo) - 1 + tap % 3;
      val[i] = __float2bfloat16(0.0f);
      if (m < M && k < G::K && hi >= 0 && hi < H && wi >= 0 && wi < W)
        val[i] = x[(((long long)b * H + hi) * W + wi) * CIN + ci];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      As[(e / G::KP) * G::LDA + e % G::KP] = val[i];
    }
  }
}

// Each CTA stages the weights once and walks tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...
template <int CIN, int CC>
__global__ void __launch_bounds__(128)
down_eval_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wmat,
                 const float* __restrict__ bias,
                 const float* __restrict__ scale,
                 const float* __restrict__ shift, bf16* __restrict__ out,
                 int M, int Ho, int Wo) {
  using G = Cfg<CIN, CC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + G::a_bytes);
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::a_bytes + G::c_bytes);
  const int tiles = (M + G::BM - 1) / G::BM;

  load_matrix(Ws, G::LDB, wmat, G::KP, G::NP);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * G::BM;
    gather<CIN, CC>(As, x, m0, M, Ho, Wo);
    cp_async_wait_all();
    __syncthreads();

    block_gemm<16, G::NP, G::LDA, G::NP, G::KP>(As, Ws, Cs);

    // the tile's output is one contiguous run of BM * COUT elements; the
    // pool reads its 2x2 window from the staged 3x3 one (taps 4, 5, 7, 8)
    for (int e = threadIdx.x; e < G::BM * G::COUT; e += blockDim.x) {
      const int r = e / G::COUT, c = e % G::COUT;
      const int m = m0 + r;
      if (m >= M) break;  // e grows with m: the rest of this thread is past M
      float v;
      if (c < CC) {
        v = Cs[r * G::LDC + c] + __ldg(bias + c);
      } else {
        const bf16* a = As + r * G::LDA + (c - CC);
        v = fmaxf(fmaxf(__bfloat162float(a[4 * CIN]),
                        __bfloat162float(a[5 * CIN])),
                  fmaxf(__bfloat162float(a[7 * CIN]),
                        __bfloat162float(a[8 * CIN])));
      }
      // no fma contraction: the plain version rounds the product, then
      // the sum
      v = __fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c));
      out[(long long)m * G::COUT + c] = __float2bfloat16(fmaxf(v, 0.0f));
    }
    __syncthreads();  // A read by the pool before the next gather
  }
}

template <int CIN, int CC>
int launch(const void* x, const void* wmat, const void* bias,
           const void* scale, const void* shift, void* out, int B, int H,
           int W, cudaStream_t stream) {
  using G = Cfg<CIN, CC>;
  static bool smem_ok = false;
  static int grid_max = 0;
  cudaError_t e = allow_smem(down_eval_kernel<CIN, CC>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(down_eval_kernel<CIN, CC>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  const int Ho = H / 2, Wo = W / 2;
  const long long M = (long long)B * Ho * Wo;
  if ((long long)B * H * W * CIN >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long tiles = (M + G::BM - 1) / G::BM;
  const unsigned grid = (unsigned)(tiles < grid_max ? tiles : grid_max);
  down_eval_kernel<CIN, CC><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wmat),
      static_cast<const float*>(bias), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<bf16*>(out), (int)M, Ho,
      Wo);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16, H and W even; wmat: (KP, NP) bf16, row
// (kh*3 + kw)*Cin + ci, column co, zero padded to multiples of 16; bias:
// (Cc,) f32; scale, shift: (Cin + Cc,) f32; out: (B, H/2, W/2, Cin + Cc) bf16.
extern "C" int erf_downsampler_eval(const void* x, const void* wmat,
                                    const void* bias, const void* scale,
                                    const void* shift, void* out, int B,
                                    int H, int W, int cin, int cc,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 3 && cc == 13)
    return launch<3, 13>(x, wmat, bias, scale, shift, out, B, H, W, s);
  if (cin == 16 && cc == 48)
    return launch<16, 48>(x, wmat, bias, scale, shift, out, B, H, W, s);
  if (cin == 64 && cc == 64)
    return launch<64, 64>(x, wmat, bias, scale, shift, out, B, H, W, s);
  return cudaErrorInvalidValue;
}
