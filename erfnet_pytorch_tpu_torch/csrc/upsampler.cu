// UpsamplerBlock inference: ConvTranspose2d(k3 s2 p1 op1) with BatchNorm
// folded into the weights -> + bias -> ReLU, in one launch.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/upsampler.py:
// _ups_eval_kernel_blocked (via upsampler_packed_eval).  Same rounding
// points: BN folded in f32, then the weights rounded to bf16; bias in f32;
// f32 accumulation; one bf16 rounding of relu(acc + bias).
//
// The parity-plane product of parity_plane.cuh (pp_run), as the train
// upsampler's forward runs it (upsampler_train.cu fwd_kernel): output
// pixel (2i+a, 2j+b) reads input (i + m_h, j + m_w) through tap (t_h, t_w)
// of the forward-conv-equivalent (flipped) HWIO weight, with per dimension
// parity 0 -> {(m 0, t 1)} and parity 1 -> {(m 0, t 0), (m 1, t 2)}
// (ops/convt_mm.py PARITY_TAPS; the nine non-zero blocks read straight
// from the (3, 3, Cin, Cout) stack, nothing gathered on the host); inputs
// past the bottom/right edge are zero.  Persistent CTAs (as many as the
// card holds) over tiles of 4 x 32 input pixels of one image: a tile's
// halo patch is staged once for all four planes, the weight blocks stream
// through a cp.async ring (resident at 64 -> 16) while the tensor cores
// work, and each half's output rows are written whole, 16 bytes a thread,
// bf16(relu(sum + bias)) rounded once.
//
// Bound on this card: bytes for both widths at these shapes (9 Cin Cout
// MACs per input pixel against 2 Cin + 8 Cout bytes).  Each tile reads
// its 9 Cin Cout weights from L2 (1.2 KB a pixel at 128 -> 64), one CTA
// an SM at 128 -> 64, mma.sync and not wgmma.
//
// The f32 form (the JAX package's default compute dtype): f32 maps, the
// f32 fold of the weights, f32 bias, no rounding but f32's own.  Each CTA
// multiplies its plane's taps one at a time (K chunks of Cin: a plane's
// four f32 taps at Cin 128 would not fit in shared memory beside the
// tile), an FFMA micro-tile on the CUDA cores (each thread TM input pixels
// x TN output channels; no TF32).  Bound on this card at f32: operations
// at both widths (9 Cin Cout MACs per input pixel against 67 TFLOP/s).
#include "parity_plane.cuh"

using namespace erfk;

namespace {

template <int CIN, int COUT>
using EvalCfg = PPCfg<CIN, COUT, 4, COUT == 16 ? 9 : 4>;

// pp_run's policy: y = bf16(relu(sum + bias)), whole output rows
template <class C>
struct EvalEpi {
  int tiles, H, W;
  const float* bias;
  bf16* y;
  __device__ float pre(float v, int n) const {
    return fmaxf(v + __ldg(bias + n), 0.0f);
  }
  // half a's output rows of the tile
  __device__ void out(int a, PPTile tl, const bf16* Cs) const {
    for (int e = threadIdx.x; e < C::TH * 2 * C::TW * C::VN;
         e += C::THREADS) {
      const int pix = e / C::VN, j = e % C::VN;
      const int r = pix / (2 * C::TW), pc = pix % (2 * C::TW);
      const int i = tl.i0 + r;
      if (i >= H || tl.j0 + pc / 2 >= W) continue;
      *reinterpret_cast<uint4*>(
          y + (((long long)tl.b * 2 * H + 2 * i + a) * 2 * W + 2 * tl.j0 +
               pc) * C::N + j * 8) =
          *reinterpret_cast<const uint4*>(Cs + pix * C::LDN + j * 8);
    }
  }
  __device__ void end_tile(int) const {}
};

template <int CIN, int COUT>
__host__ __device__ constexpr int eval_tiles_per_image(int H, int W) {
  return ((H + EvalCfg<CIN, COUT>::TH - 1) / EvalCfg<CIN, COUT>::TH) *
         ((W + EvalCfg<CIN, COUT>::TW - 1) / EvalCfg<CIN, COUT>::TW);
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(256)
ups_eval_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out,
                int B, int H, int W) {
  using C = EvalCfg<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  EvalEpi<C> epi{B * eval_tiles_per_image<CIN, COUT>(H, W), H, W, bias,
                 out};
  pp_run<C, false>(smem, PPSrc{x, CIN}, w, H, W, epi);
}

template <int CIN, int COUT>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using C = EvalCfg<CIN, COUT>;
  static bool smem_ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(ups_eval_kernel<CIN, COUT>, C::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (gm == 0 && (e = resident_ctas(ups_eval_kernel<CIN, COUT>, C::THREADS,
                                    C::smem, &gm)) != cudaSuccess)
    return e;
  const long long M = (long long)B * H * W;
  if (4 * M * (CIN > COUT ? CIN : COUT) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = B * eval_tiles_per_image<CIN, COUT>(H, W);
  ups_eval_kernel<CIN, COUT><<<tiles < gm ? tiles : gm, C::THREADS, C::smem,
                               stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// f32 form
// ---------------------------------------------------------------------------

// Thread t owns input pixels rg, rg + RS, ... (rg = t / TC) of the tile and
// the output channels 4 cg + g CS + q, q < 4, of its TN / 4 groups g (cg =
// t % TC, CS = 4 TC; see ffma_tile).
template <int CIN, int COUT>
struct Cfg32 {
  static constexpr int BM = 64, THREADS = 128, TN = COUT == 16 ? 4 : 8;
  static constexpr int TC = COUT / TN, RS = THREADS / TC, TM = BM / RS;
  static constexpr int CS = 4 * TC;
  static constexpr int LDA = pitch4(CIN), LDB = COUT;
  static_assert(COUT % TN == 0 && THREADS % TC == 0 && BM % RS == 0,
                "f32 upsampler tile");
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + (size_t)CIN * LDB * 4;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(128)
ups_eval_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int M, int H, int W) {
  using G = Cfg32<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + G::a_bytes);
  const int m0 = blockIdx.x * G::BM;
  const int pa = blockIdx.y >> 1, pb = blockIdx.y & 1;
  const int nw = pb ? 2 : 1, ntaps = (pa ? 2 : 1) * nw;
  const int cg = threadIdx.x % G::TC, rg = threadIdx.x / G::TC;
  float acc[G::TM][G::TN];
  zero_tile(acc);

  constexpr int VPT = CIN / 4;
  for (int q = 0; q < ntaps; ++q) {
    // tap q = ih * nw + iw reads input (i + ih, j + iw) through weight tap
    // (th, tw) = (ih ? 2 : (pa ? 0 : 1), iw ? 2 : (pb ? 0 : 1))
    const int ih = q / nw, iw = q % nw;
    const int th = ih ? 2 : (pa ? 0 : 1), tw = iw ? 2 : (pb ? 0 : 1);
    load_matrix(Ws, G::LDB, w + (size_t)(th * 3 + tw) * CIN * COUT, CIN,
                COUT);
    for (int v = threadIdx.x; v < G::BM * VPT; v += blockDim.x) {
      const int r = v / VPT, j = v % VPT;
      const int m = m0 + r;
      const int i = (m / W) % H, jj = m % W;
      const bool valid = m < M && i + ih < H && jj + iw < W;
      const long long pix = valid ? (long long)m + ih * W + iw : 0;
      cp_async16(As + r * G::LDA + j * 4, x + pix * CIN + j * 4, valid);
    }
    cp_async_wait_all();
    __syncthreads();
    ffma_tile<G::TM, G::TN, CIN, G::CS>(acc, As + rg * G::LDA,
                                        G::RS * G::LDA, Ws + 4 * cg, G::LDB);
    __syncthreads();  // every thread is done with this tap
  }

#pragma unroll
  for (int i = 0; i < G::TM; ++i) {
    const int m = m0 + rg + i * G::RS;
    if (m >= M) break;  // rows grow with i
    const long long b = m / (H * W);
    const int ii = (m / W) % H, jj = m % W;
    float* dst = out + ((b * 2 * H + 2 * ii + pa) * 2 * W + 2 * jj + pb) *
                           COUT;
#pragma unroll
    for (int j = 0; j < G::TN; j += 4) {
      const int c = 4 * cg + (j / 4) * G::CS;
      *reinterpret_cast<float4*>(dst + c) = make_float4(
          fmaxf(acc[i][j] + __ldg(bias + c), 0.0f),
          fmaxf(acc[i][j + 1] + __ldg(bias + c + 1), 0.0f),
          fmaxf(acc[i][j + 2] + __ldg(bias + c + 2), 0.0f),
          fmaxf(acc[i][j + 3] + __ldg(bias + c + 3), 0.0f));
    }
  }
}

template <int CIN, int COUT>
int launch_f32(const void* x, const void* w, const void* bias, void* out,
               int B, int H, int W, cudaStream_t stream) {
  using G = Cfg32<CIN, COUT>;
  static bool smem_ok = false;
  cudaError_t e = allow_smem(ups_eval_f32_kernel<CIN, COUT>, G::smem,
                             &smem_ok);
  if (e != cudaSuccess) return e;
  const long long M = (long long)B * H * W;
  if (4 * M * (CIN > COUT ? CIN : COUT) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + G::BM - 1) / G::BM), 4);
  ups_eval_f32_kernel<CIN, COUT><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), (int)M, H,
      W);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W, Cin) bf16; w: (3, 3, Cin, Cout) bf16 forward-conv HWIO with
// BN folded; bias: (Cout,) f32; out: (B, 2H, 2W, Cout) bf16.
extern "C" int erf_upsampler_eval(const void* x, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int cin, int cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 128 && cout == 64)
    return launch<128, 64>(x, w, bias, out, B, H, W, s);
  if (cin == 64 && cout == 16)
    return launch<64, 16>(x, w, bias, out, B, H, W, s);
  return cudaErrorInvalidValue;
}

// The f32 form: x (B, H, W, Cin) f32; w (3, 3, Cin, Cout) f32 with BN
// folded; bias (Cout,) f32; out (B, 2H, 2W, Cout) f32.
extern "C" int erf_upsampler_eval_f32(const void* x, const void* w,
                                      const void* bias, void* out, int B,
                                      int H, int W, int cin, int cout,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 128 && cout == 64)
    return launch_f32<128, 64>(x, w, bias, out, B, H, W, s);
  if (cin == 64 && cout == 16)
    return launch_f32<64, 16>(x, w, bias, out, B, H, W, s);
  return cudaErrorInvalidValue;
}
