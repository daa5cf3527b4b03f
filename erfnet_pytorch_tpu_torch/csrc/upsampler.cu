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
// f32 fold of the weights, f32 bias, no rounding but f32's own.  The
// train upsampler's f32 forward (ups_fwd32.cuh) with the epilogue
// relu(sum + bias): tiles of 4 x 32 input pixels, each tile's f32 halo
// patch staged once for the four planes, the nine taps as units of a view
// and its planes, 3xTF32 in wgmma, the split taps resident at 64 -> 16 and
// streamed and split in the kernel at 128 -> 64 (the output channels over
// two CTAs).  Bound on this card at f32: operations (9 Cin Cout MACs per
// input pixel against 67 TFLOP/s).
#include "parity_plane.cuh"
#include "ups_fwd32.cuh"

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
// f32 form: ups_fwd32.cuh's parity-plane product over halo patches with
// the epilogue relu(sum + bias)
// ---------------------------------------------------------------------------

struct EvalOut32 {
  static constexpr bool STATS = false;
  const float* bias;
  float* y;
  float* part;   // unused
  __device__ float4 operator()(long long o, int ch, float4 v) const {
    const float4 b = make_float4(__ldg(bias + ch), __ldg(bias + ch + 1),
                                 __ldg(bias + ch + 2), __ldg(bias + ch + 3));
    const float4 r =
        make_float4(fmaxf(v.x + b.x, 0.0f), fmaxf(v.y + b.y, 0.0f),
                    fmaxf(v.z + b.z, 0.0f), fmaxf(v.w + b.w, 0.0f));
    *reinterpret_cast<float4*>(y + o) = r;
    return r;
  }
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(256, 1)
ups_eval32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  ups_fwd32<CIN, COUT>(smem, x, w, B, H, W, EvalOut32{bias, out, nullptr});
}

template <int CIN, int COUT>
int launch_f32(const void* x, const void* w, const void* bias, void* out,
               int B, int H, int W, cudaStream_t stream) {
  using C = Ups32<CIN, COUT>;
  constexpr size_t smem = Ups32Smem<CIN, COUT>::smem;
  static bool smem_ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(ups_eval32_kernel<CIN, COUT>, smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (gm == 0 && (e = resident_ctas(ups_eval32_kernel<CIN, COUT>, C::THREADS,
                                    smem, &gm)) != cudaSuccess)
    return e;
  const long long M = (long long)B * H * W;
  if (4 * M * (CIN > COUT ? CIN : COUT) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = B * ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW);
  const int per = gm / C::NSPLIT > 0 ? gm / C::NSPLIT : 1;  // CTAs a split
  ups_eval32_kernel<CIN, COUT><<<dim3(tiles < per ? tiles : per, C::NSPLIT),
                                 C::THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W);
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
