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
// without --bf16): the same function at f32 maps and f32 weights, read
// from w as it is, nothing rounded but f32's own, in the same frame: at
// Cin = 16 and 64 down_fwd32.cuh's halo-patch forward (TH x 32 output
// pixels a tile, TH = 4 / 2, the patch in four parity planes, each tap a
// unit-stride view; 3xTF32 in wgmma, the taps split into TF32 hi and lo
// images in the kernel: resident at Cin = 16, streamed half a tap a stage
// at 64; the pool from the same patch), at Cin = 3 the train forward's
// raw-patch tile (down_fwd32.cuh down_fwd3_f32_kernel: an FFMA chain per
// output in the plain version's (tap, ci) order), each with the BatchNorm
// and ReLU in its epilogue (bias added to the sum, then the scale's
// product and the shift's sum each rounded, no contraction).
// Bound on this card at f32, B=4 512x1024: operations for the 16 -> 64
// and 64 -> 128 blocks (144 x 48 and 576 x 64 MACs per output pixel
// against 67 TFLOP/s), bytes for the stem; 0.0806 ms in all.  Under
// 3xTF32 (the three products against 494.7 TFLOP/s) the two blocks are
// bound by their bytes too: about 0.053 ms for the three.  What is left
// (scripts/cuda_down_eval32_variants.py, NVIDIA H100 80GB HBM3, 700.00
// W): the 64 -> 64 block takes half of the three's time, as long as
// cuDNN's conv; without its product it keeps 0.61 of its time, without
// the taps' split 0.83, without the patch copies 0.85 (B=6): one CTA an
// SM runs copies, splits, product and epilogue in turn, a barrier each
// half tap.
#include "down_fwd.cuh"
#include "down_fwd32.cuh"

using namespace erfk;

namespace {

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

// relu(v * scale[c] + shift[c]): the product, then the sum, each rounded
// (no fma contraction, as in the plain version)
struct EvalEpi32 {
  const float* scale;
  const float* shift;
  __device__ float operator()(float v, int c) const {
    return fmaxf(__fadd_rn(__fmul_rn(v, __ldg(scale + c)), __ldg(shift + c)),
                 0.0f);
  }
};

template <int CIN, int CC>
__global__ void __launch_bounds__(Down32<CIN, CC>::THREADS,
                                  Down32<CIN, CC>::CTAS)
down_eval32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out,
                   int B, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  down_fwd32<CIN, CC>(smem, x, w, bias, out, B, Ho, Wo,
                      EvalEpi32{scale, shift});
}

template <int CIN, int CC>
int launch32(const void* x, const void* w, const void* bias,
               const void* scale, const void* shift, void* out, int B, int H,
               int W, cudaStream_t stream) {
  static bool smem_ok = false;
  static int grid_max = 0;
  if ((long long)B * H * W * CIN >= (1LL << 31)) return cudaErrorInvalidValue;
  const int Ho = H / 2, Wo = W / 2;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(bias);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* of = static_cast<float*>(out);
  cudaError_t e;
  if constexpr (CIN == 3) {
    using G = Fwd3F32;
    const auto kernel = down_fwd3_f32_kernel<false, false, true>;
    if ((e = allow_smem(kernel, G::smem, &smem_ok)) != cudaSuccess) return e;
    if (grid_max == 0 &&
        (e = resident_ctas(kernel, G::THREADS, G::smem, &grid_max)) !=
            cudaSuccess)
      return e;
    const int tiles =
        B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
    kernel<<<tiles < grid_max ? tiles : grid_max, G::THREADS, G::smem,
             stream>>>(xf, nullptr, wf, bf, of, nullptr, nullptr, B, Ho, Wo,
                       sc, sh);
  } else {
    using G = Down32<CIN, CC>;
    const auto kernel = down_eval32_kernel<CIN, CC>;
    if ((e = allow_smem(kernel, G::smem, &smem_ok)) != cudaSuccess) return e;
    if (grid_max == 0 &&
        (e = resident_ctas(kernel, G::THREADS, G::smem, &grid_max)) !=
            cudaSuccess)
      return e;
    const int tiles =
        B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
    kernel<<<tiles < grid_max ? tiles : grid_max, G::THREADS, G::smem,
             stream>>>(xf, wf, bf, sc, sh, of, B, Ho, Wo);
  }
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

// The f32 form: x (B, H, W, Cin) f32; w (3, 3, Cin, Cc) f32, the tap
// stack as it is, 16-byte aligned; out (B, H/2, W/2, Cin + Cc) f32.
extern "C" int erf_downsampler_eval_f32(const void* x, const void* w,
                                        const void* bias, const void* scale,
                                        const void* shift, void* out, int B,
                                        int H, int W, int cin, int cc,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2) return cudaErrorInvalidValue;
  if (cin == 3 && cc == 13)
    return launch32<3, 13>(x, w, bias, scale, shift, out, B, H, W, s);
  if (cin == 16 && cc == 48)
    return launch32<16, 48>(x, w, bias, scale, shift, out, B, H, W, s);
  if (cin == 64 && cc == 64)
    return launch32<64, 64>(x, w, bias, scale, shift, out, B, H, W, s);
  return cudaErrorInvalidValue;
}
