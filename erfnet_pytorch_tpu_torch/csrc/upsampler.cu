// UpsamplerBlock inference: ConvTranspose2d(k3 s2 p1 op1) with BatchNorm
// folded into the weights -> + bias -> ReLU, in one launch.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/upsampler.py:
// _ups_eval_kernel_blocked (via upsampler_packed_eval).  Same rounding
// points: BN folded in f32, then the weights rounded to bf16; bias in f32;
// f32 accumulation; one bf16 rounding of relu(acc + bias).
//
// Parity-plane form (ops/convt_mm.py): output pixel (2i+a, 2j+b) reads input
// (i + m_h, j + m_w) through tap (t_h, t_w) of the forward-conv-equivalent
// (flipped) HWIO weight, with per dimension parity 0 -> {(m 0, t 1)} and
// parity 1 -> {(m 0, t 0), (m 1, t 2)}; inputs past the bottom/right edge
// are zero.  blockIdx.y picks the plane, so each CTA multiplies only the
// plane's 1, 2 or 4 taps (no structural zeros): 64 input pixels x Cout, K =
// taps x Cin, mma.sync on tiles gathered into shared memory.  (CTAs that
// loop over tiles with the plane's weights staged once measured slower:
// the planes' unequal work then leaves SMs idle.)
//
// Bound on this card: bytes for both widths at these shapes (9 Cin Cout
// MACs per input pixel against 2 Cin + 8 Cout bytes).  Each CTA stages the
// plane's weights itself and gathers (cp.async) each input pixel once per
// tap; the four planes re-read the same input tile through L2.
#include "common.cuh"

using namespace erfk;

namespace {

template <int CIN, int COUT>
struct Cfg {
  static constexpr int BM = 64, THREADS = 128;
  static constexpr int KMAX = 4 * CIN, LDA = KMAX + 8, LDB = COUT + 8,
                       LDC = COUT + 4;
  static constexpr size_t a_raw = (size_t)BM * LDA * 2 > (size_t)BM * LDC * 4
                                      ? (size_t)BM * LDA * 2
                                      : (size_t)BM * LDC * 4;
  static constexpr size_t a_bytes = (a_raw + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + (size_t)KMAX * LDB * 2;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(128)
ups_eval_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out,
                int M, int H, int W) {
  using G = Cfg<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::a_bytes);
  const int m0 = blockIdx.x * G::BM;
  const int pa = blockIdx.y >> 1, pb = blockIdx.y & 1;
  const int nh = pa ? 2 : 1, nw = pb ? 2 : 1, ntaps = nh * nw;

  // tap q = ih * nw + iw: (m_h, t_h) = ih ? (1, 2) : (0, pa ? 0 : 1)
  for (int q = 0; q < ntaps; ++q) {
    const int ih = q / nw, iw = q % nw;
    const int th = ih ? 2 : (pa ? 0 : 1), tw = iw ? 2 : (pb ? 0 : 1);
    load_matrix(Ws + q * CIN * G::LDB, G::LDB,
                w + (size_t)(th * 3 + tw) * CIN * COUT, CIN, COUT);
  }

  constexpr int VPT = CIN / 8;
  for (int v = threadIdx.x; v < G::BM * ntaps * VPT; v += blockDim.x) {
    const int r = v / (ntaps * VPT), q = (v / VPT) % ntaps, j = v % VPT;
    const int m = m0 + r;
    const int mh = q / nw, mw = q % nw;  // offsets equal the tap's ih, iw
    const int i = (m / W) % H, jj = m % W;
    const bool valid = m < M && i + mh < H && jj + mw < W;
    const long long pix = valid ? (long long)m + mh * W + mw : 0;
    cp_async16(As + r * G::LDA + q * CIN + j * 8, x + pix * CIN + j * 8,
               valid);
  }
  cp_async_wait_all();
  __syncthreads();

  switch (ntaps) {  // K = taps x CIN, fixed at compile time per plane
    case 1: block_gemm<16, COUT, G::LDA, COUT, CIN>(As, Ws, Cs); break;
    case 2: block_gemm<16, COUT, G::LDA, COUT, 2 * CIN>(As, Ws, Cs); break;
    default: block_gemm<16, COUT, G::LDA, COUT, 4 * CIN>(As, Ws, Cs);
  }

  constexpr int VPO = COUT / 8;
  for (int v = threadIdx.x; v < G::BM * VPO; v += blockDim.x) {
    const int r = v / VPO, j = v % VPO;
    const int m = m0 + r;
    if (m >= M) continue;
    const long long b = m / (H * W);
    const int i = (m / W) % H, jj = m % W;
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = fmaxf(Cs[r * G::LDC + j * 8 + k] + __ldg(bias + j * 8 + k), 0.0f);
    bf16* dst = out + ((b * 2 * H + 2 * i + pa) * 2 * W + 2 * jj + pb) * COUT +
                j * 8;
    *reinterpret_cast<uint4*>(dst) = pack_bf16x8(o);
  }
}

template <int CIN, int COUT>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using G = Cfg<CIN, COUT>;
  static bool smem_ok = false;
  cudaError_t e = allow_smem(ups_eval_kernel<CIN, COUT>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  const long long M = (long long)B * H * W;
  if (4 * M * (CIN > COUT ? CIN : COUT) >= (1LL << 31))
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + G::BM - 1) / G::BM), 4);
  ups_eval_kernel<CIN, COUT><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), (int)M, H, W);
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
