// DownsamplerBlock train path: forward with BN statistics, and backward.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/downsampler.py:
//   _down_fwd_kernel_st    (via downsampler_packed_stats),
//   _down_bwd_kernel       (its backward; the pool's VJP ran in XLA),
//   _down_fwd_kernel_staug (via downsampler_packed_stats_aug, the stem),
//   _down_bwd_kernel_nodx  (the stem's backward: no input gradient).
//
// Forward: y = cat[bf16(conv3x3 s2 p1 (x; Cin -> Cc) + b), maxpool2x2(x)]
// (bf16, NHWC, conv channels first), and per image the f32 sum and sum of
// squares of the stored y.  The stem mode reads the f32 flipped image,
// applies the per-image (tx, ty) translate with zero fill (out[h, w] =
// x[h - ty, w - tx]) and the cast to bf16 in its gather, and writes the
// translated bf16 image for the backward.
//
// Backward, from g = bf16(gy + gs1 + 2 y gs2) (the stats fold):
//   dW[kh, kw, ci, co] = sum_p x[2ho - 1 + kh, 2wo - 1 + kw, ci] g[p, co]
//   db[co] = sum_p g[p, co]                        (co < Cc, f32)
//   dx = bf16(bf16(conv_input_grad) + pool_grad)   (not in the stem mode)
// The pool gradient follows JAX's reduce-max VJP in the order the TPU path
// pools (the W pair, then the H pair): each max splits its cotangent
// equally among tied inputs, so a window of four equal values gives a
// quarter to each.
//
// Forward: an implicit GEMM over tiles of 64 output pixels of one image
// (K = 9 Cin padded to 16, N = Cc padded to 16), the 3x3 windows gathered
// into shared memory, mma.sync; the pool from the staged window; per-tile
// stat partials reduced in a fixed order by a second launch.  Input
// gradient: an implicit GEMM over tiles of 64 input pixels with K = 9 Cc
// (each tap's output pixel, zero where the stride skips it) and N = Cin.
// Weight gradient: per (chunk of output pixels, tap) partials with the
// pixels as the product's depth, reduced in a fixed order.
//
// Bound on this card: bytes (the products are small next to the maps they
// read).  This version gathers each input pixel up to four times through
// L2 and runs the transposed conv over all nine taps although the stride
// leaves 1, 2 or 4 of them for each input pixel.
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

template <int CIN, int CC>
struct Fwd {
  static constexpr int BM = 64, THREADS = 128;
  static constexpr int COUT = CIN + CC;
  static constexpr int K = 9 * CIN, KP = round16(K), NP = round16(CC);
  static constexpr int LDA = KP + 8, LDB = NP + 8, LDC = NP + 4;
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 2 + 127) / 128 * 128;
  static constexpr size_t c_bytes = ((size_t)BM * LDC * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + c_bytes + (size_t)KP * LDB * 2;
  static_assert(THREADS % COUT == 0, "a thread keeps one channel");
  static_assert((size_t)THREADS * 2 * 4 <= c_bytes, "reduction scratch");
};

// Stage the 3x3 windows of output pixels [m0, m_end) (row r, column
// tap * CIN + ci, tap = kh * 3 + kw), zero outside the map and in the K
// padding.  STEM: x is the f32 image, translated by (tx, ty) and rounded
// to bf16 on the way; else x is bf16.
template <int CIN, int CC, bool STEM>
__device__ __forceinline__ void gather_fwd(bf16* As, const void* xv,
                                           const int* shifts, long long m0,
                                           long long m_end, int Ho, int Wo) {
  using G = Fwd<CIN, CC>;
  const int H = 2 * Ho, W = 2 * Wo;
  if constexpr (!STEM && CIN % 8 == 0) {
    const bf16* x = static_cast<const bf16*>(xv);
    constexpr int VPT = CIN / 8;
    for (int v = threadIdx.x; v < G::BM * 9 * VPT; v += blockDim.x) {
      const int r = v / (9 * VPT), tap = (v / VPT) % 9, j = v % VPT;
      const long long m = m0 + r;
      const long long b = m / ((long long)Ho * Wo);
      const int rem = (int)(m % ((long long)Ho * Wo));
      const int hi = 2 * (rem / Wo) - 1 + tap / 3;
      const int wi = 2 * (rem % Wo) - 1 + tap % 3;
      const bool valid = m < m_end && hi >= 0 && hi < H && wi >= 0 && wi < W;
      const long long pix = valid ? (b * H + hi) * W + wi : 0;
      cp_async16(As + r * G::LDA + tap * CIN + j * 8, x + pix * CIN + j * 8,
                 valid);
    }
    cp_async_commit();
    cp_async_wait_all();
  } else {
    constexpr int PER = G::BM * G::KP / G::THREADS;
    static_assert(G::BM * G::KP % G::THREADS == 0, "tile / threads");
    bf16 val[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      const int r = e / G::KP, k = e % G::KP;
      const long long m = m0 + r;
      const int tap = k / CIN, ci = k % CIN;
      const long long b = m / ((long long)Ho * Wo);
      const int rem = (int)(m % ((long long)Ho * Wo));
      int hi = 2 * (rem / Wo) - 1 + tap / 3;
      int wi = 2 * (rem % Wo) - 1 + tap % 3;
      bool valid = m < m_end && k < G::K && hi >= 0 && hi < H && wi >= 0 &&
                   wi < W;
      val[i] = __float2bfloat16(0.0f);
      if constexpr (STEM) {
        if (valid) {
          hi -= __ldg(shifts + 2 * b + 1);
          wi -= __ldg(shifts + 2 * b);
          valid = hi >= 0 && hi < H && wi >= 0 && wi < W;
        }
        if (valid)
          val[i] = __float2bfloat16(__ldg(static_cast<const float*>(xv) +
                                          ((b * H + hi) * W + wi) * CIN + ci));
      } else {
        if (valid)
          val[i] = static_cast<const bf16*>(xv)[((b * H + hi) * W + wi) * CIN +
                                                ci];
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * G::THREADS;
      As[(e / G::KP) * G::LDA + e % G::KP] = val[i];
    }
  }
}

template <int CIN, int CC, bool STEM>
__global__ void __launch_bounds__(128)
down_fwd_kernel(const void* __restrict__ x, const int* __restrict__ shifts,
                const bf16* __restrict__ wmat, const float* __restrict__ bias,
                bf16* __restrict__ out, bf16* __restrict__ xa,
                float* __restrict__ part, int B, int Ho, int Wo) {
  using G = Fwd<CIN, CC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + G::a_bytes);
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::a_bytes + G::c_bytes);
  const int HWo = Ho * Wo, TPI = (HWo + G::BM - 1) / G::BM;
  const int tiles = B * TPI;
  const int c = threadIdx.x % G::COUT;  // this thread's output channel
  const float bc = c < CC ? __ldg(bias + c) : 0.0f;

  load_matrix(Ws, G::LDB, wmat, G::KP, G::NP);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / TPI, local = tile % TPI;
    const long long m0 = (long long)b * HWo + (long long)local * G::BM;
    const long long e_img = (long long)b * HWo + HWo;
    const long long m_end = m0 + G::BM < e_img ? m0 + G::BM : e_img;
    gather_fwd<CIN, CC, STEM>(As, x, shifts, m0, m_end, Ho, Wo);
    cp_async_wait_all();  // the weights, at the first tile
    __syncthreads();

    block_gemm<16, G::NP, G::LDA, G::NP, G::KP>(As, Ws, Cs);

    float s0 = 0.0f, s1 = 0.0f;
    for (int e = threadIdx.x; e < G::BM * G::COUT; e += blockDim.x) {
      const int r = e / G::COUT;
      const long long m = m0 + r;
      if (m >= m_end) break;
      float v;
      if (c < CC) {
        v = __bfloat162float(__float2bfloat16(Cs[r * G::LDC + c] + bc));
      } else {
        const bf16* a = As + r * G::LDA + (c - CC);
        v = fmaxf(fmaxf(__bfloat162float(a[4 * CIN]),
                        __bfloat162float(a[5 * CIN])),
                  fmaxf(__bfloat162float(a[7 * CIN]),
                        __bfloat162float(a[8 * CIN])));
      }
      out[m * G::COUT + c] = __float2bfloat16(v);
      s0 += v;
      s1 += __fmul_rn(v, v);
    }
    if constexpr (STEM) {
      // each input pixel lies in exactly one output pixel's 2x2 window
      // (taps 4, 5, 7, 8): that tile writes its translated value
      for (int e = threadIdx.x; e < G::BM * 4 * CIN; e += blockDim.x) {
        const int r = e / (4 * CIN), q = (e / CIN) % 4, ci = e % CIN;
        const long long m = m0 + r;
        if (m >= m_end) break;
        const int rem = (int)(m - (long long)b * HWo);
        const int h = 2 * (rem / Wo) + q / 2, w = 2 * (rem % Wo) + q % 2;
        const int tap = (1 + q / 2) * 3 + 1 + q % 2;
        xa[(((long long)b * 2 * Ho + h) * 2 * Wo + w) * CIN + ci] =
            As[r * G::LDA + tap * CIN + ci];
      }
    }
    __syncthreads();  // Cs and As read: Cs becomes the reduction scratch
    float* red = Cs;
    red[threadIdx.x] = s0;
    red[G::THREADS + threadIdx.x] = s1;
    __syncthreads();
    if (threadIdx.x < G::COUT) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int t = threadIdx.x; t < G::THREADS; t += G::COUT) {
        a0 += red[t];
        a1 += red[G::THREADS + t];
      }
      part[(long long)tile * 2 * G::COUT + threadIdx.x] = a0;
      part[(long long)tile * 2 * G::COUT + G::COUT + threadIdx.x] = a1;
    }
    __syncthreads();
  }
}

// Input gradient of the conv (K = 9 CC, N = CIN) plus the pool's.
template <int CIN, int CC>
struct Bwd {
  static constexpr int BM = 64, THREADS = 128;
  static constexpr int COUT = CIN + CC;
  static constexpr int K = 9 * CC, N = CIN;
  static constexpr int WCOLS = N == 16 ? 1 : 2, WN = N / WCOLS,
                       WM = BM * WCOLS / (THREADS / 32);
  static constexpr int LDA = K + 8, LDB = N + 8, LDC = N + 4;
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 2 + 127) / 128 * 128;
  static constexpr size_t c_bytes = ((size_t)BM * LDC * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + c_bytes + (size_t)K * LDB * 2;
  static_assert(CC % 8 == 0 && CIN % 16 == 0, "dx shapes");
};

template <int CIN, int CC>
__global__ void __launch_bounds__(128)
down_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
               const bf16* __restrict__ wt, bf16* __restrict__ dx, int B,
               int H, int W) {
  using G = Bwd<CIN, CC>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + G::a_bytes);
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::a_bytes + G::c_bytes);
  const int Ho = H / 2, Wo = W / 2;
  const long long M = (long long)B * H * W;
  const long long tiles = (M + G::BM - 1) / G::BM;
  constexpr int VPT = CC / 8;

  load_matrix(Ws, G::LDB, wt, G::K, G::N);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m0 = tile * G::BM;
    for (int v = threadIdx.x; v < G::BM * 9 * VPT; v += blockDim.x) {
      const int r = v / (9 * VPT), tap = (v / VPT) % 9, j = v % VPT;
      const long long m = m0 + r;
      const long long b = m / ((long long)H * W);
      const int rem = (int)(m % ((long long)H * W));
      const int hh = rem / W + 1 - tap / 3, ww = rem % W + 1 - tap % 3;
      const bool valid = m < M && hh >= 0 && ww >= 0 && hh % 2 == 0 &&
                         ww % 2 == 0 && hh / 2 < Ho && ww / 2 < Wo;
      const long long pix = valid ? (b * Ho + hh / 2) * Wo + ww / 2 : 0;
      cp_async16(As + r * G::LDA + tap * CC + j * 8,
                 g + pix * G::COUT + j * 8, valid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    block_gemm<G::WM, G::WN, G::LDA, G::N, G::K>(As, Ws, Cs);

    for (int e = threadIdx.x; e < G::BM * CIN; e += blockDim.x) {
      const int r = e / CIN, ci = e % CIN;
      const long long m = m0 + r;
      if (m >= M) break;
      const long long b = m / ((long long)H * W);
      const int rem = (int)(m % ((long long)H * W));
      const int h = rem / W, w = rem % W;
      const int ho = h / 2, wo = w / 2, pr = h % 2, pc = w % 2;
      const bf16* win = x + ((b * H + 2 * ho) * W + 2 * wo) * CIN + ci;
      float xv[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          xv[i][k] = __bfloat162float(win[((long long)i * W + k) * CIN]);
      const float m0v = fmaxf(xv[0][0], xv[0][1]);
      const float m1v = fmaxf(xv[1][0], xv[1][1]);
      const float mp = fmaxf(m0v, m1v);
      const float gp = __bfloat162float(
          g[((b * Ho + ho) * Wo + wo) * G::COUT + CC + ci]);
      const float mr = pr ? m1v : m0v;
      float share = 0.0f;
      if (mr == mp) {
        const float gr = gp / (float)((m0v == mp) + (m1v == mp));
        if (xv[pr][pc] == mr)
          share = gr / (float)((xv[pr][0] == mr) + (xv[pr][1] == mr));
      }
      const float conv = __bfloat162float(__float2bfloat16(Cs[r * G::LDC + ci]));
      dx[m * CIN + ci] = __float2bfloat16(conv + share);
    }
    __syncthreads();
  }
}

// Weight gradient: blockIdx.y = tap (kh * 3 + kw), blockIdx.x = a chunk of
// CHUNK output pixels.  part[chunk] = [dW (9, CIN, CC) | db (CC)], db from
// the tap-0 CTAs.
constexpr int CHUNK = 2048;

template <int CIN, int CC>
struct WgShape {
  static constexpr int MB = round16(CIN), NP = round16(CC);
  static constexpr int WM = 16, WN = MB == 64 ? 32 : NP;
  using Q = WgCfg<MB, NP, WM, WN>;
  static constexpr int PLEN = 9 * CIN * CC + CC;
};

template <int CIN, int CC>
__global__ void __launch_bounds__(256)
down_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ part, int B, int Ho, int Wo) {
  using S = WgShape<CIN, CC>;
  using Q = typename S::Q;
  constexpr int COUT = CIN + CC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + Q::a_bytes);
  const int tap = blockIdx.y, kh = tap / 3, kw = tap % 3;
  const int H = 2 * Ho, W = 2 * Wo;
  const long long P = (long long)B * Ho * Wo;
  const long long p_begin = (long long)blockIdx.x * CHUNK;
  const long long p_stop = p_begin + CHUNK < P ? p_begin + CHUNK : P;
  float dbs = 0.0f;

  float acc[Q::MT][Q::NT][4];
#pragma unroll
  for (int m = 0; m < Q::MT; ++m)
#pragma unroll
    for (int n = 0; n < Q::NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;

  for (long long p0 = p_begin; p0 < p_stop; p0 += Q::BP) {
    // A: the tap's input pixel of each output pixel; G: its conv gradient
    for (int e = threadIdx.x; e < Q::BP * S::MB; e += blockDim.x) {
      const int r = e / S::MB, k = e % S::MB;
      if (CIN % 8 == 0 && k % 8) continue;
      const long long p = p0 + r;
      const long long b = p / ((long long)Ho * Wo);
      const int rem = (int)(p % ((long long)Ho * Wo));
      const int hi = 2 * (rem / Wo) - 1 + kh, wi = 2 * (rem % Wo) - 1 + kw;
      const bool valid = p < p_stop && k < CIN && hi >= 0 && hi < H &&
                         wi >= 0 && wi < W;
      const long long src = ((b * H + hi) * W + wi) * CIN + k;
      if constexpr (CIN % 8 == 0) {
        cp_async16(As + r * Q::LDA + k, x + (valid ? src : 0), valid);
      } else {
        As[r * Q::LDA + k] = valid ? x[src] : __float2bfloat16(0.0f);
      }
    }
    for (int e = threadIdx.x; e < Q::BP * S::NP; e += blockDim.x) {
      const int r = e / S::NP, k = e % S::NP;
      if (CC % 8 == 0 && k % 8) continue;
      const long long p = p0 + r;
      const bool valid = p < p_stop && k < CC;
      if constexpr (CC % 8 == 0) {
        cp_async16(Gs + r * Q::LDG + k, g + (valid ? p * COUT + k : 0), valid);
      } else {
        Gs[r * Q::LDG + k] = valid ? g[p * COUT + k] : __float2bfloat16(0.0f);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (tap == 0 && threadIdx.x < CC)
      for (int r = 0; r < Q::BP; ++r)
        dbs += __bfloat162float(Gs[r * Q::LDG + threadIdx.x]);
    wgrad_step<S::MB, S::NP, S::WM, S::WN>(As, Gs, acc);
    __syncthreads();
  }
  float* dst = part + (long long)blockIdx.x * S::PLEN;
  if (tap == 0 && threadIdx.x < CC) dst[9 * CIN * CC + threadIdx.x] = dbs;
  wgrad_store<S::MB, S::NP, S::WM, S::WN>(
      acc, reinterpret_cast<float*>(smem), dst + tap * CIN * CC, CIN, CC);
}

// ------------------------------- launchers --------------------------------

template <class Kernel>
cudaError_t grid_for(Kernel k, int threads, size_t smem, bool* ok, int* gm) {
  cudaError_t e = allow_smem(k, smem, ok);
  if (e != cudaSuccess) return e;
  if (*gm == 0) return resident_ctas(k, threads, smem, gm);
  return cudaSuccess;
}

template <int CIN, int CC, bool STEM>
int fwd(const void* x, const void* shifts, const void* wmat, const void* bias,
        void* out, void* xa, void* part, void* stats, int B, int H, int W,
        cudaStream_t s) {
  using G = Fwd<CIN, CC>;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = grid_for(down_fwd_kernel<CIN, CC, STEM>, G::THREADS,
                           G::smem, &ok, &gm);
  if (e != cudaSuccess) return e;
  const int Ho = H / 2, Wo = W / 2;
  const int tpi = (Ho * Wo + G::BM - 1) / G::BM;
  const int tiles = B * tpi;
  down_fwd_kernel<CIN, CC, STEM>
      <<<tiles < gm ? tiles : gm, G::THREADS, G::smem, s>>>(
          x, static_cast<const int*>(shifts), static_cast<const bf16*>(wmat),
          static_cast<const float*>(bias), static_cast<bf16*>(out),
          static_cast<bf16*>(xa), static_cast<float*>(part), B, Ho, Wo);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * G::COUT, s);
}

template <int CIN, int CC, bool DX>
int bwd(const void* gy, const void* y, const void* gs1, const void* gs2,
        const void* x, const void* wt, void* g, void* dx, void* part,
        void* grads, int B, int H, int W, cudaStream_t s) {
  constexpr int COUT = CIN + CC;
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t e = adjust_grad(gy, y, gs1, gs2, g, B, Ho * Wo, COUT, s);
  if (e != cudaSuccess) return e;
  if constexpr (DX) {
    using G = Bwd<CIN, CC>;
    static bool ok = false;
    static int gm = 0;
    if ((e = grid_for(down_dx_kernel<CIN, CC>, G::THREADS, G::smem, &ok,
                      &gm)) != cudaSuccess)
      return e;
    const long long tiles = ((long long)B * H * W + G::BM - 1) / G::BM;
    down_dx_kernel<CIN, CC>
        <<<(unsigned)(tiles < gm ? tiles : gm), G::THREADS, G::smem, s>>>(
            static_cast<const bf16*>(g), static_cast<const bf16*>(x),
            static_cast<const bf16*>(wt), static_cast<bf16*>(dx), B, H, W);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  using S = WgShape<CIN, CC>;
  using Q = typename S::Q;
  static bool wg_ok = false;
  if ((e = allow_smem(down_wgrad_kernel<CIN, CC>, Q::smem, &wg_ok)) !=
      cudaSuccess)
    return e;
  const long long P = (long long)B * Ho * Wo;
  const int chunks = (int)((P + CHUNK - 1) / CHUNK);
  down_wgrad_kernel<CIN, CC><<<dim3(chunks, 9), Q::THREADS, Q::smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<float*>(part), B, Ho, Wo);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks, S::PLEN, s);
}

bool shape_ok(int B, int H, int W, int cin) {
  return B > 0 && H > 0 && W > 0 && H % 2 == 0 && W % 2 == 0 &&
         (long long)B * H * W * (cin > 64 ? cin : 64) < (1LL << 31);
}

}  // namespace

// ------------------------------ C interface -------------------------------
//
// (cin, cc) in {(3, 13) stem only, (16, 48), (64, 64)}.  x: (B, H, W, cin)
// f32 in the stem mode (the flipped image), else bf16; shifts: (B, 2) int32
// (tx, ty), stem mode only; wmat: (round16(9 cin), round16(cc)) bf16, row
// (kh * 3 + kw) cin + ci; bias: (cc,) f32; out: (B, H/2, W/2, cin + cc)
// bf16; xa: (B, H, W, 3) bf16, the translated image (stem mode); part:
// (B * ceil(H W / 256), 2 (cin + cc)) f32 scratch; stats: (B, 2 (cin +
// cc)) f32 = [sum y, sum y^2] per image.
extern "C" int erf_down_train_fwd(const void* x, const void* shifts,
                                  const void* wmat, const void* bias,
                                  void* out, void* xa, void* part,
                                  void* stats, int B, int H, int W, int cin,
                                  int cc, int stem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin)) return cudaErrorInvalidValue;
  if (stem && cin == 3 && cc == 13)
    return fwd<3, 13, true>(x, shifts, wmat, bias, out, xa, part, stats, B,
                            H, W, s);
  if (!stem && cin == 16 && cc == 48)
    return fwd<16, 48, false>(x, shifts, wmat, bias, out, xa, part, stats, B,
                              H, W, s);
  if (!stem && cin == 64 && cc == 64)
    return fwd<64, 64, false>(x, shifts, wmat, bias, out, xa, part, stats, B,
                              H, W, s);
  return cudaErrorInvalidValue;
}

// gy, y: (B, H/2, W/2, cin + cc) bf16; gs1, gs2: (B, cin + cc) f32; x:
// the forward's bf16 input (the translated image in the stem mode); wt:
// (9 cc, cin) bf16, row (kh * 3 + kw) cc + co, column ci (not read in the
// stem mode); g: (B, H/2, W/2, cin + cc) bf16 scratch; dx: (B, H, W, cin)
// bf16 (not written in the stem mode); part: (ceil(B H W / 8192),
// 9 cin cc + cc) f32 scratch; grads: (9 cin cc + cc) f32 = [dW in HWIO
// order, db].
extern "C" int erf_down_train_bwd(const void* gy, const void* y,
                                  const void* gs1, const void* gs2,
                                  const void* x, const void* wt, void* g,
                                  void* dx, void* part, void* grads, int B,
                                  int H, int W, int cin, int cc, int stem,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin)) return cudaErrorInvalidValue;
  if (stem && cin == 3 && cc == 13)
    return bwd<3, 13, false>(gy, y, gs1, gs2, x, wt, g, dx, part, grads, B,
                             H, W, s);
  if (!stem && cin == 16 && cc == 48)
    return bwd<16, 48, true>(gy, y, gs1, gs2, x, wt, g, dx, part, grads, B,
                             H, W, s);
  if (!stem && cin == 64 && cc == 64)
    return bwd<64, 64, true>(gy, y, gs1, gs2, x, wt, g, dx, part, grads, B,
                             H, W, s);
  return cudaErrorInvalidValue;
}
