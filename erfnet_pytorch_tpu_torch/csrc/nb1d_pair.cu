// non_bottleneck_1d train conv pair, forward and backward, with the
// per-image BatchNorm statistics of its output.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d_train.py:
//   fused_pair_stats        (_fwd_kernel_st / _bwd_kernel_st),
//   fused_pair_affine_stats (_fwd_kernel_affine_st / _bwd_kernel_affine_st),
//   fused_pair_epi_stats    (_fwd_kernel_epi_st / _bwd_kernel_epi_st).
// One pair is
//
//   t0 = lead(x)                          none:   x
//                                         affine: relu(x a + b)      (BN1)
//                                         epi:    relu((t a + b) m + y_res)
//   t1 = bf16(relu(conv_h(t0) + bh))      3 taps along H, dilation d
//   z  = bf16(conv_w(t1) + bw)            3 taps along W, dilation d
//   s1[b], s2[b] = sum, sum of squares of z over image b (after rounding)
//
// with the TPU kernels' rounding points: the lead stage in bf16 (a, b and
// the mask rounded to bf16 first), t1 rounded between the convs, f32
// accumulation.  The backward (cotangents gz, gs1, gs2) is
//
//   g    = bf16(gz + gs1 + 2 z gs2)                     (_adjust_g)
//   dt1  = conv_w^T(g);  dz1 = dt1 [t1 > 0]             f32
//   dbh  = sum dz1 (f32);  dz1 -> bf16;  dbw = sum g
//   dww[k] = shift_w(t1, k)^T g;  dwh[k] = shift_h(t0, k)^T dz1
//   dt0  = conv_h^T(dz1)                                f32
//   none:   dx = bf16(dt0)
//   affine: dpre = dt0 [t0 > 0]; da = sum dpre x; db = sum dpre;
//           dx = bf16(dpre a) with the f32 a
//   epi:    dsum = (dt0 + gy) [y_next > 0]; dy_res = bf16(dsum);
//           dpre = dsum m (f32 m); da = sum dpre t; db = sum dpre;
//           dt = bf16(dpre a)
//
// [t0 > 0] is [pre > 0] (t0 = relu(pre) in bf16), and [t1 > 0] is
// [z1 > 0] except for a positive z1 below bf16's least subnormal.
//
// Launches.  Forward: lead (affine and epi only; an elementwise pass that
// writes t0, in epi mode y_next, which the pair returns anyway), the H
// conv (t1), the W conv (z and per-tile stat partials), the reduction of
// the partials.  Backward: the g fold, the transposed W conv (dz1, bias
// partials), the transposed H conv (the lead's backward and its partials),
// the weight-gradient product (six (C x C) products as per-chunk
// partials), and two fixed-order reductions.  t0 and t1 are kept from the
// forward instead of recomputed: memory for one conv per backward.
//
// Each conv is an implicit GEMM over tiles of 64 consecutive pixels of
// one image x all C channels (K = 3C): the three tap rows of each pixel
// are gathered into shared memory with cp.async (zero fill off the map,
// which also covers d >= H or W), the (3C x C) tap stack sits beside
// them, eight warps (four at C = 16) multiply with ldmatrix + mma.sync.
// A persistent grid walks the tiles, staging the tap stack once per CTA.
// The transposed convs are the same kernel with the tap stack flipped and
// each tap transposed (the wrapper prepares it).
//
// Bound on this card: 6 C^2 MACs per pixel forward and 12 C^2 backward
// against 4 C to 10 C bytes per pixel read and written once, so
// operations at C = 128 and bytes at C = 64 and at C = 16 (the decoder's
// last run).
//
// This version moves t1, g and dz1 through device memory between launches
// and gathers every input pixel three times; one fused launch per pair
// with the intermediate kept on chip, and wgmma, are the next steps.
#include "common.cuh"

using namespace erfk;

namespace {

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// C = 16: four warps of 16 x 16 (N = 16 is two n8 tiles, K = 48 three k16
// steps); C = 64, 128: eight warps in two column bands.
template <int C>
struct Cfg {
  static constexpr int THREADS = C == 16 ? 128 : 256, BM = 64;
  static constexpr int NBUF = C == 64 ? 1 : 2;
  static constexpr int WCOLS = C == 16 ? 1 : 2;
  static constexpr int WN = C / WCOLS, WM = BM * WCOLS / (THREADS / 32);
  static constexpr int K = 3 * C, LDA = K + 8, LDB = C + 8, LDC = C + 4;
  static constexpr int VPT = C / 8, RSTEP = THREADS / VPT, PER = BM / RSTEP;
  // one buffer holds the gathered A tile, then the f32 product, then the
  // per-thread statistic sums of the tile
  static constexpr size_t a_raw =
      cmax(cmax((size_t)BM * LDA * 2, (size_t)BM * LDC * 4),
           (size_t)RSTEP * 2 * C * 4);
  static constexpr size_t a_bytes = (a_raw + 127) / 128 * 128;
  static constexpr size_t smem = NBUF * a_bytes + (size_t)K * LDB * 2;
};

// tile -> pixels [m0, m_end) of image b: tiles never straddle two images,
// so a tile's partial sums belong to one image.
struct TileMap {
  int HW, TPI;
  __device__ __forceinline__ void at(int tile, int bm, int& b, long long& m0,
                                     long long& m_end) const {
    b = tile / TPI;
    const int local = tile % TPI;
    m0 = (long long)b * HW + (long long)local * bm;
    const long long e = (long long)b * HW + HW;
    m_end = m0 + bm < e ? m0 + bm : e;
  }
};

// Start copying the A tile of pixels [m0, m_end): row r holds the three
// taps of pixel m0 + r, zero where a tap leaves the map or r is past the
// tile.
template <int C>
__device__ __forceinline__ void gather(unsigned char* buf, const bf16* src,
                                       long long m0, long long m_end, int H,
                                       int W, int axis, int dil) {
  using G = Cfg<C>;
  constexpr int VPT = C / 8;
  bf16* As = reinterpret_cast<bf16*>(buf);
  const int step = axis == 0 ? W : 1;
  const int lim = axis == 0 ? H : W;
  for (int v = threadIdx.x; v < G::BM * 3 * VPT; v += blockDim.x) {
    const int r = v / (3 * VPT), t = (v / VPT) % 3, j = v % VPT;
    const long long m = m0 + r;
    const int off = (t - 1) * dil;
    const int pos = axis == 0 ? (int)((m / W) % H) : (int)(m % W);
    const bool valid = m < m_end && pos + off >= 0 && pos + off < lim;
    const long long pix = valid ? m + (long long)off * step : 0;
    cp_async16(As + r * G::LDA + t * C + j * 8, src + pix * C + j * 8, valid);
  }
  cp_async_commit();
}

// One conv over all tiles of this CTA's share: acc = sum_t shift(src, t)
// @ w[t]; then epi(m, b, c0, acc, s0, s1) for each pixel m of the tile and
// 8 channels c0.. of it.  With Epi::SUMS the per-thread sums s0, s1 are
// added over the tile in a fixed order and stored as part[tile][2C].
template <int C, class Epi>
__device__ void conv_tiles(unsigned char* smem, const bf16* src,
                           const bf16* w, int B, int H, int W, int axis,
                           int dil, const Epi& epi, float* part) {
  using G = Cfg<C>;
  constexpr int VPT = G::VPT, RSTEP = G::RSTEP, PER = G::PER;
  const TileMap tm{H * W, (H * W + G::BM - 1) / G::BM};
  const int tiles = B * tm.TPI;
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::NBUF * G::a_bytes);
  const int j = threadIdx.x % VPT, r0 = threadIdx.x / VPT;

  load_matrix(Ws, G::LDB, w, G::K, C);
  int tile = blockIdx.x;
  {
    int b;
    long long m0, me;
    tm.at(tile, G::BM, b, m0, me);
    if (tile < tiles) gather<C>(smem, src, m0, me, H, W, axis, dil);
    else cp_async_commit();
  }
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + (int)gridDim.x;
    unsigned char* cur = smem + (it % G::NBUF) * G::a_bytes;
    if constexpr (G::NBUF == 2) {
      if (next < tiles) {
        int b;
        long long m0, me;
        tm.at(next, G::BM, b, m0, me);
        gather<C>(smem + ((it + 1) % 2) * G::a_bytes, src, m0, me, H, W, axis,
                  dil);
      } else {
        cp_async_commit();
      }
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();

    int b;
    long long m0, m_end;
    tm.at(tile, G::BM, b, m0, m_end);
    float* Cs = reinterpret_cast<float*>(cur);
    block_gemm<G::WM, G::WN, G::LDA, C, G::K>(
        reinterpret_cast<const bf16*>(cur), Ws, Cs);
    float s0[8], s1[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s0[k] = s1[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = r0 + i * RSTEP;
      const long long m = m0 + r;
      if (m >= m_end) break;  // rows grow with i
      const float4* c = reinterpret_cast<const float4*>(Cs + r * G::LDC + j * 8);
      const float4 c0 = c[0], c1 = c[1];
      float acc[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      epi(m, b, j * 8, acc, s0, s1);
    }
    if constexpr (Epi::SUMS) {
      __syncthreads();  // every read of Cs is done: reuse it as scratch
      float* red = Cs;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        red[r0 * 2 * C + j * 8 + k] = s0[k];
        red[r0 * 2 * C + C + j * 8 + k] = s1[k];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
        float s = 0.0f;
        for (int q = 0; q < RSTEP; ++q) s += red[q * 2 * C + c];
        part[(long long)tile * 2 * C + c] = s;
      }
    }
    __syncthreads();  // this buffer is read before a gather refills it
    if constexpr (G::NBUF == 1) {
      if (next < tiles) {
        int nb;
        long long n0, ne;
        tm.at(next, G::BM, nb, n0, ne);
        gather<C>(smem, src, n0, ne, H, W, axis, dil);
      }
    }
  }
  cp_async_wait_all();
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  unpack_bf16x8(__ldcg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// t1 = bf16(relu(acc + bh))
template <int C>
struct EpiReluBias {
  static constexpr bool SUMS = false;
  const float* bias;
  bf16* out;
  __device__ void operator()(long long m, int, int c0, float (&v)[8],
                             float (&)[8], float (&)[8]) const {
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = fmaxf(v[k] + __ldg(bias + c0 + k), 0.0f);
    store8(out + m * C + c0, o);
  }
};

// z = bf16(acc + bw); s0 += z, s1 += z^2 (of the rounded z)
template <int C>
struct EpiStats {
  static constexpr bool SUMS = true;
  const float* bias;
  bf16* out;
  __device__ void operator()(long long m, int, int c0, float (&v)[8],
                             float (&s0)[8], float (&s1)[8]) const {
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = round_bf16(v[k] + __ldg(bias + c0 + k));
    store8(out + m * C + c0, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s0[k] += o[k];
      s1[k] += __fmul_rn(o[k], o[k]);
    }
  }
};

// dz1 = acc [t1 > 0] -> bf16; s0 += dz1 (f32, before rounding), s1 += g
template <int C>
struct EpiDz1 {
  static constexpr bool SUMS = true;
  const bf16* t1;
  const bf16* g;
  bf16* out;
  __device__ void operator()(long long m, int, int c0, float (&v)[8],
                             float (&s0)[8], float (&s1)[8]) const {
    float tv[8], gv[8];
    load8(t1 + m * C + c0, tv);
    load8(g + m * C + c0, gv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = tv[k] > 0.0f ? v[k] : 0.0f;
      s0[k] += v[k];
      s1[k] += gv[k];
    }
    store8(out + m * C + c0, v);
  }
};

enum Lead { NONE = 0, AFFINE = 1, EPI = 2 };

// the lead stage's backward from dt0 = acc (see the file comment)
template <int C, int MODE>
struct EpiLeadBwd {
  static constexpr bool SUMS = MODE != NONE;
  const bf16* x;      // affine: x; epi: t
  const bf16* mask;   // affine: t0; epi: y_next
  const bf16* gy;     // epi
  const float* drop;  // epi: (B, C) f32
  const float* a;     // f32 (C,)
  bf16* out;          // dx (none, affine) or dt (epi)
  bf16* out2;         // epi: dy_res
  __device__ void operator()(long long m, int b, int c0, float (&v)[8],
                             float (&s0)[8], float (&s1)[8]) const {
    if constexpr (MODE == NONE) {
      store8(out + m * C + c0, v);
    } else {
      float xv[8], mv[8], o[8];
      load8(x + m * C + c0, xv);
      load8(mask + m * C + c0, mv);
      if constexpr (MODE == EPI) {
        float gv[8];
        load8(gy + m * C + c0, gv);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = mv[k] > 0.0f ? v[k] + gv[k] : 0.0f;
        store8(out2 + m * C + c0, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = v[k] * __ldg(drop + b * C + c0 + k);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = mv[k] > 0.0f ? v[k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        o[k] = v[k] * __ldg(a + c0 + k);
        s0[k] += __fmul_rn(v[k], xv[k]);
        s1[k] += v[k];
      }
      store8(out + m * C + c0, o);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(256)
fwd_h_kernel(const bf16* t0, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* t1, int B, int H, int W,
             int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, t0, w, B, H, W, 0, dil, EpiReluBias<C>{bias, t1},
                nullptr);
}

template <int C>
__global__ void __launch_bounds__(256)
fwd_w_kernel(const bf16* t1, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* z, float* part, int B,
             int H, int W, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, t1, w, B, H, W, 1, dil, EpiStats<C>{bias, z}, part);
}

template <int C>
__global__ void __launch_bounds__(256)
bwd_w_kernel(const bf16* g, const bf16* __restrict__ wt, const bf16* t1,
             bf16* dz1, float* part, int B, int H, int W, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, g, wt, B, H, W, 1, dil, EpiDz1<C>{t1, g, dz1}, part);
}

template <int C, int MODE>
__global__ void __launch_bounds__(256)
bwd_h_kernel(const bf16* dz1, const bf16* __restrict__ wt, const bf16* x,
             const bf16* mask, const bf16* gy, const float* drop,
             const float* a, bf16* out, bf16* out2, float* part, int B, int H,
             int W, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, dz1, wt, B, H, W, 0, dil,
                EpiLeadBwd<C, MODE>{x, mask, gy, drop, a, out, out2}, part);
}

// t0 = relu(bf16(bf16(x a) + b)), a and b rounded to bf16 first
__global__ void __launch_bounds__(256)
lead_affine_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ b, bf16* __restrict__ t0,
                   long long n8, int C) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n8) return;
  const int c0 = (int)(v % (C / 8)) * 8;
  float xv[8], o[8];
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(x) + v), xv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float p = round_bf16(__fmul_rn(xv[k], round_bf16(__ldg(a + c0 + k))));
    o[k] = fmaxf(round_bf16(__fadd_rn(p, round_bf16(__ldg(b + c0 + k)))), 0.0f);
  }
  reinterpret_cast<uint4*>(t0)[v] = pack_bf16x8(o);
}

// y_next = relu(bf16(bf16(bf16(bf16(t a) + b) m) + y_res)), a, b and the
// (B, C) f32 mask m rounded to bf16 first
__global__ void __launch_bounds__(256)
lead_epi_kernel(const bf16* __restrict__ t, const bf16* __restrict__ yres,
                const float* __restrict__ drop, const float* __restrict__ a,
                const float* __restrict__ b, bf16* __restrict__ ynext,
                long long n8, int HW, int C) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n8) return;
  const int c0 = (int)(v % (C / 8)) * 8;
  const int img = (int)(v / ((long long)HW * (C / 8)));
  float tv[8], yv[8], o[8];
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(t) + v), tv);
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(yres) + v), yv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float p = round_bf16(__fmul_rn(tv[k], round_bf16(__ldg(a + c0 + k))));
    p = round_bf16(__fadd_rn(p, round_bf16(__ldg(b + c0 + k))));
    p = round_bf16(__fmul_rn(p, round_bf16(__ldg(drop + img * C + c0 + k))));
    o[k] = fmaxf(round_bf16(__fadd_rn(p, yv[k])), 0.0f);
  }
  reinterpret_cast<uint4*>(ynext)[v] = pack_bf16x8(o);
}

// Weight gradients: blockIdx.y = 0..2: dwh[k] = shift_h(t0, k)^T dz1;
// 3..5: dww[k] = shift_w(t1, k)^T g.  blockIdx.x = a chunk of CHUNK
// pixels; its (C x C) partial goes to part[chunk][y].
constexpr int CHUNK = 2048;

template <int C>
struct WgPick;
template <>
struct WgPick<16> {
  using Q = WgCfg<16, 16, 16, 16>;
  static constexpr int WM = 16, WN = 16;
};
template <>
struct WgPick<64> {
  using Q = WgCfg<64, 64, 16, 32>;
  static constexpr int WM = 16, WN = 32;
};
template <>
struct WgPick<128> {
  using Q = WgCfg<128, 128, 32, 64>;
  static constexpr int WM = 32, WN = 64;
};

template <int C>
__global__ void __launch_bounds__(256)
wgrad_kernel(const bf16* __restrict__ t0, const bf16* __restrict__ dz1,
             const bf16* __restrict__ t1, const bf16* __restrict__ g,
             float* __restrict__ part, int B, int H, int W, int dil) {
  using P = WgPick<C>;
  using Q = typename P::Q;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + Q::a_bytes);
  const int y = blockIdx.y;
  const int axis = y < 3 ? 0 : 1, tap = y % 3;
  const bf16* A = y < 3 ? t0 : t1;
  const bf16* Gm = y < 3 ? dz1 : g;
  const int off = (tap - 1) * dil;
  const int step = axis == 0 ? W : 1, lim = axis == 0 ? H : W;
  const long long P_ = (long long)B * H * W;
  const long long p_begin = (long long)blockIdx.x * CHUNK;
  const long long p_stop = p_begin + CHUNK < P_ ? p_begin + CHUNK : P_;
  constexpr int VPT = C / 8;

  float acc[Q::MT][Q::NT][4];
#pragma unroll
  for (int m = 0; m < Q::MT; ++m)
#pragma unroll
    for (int n = 0; n < Q::NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;

  for (long long p0 = p_begin; p0 < p_stop; p0 += Q::BP) {
    for (int v = threadIdx.x; v < Q::BP * VPT; v += blockDim.x) {
      const int r = v / VPT, jv = v % VPT;
      const long long p = p0 + r;
      const bool in = p < p_stop;
      const int pos = axis == 0 ? (int)((p / W) % H) : (int)(p % W);
      const bool valid = in && pos + off >= 0 && pos + off < lim;
      const long long src = valid ? p + (long long)off * step : 0;
      cp_async16(As + r * Q::LDA + jv * 8, A + src * C + jv * 8, valid);
      cp_async16(Gs + r * Q::LDG + jv * 8, Gm + (in ? p : 0) * C + jv * 8, in);
    }
    cp_async_wait_all();
    __syncthreads();
    wgrad_step<C, C, P::WM, P::WN>(As, Gs, acc);
    __syncthreads();
  }
  float* dst = part + ((long long)blockIdx.x * 6 + y) * C * C;
  wgrad_store<C, C, P::WM, P::WN>(acc, reinterpret_cast<float*>(smem), dst, C,
                                  C);
}

// ------------------------------- launchers --------------------------------

template <int C, class Kernel>
cudaError_t prep(Kernel k, bool* smem_ok, int* grid_max) {
  using G = Cfg<C>;
  cudaError_t e = allow_smem(k, G::smem, smem_ok);
  if (e != cudaSuccess) return e;
  if (*grid_max == 0) return resident_ctas(k, G::THREADS, G::smem, grid_max);
  return cudaSuccess;
}

template <int C>
int conv_grid(int B, int H, int W, int grid_max) {
  const int tiles = B * ((H * W + Cfg<C>::BM - 1) / Cfg<C>::BM);
  return tiles < grid_max ? tiles : grid_max;
}

template <int C>
int fwd(const void* t0, const void* wh, const void* bh, const void* ww,
        const void* bw, void* t1, void* z, void* part, void* stats, int B,
        int H, int W, int dil, cudaStream_t s) {
  using G = Cfg<C>;
  static bool ok_h = false, ok_w = false;
  static int gm_h = 0, gm_w = 0;
  cudaError_t e = prep<C>(fwd_h_kernel<C>, &ok_h, &gm_h);
  if (e == cudaSuccess) e = prep<C>(fwd_w_kernel<C>, &ok_w, &gm_w);
  if (e != cudaSuccess) return e;
  fwd_h_kernel<C><<<conv_grid<C>(B, H, W, gm_h), G::THREADS, G::smem, s>>>(
      static_cast<const bf16*>(t0), static_cast<const bf16*>(wh),
      static_cast<const float*>(bh), static_cast<bf16*>(t1), B, H, W, dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  fwd_w_kernel<C><<<conv_grid<C>(B, H, W, gm_w), G::THREADS, G::smem, s>>>(
      static_cast<const bf16*>(t1), static_cast<const bf16*>(ww),
      static_cast<const float*>(bw), static_cast<bf16*>(z),
      static_cast<float*>(part), B, H, W, dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int tpi = (H * W + G::BM - 1) / G::BM;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * C, s);
}

template <int C, int MODE>
int bwd_h(const void* dz1, const void* wht, const void* x, const void* mask,
          const void* gy, const void* drop, const void* a, void* out,
          void* out2, float* part, int B, int H, int W, int dil,
          cudaStream_t s) {
  using G = Cfg<C>;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = prep<C>(bwd_h_kernel<C, MODE>, &ok, &gm);
  if (e != cudaSuccess) return e;
  bwd_h_kernel<C, MODE><<<conv_grid<C>(B, H, W, gm), G::THREADS, G::smem, s>>>(
      static_cast<const bf16*>(dz1), static_cast<const bf16*>(wht),
      static_cast<const bf16*>(x), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(gy), static_cast<const float*>(drop),
      static_cast<const float*>(a), static_cast<bf16*>(out),
      static_cast<bf16*>(out2), part, B, H, W, dil);
  return cudaGetLastError();
}

template <int C>
int bwd(int mode, const void* gz, const void* z, const void* gs1,
        const void* gs2, const void* t0, const void* t1, const void* wht,
        const void* wwt, const void* x, const void* mask, const void* gy,
        const void* drop, const void* a, void* g, void* dz1, void* out,
        void* out2, void* part_b, void* part_w, void* grads, int B, int H,
        int W, int dil, cudaStream_t s) {
  using G = Cfg<C>;
  static bool ok_w = false;
  static int gm_w = 0;
  static bool wg_ok = false;
  const long long P = (long long)B * H * W;
  const int tiles = B * ((H * W + G::BM - 1) / G::BM);
  float* pb = static_cast<float*>(part_b);
  cudaError_t e = adjust_grad(gz, z, gs1, gs2, g, B, H * W, C, s);
  if (e != cudaSuccess) return e;
  if ((e = prep<C>(bwd_w_kernel<C>, &ok_w, &gm_w)) != cudaSuccess) return e;
  // bias partials: part_b holds two (tiles, 2C) halves, [dbh, dbw] per
  // tile from bwd_w and [da, db] per tile from bwd_h
  bwd_w_kernel<C><<<conv_grid<C>(B, H, W, gm_w), G::THREADS, G::smem, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(wwt),
      static_cast<const bf16*>(t1), static_cast<bf16*>(dz1), pb, B, H, W,
      dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* ph = pb + (long long)tiles * 2 * C;
  switch (mode) {
    case NONE:
      e = (cudaError_t)bwd_h<C, NONE>(dz1, wht, x, mask, gy, drop, a, out,
                                      out2, ph, B, H, W, dil, s);
      break;
    case AFFINE:
      e = (cudaError_t)bwd_h<C, AFFINE>(dz1, wht, x, mask, gy, drop, a, out,
                                        out2, ph, B, H, W, dil, s);
      break;
    case EPI:
      e = (cudaError_t)bwd_h<C, EPI>(dz1, wht, x, mask, gy, drop, a, out,
                                     out2, ph, B, H, W, dil, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  using Q = typename WgPick<C>::Q;
  if (!wg_ok && Q::smem > 48 * 1024) {
    e = cudaFuncSetAttribute(wgrad_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Q::smem);
    if (e != cudaSuccess) return e;
  }
  wg_ok = true;
  const int chunks = (int)((P + CHUNK - 1) / CHUNK);
  wgrad_kernel<C><<<dim3(chunks, 6), Q::THREADS, Q::smem, s>>>(
      static_cast<const bf16*>(t0), static_cast<const bf16*>(dz1),
      static_cast<const bf16*>(t1), static_cast<const bf16*>(g),
      static_cast<float*>(part_w), B, H, W, dil);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // grads = [dwh (3CC), dww (3CC) | dbh, dbw | da, db]
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        6 * C * C, s)) != cudaSuccess)
    return e;
  if ((e = reduce_parts(pb, gr + 6 * C * C, 1, tiles, 2 * C, s)) !=
      cudaSuccess)
    return e;
  if (mode != NONE)
    e = reduce_parts(ph, gr + 6 * C * C + 2 * C, 1, tiles, 2 * C, s);
  return e;
}

bool shape_ok(int B, int H, int W, int C) {
  return (C == 16 || C == 64 || C == 128) && B > 0 && H > 0 && W > 0 &&
         (long long)B * H * W * C < (1LL << 31);
}

}  // namespace

// ------------------------------ C interface -------------------------------
//
// Maps are (B, H, W, C) bf16, NHWC, C in {16, 64, 128}; tap stacks (3, C, C)
// bf16 [tap, cin, cout]; biases, a, b (C,) f32; the dropout mask (B, C)
// f32.  Scratch (from the wrapper): part (B * tiles_per_image, 2C) f32 in
// the forward, part_b (tiles, 4C) and part_w (chunks, 6, C, C) f32 in the
// backward, with tiles_per_image = ceil(H W / 64) and chunks =
// ceil(B H W / 2048).  Each entry point returns the first CUDA error.

// t0 = lead(x): mode 1 affine (x, a, b), 2 epi (x = t, yres, drop, a, b).
// Pointers first, then ints, then the stream, in every entry point.
extern "C" int erf_pair_lead(const void* x, const void* yres,
                             const void* drop, const void* a, const void* b,
                             void* t0, int mode, int B, int H, int W, int C,
                             void* stream) {
  if (!shape_ok(B, H, W, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n8 = (long long)B * H * W * C / 8;
  const unsigned grid = (unsigned)((n8 + 255) / 256);
  if (mode == AFFINE)
    lead_affine_kernel<<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<bf16*>(t0), n8, C);
  else if (mode == EPI)
    lead_epi_kernel<<<grid, 256, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(yres),
        static_cast<const float*>(drop), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<bf16*>(t0), n8, H * W, C);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// t1 = bf16(relu(conv_h(t0) + bh)); z = bf16(conv_w(t1) + bw);
// stats (B, 2C) = [sum z, sum z^2] per image
extern "C" int erf_pair_fwd(const void* t0, const void* wh, const void* bh,
                            const void* ww, const void* bw, void* t1,
                            void* z, void* part, void* stats, int B, int H,
                            int W, int C, int dil, void* stream) {
  if (!shape_ok(B, H, W, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return fwd<16>(t0, wh, bh, ww, bw, t1, z, part, stats, B, H, W, dil, s);
  if (C == 64)
    return fwd<64>(t0, wh, bh, ww, bw, t1, z, part, stats, B, H, W, dil, s);
  return fwd<128>(t0, wh, bh, ww, bw, t1, z, part, stats, B, H, W, dil, s);
}

// The backward.  wht, wwt: the tap stacks flipped and transposed
// (w[2 - k]^T).  mode 0: out = dx; 1: x, mask = t0, out = dx; 2: x = t,
// mask = y_next, gy, drop, out = dt, out2 = dy_res.  g, dz1: (B, H, W, C)
// bf16 scratch (g is the adjusted gradient).  grads (6CC + 4C) f32 =
// [dwh, dww, dbh, dbw, da, db] (da, db left as they are in mode 0).
extern "C" int erf_pair_bwd(const void* gz, const void* z, const void* gs1,
                            const void* gs2, const void* t0, const void* t1,
                            const void* wht, const void* wwt, const void* x,
                            const void* mask, const void* gy,
                            const void* drop, const void* a, void* g,
                            void* dz1, void* out, void* out2, void* part_b,
                            void* part_w, void* grads, int mode, int B,
                            int H, int W, int C, int dil, void* stream) {
  if (!shape_ok(B, H, W, C)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return bwd<16>(mode, gz, z, gs1, gs2, t0, t1, wht, wwt, x, mask, gy,
                   drop, a, g, dz1, out, out2, part_b, part_w, grads, B, H,
                   W, dil, s);
  if (C == 64)
    return bwd<64>(mode, gz, z, gs1, gs2, t0, t1, wht, wwt, x, mask, gy,
                   drop, a, g, dz1, out, out2, part_b, part_w, grads, B, H,
                   W, dil, s);
  return bwd<128>(mode, gz, z, gs1, gs2, t0, t1, wht, wwt, x, mask, gy, drop,
                  a, g, dz1, out, out2, part_b, part_w, grads, B, H, W, dil,
                  s);
}
