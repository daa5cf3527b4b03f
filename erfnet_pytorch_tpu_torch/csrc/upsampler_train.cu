// Train UpsamplerBlock conv, ConvTranspose2d(Cin, Cout, 3, s2, p1, op1)
// plus bias, with the per-image BatchNorm sums of its output, forward and
// backward.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/upsampler.py:upsampler_packed_stats
// (_ups_fwd_kernel_st via the pallas_call of _call_fwd_st, and
// _ups_bwd_kernel_st / _ups_bwd_math via _call_bwd_st), without the TPU's
// W-packing (a lane-filling layout).  As a parity-plane product, input
// pixel p = (i, j) writes output pixels (2i + a, 2j + b):
//
//   y4[p] = sum_q x[p + e_q] @ Wcat[q]       q: e_q = (0,0) (1,0) (0,1) (1,1)
//   y[2i + a, 2j + b] = bf16(y4[p][plane a*2+b] + bias)   (zero fill past
//                                                          the bottom/right)
//   s1[b], s2[b] = sum, sum of squares of the stored y over image b
//
// Wcat (4 Cin x 4 Cout) is ops/convt_mm.py:build_upsampler_matmul's, its
// taps rounded to bf16; seven of its sixteen (Cin x Cout) blocks are zero.
// The backward, from (gy, gs1, gs2):
//
//   g  = bf16(gy + gs1[b] + 2 y gs2[b])                  (adjust_grad)
//   dx[p] = bf16(sum_q g4[p - e_q] @ Wcat[q]^T)          f32 sums
//   dW[tap] = sum_p x[p + e_q]^T g_plane[p]              f32, per tap
//   db = sum g                                           f32
//
// Launches.  Forward: the product with its epilogue (bias, bf16 store,
// per-tile statistic partials) and the fixed-order reduction of the
// partials.  Backward: the g fold, the dx product, the weight-gradient
// product (one (Cin x Cout) block per tap, the nine non-zero blocks of
// Wcat, per-chunk partials; the four blocks of offset (0, 0) also sum
// db), and two fixed-order reductions.
//
// Forward (bf16): the parity-plane product of parity_plane.cuh, which
// reads the nine non-zero blocks straight from the (3, 3, Cin, Cout) tap
// stack (no Wcat is built): per tile of 4 x 32 input pixels the A patch
// with its halo is gathered once
// for all four planes, the weight blocks stream through a cp.async ring,
// persistent CTAs, whole output rows 16 bytes a thread; the statistic
// partials per tile, over a warp's lanes by a fixed xor tree, then over
// the warps in order.
//
// dx: a tiled GEMM over 64 input pixels of one image by 64 output
// columns: the K extent (16 Cout) is staged 64 at a time, A gathered from
// the four neighbours with cp.async and zero fill, B copied from the bf16
// weight matrix, double-buffered, and multiplied by four warps with
// ldmatrix + mma.sync m16n8k16 into f32 registers, through the zero
// blocks too.
//
// Bound on this card: bytes (9 Cin Cout MACs per input pixel forward
// against 2 Cin + 8 Cout bytes read and written: 72 operations per byte
// at 64 -> 16 and 192 at 128 -> 64, under the card's 295).  What is left
// in the forward: each tile reads its 9 Cin Cout weights from L2 (1.2 KB
// a pixel at 128 -> 64), one CTA an SM there (165 KB of shared memory),
// mma.sync and not wgmma.  The backward is as it was: dx is the
// downsampler forward's product (a stride-2 conv of g), next to port.
//
// The f32 forms (erf_ups_train_*_f32, the JAX package's default compute
// dtype): the same launches and the same function with x, y, g, dx and
// Wcat in f32 and nothing rounded to bf16 (Wcat's taps unrounded).  Both
// products are tiled GEMMs as dx's above (64 pixels x 64 columns, K staged
// 64 at a time, the forward skipping zero weight blocks) on the CUDA
// cores (FFMA micro-tiles of 4 pixels x 8 columns a thread, common.cuh
// ffma_tile; no TF32): the forward's K in one FFMA chain per output (as
// the plain version's single matmul sums it), the dx product's 16 Cout
// in a chain per 64-wide chunk, the chunks added in order (shorter
// chains; measured 0.4 of the single chain's error, PERF.md §6); the
// weight gradient is one (Cin x Cout) product per (chunk, tap) with the
// pixels as its depth (common.cuh ffma_outer).
// Bound at f32: operations (9 Cin Cout MACs per input pixel forward, twice
// that backward, against 67 TFLOP/s).
//
// The stats-free forms (with_stats = 0) replace upsampler_packed
// (_ups_fwd_kernel via _call_fwd_local, _ups_bwd_kernel via
// _call_bwd_local): the forward's epilogue writes y without the
// statistic partials and their reduction is skipped; the backward starts
// from g = gy (no g fold, y not read).
#include "parity_plane.cuh"

using namespace erfk;

namespace {

constexpr int THREADS = 128, BM = 64, BN = 64, KC = 64;
constexpr int LDA = KC + 8, LDB = BN + 8, LDC = BN + 4;
constexpr int WM = 32, WN = 32, MT = WM / 16, NT = WN / 8;
constexpr size_t A_BYTES = (size_t)BM * LDA * 2;
constexpr size_t B_BYTES = (size_t)KC * LDB * 2;
constexpr size_t STAGE = (A_BYTES + B_BYTES + 127) / 128 * 128;
constexpr size_t SMEM = 2 * STAGE;
constexpr int RSTEP = THREADS / (BN / 8), PER = BM / RSTEP;
static_assert((size_t)BM * LDC * 4 <= SMEM, "product staging");
static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "warp grid");

// neighbour q of Wcat's row blocks [x, x_h, x_w, x_hw]
__device__ __forceinline__ int dh_of(int q) { return q & 1; }
__device__ __forceinline__ int dw_of(int q) { return q >> 1; }

// Start copying B rows [k0, k0 + KC) x columns [n0, n0 + BN) of the
// row-major (K x N) bf16 matrix w.
__device__ __forceinline__ void load_b(bf16* Bs, const bf16* w, int N, int k0,
                                       int n0) {
  for (int v = threadIdx.x; v < KC * BN / 8; v += THREADS) {
    const int r = v / (BN / 8), j = v % (BN / 8);
    cp_async16(Bs + r * LDB + j * 8, w + (long long)(k0 + r) * N + n0 + j * 8,
               true);
  }
}

// dx A chunk: columns [k0, k0 + KC) of the (BM x 16 Cout) gather of the
// adjusted gradient: column k is channel c of plane pl = a*2+b of the
// output block of input pixel p - e_q, with q = k / (4 Cout), zero before
// the map's top and left edges.
__device__ __forceinline__ void load_a_dx(bf16* As, const bf16* g, int Cout,
                                          int H, int W, int b, int p0,
                                          int p_end, int k0) {
  for (int v = threadIdx.x; v < BM * KC / 8; v += THREADS) {
    const int r = v / (KC / 8), j = v % (KC / 8);
    const int k = k0 + j * 8, q = k / (4 * Cout), w4 = k % (4 * Cout);
    const int pl = w4 / Cout, c = w4 % Cout;
    const int p = p0 + r, i = p / W - dh_of(q), jj = p % W - dw_of(q);
    const bool valid = p < p_end && i >= 0 && jj >= 0;
    const long long src =
        valid ? (((long long)b * 2 * H + 2 * i + (pl >> 1)) * 2 * W + 2 * jj +
                 (pl & 1)) * Cout + c
              : 0;
    cp_async16(As + r * LDA + j * 8, g + src, valid);
  }
}

// Is forward K chunk k0 non-zero for some column of [n0, n0 + BN)?  Block
// (q, plane a*2+b) of Wcat is non-zero iff dh(q) <= a and dw(q) <= b.
__device__ __forceinline__ bool fwd_chunk_used(int k0, int n0, int Cin,
                                               int Cout) {
  const int q = k0 / Cin;
  for (int pl = n0 / Cout; pl <= (n0 + BN - 1) / Cout; ++pl)
    if (dh_of(q) <= (pl >> 1) && dw_of(q) <= (pl & 1)) return true;
  return false;
}

// acc (this warp's WM x WN block) += As (BM x KC) @ Bs (KC x BN)
__device__ __forceinline__ void mma_chunk(const bf16* As, const bf16* Bs,
                                          float (&acc)[MT][NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const bf16* a_row = As + (wm * WM + lane % 16) * LDA + (lane / 16) * 8;
  const bf16* b_row = Bs + (lane % 16) * LDB + wn * WN + (lane / 16) * 8;
#pragma unroll
  for (int k = 0; k < KC; k += 16) {
    unsigned a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], a_row + m * 16 * LDA + k);
#pragma unroll
    for (int n = 0; n < WN / 16; ++n) {
      unsigned bb[4];
      ldsm_x4_trans(bb, b_row + k * LDB + n * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16_16816(acc[m][2 * n], a[m], bb[0], bb[1]);
        mma_bf16_16816(acc[m][2 * n + 1], a[m], bb[2], bb[3]);
      }
    }
  }
}

// Write the accumulators to Cs (BM x BN f32, pitch LDC); the caller
// synchronises before and after.
__device__ __forceinline__ void store_acc(float* Cs,
                                          const float (&acc)[MT][NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  float* c_row = Cs + (wm * WM + lane / 4) * LDC + wn * WN + 2 * (lane % 4);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* c = c_row + m * 16 * LDC + n * 8;
      *reinterpret_cast<float2*>(c) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(c + 8 * LDC) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
}

// The dx tile of CTA (blockIdx.x = pixel tile, blockIdx.y = column tile):
// the product over the K chunks, double-buffered, left in Cs.
__device__ void gemm_tile(unsigned char* smem, const bf16* g, const bf16* w,
                          int K, int N, int Cout, int H, int W, int b, int p0,
                          int p_end, int n0) {
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
  auto stage = [&](int s) { return smem + s * STAGE; };
  auto load = [&](int s, int k0) {
    load_a_dx(reinterpret_cast<bf16*>(stage(s)), g, Cout, H, W, b, p0, p_end,
              k0);
    load_b(reinterpret_cast<bf16*>(stage(s) + A_BYTES), w, N, k0, n0);
    cp_async_commit();
  };
  const int nc = K / KC;
  load(0, 0);
  for (int c = 0; c < nc; ++c) {
    if (c + 1 < nc) {
      load((c + 1) % 2, (c + 1) * KC);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    mma_chunk(reinterpret_cast<const bf16*>(stage(c % 2)),
              reinterpret_cast<const bf16*>(stage(c % 2) + A_BYTES), acc);
    __syncthreads();  // this buffer is read before a load refills it
  }
  store_acc(reinterpret_cast<float*>(smem), acc);
  __syncthreads();
}

// Forward: the parity-plane product (parity_plane.cuh) of x and the
// (3, 3, Cin, Cout) tap stack, y = bf16(sum + bias); with S, the per-tile
// partials part[tile][2 Cout] = [sum y, sum y^2] of the stored y.
template <int CIN, int COUT>
using UpsCfg = PPCfg<CIN, COUT, 4, COUT == 16 ? 9 : 4>;

template <class C, bool S>
struct UpsFwdEpi {
  int tiles, H, W;
  const float* bias;
  bf16* y;
  float* part;
  float* red;  // WARPS x 2 COUT f32 in shared memory
  // this thread's sums over its channels 8 (threadIdx % VN) .. + 7
  float s0[8], s1[8];
  __device__ float pre(float v, int n) const { return v + __ldg(bias + n); }
  // half a's output rows of the tile (each thread always the same 8
  // channels: THREADS % VN == 0)
  __device__ void out(int a, PPTile tl, const bf16* Cs) {
    for (int e = threadIdx.x; e < C::TH * 2 * C::TW * C::VN;
         e += C::THREADS) {
      const int pix = e / C::VN, j = e % C::VN;
      const int r = pix / (2 * C::TW), pc = pix % (2 * C::TW);
      const int i = tl.i0 + r;
      if (i >= H || tl.j0 + pc / 2 >= W) continue;
      const uint4 v =
          *reinterpret_cast<const uint4*>(Cs + pix * C::LDN + j * 8);
      *reinterpret_cast<uint4*>(
          y + (((long long)tl.b * 2 * H + 2 * i + a) * 2 * W + 2 * tl.j0 +
               pc) * C::N + j * 8) = v;
      if constexpr (S) {
        float f[8];
        unpack_bf16x8(v, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s0[k] += f[k];
          s1[k] += __fmul_rn(f[k], f[k]);
        }
      }
    }
  }
  // the tile's partials: over the lanes of a warp that hold the same
  // channels (a fixed xor tree), then over the warps in order
  __device__ void end_tile(int t) {
    if constexpr (S) {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        for (int o = C::VN; o < 32; o <<= 1) {
          s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], o);
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        }
      if (lane < C::VN)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[warp * 2 * C::N + lane * 8 + k] = s0[k];
          red[warp * 2 * C::N + C::N + lane * 8 + k] = s1[k];
        }
      __syncthreads();
      for (int q = threadIdx.x; q < 2 * C::N; q += C::THREADS) {
        float s = 0.0f;
        for (int w = 0; w < C::WARPS; ++w) s += red[w * 2 * C::N + q];
        part[(long long)t * 2 * C::N + q] = s;
      }
      // red is rewritten after the next tile's units, each of which
      // synchronises the block first
#pragma unroll
      for (int k = 0; k < 8; ++k) s0[k] = s1[k] = 0.0f;
    }
  }
};

template <int CIN, int COUT>
__host__ __device__ constexpr int ups_tiles_per_image(int H, int W) {
  return ((H + UpsCfg<CIN, COUT>::TH - 1) / UpsCfg<CIN, COUT>::TH) *
         ((W + 31) / 32);
}

template <int CIN, int COUT, bool S>
__global__ void __launch_bounds__(256)
fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
           const float* __restrict__ bias, bf16* __restrict__ y,
           float* __restrict__ part, int B, int H, int W) {
  using C = UpsCfg<CIN, COUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  UpsFwdEpi<C, S> epi;
  epi.tiles = B * ups_tiles_per_image<CIN, COUT>(H, W);
  epi.H = H;
  epi.W = W;
  epi.bias = bias;
  epi.y = y;
  epi.part = part;
  epi.red = reinterpret_cast<float*>(smem + C::red_off);
#pragma unroll
  for (int k = 0; k < 8; ++k) epi.s0[k] = epi.s1[k] = 0.0f;
  const PPSrc src{x, CIN};
  pp_run<C, false>(smem, src, w, H, W, epi);
}

// dx (B, H, W, Cin) bf16 from the adjusted gradient g (B, 2H, 2W, Cout)
// and wt (16 Cout x Cin): row q * 4 Cout + pl * Cout + c = Wcat[q][:, pl
// * Cout + c]^T.
__global__ void __launch_bounds__(THREADS)
dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ wt,
          bf16* __restrict__ dx, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HW = H * W, tpi = (HW + BM - 1) / BM;
  const int tile = blockIdx.x, b = tile / tpi, p0 = (tile % tpi) * BM;
  const int p_end = p0 + BM < HW ? p0 + BM : HW;
  const int n0 = blockIdx.y * BN;
  gemm_tile(smem, g, wt, 16 * Cout, Cin, Cout, H, W, b, p0, p_end, n0);
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int j = threadIdx.x % (BN / 8), r0 = threadIdx.x / (BN / 8);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int r = r0 + i * RSTEP, p = p0 + r;
    if (p >= p_end) break;
    const float4* cv = reinterpret_cast<const float4*>(Cs + r * LDC + j * 8);
    const float4 v0 = cv[0], v1 = cv[1];
    const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    *reinterpret_cast<uint4*>(
        dx + ((long long)b * HW + p) * Cin + n0 + j * 8) = pack_bf16x8(v);
  }
}

// Weight gradient: blockIdx.y = tap t_h * 3 + t_w of the HWIO weight, the
// one non-zero Wcat block (neighbour q, plane a*2+b) that holds it;
// blockIdx.x = a chunk of CHUNK input pixels (flattened over the batch).
// part_w[chunk][tap] = sum over the chunk of x[p + e_q]^T g_plane[p]; the
// four taps of neighbour (0, 0) also write part_db[chunk][plane] = sum of
// g_plane over the chunk (each output pixel once).
constexpr int CHUNK = 1024;

// tap index along one axis -> (output parity, neighbour offset)
__device__ __forceinline__ void tap_of(int t, int& parity, int& off) {
  parity = t == 1 ? 0 : 1;
  off = t == 2 ? 1 : 0;
}

template <int CIN, int COUT>
struct WgPick;
template <>
struct WgPick<128, 64> {
  using Q = WgCfg<128, 64, 32, 32>;
  static constexpr int WM = 32, WN = 32;
};
template <>
struct WgPick<64, 16> {
  using Q = WgCfg<64, 16, 16, 16>;
  static constexpr int WM = 16, WN = 16;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(256)
wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
             float* __restrict__ part_w, float* __restrict__ part_db, int B,
             int H, int W) {
  using P = WgPick<CIN, COUT>;
  using Q = typename P::Q;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Gs = reinterpret_cast<bf16*>(smem + Q::a_bytes);
  const int tap = blockIdx.y;
  int a, bb, dh, dw;
  tap_of(tap / 3, a, dh);
  tap_of(tap % 3, bb, dw);
  const bool sum_db = dh == 0 && dw == 0;
  const int HW = H * W;
  const long long P_ = (long long)B * HW;
  const long long p_begin = (long long)blockIdx.x * CHUNK;
  const long long p_stop = p_begin + CHUNK < P_ ? p_begin + CHUNK : P_;
  constexpr int VA = CIN / 8, VG = COUT / 8;

  float acc[Q::MT][Q::NT][4];
#pragma unroll
  for (int m = 0; m < Q::MT; ++m)
#pragma unroll
    for (int n = 0; n < Q::NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
  float dbs = 0.0f;  // thread t < COUT: channel t of this plane

  for (long long p0 = p_begin; p0 < p_stop; p0 += Q::BP) {
    for (int v = threadIdx.x; v < Q::BP * (VA + VG); v += blockDim.x) {
      const int r = v / (VA + VG), e = v % (VA + VG);
      const long long p = p0 + r;
      const bool in = p < p_stop;
      const int img = (int)(p / HW), local = (int)(p % HW);
      const int i = local / W, jj = local % W;
      if (e < VA) {
        const bool valid = in && i + dh < H && jj + dw < W;
        const long long src =
            valid ? (((long long)img * H + i + dh) * W + jj + dw) * CIN : 0;
        cp_async16(As + r * Q::LDA + e * 8, x + src + e * 8, valid);
      } else {
        const long long src =
            in ? (((long long)img * 2 * H + 2 * i + a) * 2 * W + 2 * jj +
                  bb) * COUT
               : 0;
        cp_async16(Gs + r * Q::LDG + (e - VA) * 8, g + src + (e - VA) * 8,
                   in);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    wgrad_step<CIN, COUT, P::WM, P::WN>(As, Gs, acc);
    if (sum_db && threadIdx.x < COUT)
      for (int r = 0; r < Q::BP; ++r)
        dbs += __bfloat162float(Gs[r * Q::LDG + threadIdx.x]);
    __syncthreads();
  }
  float* dst = part_w + ((long long)blockIdx.x * 9 + tap) * CIN * COUT;
  wgrad_store<CIN, COUT, P::WM, P::WN>(acc, reinterpret_cast<float*>(smem),
                                       dst, CIN, COUT);
  if (sum_db && threadIdx.x < COUT)
    part_db[((long long)blockIdx.x * 4 + a * 2 + bb) * COUT + threadIdx.x] =
        dbs;
}


// ---------------------------------------------------------------------------
// f32 forms
// ---------------------------------------------------------------------------

// Thread (rowg, colg) of an RS32 x TC32 grid owns rows rowg + i RS32 (i <
// TM32) and columns 4 colg + g CS32 + q (g < 2, q < 4) of the tile.
constexpr int THREADS32 = 128, TN32 = 8, TC32 = BN / TN32;
constexpr int RS32 = THREADS32 / TC32, TM32 = BM / RS32, CS32 = 4 * TC32;
constexpr int LDA32 = pitch4(KC);
constexpr size_t A32_BYTES = ((size_t)BM * LDA32 * 4 + 127) / 128 * 128;
constexpr size_t SMEM32 = A32_BYTES + (size_t)KC * BN * 4;
static_assert((size_t)RS32 * 2 * BN * 4 <= SMEM32, "f32 statistic scratch");

// Start copying chunk [k0, k0 + KC) of the forward gather (FWD: column k
// is channel k % Cin of neighbour q = k / Cin, zero past the bottom and
// right edges) or of the dx gather (load_a_dx), f32, and rows [k0, k0 + KC) x
// columns [n0, n0 + BN) of the (K x N) f32 matrix w.
template <bool FWD>
__device__ __forceinline__ void load_chunk_f32(float* As, float* Bs,
                                               const float* a_src,
                                               const float* w, int N, int Cin,
                                               int Cout, int H, int W, int b,
                                               int p0, int p_end, int k0,
                                               int n0) {
  for (int v = threadIdx.x; v < BM * KC / 4; v += THREADS32) {
    const int r = v / (KC / 4), j = v % (KC / 4);
    const int k = k0 + j * 4, p = p0 + r;
    long long src = 0;
    bool valid;
    if (FWD) {
      const int q = k / Cin, c = k % Cin;
      const int i = p / W + dh_of(q), jj = p % W + dw_of(q);
      valid = p < p_end && i < H && jj < W;
      if (valid) src = (((long long)b * H + i) * W + jj) * Cin + c;
    } else {
      const int q = k / (4 * Cout), w4 = k % (4 * Cout);
      const int pl = w4 / Cout, c = w4 % Cout;
      const int i = p / W - dh_of(q), jj = p % W - dw_of(q);
      valid = p < p_end && i >= 0 && jj >= 0;
      if (valid)
        src = (((long long)b * 2 * H + 2 * i + (pl >> 1)) * 2 * W + 2 * jj +
               (pl & 1)) * Cout + c;
    }
    cp_async16(As + r * LDA32 + j * 4, a_src + src, valid);
  }
  for (int v = threadIdx.x; v < KC * BN / 4; v += THREADS32) {
    const int r = v / (BN / 4), j = v % (BN / 4);
    cp_async16(Bs + r * BN + j * 4, w + (long long)(k0 + r) * N + n0 + j * 4,
               true);
  }
  cp_async_commit();
}

// The tile of CTA (blockIdx.x = pixel tile, blockIdx.y = column tile):
// acc = the product over the K chunks (the forward skips zero blocks).
template <bool FWD>
__device__ void gemm_tile_f32(unsigned char* smem, const float* a_src,
                              const float* w, int K, int N, int Cin, int Cout,
                              int H, int W, int b, int p0, int p_end, int n0,
                              float (&acc)[TM32][TN32]) {
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + A32_BYTES);
  const int colg = threadIdx.x % TC32, rowg = threadIdx.x / TC32;
  zero_tile(acc);
  for (int k0 = 0; k0 < K; k0 += KC) {
    if (FWD && !fwd_chunk_used(k0, n0, Cin, Cout)) continue;
    load_chunk_f32<FWD>(As, Bs, a_src, w, N, Cin, Cout, H, W, b, p0, p_end,
                        k0, n0);
    cp_async_wait_all();
    __syncthreads();
    if constexpr (FWD) {  // one chain: the plain version's single matmul
      ffma_tile<TM32, TN32, KC, CS32>(acc, As + rowg * LDA32, RS32 * LDA32,
                                      Bs + 4 * colg, BN);
    } else {  // a chain per chunk, added in order (add_tile)
      float part[TM32][TN32];
      zero_tile(part);
      ffma_tile<TM32, TN32, KC, CS32>(part, As + rowg * LDA32, RS32 * LDA32,
                                      Bs + 4 * colg, BN);
      add_tile(acc, part);
    }
    __syncthreads();  // the chunk is consumed before the next load
  }
}

template <bool S>
__global__ void __launch_bounds__(THREADS32)
fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ wcat,
               const float* __restrict__ bias, float* __restrict__ y,
               float* __restrict__ part, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HW = H * W, tpi = (HW + BM - 1) / BM;
  const int tile = blockIdx.x, ct = blockIdx.y, n_ct = gridDim.y;
  const int b = tile / tpi, p0 = (tile % tpi) * BM;
  const int p_end = p0 + BM < HW ? p0 + BM : HW;
  const int n0 = ct * BN;
  float acc[TM32][TN32];
  gemm_tile_f32<true>(smem, x, wcat, 4 * Cin, 4 * Cout, Cin, Cout, H, W, b,
                      p0, p_end, n0, acc);
  const int colg = threadIdx.x % TC32, rowg = threadIdx.x / TC32;
  float s0[TN32], s1[TN32];
#pragma unroll
  for (int j = 0; j < TN32; ++j) s0[j] = s1[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < TM32; ++i) {
    const int p = p0 + rowg + i * RS32;
    if (p >= p_end) break;
#pragma unroll
    for (int g = 0; g < TN32 / 4; ++g) {
      const int n = n0 + 4 * colg + g * CS32, pl = n / Cout, c0 = n % Cout;
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        o[q] = acc[i][4 * g + q] + __ldg(bias + c0 + q);
        if constexpr (S) {
          s0[4 * g + q] += o[q];
          s1[4 * g + q] += __fmul_rn(o[q], o[q]);
        }
      }
      const int oi = 2 * (p / W) + (pl >> 1), oj = 2 * (p % W) + (pl & 1);
      *reinterpret_cast<float4*>(
          y + (((long long)b * 2 * H + oi) * 2 * W + oj) * Cout + c0) =
          make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if constexpr (!S) return;
  float* red = reinterpret_cast<float*>(smem);  // gemm ended with a barrier
#pragma unroll
  for (int j = 0; j < TN32; ++j) {
    const int col = 4 * colg + (j / 4) * CS32 + j % 4;
    red[rowg * 2 * BN + col] = s0[j];
    red[rowg * 2 * BN + BN + col] = s1[j];
  }
  __syncthreads();
  // output t < 2 Cout: [sum | sum of squares] of channel t % Cout over
  // the planes of this column tile, then the row groups, in order
  for (int t = threadIdx.x; t < 2 * Cout; t += THREADS32) {
    const int c = t % Cout, sq = t / Cout;
    float s = 0.0f;
    for (int pn = 0; pn < BN; pn += Cout)  // Cout divides BN
      for (int q = 0; q < RS32; ++q) s += red[q * 2 * BN + sq * BN + pn + c];
    part[((long long)tile * n_ct + ct) * 2 * Cout + t] = s;
  }
}

__global__ void __launch_bounds__(THREADS32)
dx_f32_kernel(const float* __restrict__ g, const float* __restrict__ wt,
              float* __restrict__ dx, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int HW = H * W, tpi = (HW + BM - 1) / BM;
  const int tile = blockIdx.x, b = tile / tpi, p0 = (tile % tpi) * BM;
  const int p_end = p0 + BM < HW ? p0 + BM : HW;
  const int n0 = blockIdx.y * BN;
  float acc[TM32][TN32];
  gemm_tile_f32<false>(smem, g, wt, 16 * Cout, Cin, Cin, Cout, H, W, b, p0,
                       p_end, n0, acc);
  const int colg = threadIdx.x % TC32, rowg = threadIdx.x / TC32;
#pragma unroll
  for (int i = 0; i < TM32; ++i) {
    const int p = p0 + rowg + i * RS32;
    if (p >= p_end) break;
#pragma unroll
    for (int gq = 0; gq < TN32 / 4; ++gq)
      *reinterpret_cast<float4*>(dx + ((long long)b * HW + p) * Cin + n0 +
                                 4 * colg + gq * CS32) =
          make_float4(acc[i][4 * gq], acc[i][4 * gq + 1], acc[i][4 * gq + 2],
                      acc[i][4 * gq + 3]);
  }
}

// Weight gradient, f32: as wgrad_kernel (blockIdx.y = tap, blockIdx.x = a
// chunk of CHUNK input pixels; part_w, part_db as there).
template <int CIN, int COUT>
struct WgPick32 {
  static constexpr int TM = CIN == 128 ? 8 : 4, TN = 4, THREADS = 256;
  static constexpr int BP = 64;
  using Q = Wg32<CIN, COUT, TM, TN, THREADS, BP>;
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(256)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 float* __restrict__ part_w, float* __restrict__ part_db,
                 int B, int H, int W) {
  using P = WgPick32<CIN, COUT>;
  using Q = typename P::Q;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Gs = reinterpret_cast<float*>(smem + Q::a_bytes);
  const int tap = blockIdx.y;
  int a, bb, dh, dw;
  tap_of(tap / 3, a, dh);
  tap_of(tap % 3, bb, dw);
  const bool sum_db = dh == 0 && dw == 0;
  const int HW = H * W;
  const long long P_ = (long long)B * HW;
  const long long p_begin = (long long)blockIdx.x * CHUNK;
  const long long p_stop = p_begin + CHUNK < P_ ? p_begin + CHUNK : P_;
  constexpr int VA = CIN / 4, VG = COUT / 4;
  float acc[P::TM][P::TN];
  zero_tile(acc);
  float dbs = 0.0f;  // thread t < COUT: channel t of this plane

  for (long long p0 = p_begin; p0 < p_stop; p0 += P::BP) {
    for (int v = threadIdx.x; v < P::BP * (VA + VG); v += blockDim.x) {
      const int r = v / (VA + VG), e = v % (VA + VG);
      const long long p = p0 + r;
      const bool in = p < p_stop;
      const int img = (int)(p / HW), local = (int)(p % HW);
      const int i = local / W, jj = local % W;
      if (e < VA) {
        const bool valid = in && i + dh < H && jj + dw < W;
        const long long src =
            valid ? (((long long)img * H + i + dh) * W + jj + dw) * CIN : 0;
        cp_async16(As + r * CIN + e * 4, x + src + e * 4, valid);
      } else {
        const long long src =
            in ? (((long long)img * 2 * H + 2 * i + a) * 2 * W + 2 * jj +
                  bb) * COUT
               : 0;
        cp_async16(Gs + r * COUT + (e - VA) * 4, g + src + (e - VA) * 4, in);
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    wg32_step<CIN, COUT, P::TM, P::TN, P::THREADS, P::BP>(As, Gs, acc);
    if (sum_db && threadIdx.x < COUT)
      for (int r = 0; r < P::BP; ++r) dbs += Gs[r * COUT + threadIdx.x];
    __syncthreads();
  }
  float* dst = part_w + ((long long)blockIdx.x * 9 + tap) * CIN * COUT;
  wg32_store<CIN, COUT, P::TM, P::TN, P::THREADS, P::BP>(
      acc, reinterpret_cast<float*>(smem), dst, CIN, COUT);
  if (sum_db && threadIdx.x < COUT)
    part_db[((long long)blockIdx.x * 4 + a * 2 + bb) * COUT + threadIdx.x] =
        dbs;
}

// ------------------------------- launchers --------------------------------

bool shape_ok(int B, int H, int W, int Cin, int Cout) {
  return ((Cin == 128 && Cout == 64) || (Cin == 64 && Cout == 16)) && B > 0 &&
         H > 0 && W > 0 && (long long)B * 4 * H * W * Cin < (1LL << 31);
}

cudaError_t allow(const void* fn, size_t bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

template <int CIN, int COUT>
int wgrad(const void* x, const void* g, void* part_w, void* part_db, int B,
          int H, int W, cudaStream_t s) {
  using Q = typename WgPick<CIN, COUT>::Q;
  static bool ok = false;
  cudaError_t e = allow((const void*)wgrad_kernel<CIN, COUT>, Q::smem, &ok);
  if (e != cudaSuccess) return e;
  const int chunks = (int)(((long long)B * H * W + CHUNK - 1) / CHUNK);
  wgrad_kernel<CIN, COUT><<<dim3(chunks, 9), Q::THREADS, Q::smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<float*>(part_w), static_cast<float*>(part_db), B, H, W);
  return cudaGetLastError();
}

template <int CIN, int COUT>
int wgrad_f32(const void* x, const void* g, void* part_w, void* part_db,
              int B, int H, int W, cudaStream_t s) {
  using P = WgPick32<CIN, COUT>;
  static bool ok = false;
  cudaError_t e = allow((const void*)wgrad_f32_kernel<CIN, COUT>,
                        P::Q::smem, &ok);
  if (e != cudaSuccess) return e;
  const int chunks = (int)(((long long)B * H * W + CHUNK - 1) / CHUNK);
  wgrad_f32_kernel<CIN, COUT><<<dim3(chunks, 9), P::THREADS, P::Q::smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(part_w), static_cast<float*>(part_db), B, H, W);
  return cudaGetLastError();
}

template <int CIN, int COUT, bool S>
int fwd(const void* x, const void* w, const void* bias, void* y, void* part,
        void* stats, int B, int H, int W, cudaStream_t s) {
  using C = UpsCfg<CIN, COUT>;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(fwd_kernel<CIN, COUT, S>, C::smem, &ok);
  if (e != cudaSuccess) return e;
  if (gm == 0 && (e = resident_ctas(fwd_kernel<CIN, COUT, S>, C::THREADS,
                                    C::smem, &gm)) != cudaSuccess)
    return e;
  const int tpi = ups_tiles_per_image<CIN, COUT>(H, W), tiles = B * tpi;
  fwd_kernel<CIN, COUT, S><<<tiles < gm ? tiles : gm, C::THREADS, C::smem,
                             s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(part), B, H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * COUT, s);
}

template <bool S>
int fwd_f32(const void* x, const void* wcat, const void* bias, void* y,
            void* part, void* stats, int B, int H, int W, int Cin, int Cout,
            cudaStream_t s) {
  static bool ok = false;
  cudaError_t e = allow((const void*)fwd_f32_kernel<S>, SMEM32, &ok);
  if (e != cudaSuccess) return e;
  const int tpi = (H * W + BM - 1) / BM, n_ct = 4 * Cout / BN;
  fwd_f32_kernel<S><<<dim3(B * tpi, n_ct), THREADS32, SMEM32, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wcat),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(part), H, W, Cin, Cout);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi * n_ct, 2 * Cout, s);
}

}  // namespace

// ------------------------------ C interface -------------------------------
//
// x (B, H, W, Cin) and y (B, 2H, 2W, Cout) bf16, NHWC, (Cin, Cout) in
// {(128, 64), (64, 16)}; bias (Cout,) f32; with_stats 1 for the forms
// with the per-image statistics, 0 for the stats-free ones.  Each entry
// point returns the first CUDA error.

// Forward.  w (3, 3, Cin, Cout) bf16, the forward-conv HWIO tap stack
// (each parity-plane block is one of its taps); part (B * ceil(H / 4) *
// ceil(W / 32), 2 Cout) f32 scratch; stats (B, 2 Cout) f32 = [sum y, sum
// y^2] per image (with_stats 0: part and stats are not touched).
extern "C" int erf_ups_train_fwd(const void* x, const void* w,
                                 const void* bias, void* y, void* part,
                                 void* stats, int B, int H, int W, int Cin,
                                 int Cout, int with_stats, void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin == 128)
    return with_stats
               ? fwd<128, 64, true>(x, w, bias, y, part, stats, B, H, W, s)
               : fwd<128, 64, false>(x, w, bias, y, part, stats, B, H, W, s);
  return with_stats
             ? fwd<64, 16, true>(x, w, bias, y, part, stats, B, H, W, s)
             : fwd<64, 16, false>(x, w, bias, y, part, stats, B, H, W, s);
}

// Backward.  y: the forward's output; gy (B, 2H, 2W, Cout) bf16; gs1, gs2
// (B, Cout) f32; wt (16 Cout, Cin) bf16 (see dx_kernel); g (B, 2H, 2W,
// Cout) bf16 scratch (with_stats 0: gy is g, and y, gs1, gs2 and g are not
// read); dx (B, H, W, Cin) bf16; part_w (chunks, 9, Cin, Cout) and part_db
// (chunks, 4, Cout) f32 scratch with chunks = ceil(B H W / 1024); grads
// (9 Cin Cout + Cout) f32 = [dW (3, 3, Cin, Cout) HWIO, db].
extern "C" int erf_ups_train_bwd(const void* x, const void* y, const void* gy,
                                 const void* gs1, const void* gs2,
                                 const void* wt, void* g, void* dx,
                                 void* part_w, void* part_db, void* grads,
                                 int B, int H, int W, int Cin, int Cout,
                                 int with_stats, void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const void* gg = with_stats ? g : gy;
  if (with_stats &&
      (e = adjust_grad(gy, y, gs1, gs2, g, B, 4 * H * W, Cout, s)) !=
          cudaSuccess)
    return e;
  static bool ok = false;
  if ((e = allow((const void*)dx_kernel, SMEM, &ok)) != cudaSuccess) return e;
  const int tpi = (H * W + BM - 1) / BM;
  dx_kernel<<<dim3(B * tpi, Cin / BN), THREADS, SMEM, s>>>(
      static_cast<const bf16*>(gg), static_cast<const bf16*>(wt),
      static_cast<bf16*>(dx), H, W, Cin, Cout);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = (cudaError_t)(Cin == 128 ? wgrad<128, 64>(x, gg, part_w, part_db, B, H,
                                                 W, s)
                               : wgrad<64, 16>(x, gg, part_w, part_db, B, H,
                                               W, s));
  if (e != cudaSuccess) return e;
  const int chunks = (int)(((long long)B * H * W + CHUNK - 1) / CHUNK);
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        9 * Cin * Cout, s)) != cudaSuccess)
    return e;
  return reduce_parts(static_cast<const float*>(part_db), gr + 9 * Cin * Cout,
                      1, 4 * chunks, Cout, s);
}


// The f32 forms: x, y, gy, g, dx, wcat (4 Cin, 4 Cout) and wt (16 Cout,
// Cin) in f32; the same scratch and outputs.
extern "C" int erf_ups_train_fwd_f32(const void* x, const void* wcat,
                                     const void* bias, void* y, void* part,
                                     void* stats, int B, int H, int W,
                                     int Cin, int Cout, int with_stats,
                                     void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_stats ? fwd_f32<true>(x, wcat, bias, y, part, stats, B, H, W,
                                    Cin, Cout, s)
                    : fwd_f32<false>(x, wcat, bias, y, part, stats, B, H, W,
                                     Cin, Cout, s);
}

extern "C" int erf_ups_train_bwd_f32(const void* x, const void* y,
                                     const void* gy, const void* gs1,
                                     const void* gs2, const void* wt, void* g,
                                     void* dx, void* part_w, void* part_db,
                                     void* grads, int B, int H, int W,
                                     int Cin, int Cout, int with_stats,
                                     void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const void* gg = with_stats ? g : gy;
  if (with_stats &&
      (e = adjust_grad_f32(gy, y, gs1, gs2, g, B, 4 * H * W, Cout, s)) !=
          cudaSuccess)
    return e;
  static bool ok = false;
  if ((e = allow((const void*)dx_f32_kernel, SMEM32, &ok)) != cudaSuccess)
    return e;
  const int tpi = (H * W + BM - 1) / BM;
  dx_f32_kernel<<<dim3(B * tpi, Cin / BN), THREADS32, SMEM32, s>>>(
      static_cast<const float*>(gg), static_cast<const float*>(wt),
      static_cast<float*>(dx), H, W, Cin, Cout);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = (cudaError_t)(Cin == 128
                        ? wgrad_f32<128, 64>(x, gg, part_w, part_db, B, H, W,
                                             s)
                        : wgrad_f32<64, 16>(x, gg, part_w, part_db, B, H, W,
                                            s));
  if (e != cudaSuccess) return e;
  const int chunks = (int)(((long long)B * H * W + CHUNK - 1) / CHUNK);
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        9 * Cin * Cout, s)) != cudaSuccess)
    return e;
  return reduce_parts(static_cast<const float*>(part_db), gr + 9 * Cin * Cout,
                      1, 4 * chunks, Cout, s);
}
