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
//           (= sum_p x[p]^T g[2p - 1 + (2 - tap)] in the conv's terms)
//   db = sum g                                           f32
//
// Launches.  Forward: the product with its epilogue (bias, bf16 store,
// per-tile statistic partials) and the fixed-order reduction of the
// partials.  Backward: the g fold, the dx product, the weight-gradient
// product (per-chunk partials of dW and db), and two fixed-order
// reductions.
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
// dx (bf16): the transposed conv's input gradient is the stride-2 3x3
// pad-1 conv of g with the flipped, transposed taps,
//   dx[i, j] = bf16(sum_{kh, kw} g[2i - 1 + kh, 2j - 1 + kw] @ w[2 - kh, 2 - kw]^T)
// the train downsampler forward's product (Fwd there): a tile of TH x 32
// dx pixels stages its (2 TH + 1) x 65 g pixels once in four parity
// planes (parity_plane.cuh PFPatch), each tap a shifted ldmatrix view;
// 9 Cout Cin MACs a dx pixel on mma.sync (Wcat's seven zero blocks are
// never multiplied); the taps copied from w as they are (the flip in the
// row order, the transpose by the non-transposing ldmatrix of the n-major
// stack, no wt is built), resident; persistent CTAs with the next tile's
// patch in flight; whole dx pixels written 16 bytes a thread.  At 128 ->
// 64 the resident stack (147 KB) leaves room for two patches and no
// output stage: the stage aliases the tile's own patch once read.
//
// Weight gradient (bf16): on a (chunk of input rows, kh) grid, the train
// downsampler's weight gradient with the maps' roles swapped: a block of
// BP input pixels stages its x tile once and g's one high-resolution row
// segment per kh, the three kw taps stride-2 views of it, so x is read at
// most 3 times (once per kh; not 9) and g 1.5 times (not 2.25); at 64 ->
// 16 one CTA takes all three kh (x read once).  The blocks stream through
// a cp.async ring; the chunks are sized so that the grid is one wave of
// one CTA an SM (erf_ups_train_wg_rows).  db sums every g pixel once, the
// kh = 1 segments its even rows and the kh = 2 ones its odd rows.
// Partials per chunk (17.4 MB at the B=6 shapes on 132 SMs, where
// partials per 1024-pixel chunk and tap took 21 MB), reduced in a fixed
// order: a step stays bit-reproducible.
//
// Bound on this card: bytes (9 Cin Cout MACs per input pixel forward
// against 2 Cin + 8 Cout bytes read and written: 72 operations per byte
// at 64 -> 16 and 192 at 128 -> 64, under the card's 295; the backward
// twice the operations on 4 Cin + 16 Cout bytes: x, dx, gy, y).  What is
// left: each forward tile reads its 9 Cin Cout weights from L2 (1.2 KB a
// pixel at 128 -> 64), one CTA an SM for the forward and dx at 128 ->
// 64, mma.sync and not wgmma, the g fold a pass of its own.
//
// The f32 forms (erf_ups_train_*_f32, the JAX package's default compute
// dtype): the same launches and the same function with x, y, g and dx in
// f32 and nothing rounded to bf16, no library call; every form reads the
// tap stack w (3, 3, Cin, Cout) as it is (no Wcat).  The forward is
// ups_fwd32.cuh's parity-plane product over halo patches (the bf16
// form's 4 x 32 tiles and partials; only the nine non-zero blocks; 3xTF32
// in wgmma, within 5e-7 of the plain version, the taps split into TF32
// images in the kernel).  The backward keeps the bf16 form's two designs
// in f32, on FFMA micro-tiles (no TF32):
// * dx (UpsDx32): the halo-patch stride-2 conv of g, 9 Cout Cin MACs a dx
//   pixel (the transposed Wcat GEMM it replaced multiplied Wcat's seven
//   zero blocks too: 9.66 against 5.44 GMAC at the B=6 shapes).  At 64 ->
//   16 the f32 stack (36 KB) is resident beside two patches, two CTAs an
//   SM.  At 128 -> 64 the stack (295 KB) exceeds a CTA's 227 KB, so it
//   streams a tap (32 KB) a stage through a 2-stage cp.async ring beside
//   two 2 x 32 tiles' patches (the next tile's in flight).  A ring, and
//   not dx's 128 channels split over two CTAs each with its 147 KB half
//   resident: that leaves room for one patch (copies and product in turn)
//   and reads g twice.  Of the rings timed, whole taps in two stages beat
//   half taps in four or three (9 barriers a tile, not 18) and 1 x 32
//   tiles (PERF.md §6).  Each output one FMA chain per tap (128 -> 64) or
//   per kh row of three taps (64 -> 16), the chains added in the order the
//   taps stream.
// * The weight gradient (UpsWg32): the (chunk of input rows, kh) grid, x
//   read 3 / KHN times (once at 64 -> 16) and g 1.5 times, one partial
//   per chunk (12.7 MB at 128 -> 64 and 4.7 MB at 64 -> 16 on 132 SMs,
//   where partials per 1024-pixel chunk and tap took 21 MB), each output
//   one FMA chain per thread group, the groups added in order.
// Bound at f32: operations (9 Cin Cout MACs per input pixel forward, twice
// that backward, against 67 TFLOP/s; the forward's three TF32 products
// against 494.7 TFLOP/s take 0.41 of that).  What is left: dx runs at 2.2-2.6x
// its bound, its product at about half the FFMA rate (without the product
// dx takes 0.06 of its 0.23 ms at 128 -> 64, scripts/cuda_ups_bwd_variants.py;
// PERF.md §6); at 64 -> 16 two CTAs an SM cap it at 128 registers (a few
// spilled, still faster than one CTA); the g fold is a pass of its own.
//
// The stats-free forms (with_stats = 0) replace upsampler_packed
// (_ups_fwd_kernel via _call_fwd_local, _ups_bwd_kernel via
// _call_bwd_local): the forward's epilogue writes y without the
// statistic partials and their reduction is skipped; the backward starts
// from g = gy (no g fold, y not read).
#include "parity_plane.cuh"
#include "ups_fwd32.cuh"

using namespace erfk;

namespace {

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

// dx (bf16): the stride-2 3x3 pad-1 conv of g (B, 2H, 2W, K = Cout) with
// the flipped, transposed taps, dx[i, j] = bf16(sum over (kh, kw) of
// g[2i - 1 + kh, 2j - 1 + kw] @ w[2 - kh, 2 - kw]^T), as the train
// downsampler forward runs it (downsampler_train.cu Fwd): a tile of TH x
// 32 dx pixels of one image stages its (2 TH + 1) x 65 g pixels once into
// four parity planes (parity_plane.cuh PFPatch), each of the nine taps a
// shifted ldmatrix view; 9 Cout Cin MACs a dx pixel on mma.sync.  The tap
// stack, row T N + n holding w[8 - T][n, :] (T = kh 3 + kw: the flip),
// is copied from w as it is, n-major, so the non-transposing ldmatrix
// gives the B fragments (the transpose); PFPatch's swizzle keeps its
// ldmatrix rows on distinct bank groups.  At (64, 128) the resident tap
// stack (147 KB) and two 41.6 KB patches fill the CTA's 227 KB: the
// output stage aliases the tile's own patch once the product has read it
// (no third buffer).  Persistent CTAs, the next tile's patch in flight;
// whole dx pixels written 16 bytes a thread.
template <int K, int N>  // K = Cout (g's channels), N = Cin (dx's)
struct UpsDx {
  static constexpr int TH = K == 64 ? 2 : 4, TW = 32, BM = TH * TW;
  static constexpr int THREADS = 256, WARPS = 8, WN = 32;
  static constexpr int WCOLS = N / WN, WROWS = WARPS / WCOLS;
  static constexpr int WM = BM / WROWS, MT = WM / 16, NT = WN / 8;
  static constexpr int VN = N / 8, LDO = N + 8;
  static constexpr int MIN_CTAS = K == 64 ? 1 : 2;
  using Patch = PFPatch<K, TH>;
  static constexpr size_t w_off = 2 * Patch::bytes;  // two patches
  static constexpr size_t smem = w_off + pp_align((size_t)9 * N * K * 2);
  static_assert(N % WN == 0 && WARPS % WCOLS == 0 && WM % 16 == 0 &&
                    TW % WM == 0 && (size_t)BM * LDO * 2 <= Patch::bytes &&
                    smem <= 232448,
                "dx tile");
};

template <int K, int N>
__host__ __device__ constexpr int dx_tiles_per_image(int H, int W) {
  return ((H + UpsDx<K, N>::TH - 1) / UpsDx<K, N>::TH) * ((W + 31) / 32);
}

template <int K, int N>
__global__ void __launch_bounds__(256, UpsDx<K, N>::MIN_CTAS)
dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ w,
          bf16* __restrict__ dx, int B, int H, int W) {
  using G = UpsDx<K, N>;
  using P = typename G::Patch;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::w_off);
  const int tiles = B * dx_tiles_per_image<K, N>(H, W);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WCOLS, wn = warp % G::WCOLS;

  // the tap stack: row T N + n = w[8 - T][n, :] (K values, PFPatch's
  // chunk order)
  for (int v = threadIdx.x; v < 9 * N * P::VK; v += G::THREADS) {
    const int r = v / P::VK, e = v % P::VK;
    cp_async16(const_cast<bf16*>(P::at(Ws, r, e)),
               w + ((size_t)(8 - r / N) * N + r % N) * K + e * 8, true);
  }
  auto patch_of = [&](int kk) {
    return reinterpret_cast<bf16*>(smem + (kk & 1) * P::bytes);
  };
  auto issue = [&](int t, int kk) {
    if (t < tiles)
      pf_load_patch<P>(patch_of(kk), g, pp_tile_of<G>(t, H, W), 2 * H,
                       2 * W, G::THREADS);
    cp_async_commit();
  };

  issue(blockIdx.x, 0);  // with the tap stack
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, H, W);
    issue(t + gridDim.x, kk + 1);  // into the buffer tile kk - 1 left
    cp_async_wait_group<1>();
    __syncthreads();
    const bf16* pb = patch_of(kk);
    float acc[G::MT][G::NT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      int q[G::MT];  // this lane's A row: the tap's plane pixel
#pragma unroll
      for (int mt = 0; mt < G::MT; ++mt) {
        const int m = wm * G::WM + mt * 16 + lane % 16;
        q[mt] = P::tap(m / G::TW, m % G::TW, tap / 3, tap % 3);
      }
#pragma unroll
      for (int k = 0; k < K; k += 16) {
        unsigned a[G::MT][4];
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
          ldsm_x4(a[mt], P::at(pb, q[mt], k / 8 + lane / 16));
#pragma unroll
        for (int n = 0; n < G::WN / 16; ++n) {
          // rows n0 + lane % 8 (+ 8 for lanes 16-31), chunk k / 8 (+ 1
          // for lanes 8-15, 24-31): b0 b1 of columns n0 .. + 7, then of
          // n0 + 8 .. + 15
          unsigned bb[4];
          ldsm_x4(bb, P::at(Ws,
                            tap * N + wn * G::WN + n * 16 + lane % 8 +
                                (lane / 16) * 8,
                            k / 8 + (lane / 8) % 2));
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * n], a[mt], bb[0], bb[1]);
            mma_bf16_16816(acc[mt][2 * n + 1], a[mt], bb[2], bb[3]);
          }
        }
      }
    }
    __syncthreads();  // the patch is read: its buffer stages the output
    bf16* Cs = patch_of(kk);
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * G::WM + mt * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int n = wn * G::WN + nt * 8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(Cs + m * G::LDO + n) =
              __floats2bfloat162_rn(acc[mt][nt][2 * h],
                                    acc[mt][nt][2 * h + 1]);
        }
      }
    __syncthreads();
    for (int v = threadIdx.x; v < G::BM * G::VN; v += G::THREADS) {
      const int m = v / G::VN, j = v % G::VN;
      const int i = tl.i0 + m / G::TW, jj = tl.j0 + m % G::TW;
      if (i < H && jj < W)
        *reinterpret_cast<uint4*>(
            dx + (((long long)tl.b * H + i) * W + jj) * N + j * 8) =
            *reinterpret_cast<const uint4*>(Cs + m * G::LDO + j * 8);
    }
    __syncthreads();  // Cs read before the next tile's copies refill it
  }
  cp_async_wait_all();
}

// Weight gradient (bf16): dW[2 - kh, 2 - kw] = sum_p x[p]^T g[2i - 1 + kh,
// 2j - 1 + kw] (p = (i, j)), the train downsampler's weight gradient
// (downsampler_train.cu down_wgrad_kernel) with the two maps' roles
// swapped.  blockIdx.x = a chunk of `rows_per` input rows (flattened over
// the batch; the wrapper sizes the chunks so that the grid is one wave of
// one CTA an SM), blockIdx.y = khg: the CTA owns the KHN kernel rows kh =
// khg KHN .. + KHN - 1.  At 128 -> 64 a CTA takes one kh (the taps of all
// three would not fit its registers), at 64 -> 16, where x is as large as
// g, all three (x read once).  Each row in blocks of BP input pixels: a
// block stages its x tile (BP x Cin) once and, per kh, g's one
// high-resolution row segment (columns 2 j0 - 1 + s, s < 2 BP + 1), even
// slots in GE, odd ones in GO, so tap kw's B operand is a stride-2 view
// (kw = 0: GE rows [0, BP), 1: GO, 2: GE rows [1, BP]): x is read 3 / KHN
// times, g 1.5 times.  The blocks stream through a ring of NS stages (NS
// - 1 in flight).  Each warp owns WMT x WNT m16 x n16 tiles of all its
// taps over every WARPS_K-th 16-pixel step (the A fragments shared by the
// taps); the warp groups' sums are added in group order at the end.  db
// sums every g pixel once: the kh = 1 segments its even rows 2i, the kh =
// 2 ones its odd rows 2i + 1, slots 1 .. 2 BP of each; thread t takes the
// 16-byte chunk t % VG of channels and every DBG-th slot, the DBG threads
// of a chunk added in order at the end.  part_w[chunk] = dW (3, 3, Cin,
// Cout) HWIO, part_db[chunk][kh - 1] = db's partial over that kh's rows.
template <int CIN, int COUT>
struct UpsWg {
  static constexpr bool WIDE = CIN == 128;
  static constexpr int KHN = WIDE ? 1 : 3, KHG = 3 / KHN, TAPS = 3 * KHN;
  static constexpr int WMT = WIDE ? 2 : 1, WNT = WIDE ? 2 : 1;
  static constexpr int WARPS_N = COUT / 16 / WNT;
  static constexpr int WARPS_MN = (CIN / 16 / WMT) * WARPS_N;
  static constexpr int WARPS_K = 8 / WARPS_MN;
  static constexpr int BP = 128;  // input pixels a block
  static constexpr int NS = 3;    // ring stages
  static constexpr int CTAS = 1;  // CTAs an SM
  static constexpr int THREADS = 256;
  static constexpr int LDA = CIN + 8, LDG = COUT + 8;
  static constexpr int VG = COUT / 8, DBG = 256 / VG;
  static constexpr size_t x_bytes = pp_align((size_t)BP * LDA * 2);
  static constexpr size_t ge_bytes = pp_align((size_t)(BP + 1) * LDG * 2);
  static constexpr size_t seg_bytes =
      ge_bytes + pp_align((size_t)BP * LDG * 2);
  static constexpr size_t stage_bytes = x_bytes + KHN * seg_bytes;
  static constexpr size_t red_bytes =
      ((size_t)WARPS_K * TAPS * CIN * COUT + 2 * 256 * 8) * 4;
  static constexpr size_t smem = NS * stage_bytes > red_bytes
                                     ? NS * stage_bytes
                                     : red_bytes;
  static_assert(CIN % (16 * WMT) == 0 && COUT % (16 * WNT) == 0 &&
                    8 % WARPS_MN == 0 && (BP / 16) % WARPS_K == 0 &&
                    256 % VG == 0 && smem <= 232448,
                "upsampler wgrad tile");
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(256, UpsWg<CIN, COUT>::CTAS)
wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
             float* __restrict__ part_w, float* __restrict__ part_db, int B,
             int H, int W, int rows_per) {
  using G = UpsWg<CIN, COUT>;
  constexpr int LDA = G::LDA, LDG = G::LDG, BP = G::BP;
  constexpr int KHN = G::KHN, NS = G::NS, VG = G::VG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh0 = blockIdx.y * KHN;
  const int row0 = blockIdx.x * rows_per;
  const int rows = B * H - row0 < rows_per ? B * H - row0 : rows_per;
  const int bpr = (W + BP - 1) / BP, nb = rows * bpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / G::WARPS_MN, wmn = warp % G::WARPS_MN;
  const int wm = wmn / G::WARPS_N, wn = wmn % G::WARPS_N;
  auto xs_of = [&](int j) {
    return reinterpret_cast<bf16*>(smem + (j % NS) * G::stage_bytes);
  };
  // kernel row kh0 + l's segment of block j: GE, then GO
  auto ge_of = [&](int j, int l) {
    return xs_of(j) + (G::x_bytes + l * G::seg_bytes) / 2;
  };
  auto go_of = [&](int j, int l) { return ge_of(j, l) + G::ge_bytes / 2; };
  // start staging block j (rows of the chunk, then blocks of a row)
  auto issue = [&](int j) {
    if (j < nb) {
      const int row = row0 + j / bpr, j0 = (j % bpr) * BP;
      const int img = row / H;
      bf16* xs = xs_of(j);
      const bf16* xrow = x + (long long)row * W * CIN;
      for (int v = threadIdx.x; v < BP * (CIN / 8); v += 256) {
        const int p = v / (CIN / 8), e = v % (CIN / 8);
        const bool ok = j0 + p < W;
        cp_async16(xs + p * LDA + e * 8,
                   xrow + (ok ? (long long)(j0 + p) * CIN + e * 8 : 0), ok);
      }
#pragma unroll
      for (int l = 0; l < KHN; ++l) {
        const int hr = 2 * (row % H) - 1 + kh0 + l;  // < 2H
        bf16* ge = ge_of(j, l);
        bf16* go = go_of(j, l);
        const bf16* grow =
            g + ((long long)img * 2 * H + (hr >= 0 ? hr : 0)) * 2 * W * COUT;
        for (int v = threadIdx.x; v < (2 * BP + 1) * VG; v += 256) {
          const int sl = v / VG, e = v % VG, col = 2 * j0 - 1 + sl;
          const bool ok = hr >= 0 && col >= 0 && col < 2 * W;
          cp_async16((sl & 1 ? go : ge) + (sl >> 1) * LDG + e * 8,
                     grow + (ok ? (long long)col * COUT + e * 8 : 0), ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[G::TAPS][G::WMT][2 * G::WNT][4];
#pragma unroll
  for (int t = 0; t < G::TAPS; ++t)
#pragma unroll
    for (int mt = 0; mt < G::WMT; ++mt)
#pragma unroll
      for (int n = 0; n < 2 * G::WNT; ++n)
        acc[t][mt][n][0] = acc[t][mt][n][1] = acc[t][mt][n][2] =
            acc[t][mt][n][3] = 0.0f;
  float dbs[2][8];  // db over the even (kh = 1) and odd (kh = 2) rows
#pragma unroll
  for (int k = 0; k < 8; ++k) dbs[0][k] = dbs[1][k] = 0.0f;
  for (int j = 0; j < NS - 1; ++j) issue(j);
  for (int j = 0; j < nb; ++j) {
    cp_async_wait_group<NS - 2>();
    __syncthreads();  // block j landed; block j - 1's stage is free
    issue(j + NS - 1);
    const bf16* xs = xs_of(j);
    // slots 1 .. 2 BP of kernel row kh0 + l's segment into d
    auto sum_db = [&](float (&d)[8], int l) {
      const bf16* ge = ge_of(j, l);
      const bf16* go = go_of(j, l);
      for (int sl = 1 + threadIdx.x / VG; sl <= 2 * BP; sl += G::DBG) {
        float f[8];
        unpack_bf16x8(*reinterpret_cast<const uint4*>(
                          (sl & 1 ? go : ge) + (sl >> 1) * LDG +
                          (threadIdx.x % VG) * 8),
                      f);
#pragma unroll
        for (int k = 0; k < 8; ++k) d[k] += f[k];
      }
    };
#pragma unroll
    for (int l = 0; l < KHN; ++l) {
      if (kh0 + l == 1) sum_db(dbs[0], l);
      if (kh0 + l == 2) sum_db(dbs[1], l);
    }
#pragma unroll
    for (int kq = 0; kq < BP / 16 / G::WARPS_K; ++kq) {
      const int ks = kq * G::WARPS_K + wk;
      unsigned a[G::WMT][4];
#pragma unroll
      for (int mt = 0; mt < G::WMT; ++mt)
        ldsm_x4_trans(a[mt], xs + (ks * 16 + lane % 8 + (lane / 16) * 8) *
                                      LDA +
                                 (wm * G::WMT + mt) * 16 +
                                 ((lane / 8) % 2) * 8);
#pragma unroll
      for (int t = 0; t < G::TAPS; ++t) {
        const int l = t / 3, kw = t % 3;
        const bf16* view =
            (kw == 1 ? go_of(j, l) : ge_of(j, l)) + (kw == 2 ? LDG : 0);
#pragma unroll
        for (int nt = 0; nt < G::WNT; ++nt) {
          unsigned bq[4];
          ldsm_x4_trans(bq, view + (ks * 16 + lane % 16) * LDG +
                                (wn * G::WNT + nt) * 16 + (lane / 16) * 8);
#pragma unroll
          for (int mt = 0; mt < G::WMT; ++mt) {
            mma_bf16_16816(acc[t][mt][2 * nt], a[mt], bq[0], bq[1]);
            mma_bf16_16816(acc[t][mt][2 * nt + 1], a[mt], bq[2], bq[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the stages are dead: the warp groups' sums and db's
                    // partials take their place
  float* red = reinterpret_cast<float*>(smem);
  float* dbr = red + G::WARPS_K * G::TAPS * CIN * COUT;
  const int g8 = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int t = 0; t < G::TAPS; ++t)
#pragma unroll
    for (int mt = 0; mt < G::WMT; ++mt)
#pragma unroll
      for (int n8 = 0; n8 < 2 * G::WNT; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (wm * G::WMT + mt) * 16 + g8 + 8 * h;
          const int c = wn * G::WNT * 16 + n8 * 8 + 2 * t4;
          float* d = red + ((wk * G::TAPS + t) * CIN + r) * COUT + c;
          d[0] = acc[t][mt][n8][2 * h];
          d[1] = acc[t][mt][n8][2 * h + 1];
        }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dbr[threadIdx.x * 8 + k] = dbs[0][k];
    dbr[(256 + threadIdx.x) * 8 + k] = dbs[1][k];
  }
  __syncthreads();
  float* dst = part_w + (long long)blockIdx.x * 9 * CIN * COUT;
  for (int e = threadIdx.x; e < G::TAPS * CIN * COUT; e += 256) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < G::WARPS_K; ++k)
      v += red[k * G::TAPS * CIN * COUT + e];
    const int t = e / (CIN * COUT), rc = e % (CIN * COUT);
    const int kh = kh0 + t / 3, kw = t % 3;
    dst[((2 - kh) * 3 + 2 - kw) * CIN * COUT + rc] = v;
  }
  if (threadIdx.x < 2 * COUT) {
    const int par = threadIdx.x / COUT, c = threadIdx.x % COUT;
    if (kh0 <= par + 1 && par + 1 < kh0 + KHN) {  // this CTA's kh = par + 1
      float v = 0.0f;
      for (int q = 0; q < G::DBG; ++q)
        v += dbr[(par * 256 + q * VG + c / 8) * 8 + c % 8];
      part_db[((long long)blockIdx.x * 2 + par) * COUT + c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// f32 forms
// ---------------------------------------------------------------------------

// Forward (f32): ups_fwd32.cuh's parity-plane product over halo patches,
// y = sum + bias; with S, the per-tile partials part[tile][2 COUT] = [sum
// y, sum y^2] of the stored y (the bf16 form's tiles, 4 x 32 input pixels).
template <bool S>
struct TrainOut32 {
  static constexpr bool STATS = S;
  const float* bias;
  float* y;
  float* part;
  __device__ float4 operator()(long long o, int ch, float4 v) const {
    const float4 b = make_float4(__ldg(bias + ch), __ldg(bias + ch + 1),
                                 __ldg(bias + ch + 2), __ldg(bias + ch + 3));
    const float4 r = make_float4(v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w);
    *reinterpret_cast<float4*>(y + o) = r;
    return r;
  }
};

template <int CIN, int COUT, bool S>
__global__ void __launch_bounds__(256, 1)
fwd32_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ bias, float* __restrict__ y,
             float* __restrict__ part, int B, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  ups_fwd32<CIN, COUT>(smem, x, w, B, H, W, TrainOut32<S>{bias, y, part});
}

// dx (f32): the bf16 form's halo-patch stride-2 conv of g (UpsDx) on FFMA
// micro-tiles,
//   dx[i, j] = sum_{kh, kw} g[2i - 1 + kh, 2j - 1 + kw] @ w[2 - kh, 2 - kw]^T
// A tile of TH x 32 dx pixels of one image stages its (2 TH + 1) x 65 g
// pixels once, 16-byte cp.async into four parity planes (PFPatch's
// geometry, f32 chunks swizzled by f32_swz, zero past the map:
// parity_plane.cuh pf_load_patch_f32), each tap a unit-stride view of
// one plane.  The taps stream from w (3, 3, N, K) as they are: stage s
// holds KS of the K values of w's tap t = s / SPT for every dx channel n
// (row n = w[t][n][k0 .. k0 + KS): the transpose is in the operand's
// indexing), in the order t = 0 .. 8, patch tap (2 - t / 3, 2 - t % 3)
// (the flip), through a ring of NS stages (NS - 1 in flight); at 64 -> 16
// the ring holds the whole f32 stack (36 KB) and only a CTA's first tile
// loads it.  At 128 -> 64 the stack (295 KB) exceeds a CTA's 227 KB: a
// tap (32 KB) a stage, two stages, beside two 2 x 32 tiles' 83 KB
// patches (231.9 KB in all; PERF.md §6 has the other layouts timed).
// Persistent CTAs: the next tile's patch travels with its first stage
// (the copies, PFRing, and the micro-tile, pf32_fma, are the f32
// downsampler forward's too).  Thread (rg, tc) owns dx pixels rg + i RS
// (i < TM) and channels tc + j TC (j < TN): per four k, TM float4 of the
// patch and TN of the stage (each a channel's k-contiguous row) and 4 TM
// TN FMAs;
// the RS pixels of one i are consecutive plane pixels and the TC
// channels consecutive rows, on distinct bank groups.  Sum order: one FMA
// chain per group of TPG taps over the group's (tap, k) in increasing
// order, the groups added in the order they stream.  The sums are staged
// in the tile's own patch buffer once it is read and whole dx pixels
// written 16 bytes a thread.
template <int K, int N>  // K = Cout (g's channels), N = Cin (dx's)
struct UpsDx32 {
  static constexpr bool WIDE = K == 64;
  static constexpr int TH = WIDE ? 2 : 4, TW = 32, BM = TH * TW;
  static constexpr int THREADS = 256, TN = 8, TC = N / TN;
  static constexpr int RS = THREADS / TC, TM = BM / RS;
  // k values a stage: a whole tap (scripts/cuda_ups_bwd_variants.py times
  // half taps)
  static constexpr int KS = K;
  static constexpr int SPT = K / KS, STAGES = 9 * SPT;  // a tap's, a tile's
  static constexpr int NS = WIDE ? 2 : STAGES;   // ring stages
  static constexpr int TPG = WIDE ? 1 : 3;       // taps a chain
  static constexpr int CTAS = WIDE ? 1 : 2;      // CTAs an SM
  static constexpr int VS = KS / 4, LDO = N + TC;
  using Geo = PFPatch<K, TH>;
  static constexpr size_t patch_bytes = pp_align((size_t)Geo::PIXELS * K * 4);
  static constexpr size_t stage_bytes = (size_t)N * KS * 4;
  static constexpr size_t ring_off = 2 * patch_bytes;  // two patches
  static constexpr size_t smem = ring_off + NS * stage_bytes;
  static_assert(K % KS == 0 && KS % 4 == 0 && N % TN == 0 && TC % 8 == 0 &&
                    THREADS % TC == 0 && BM % RS == 0 && 9 % TPG == 0 &&
                    (size_t)BM * LDO * 4 <= patch_bytes &&
                    CTAS * (smem + 1024) <= 233472,
                "f32 dx tile");
};

template <int K, int N>
__global__ void __launch_bounds__(256, UpsDx32<K, N>::CTAS)
dx32_kernel(const float* __restrict__ g, const float* __restrict__ w,
            float* __restrict__ dx, int B, int H, int W) {
  using G = UpsDx32<K, N>;
  using P = typename G::Geo;
  using Ring = PFRing<G::STAGES, G::NS>;
  constexpr int TM = G::TM, TN = G::TN, TC = G::TC, KS = G::KS;
  constexpr int VS = G::VS, SPT = G::SPT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles =
      B * ((H + G::TH - 1) / G::TH) * ((W + G::TW - 1) / G::TW);
  const int tc = threadIdx.x % TC, rg = threadIdx.x / TC;
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * G::patch_bytes);
  };
  auto stage_of = [&](int r) {
    return reinterpret_cast<float*>(smem + G::ring_off + r * G::stage_bytes);
  };
  auto patch = [&](int kk) {
    pf_load_patch_f32<P>(patch_of(kk), g,
                         pp_tile_of<G>(blockIdx.x + kk * gridDim.x, H, W),
                         H2, W2, G::THREADS);
  };
  // stage s: KS of the K values of w's tap s / SPT for every dx channel n
  // (row n = w[t][n][k0 .. k0 + KS), chunk e at e ^ f32_swz(n, VS))
  auto stage = [&](int r, int s) {
    float* dst = stage_of(r);
    const float* src = w + (size_t)(s / SPT) * N * K + (s % SPT) * KS;
    for (int c = threadIdx.x; c < N * VS; c += G::THREADS) {
      const int n = c / VS, e = c % VS;
      cp_async16(dst + n * KS + 4 * (e ^ f32_swz(n, VS)),
                 src + (size_t)n * K + 4 * e, true);
    }
  };
  int pr0[TM], pc0[TM];  // this thread's pixels in the tile
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = rg + i * G::RS;
    pr0[i] = m / G::TW;
    pc0[i] = m % G::TW;
  }
  // every channel tc + j TC of a stage row shares tc's swizzle (TC % 8 == 0)
  const int fb = f32_swz(tc, VS);

  Ring::start(tiles, patch, stage);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, H, W);
    const float* pb = patch_of(kk);
    float acc[TM][TN], part[TM][TN];
    zero_tile(acc);
    zero_tile(part);
    for (int s = 0; s < G::STAGES; ++s) {
      const float* bs = stage_of(Ring::next(kk, s, tiles, patch, stage)) +
                        tc * KS;
      const int tap = s / SPT;  // patch tap (2 - tap / 3, 2 - tap % 3)
      const PF32Tap<P, TM> a(pr0, pc0, 2 - tap / 3, 2 - tap % 3);
      // B: channel n's k-contiguous row, four k a float4
      pf32_fma<VS>(pb, a, (s % SPT) * VS, [&](int e, float (&bv)[4][TN]) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              bs + j * TC * KS + 4 * (e ^ fb));
          bv[0][j] = b.x; bv[1][j] = b.y; bv[2][j] = b.z; bv[3][j] = b.w;
        }
      }, part);
      if (s % SPT == SPT - 1 && tap % G::TPG == G::TPG - 1) {
        add_tile(acc, part);  // the group's chain ends
        zero_tile(part);
      }
    }
    __syncthreads();  // the patch is read: its buffer stages the output
    float* Cs = patch_of(kk);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Cs[(rg + i * G::RS) * G::LDO + tc + j * TC] = acc[i][j];
    __syncthreads();
    for (int c = threadIdx.x; c < G::BM * (N / 4); c += G::THREADS) {
      const int m = c / (N / 4), e = c % (N / 4);
      const int i = tl.i0 + m / G::TW, jj = tl.j0 + m % G::TW;
      if (i < H && jj < W)
        *reinterpret_cast<float4*>(
            dx + (((long long)tl.b * H + i) * W + jj) * N + 4 * e) =
            *reinterpret_cast<const float4*>(Cs + m * G::LDO + 4 * e);
    }
    // Cs is rewritten only by tile kk + 2's patch, issued after the next
    // tile's first barrier
  }
  cp_async_wait_all();
}

// Weight gradient (f32): the bf16 form's (chunk of input rows, kh) grid
// (UpsWg) on FFMA micro-tiles, as Wg32R is for the downsampler.
// blockIdx.x = a chunk of `rows_per` input rows (flattened over the batch;
// the wrapper sizes the chunks so that the grid is one wave of one CTA an
// SM, erf_ups_train_wg_rows_f32), blockIdx.y = khg: the CTA owns the KHN
// kernel rows kh = khg KHN .. + KHN - 1 (at 128 -> 64 one, at 64 -> 16 all
// three, so x is read once).  Each row in blocks of BP input pixels: a
// block stages its x tile (BP x CIN) once and, per kh, g's one
// high-resolution row segment, slot s the COUT values of column 2 j0 - 1
// + s (s < 2 BP + 1, zero past the map), read as the kh's im2col tile:
// pixel k's taps kw < 3 are slots 2 k + kw, one run of 3 COUT values at
// 2 k COUT (row pitch 2 COUT, column kw COUT + co).  So x is read 3 / KHN
// times and g 1.5 times.  The blocks stream through a ring of NS stages
// (NS - 1 in flight).  The product dW[kh] (CIN x 3 COUT) += x_tile^T seg
// runs as FFMA micro-tiles (no TF32) with the pixels as its depth: the
// threads form WK groups of an (RG x TC) grid, thread (rg, tc) owns rows 4
// rg + 4 RG a + (0 .. 3) and columns 4 tc + 4 TC b + (0 .. 3) of each of
// its kh, and group w takes pixels [w KL, (w + 1) KL) of every block; each
// output is one FMA chain per group, the groups added in order at the
// end.  db sums every g pixel once, as in bf16: the kh = 1 segments' slots
// 1 .. 2 BP (the even g rows) and the kh = 2 ones' (the odd); thread t
// takes the 4 channels of chunk t % VG at every DBG-th slot, the DBG
// threads of a chunk added in order at the end.  part_w[chunk] = dW (3, 3,
// CIN, COUT) HWIO, part_db[chunk][kh - 1] = db's partial over that kh's
// rows.
template <int CIN, int COUT>
struct UpsWg32 {
  static constexpr bool WIDE = CIN == 128;
  static constexpr int KHN = WIDE ? 1 : 3, KHG = 3 / KHN;
  static constexpr int MC = 3 * COUT;  // product columns of a kh: (kw, co)
  static constexpr int TM = 8, TN = WIDE ? 12 : 4;
  static constexpr int RG = CIN / TM, TC = MC / TN, GT = RG * TC;
  static constexpr int THREADS = WIDE ? 256 : 384, WK = THREADS / GT;
  static constexpr int BP = 64, KL = BP / WK;  // input pixels a block, a group's
  static constexpr int NS = 3, CTAS = 1;       // ring stages, CTAs an SM
  static constexpr int VG = COUT / 4, DBG = THREADS / VG;
  static constexpr size_t x_bytes = pp_align((size_t)BP * CIN * 4);
  static constexpr size_t seg_bytes =
      pp_align((size_t)(2 * BP + 1) * COUT * 4);
  static constexpr size_t stage_bytes = x_bytes + KHN * seg_bytes;
  static constexpr size_t red_bytes =
      ((WK > 1 ? (size_t)WK * KHN * CIN * MC : 0) + 2 * THREADS * 4) * 4;
  static constexpr size_t smem =
      NS * stage_bytes > red_bytes ? NS * stage_bytes : red_bytes;
  static_assert(CIN % TM == 0 && MC % TN == 0 && TM % 4 == 0 &&
                    TN % 4 == 0 && THREADS % GT == 0 && BP % WK == 0 &&
                    THREADS % VG == 0 && smem + 1024 <= 233472,
                "f32 upsampler wgrad tile");
};

template <int CIN, int COUT>
__global__ void __launch_bounds__(UpsWg32<CIN, COUT>::THREADS,
                                  UpsWg32<CIN, COUT>::CTAS)
wgrad32_kernel(const float* __restrict__ x, const float* __restrict__ g,
               float* __restrict__ part_w, float* __restrict__ part_db,
               int B, int H, int W, int rows_per) {
  using G = UpsWg32<CIN, COUT>;
  constexpr int BP = G::BP, NS = G::NS, KHN = G::KHN, MC = G::MC;
  constexpr int TM = G::TM, TN = G::TN, VG = G::VG, THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh0 = blockIdx.y * KHN;
  const int row0 = blockIdx.x * rows_per;
  const int rows = B * H - row0 < rows_per ? B * H - row0 : rows_per;
  const int bpr = (W + BP - 1) / BP, nb = rows * bpr;
  auto xs_of = [&](int j) {
    return reinterpret_cast<float*>(smem + (j % NS) * G::stage_bytes);
  };
  // kernel row kh0 + l's segment of block j
  auto seg_of = [&](int j, int l) {
    return reinterpret_cast<float*>(smem + (j % NS) * G::stage_bytes +
                                    G::x_bytes + l * G::seg_bytes);
  };
  // start staging block j (rows of the chunk, then blocks of a row)
  auto issue = [&](int j) {
    if (j < nb) {
      const int row = row0 + j / bpr, j0 = (j % bpr) * BP;
      const int img = row / H, i = row % H;
      float* xs = xs_of(j);
      const float* xrow = x + (long long)row * W * CIN;
      constexpr int VX = CIN / 4;
      for (int v = threadIdx.x; v < BP * VX; v += THREADS) {
        const int p = v / VX, e = v % VX;
        const bool ok = j0 + p < W;
        cp_async16(xs + p * CIN + 4 * e,
                   xrow + (ok ? (long long)(j0 + p) * CIN + 4 * e : 0), ok);
      }
#pragma unroll
      for (int l = 0; l < KHN; ++l) {
        const int hr = 2 * i - 1 + kh0 + l;  // < 2H
        float* seg = seg_of(j, l);
        const float* grow =
            g + ((long long)img * 2 * H + (hr >= 0 ? hr : 0)) * 2 * W * COUT;
        for (int v = threadIdx.x; v < (2 * BP + 1) * VG; v += THREADS) {
          const int sl = v / VG, e = v % VG, col = 2 * j0 - 1 + sl;
          const bool ok = hr >= 0 && col >= 0 && col < 2 * W;
          cp_async16(seg + sl * COUT + 4 * e,
                     grow + (ok ? (long long)col * COUT + 4 * e : 0), ok);
        }
      }
    }
    cp_async_commit();
  };

  const int w = threadIdx.x / G::GT, rg = (threadIdx.x % G::GT) / G::TC,
            tc = threadIdx.x % G::TC;
  float acc[KHN][TM][TN];
#pragma unroll
  for (int l = 0; l < KHN; ++l) zero_tile(acc[l]);
  float dbs[2][4];  // db over the even (kh = 1) and odd (kh = 2) rows
#pragma unroll
  for (int q = 0; q < 4; ++q) dbs[0][q] = dbs[1][q] = 0.0f;
  for (int j = 0; j < NS - 1; ++j) issue(j);
  for (int j = 0; j < nb; ++j) {
    cp_async_wait_group<NS - 2>();
    __syncthreads();  // block j landed; block j - 1's stage is free
    issue(j + NS - 1);
#pragma unroll
    for (int l = 0; l < KHN; ++l) {
      if (kh0 + l == 0) continue;
      const float* seg = seg_of(j, l) + 4 * (threadIdx.x % VG);
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int sl = 1 + threadIdx.x / VG; sl <= 2 * BP; sl += G::DBG) {
        const float4 v = *reinterpret_cast<const float4*>(seg + sl * COUT);
        d[0] += v.x;
        d[1] += v.y;
        d[2] += v.z;
        d[3] += v.w;
      }
      const bool odd = kh0 + l == 2;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dbs[0][q] += odd ? 0.0f : d[q];
        dbs[1][q] += odd ? d[q] : 0.0f;
      }
    }
    const float* a = xs_of(j) + w * G::KL * CIN + 4 * rg;
    const float* b[KHN];
#pragma unroll
    for (int l = 0; l < KHN; ++l)
      b[l] = seg_of(j, l) + w * G::KL * 2 * COUT + 4 * tc;
#pragma unroll 2
    for (int k = 0; k < G::KL; ++k) {
      float av[TM];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(a + k * CIN + q * 4 * G::RG);
        av[4 * q] = v.x; av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int l = 0; l < KHN; ++l) {
        float bv[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              b[l] + k * 2 * COUT + q * 4 * G::TC);
          bv[4 * q] = v.x; bv[4 * q + 1] = v.y;
          bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int n = 0; n < TN; ++n)
            acc[l][i][n] = fmaf(av[i], bv[n], acc[l][i][n]);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the stages are dead: the groups' sums and db's
                    // partials take their place
  float* red = reinterpret_cast<float*>(smem);
  float* dbr = red + (G::WK > 1 ? G::WK * KHN * CIN * MC : 0);
  float* dst = part_w + (long long)blockIdx.x * 9 * CIN * COUT;
  // kernel row kh, product column col = kw COUT + co -> the HWIO tap
  auto tap_at = [&](int kh, int col) {
    return dst + ((2 - kh) * 3 + 2 - col / COUT) * CIN * COUT + col % COUT;
  };
#pragma unroll
  for (int l = 0; l < KHN; ++l)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const int r = 4 * rg + (i / 4) * 4 * G::RG + i % 4;
        const int col = 4 * tc + q * 4 * G::TC;
        const float4 v =
            make_float4(acc[l][i][4 * q], acc[l][i][4 * q + 1],
                        acc[l][i][4 * q + 2], acc[l][i][4 * q + 3]);
        if constexpr (G::WK == 1)
          *reinterpret_cast<float4*>(tap_at(kh0 + l, col) + r * COUT) = v;
        else
          *reinterpret_cast<float4*>(
              red + (((size_t)w * KHN + l) * CIN + r) * MC + col) = v;
      }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dbr[threadIdx.x * 4 + q] = dbs[0][q];
    dbr[(THREADS + threadIdx.x) * 4 + q] = dbs[1][q];
  }
  __syncthreads();
  if constexpr (G::WK > 1)
    for (int e = threadIdx.x; e < KHN * CIN * MC; e += THREADS) {
      float v = 0.0f;
      for (int k = 0; k < G::WK; ++k) v += red[(size_t)k * KHN * CIN * MC + e];
      const int l = e / (CIN * MC), r = e / MC % CIN, col = e % MC;
      tap_at(kh0 + l, col)[r * COUT] = v;
    }
  if (threadIdx.x < 2 * COUT) {
    const int par = threadIdx.x / COUT, c = threadIdx.x % COUT;
    if (kh0 <= par + 1 && par + 1 < kh0 + KHN) {  // this CTA's kh = par + 1
      float v = 0.0f;
      for (int q = 0; q < G::DBG; ++q)
        v += dbr[(par * THREADS + q * VG + c / 4) * 4 + c % 4];
      part_db[((long long)blockIdx.x * 2 + par) * COUT + c] = v;
    }
  }
}

// ------------------------------- launchers --------------------------------

bool shape_ok(int B, int H, int W, int Cin, int Cout) {
  return ((Cin == 128 && Cout == 64) || (Cin == 64 && Cout == 16)) && B > 0 &&
         H > 0 && W > 0 && (long long)B * 4 * H * W * Cin < (1LL << 31);
}

// The backward's products: dx (persistent CTAs over its tiles), the
// weight gradient's partials (a chunk of `rows` input rows, KHG CTAs a
// chunk) and their two fixed-order reductions; F32: the f32 forms.
template <int CIN, int COUT, bool F32>
int bwd(const void* x, const void* g, const void* w, void* dx, void* part_w,
        void* part_db, void* grads, int B, int H, int W, int rows,
        cudaStream_t s) {
  using T = std::conditional_t<F32, float, bf16>;
  using D = std::conditional_t<F32, UpsDx32<COUT, CIN>, UpsDx<COUT, CIN>>;
  using G = std::conditional_t<F32, UpsWg32<CIN, COUT>, UpsWg<CIN, COUT>>;
  void (*dxk)(const T*, const T*, T*, int, int, int);
  void (*wgk)(const T*, const T*, float*, float*, int, int, int, int);
  if constexpr (F32) {
    dxk = dx32_kernel<COUT, CIN>;
    wgk = wgrad32_kernel<CIN, COUT>;
  } else {
    dxk = dx_kernel<COUT, CIN>;
    wgk = wgrad_kernel<CIN, COUT>;
  }
  static bool dx_ok = false, wg_ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(dxk, D::smem, &dx_ok);
  if (e != cudaSuccess) return e;
  if (gm == 0 &&
      (e = resident_ctas(dxk, D::THREADS, D::smem, &gm)) != cudaSuccess)
    return e;
  const int tiles = B * ((H + D::TH - 1) / D::TH) * ((W + D::TW - 1) / D::TW);
  dxk<<<tiles < gm ? tiles : gm, D::THREADS, D::smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx),
      B, H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = allow_smem(wgk, G::smem, &wg_ok)) != cudaSuccess) return e;
  const int chunks = (B * H + rows - 1) / rows;
  wgk<<<dim3(chunks, G::KHG), G::THREADS, G::smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(part_w), static_cast<float*>(part_db), B, H, W,
      rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        9 * CIN * COUT, s)) != cudaSuccess)
    return e;
  return reduce_parts(static_cast<const float*>(part_db), gr + 9 * CIN * COUT,
                      1, 2 * chunks, COUT, s);
}

// Both forms' entry: the g fold (with_stats), then bwd.
template <bool F32>
int bwd_entry(const void* x, const void* y, const void* gy, const void* gs1,
              const void* gs2, const void* w, void* g, void* dx,
              void* part_w, void* part_db, void* grads, int B, int H, int W,
              int Cin, int Cout, int rows, int with_stats, void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout) || rows < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  const void* gg = with_stats ? g : gy;
  if (with_stats &&
      (e = (F32 ? adjust_grad_f32 : adjust_grad)(
           gy, y, gs1, gs2, g, B, 4 * H * W, Cout, s)) != cudaSuccess)
    return e;
  return Cin == 128 ? bwd<128, 64, F32>(x, gg, w, dx, part_w, part_db,
                                        grads, B, H, W, rows, s)
                    : bwd<64, 16, F32>(x, gg, w, dx, part_w, part_db, grads,
                                       B, H, W, rows, s);
}

// Input rows per weight-gradient partial for a (B, H) map: chunks of
// ceil(B H KHG / (SMs CTAS)) rows, so that the grid of chunks x KHG CTAs
// is one wave of CTAS CTAs an SM of the current device; 0 on a CUDA error.
template <class Wide, class Narrow>
int wg_rows(int B, int H, int Cin) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    return 0;
  const int khg = Cin == 128 ? Wide::KHG : Narrow::KHG;
  const int ctas = sms * (Cin == 128 ? Wide::CTAS : Narrow::CTAS);
  return (int)(((long long)B * H * khg + ctas - 1) / ctas);
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

template <int CIN, int COUT, bool S>
int fwd_f32(const void* x, const void* w, const void* bias, void* y,
            void* part, void* stats, int B, int H, int W, cudaStream_t s) {
  using C = Ups32<CIN, COUT>;
  static_assert(C::TH == UpsCfg<CIN, COUT>::TH &&
                    C::TW == UpsCfg<CIN, COUT>::TW,
                "the f32 forward's partials are per bf16 tile");
  constexpr size_t smem = Ups32Smem<CIN, COUT>::smem;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(fwd32_kernel<CIN, COUT, S>, smem, &ok);
  if (e != cudaSuccess) return e;
  if (gm == 0 && (e = resident_ctas(fwd32_kernel<CIN, COUT, S>, C::THREADS,
                                    smem, &gm)) != cudaSuccess)
    return e;
  const int tpi = ups_tiles_per_image<CIN, COUT>(H, W), tiles = B * tpi;
  const int per = gm / C::NSPLIT > 0 ? gm / C::NSPLIT : 1;  // CTAs a split
  fwd32_kernel<CIN, COUT, S><<<dim3(tiles < per ? tiles : per, C::NSPLIT),
                               C::THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(part), B, H, W);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * COUT, s);
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
// (B, Cout) f32; w (3, 3, Cin, Cout) bf16, the forward-conv HWIO tap
// stack as the forward takes it, 16-byte aligned; g (B, 2H, 2W, Cout) bf16
// scratch (with_stats 0: gy is g, and y, gs1, gs2 and g are not read); dx
// (B, H, W, Cin) bf16; rows: input rows per weight-gradient partial
// (erf_ups_train_wg_rows); part_w (chunks, 9, Cin, Cout) and part_db
// (chunks, 2, Cout) f32 scratch with chunks = ceil(B H / rows); grads (9
// Cin Cout + Cout) f32 = [dW (3, 3, Cin, Cout) HWIO, db].
extern "C" int erf_ups_train_bwd(const void* x, const void* y, const void* gy,
                                 const void* gs1, const void* gs2,
                                 const void* w, void* g, void* dx,
                                 void* part_w, void* part_db, void* grads,
                                 int B, int H, int W, int Cin, int Cout,
                                 int rows, int with_stats, void* stream) {
  return bwd_entry<false>(x, y, gy, gs1, gs2, w, g, dx, part_w, part_db,
                          grads, B, H, W, Cin, Cout, rows, with_stats,
                          stream);
}

extern "C" int erf_ups_train_wg_rows(int B, int H, int Cin) {
  return wg_rows<UpsWg<128, 64>, UpsWg<64, 16>>(B, H, Cin);
}

// The f32 forms: x, y, gy, g and dx in f32, w (3, 3, Cin, Cout) f32 as
// the bf16 forms take it; the backward's rows from
// erf_ups_train_wg_rows_f32; the same scratch and outputs.
extern "C" int erf_ups_train_fwd_f32(const void* x, const void* w,
                                     const void* bias, void* y, void* part,
                                     void* stats, int B, int H, int W,
                                     int Cin, int Cout, int with_stats,
                                     void* stream) {
  if (!shape_ok(B, H, W, Cin, Cout)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cin == 128)
    return with_stats
               ? fwd_f32<128, 64, true>(x, w, bias, y, part, stats, B, H, W, s)
               : fwd_f32<128, 64, false>(x, w, bias, y, part, stats, B, H, W,
                                         s);
  return with_stats
             ? fwd_f32<64, 16, true>(x, w, bias, y, part, stats, B, H, W, s)
             : fwd_f32<64, 16, false>(x, w, bias, y, part, stats, B, H, W, s);
}

extern "C" int erf_ups_train_bwd_f32(const void* x, const void* y,
                                     const void* gy, const void* gs1,
                                     const void* gs2, const void* w, void* g,
                                     void* dx, void* part_w, void* part_db,
                                     void* grads, int B, int H, int W,
                                     int Cin, int Cout, int rows,
                                     int with_stats, void* stream) {
  return bwd_entry<true>(x, y, gy, gs1, gs2, w, g, dx, part_w, part_db,
                         grads, B, H, W, Cin, Cout, rows, with_stats, stream);
}

extern "C" int erf_ups_train_wg_rows_f32(int B, int H, int Cin) {
  return wg_rows<UpsWg32<128, 64>, UpsWg32<64, 16>>(B, H, Cin);
}
