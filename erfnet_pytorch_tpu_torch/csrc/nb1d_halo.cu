// non_bottleneck_1d inference at C=64 and C=16, for maps of any size: one
// tile of the output per step, with its halo, all four stages on chip.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d.py:_nb1d_blocked_kernel
// (:315, reached by pl.pallas_call at :365 through _nb1d_blocked_call, via
// nb1d_infer_blocked / nb1d_infer_packed_blocked): the JAX package's
// kernel for an NB1d block whose map fails the whole-map budget.  At
// 1024x2048 those are the seven C=64 blocks at (B, 256, 512, 64) and the
// two C=16 blocks at (B, 512, 1024, 16), all at dilation 1.  The port runs
// it for every C=64 and C=16 block at any frame size (it also serves
// :_nb1d_kernel, :140, at 512x1024): there too it beats nb1d.cu's
// whole-map launch.  The function is nb1d.cu's, at the same rounding
// points:
//
//   t1 = relu(conv3x1(x)      + b1)   -> bf16
//   t2 = relu(conv1x3(t1)     + b2)   -> bf16
//   t3 = relu(conv3x1_d(t2)   + b3)   -> bf16
//   y  = relu(conv1x3_d(t3)   + b4 + x) -> bf16
//
// Why not nb1d.cu's cooperative whole-map launch: that kernel passes t1
// and t2 through two scratch maps in device memory and relies on a map
// staying in the 50 MB L2.  At 1024x2048 the C=16 map alone is 64 MiB at
// B=4, so every stage would send its copies and its stores through HBM.
// This kernel keeps what the TPU kernel keeps on chip: the TPU kernel
// takes an H-band of the map plus a halo of 1 + d rows into VMEM; a CTA's
// shared memory holds far less, so here a tile of TH x TW output pixels
// of one image plus its halo on both axes.
//
// The frame.  Every region of a tile has the x window's CW = TW + 2d + 2
// columns and is a run of whole frame rows (frame row rho at map row h0 -
// d - 1 + rho): x rows [0, TH + 2d + 2), t1 and t2 rows [1, TH + 2d + 1),
// t3 and y rows [d + 1, d + 1 + TH).  So each tap of each stage is its
// input region's pixels shifted by a constant (t1: +-CW, t2: +-1, t3:
// +-d CW, y: +-d), and in chunk-major planes (16 bytes of 8 channels a
// pixel, pixel after pixel) a tap's 64 rows are a wgmma A operand as
// they stand.  The columns a region computes past what the next stage
// needs (its first and last, whose W taps wrap into the next frame row)
// are never read by a pixel that matters (ops/cuda/nb1d_halo.py
// nb1d_halo_tiled_plain reads NaN there and equals the plain version).
// Each stage is bf16 wgmma m64nCk16 with both operands in shared memory,
// A the shifted region, B the stage's tap stack; the four stacks stay
// resident for the CTA's life, laid out once by the wrapper in core
// matrices (ops/cuda/nb1d.py wg_taps: 96 KB at C = 64, no padding).  The
// warpgroups take a stage's m64 blocks in turn; the epilogue stores 4
// bytes a lane into the next region's planes (8 rows of 16 bytes a store:
// no bank conflict).  Zero fill: an intermediate at a pixel outside the
// true map is the next conv's zero padding, so stages 1-3 store 0 there,
// never relu(bias + ...) of zero-filled x.  Stage 4 adds the residual x,
// loaded from device memory before its product, stages y into t2's planes,
// and the tile leaves in 16-byte stores of the pixels inside the map.  The
// next tile's x window copies in (cp.async) while stages 2-4 run.
//
// Tiles: 12 x 16 (5, 5, 4 and 4 m64 blocks a stage, four warpgroups, 208
// KB: one CTA an SM).  The frame's whole rows cost 1.5x the products the
// block needs (the m64 blocks included).  This is the C=64 block's form;
// the C=16 block keeps mma.sync stages (below).
//
// Bound on this card (B=4, 1024x2048): a C=64 block is operation-bound
// (24 C^2 flops per pixel, 52 us), a C=16 block byte-bound (x read once,
// out written once, 40 us).  What is left (scripts/
// cuda_nb1d_bf16_variants.py): the stages run one after another behind a
// __syncthreads each, a stage's last round of m64 blocks on fewer
// warpgroups than the CTA has.
#include "conv16.cuh"

using namespace erfk;

namespace {

// The output tile (TH x TW) and the warpgroups of a CTA, by C (the wgmma
// frame runs at C=64 only).
template <int C>
struct Halo;
template <>
struct Halo<64> {
  static constexpr int TH = 12, TW = 16, THREADS = 512, CTAS_PER_SM = 1;
};

// The frame: CW = TW + 2D + 2 columns for every region; frame row rho of
// the x window at map row h0 - D - 1 + rho, column kappa at w0 - D - 1 +
// kappa.  Each region is a run of whole frame rows, so each tap is a
// constant shift of the pixels of its input (see the file comment).
// Shared memory: the four tap stacks (wgmma layout), then x (PX pixels a
// plane), t1 (P1; t3 after stage 2) and t2 (P2; stage 4's output after
// stage 3), chunk-major planes of 16 bytes a pixel (PX and P2 odd: the
// 16-byte copies of a pixel's chunks fall on distinct bank groups), then
// slack for the reads of the rows past a region's last m64 block.
template <int C, int D>
struct Cfg {
  using T = Halo<C>;
  static constexpr int TH = T::TH, TW = T::TW, THREADS = T::THREADS;
  static constexpr int WGS = THREADS / 128, VK = C / 8, NA = C / 2;
  static constexpr int CW = TW + 2 * D + 2, R0 = TH + 2 * D + 2;
  static constexpr int M1 = (TH + 2 * D) * CW;  // t1, t2: rows [1, R0 - 1)
  static constexpr int M3 = TH * CW;            // t3, y: rows [D + 1, + TH)
  static constexpr int PX = R0 * CW | 1, P1 = M1, P2 = M1 | 1;
  static constexpr size_t w_bytes = (size_t)4 * 3 * C * C * 2;
  static constexpr size_t x_off = w_bytes;
  static constexpr size_t t1_off = x_off + (size_t)VK * PX * 16;
  static constexpr size_t t2_off = t1_off + (size_t)VK * P1 * 16;
  static constexpr size_t smem = t2_off + (size_t)VK * P2 * 16 + 128 * 16;
  static_assert(M3 <= M1 && smem * T::CTAS_PER_SM <= 232448,
                "halo tile shared memory");
};

// Start copying the x window of the tile whose output corner is (h0, w0)
// of image `img` (its first pixel) into X: frame pixel pix = rho CW +
// kappa, chunk e at X + e PX 8 + pix 8; zero where it leaves the map.
template <int C, int D>
__device__ __forceinline__ void load_window(bf16* X, const bf16* img, int h0,
                                            int w0, int H, int W) {
  using G = Cfg<C, D>;
  for (int v = threadIdx.x; v < G::R0 * G::CW * G::VK; v += G::THREADS) {
    const int pix = v / G::VK, e = v % G::VK;
    const int gh = h0 - D - 1 + pix / G::CW, gw = w0 - D - 1 + pix % G::CW;
    const bool valid = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const long long off = valid ? ((long long)gh * W + gw) * C + e * 8 : 0;
    cp_async16(X + e * G::PX * 8 + pix * 8, img + off, valid);
  }
  cp_async_commit();
}

// One stage of a tile: output pixels [0, M) of a region whose pixel u is
// frame pixel u + FIRST CW (FIRST: its first frame row), each the sum over
// taps t of in[u + t TAP + OFF] @ w[t], in chunk-major planes of pitch
// PIN; the warpgroups take its m64 blocks in turn.
//   !LAST: out = bf16(relu(acc + bias)), 0 outside the map (the next
//          conv's padding), into planes of pitch POUT.
//   LAST:  out = bf16(relu(acc + bias + x)), x loaded from device memory
//          before the product, into the staging planes (pitch POUT).
template <int C, int D, int M, int FIRST, int TAP, int OFF, int PIN,
          int POUT, bool LAST>
__device__ __forceinline__ void stage(const bf16* in, const bf16* Ws,
                                      const float* bias, bf16* out,
                                      const bf16* xi, int h0, int w0, int H,
                                      int W) {
  using G = Cfg<C, D>;
  constexpr int NA = G::NA, NT = C / 8, NB = (M + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const uint64_t db = wgmma_desc(Ws, C * 16, 128);
  for (int blk = warp / 4; blk < NB; blk += G::WGS) {
    int u[2];
    bool in_map[2];
    long long pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u[h] = blk * 64 + (warp % 4) * 16 + gid + 8 * h;
      const int rho = FIRST + u[h] / G::CW, kap = u[h] % G::CW;
      const int gh = h0 - D - 1 + rho, gw = w0 - D - 1 + kap;
      in_map[h] = u[h] < M && gh >= 0 && gh < H && gw >= 0 && gw < W;
      pix[h] = (long long)gh * W + gw;
    }
    unsigned res[2][LAST ? NT : 1];
    if constexpr (LAST) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kap = u[h] % G::CW;
        const bool need = in_map[h] && kap > D && kap <= D + G::TW;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          res[h][j] = need ? __ldg(reinterpret_cast<const unsigned*>(
                                 xi + pix[h] * C + 8 * j + 2 * tq))
                           : 0u;
      }
    }
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const uint64_t da =
          wgmma_desc(in + (blk * 64 + t * TAP + OFF) * 8, PIN * 16, 128);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        const uint64_t koff_a = (uint64_t)(2 * ks * PIN);
        const uint64_t koff_b = wg_tap_offset<C>(t, ks) >> 4;
        wgmma_bf16(acc, da + koff_a, db + koff_b, ks | t);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (u[h] >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = 8 * j + 2 * tq;
        float v0 = acc[4 * j + 2 * h] + __ldg(bias + c);
        float v1 = acc[4 * j + 2 * h + 1] + __ldg(bias + c + 1);
        if constexpr (LAST) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&res[h][j]));
          v0 += r.x;
          v1 += r.y;
        }
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
        if (!LAST && !in_map[h]) v0 = v1 = 0.0f;  // the next conv's padding
        *reinterpret_cast<__nv_bfloat162*>(out + (j * POUT + u[h]) * 8 +
                                           2 * tq) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int C, int D>
__global__ void __launch_bounds__(Halo<C>::THREADS, Halo<C>::CTAS_PER_SM)
nb1d_halo_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int H, int W, int tiles_h, int tiles_w, int tiles) {
  using G = Cfg<C, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* X = reinterpret_cast<bf16*>(smem + G::x_off);
  bf16* T1 = reinterpret_cast<bf16*>(smem + G::t1_off);
  bf16* T2 = reinterpret_cast<bf16*>(smem + G::t2_off);
  constexpr int WC = 3 * C * C;  // one conv's taps
  constexpr int CW = G::CW;
  for (int v = threadIdx.x; v < 4 * WC / 8; v += G::THREADS)
    cp_async16(Ws + v * 8, wg + v * 8, true);
  const long long img_elems = (long long)H * W * C;
  const int per_img = tiles_h * tiles_w;
  auto corner = [&](int t, int& b, int& h0, int& w0) {
    b = t / per_img;
    const int r = t % per_img;
    h0 = (r / tiles_w) * G::TH;
    w0 = (r % tiles_w) * G::TW;
  };
  int tile = blockIdx.x;
  if (tile < tiles) {
    int b, h0, w0;
    corner(tile, b, h0, w0);
    load_window<C, D>(X, x + b * img_elems, h0, w0, H, W);
  }
  for (; tile < tiles; tile += gridDim.x) {
    int b, h0, w0;
    corner(tile, b, h0, w0);
    const bf16* xi = x + b * img_elems;
    cp_async_wait_all();  // this tile's window (and, once, the weights)
    fence_async_smem();
    __syncthreads();      // ... and the previous tile's copy-out is done
    // t1 (frame rows [1, R0 - 1)): x rows rho - 1 .. rho + 1
    stage<C, D, G::M1, 1, CW, 0, G::PX, G::P1, false>(
        X, Ws, bias, T1, nullptr, h0, w0, H, W);
    fence_async_smem();
    __syncthreads();  // x's window is dead: fetch the next tile's
    const int next = tile + gridDim.x;
    if (next < tiles) {
      int nb, nh0, nw0;
      corner(next, nb, nh0, nw0);
      load_window<C, D>(X, x + nb * img_elems, nh0, nw0, H, W);
    }
    // t2 (rows [1, R0 - 1)): t1 columns kappa - 1 .. kappa + 1
    stage<C, D, G::M1, 1, 1, -1, G::P1, G::P2, false>(
        T1, Ws + WC, bias + C, T2, nullptr, h0, w0, H, W);
    fence_async_smem();
    __syncthreads();
    // t3 (rows [D + 1, + TH), in t1's planes): t2 rows rho - D .. rho + D
    stage<C, D, G::M3, D + 1, D * CW, 0, G::P2, G::P1, false>(
        T2, Ws + 2 * WC, bias + 2 * C, T1, nullptr, h0, w0, H, W);
    fence_async_smem();
    __syncthreads();
    // y (rows [D + 1, + TH), staged in t2's planes): t3 columns kappa - D
    // .. kappa + D, + x
    stage<C, D, G::M3, D + 1, D, -D, G::P1, G::P2, true>(
        T1, Ws + 3 * WC, bias + 3 * C, T2, xi, h0, w0, H, W);
    __syncthreads();
    // the tile's TH x TW pixels of y inside the map, 16 bytes a copy
    bf16* oi = out + b * img_elems;
    for (int i = threadIdx.x; i < G::TH * G::TW * G::VK; i += G::THREADS) {
      const int p = i / G::VK, e = i % G::VK;
      const int r = p / G::TW, c = p % G::TW;
      const int gh = h0 + r, gw = w0 + c;
      if (gh >= H || gw >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          T2 + (e * G::P2 + r * CW + c + D + 1) * 8);
      bf16* dst = oi + ((long long)gh * W + gw) * C + e * 8;
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
  cp_async_wait_all();
}

template <int C, int D>
int launch(const void* x, const void* wg, const void* bias, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using G = Cfg<C, D>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: the persistent grid
  cudaError_t e = allow_smem(nb1d_halo_kernel<C, D>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_halo_kernel<C, D>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const int tiles_w = (W + G::TW - 1) / G::TW;
  // map offsets are 64-bit; the tile index is an int
  if ((long long)B * tiles_h * tiles_w >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = B * tiles_h * tiles_w;
  if (tiles == 0) return cudaSuccess;
  const int grid = tiles < grid_max ? tiles : grid_max;
  nb1d_halo_kernel<C, D><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W,
      tiles_h, tiles_w, tiles);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The C=16 block's product: mma.sync stages over exact regions (this
// kernel's first design), faster there than the wgmma frame: a C=16
// block is byte-bound and its wgmma is three m64n16k16 a block, whose
// issue, commit and wait per block cost more than the product
// (scripts/cuda_nb1d_bf16_variants.py c16_wgmma).  Each stage is an
// implicit GEMM of K = 3C: for an m16 tile of output pixels ldmatrix reads
// the three taps' rows straight out of the shifted shared-memory window (a
// pixel's C channels in one row of pitch C + 8), and mma.sync m16n8k16
// sums in f32; the regions are exact (x 20 x 36, t1 18 x 36, t2 18 x 34,
// t3 16 x 34 pixels of a 16 x 32 tile), the four padded tap stacks
// resident, two CTAs of 8 warps an SM, a warp's job 32 pixels by all 16
// channels.
// ---------------------------------------------------------------------------

template <int C>
struct MmaTile;
template <>
struct MmaTile<16> {
  static constexpr int TH = 16, TW = 32, CTAS_PER_SM = 2, NS = 1;
  static constexpr int THREADS = 256;
};

template <int C, int D>
struct MmaCfg {
  static constexpr int TH = MmaTile<C>::TH, TW = MmaTile<C>::TW;
  static constexpr int THREADS = MmaTile<C>::THREADS, WARPS = THREADS / 32;
  static constexpr int MT = 2;            // m16 tiles per warp job
  static constexpr int NS = MmaTile<C>::NS;  // output-channel parts a job
  static constexpr int LD = C + 8, K = 3 * C;
  static constexpr int R0 = TH + 2 * D + 2, C0 = TW + 2 * D + 2;  // x
  static constexpr int R1 = TH + 2 * D, C1 = TW + 2 * D + 2;      // t1
  static constexpr int R2 = TH + 2 * D, C2 = TW + 2 * D;          // t2
  static constexpr int R3 = TH, C3 = TW + 2 * D;                  // t3
  static_assert(R3 * C3 <= R1 * C1, "t3 reuses t1's buffer");
  static constexpr size_t w_bytes = align128((size_t)4 * K * LD * 2);
  static constexpr size_t b_bytes = align128((size_t)4 * C * 4);
  static constexpr size_t x_bytes = align128((size_t)R0 * C0 * LD * 2);
  static constexpr size_t t1_bytes = align128((size_t)R1 * C1 * LD * 2);
  static constexpr size_t t2_bytes = align128((size_t)R2 * C2 * LD * 2);
  static constexpr size_t smem =
      w_bytes + b_bytes + x_bytes + t1_bytes + t2_bytes;
  static_assert(smem * MmaTile<C>::CTAS_PER_SM <= 227 * 1024,
                "shared memory");
};

// Start copying the x window of the tile whose output corner is (h0, w0)
// of image `img` (pointer to its first pixel): zero where it leaves the
// map.
template <int C, int D>
__device__ __forceinline__ void mma_window(bf16* Xs, const bf16* img,
                                            int h0, int w0, int H, int W) {
  using G = MmaCfg<C, D>;
  constexpr int VPP = C / 8;  // 16-byte vectors per pixel
  for (int v = threadIdx.x; v < G::R0 * G::C0 * VPP; v += G::THREADS) {
    const int pix = v / VPP, j = v % VPP;
    const int gh = h0 - D - 1 + pix / G::C0, gw = w0 - D - 1 + pix % G::C0;
    const bool valid = gh >= 0 && gh < H && gw >= 0 && gw < W;
    const long long off = valid ? ((long long)gh * W + gw) * C + j * 8 : 0;
    cp_async16(Xs + pix * G::LD + j * 8, img + off, valid);
  }
  cp_async_commit();
}

// One conv mma_stage of a tile.  The output region is ROWS x COLS pixels whose
// (0, 0) lies at map pixel (gh0, gw0); the input region has IN_COLS
// columns, and output (r, c) reads input (r + t SR, c + t SC) for taps
// t = 0, 1, 2 (SR = d, SC = 0 for a conv along H; SR = 0, SC = d along W):
//
//   out(r, c) = relu(sum_t in(r + t SR, c + t SC) @ w[t] + bias [+ x])
//
// !LAST: into shared memory (pitch LD), 0 outside the map.  LAST: the
// residual x is added from device memory and only pixels inside the map
// are written, to the image's output.  A warp's job is MT x 16 output
// pixels by C / NS output channels: the four stages have 7, 6, 5 and 4
// chunks of 32 pixels at C=64, so whole chunks would leave half the
// warps idle in the last mma_stage.
template <int C, int D, int ROWS, int COLS, int IN_COLS, int SR, int SC,
          bool LAST>
__device__ __forceinline__ void mma_stage(const bf16* in, const bf16* Ws,
                                      const float* Bs, bf16* out_s,
                                      bf16* out_g, const bf16* x_g, int gh0,
                                      int gw0, int H, int W) {
  using G = MmaCfg<C, D>;
  constexpr int LD = G::LD, MT = G::MT, NS = G::NS, CN = C / NS;
  constexpr int M = ROWS * COLS, CH = 16 * MT, NT = CN / 8;
  constexpr int JOBS = (M + CH - 1) / CH * NS;
  constexpr int TAP = (SR * IN_COLS + SC) * LD;  // one tap's offset
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int job = warp; job < JOBS; job += G::WARPS) {
    const int ch = job / NS, n0 = (job % NS) * CN;
    // ldmatrix rows: A row lane % 16 of each m16 tile at column half
    // lane / 16; B (k-major) rows lane % 16 at column half lane / 16
    const bf16* b_row = Ws + (lane % 16) * LD + n0 + (lane / 16) * 8;
    const bf16* a_row[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int m = ch * CH + mt * 16 + lane % 16;
      m = m < M ? m : M - 1;  // rows past the region read a valid pixel
      a_row[mt] = in + ((m / COLS) * IN_COLS + m % COLS) * LD +
                  (lane / 16) * 8;
    }
    // thread (g, q) = (lane / 4, lane % 4) holds rows g and g + 8 of each
    // m16 tile, columns 2q and 2q + 1 of each n8 tile
    bool in_map[MT][2];
    long long pix[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ch * CH + mt * 16 + lane / 4 + 8 * h;
        const int gh = gh0 + m / COLS, gw = gw0 + m % COLS;
        in_map[mt][h] = gh >= 0 && gh < H && gw >= 0 && gw < W;
        pix[mt][h] = (long long)gh * W + gw;
      }
    // the residual, loaded before the product so that its latency hides
    // behind it
    unsigned res[MT][2][LAST ? NT : 1];
    if constexpr (LAST) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            res[mt][h][n] =
                in_map[mt][h]
                    ? __ldg(reinterpret_cast<const unsigned*>(
                          x_g + pix[mt][h] * C + n0 + n * 8 + 2 * (lane % 4)))
                    : 0u;
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        unsigned a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(a[mt], a_row[mt] + t * TAP + kc * 16);
#pragma unroll
        for (int n = 0; n < CN / 16; ++n) {
          unsigned b[4];
          ldsm_x4_trans(b, b_row + (t * C + kc * 16) * LD + n * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * n], a[mt], b[0], b[1]);
            mma_bf16_16816(acc[mt][2 * n + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ch * CH + mt * 16 + lane / 4 + 8 * h;
        if (m >= M || (LAST && !in_map[mt][h])) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n0 + n * 8 + 2 * (lane % 4);
          float v0 = acc[mt][n][2 * h] + Bs[col];
          float v1 = acc[mt][n][2 * h + 1] + Bs[col + 1];
          if constexpr (LAST) {
            const float2 r = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&res[mt][h][n]));
            v0 += r.x;
            v1 += r.y;
          }
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          if (!in_map[mt][h]) v0 = v1 = 0.f;  // the next conv's padding
          const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
          if constexpr (LAST)
            *reinterpret_cast<__nv_bfloat162*>(out_g + pix[mt][h] * C +
                                               col) = o;
          else
            *reinterpret_cast<__nv_bfloat162*>(out_s + m * LD + col) = o;
        }
      }
  }
}

template <int C, int D>
__global__ void __launch_bounds__(MmaTile<C>::THREADS, MmaTile<C>::CTAS_PER_SM)
nb1d_halo_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int H, int W, int tiles_h, int tiles_w, int tiles) {
  using G = MmaCfg<C, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  float* Bs = reinterpret_cast<float*>(smem + G::w_bytes);
  bf16* Xs = reinterpret_cast<bf16*>(smem + G::w_bytes + G::b_bytes);
  bf16* T1 = reinterpret_cast<bf16*>(smem + G::w_bytes + G::b_bytes +
                                     G::x_bytes);
  bf16* T2 = reinterpret_cast<bf16*>(smem + G::w_bytes + G::b_bytes +
                                     G::x_bytes + G::t1_bytes);
  constexpr int WS = G::K * G::LD;  // one tap stack in shared memory
  for (int s = 0; s < 4; ++s)
    load_matrix(Ws + s * WS, G::LD, w + s * 3 * C * C, G::K, C);
  for (int i = threadIdx.x; i < 4 * C; i += G::THREADS) Bs[i] = bias[i];
  const long long img_elems = (long long)H * W * C;
  const int per_img = tiles_h * tiles_w;

  int tile = blockIdx.x;
  if (tile < tiles) {
    const int b = tile / per_img, r = tile % per_img;
    mma_window<C, D>(Xs, x + b * img_elems, (r / tiles_w) * G::TH,
                      (r % tiles_w) * G::TW, H, W);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_img, r = tile % per_img;
    const int h0 = (r / tiles_w) * G::TH, w0 = (r % tiles_w) * G::TW;
    const bf16* xi = x + b * img_elems;
    cp_async_wait_all();  // this tile's window (and, once, the weights)
    __syncthreads();      // ... and the previous tile's mma_stage 4 is done
    mma_stage<C, D, G::R1, G::C1, G::C0, 1, 0, false>(
        Xs, Ws, Bs, T1, nullptr, nullptr, h0 - D, w0 - D - 1, H, W);
    __syncthreads();  // x's window is dead: fetch the next tile's
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int nb = next / per_img, nr = next % per_img;
      mma_window<C, D>(Xs, x + nb * img_elems, (nr / tiles_w) * G::TH,
                        (nr % tiles_w) * G::TW, H, W);
    }
    mma_stage<C, D, G::R2, G::C2, G::C1, 0, 1, false>(
        T1, Ws + WS, Bs + C, T2, nullptr, nullptr, h0 - D, w0 - D, H, W);
    __syncthreads();
    mma_stage<C, D, G::R3, G::C3, G::C2, D, 0, false>(
        T2, Ws + 2 * WS, Bs + 2 * C, T1, nullptr, nullptr, h0, w0 - D, H,
        W);
    __syncthreads();
    mma_stage<C, D, G::TH, G::TW, G::C3, 0, D, true>(
        T1, Ws + 3 * WS, Bs + 3 * C, nullptr, out + b * img_elems, xi, h0,
        w0, H, W);
  }
  cp_async_wait_all();
}

template <int C, int D>
int launch_mma(const void* x, const void* w, const void* bias, void* out,
               int B, int H, int W, cudaStream_t stream) {
  using G = MmaCfg<C, D>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: the persistent grid
  cudaError_t e = allow_smem(nb1d_halo_mma_kernel<C, D>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_halo_mma_kernel<C, D>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const int tiles_w = (W + G::TW - 1) / G::TW;
  // map offsets are 64-bit; the tile index is an int
  if ((long long)B * tiles_h * tiles_w >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = B * tiles_h * tiles_w;
  if (tiles == 0) return cudaSuccess;
  const int grid = tiles < grid_max ? tiles : grid_max;
  nb1d_halo_mma_kernel<C, D><<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W,
      tiles_h, tiles_w, tiles);
  return cudaGetLastError();
}


}  // namespace

// One block: out = nb1d(x).  x, out: (B, H, W, C) bf16; w: (4, 3, C, C)
// bf16 [conv, tap, cin, cout] (the C=16 mma.sync stages read it); wg:
// (4, 3, C C) bf16, the same tap stacks laid out for wgmma
// (ops/cuda/nb1d.py wg_taps; the C=64 frame reads it); bias: (4, C) f32.
// C in {16, 64} at dilation 1 (every block the JAX package sends to its
// blocked kernel at 1024x2048); anything else returns
// cudaErrorInvalidValue.  Returns the launch's error (cudaGetLastError()).
extern "C" int erf_nb1d_halo(const void* x, const void* w, const void* wg,
                             const void* bias, void* out, int B, int H,
                             int W, int C, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dil != 1) return cudaErrorInvalidValue;
  switch (C) {
    case 16: return launch_mma<16, 1>(x, w, bias, out, B, H, W, s);
    case 64: return launch<64, 1>(x, wg, bias, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}
