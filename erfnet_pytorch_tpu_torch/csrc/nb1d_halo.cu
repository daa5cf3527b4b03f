// non_bottleneck_1d inference at C=64 and C=16, for maps of any size: one
// tile of the output per step, with its halo, all four stages on chip.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d.py:_nb1d_blocked_kernel
// (:315, reached by pl.pallas_call at :365 through _nb1d_blocked_call, via
// nb1d_infer_blocked / nb1d_infer_packed_blocked): the JAX package's
// kernel for an NB1d block whose map fails the whole-map budget.  At
// 1024x2048 those are the seven C=64 blocks at (B, 256, 512, 64) and the
// two C=16 blocks at (B, 512, 1024, 16), all at dilation 1.  The port runs
// it for every C=64 and C=16 block at any frame size: at 512x1024 too it
// beats nb1d.cu's whole-map launch.  The function is nb1d.cu's, at the
// same rounding points:
//
//   t1 = relu(conv3x1(x)      + b1)   -> bf16
//   t2 = relu(conv1x3(t1)     + b2)   -> bf16
//   t3 = relu(conv3x1_d(t2)   + b3)   -> bf16
//   y  = relu(conv1x3_d(t3)   + b4 + x) -> bf16
//
// Why not nb1d.cu's cooperative whole-map launch: that kernel passes t1
// and t2 through two scratch maps in device memory and relies on a map
// staying in the 50 MB L2.  At 1024x2048 the C=16 map alone is 64 MiB at
// B=4, so every stage would send its gather and its store through HBM.
// This kernel keeps what the TPU kernel keeps on chip: the TPU kernel
// takes an H-band of the map plus a halo of 1 + d rows into VMEM; a CTA's
// shared memory holds far less, so here a tile of TH x TW output pixels
// of one image plus its halo on both axes.  Working back from the output
// (relative to the tile's corner), the regions are
//
//   x : rows [-d-1, TH+d+1) x cols [-d-1, TW+d+1)   (TH+2d+2) x (TW+2d+2)
//   t1: rows [-d,   TH+d)   x cols [-d-1, TW+d+1)   (TH+2d)   x (TW+2d+2)
//   t2: rows [-d,   TH+d)   x cols [-d,   TW+d)     (TH+2d)   x (TW+2d)
//   t3: rows [0,    TH)     x cols [-d,   TW+d)      TH       x (TW+2d)
//   out: TH x TW, plus the residual x at the same pixels.
//
// Zero fill: an intermediate at a pixel outside the true map is the next
// conv's zero padding, so every stage stores 0 there, never relu(bias +
// ...) computed from zero-filled x (the JAX docstring's warning).  Each
// stage masks its store by the map's bounds; the x load zero-fills too,
// and the last stage writes only pixels inside the map, so a ragged edge
// (H or W not a multiple of the tile) needs nothing else.
//
// Each stage is an implicit GEMM of K = 3C: for an m16 tile of output
// pixels ldmatrix reads the three taps' rows straight out of the shifted
// shared-memory window (a pixel's C channels sit in one row of pitch C +
// 8, so the eight rows of an ldmatrix hit eight bank groups), and
// mma.sync m16n8k16 bf16 sums in f32.  The four tap stacks stay in shared
// memory for the CTA's whole life (persistent grid: one CTA per SM slot
// walks the tiles), so they are fetched once per CTA, not per tile.
//
// Tiles: C=64 takes 8x16 (x 240, t1 200, t2 180 pixels of 144 bytes: 89 KB,
// with 110 KB of tap stacks: 197 KB, one CTA of 12 warps per SM); C=16
// takes 16x32 (x 720, t1 648, t2 612 pixels of 48 bytes: 95 KB, with 9 KB
// of stacks: two CTAs of 8 warps per SM).  The halo costs 27 % more
// products at C=64 and reads x 1.4x at C=16.  t3 reuses t1's buffer.  The
// next tile's x is copied in with cp.async while stages 2-4 of this tile
// run: stage 4 reads the residual from device memory (issued before its
// product, so the load's latency hides behind it), which leaves x's
// buffer free after stage 1.  A warp's job is 32 pixels by C/2 channels
// at C=64 (stage 4 has only four 32-pixel chunks per tile), by all 16
// at C=16.
//
// Bound on this card (B=4, 1024x2048): a C=64 block is operation-bound
// (24 C^2 flops per pixel, 52 us), a C=16 block byte-bound (x read once,
// out written once, 40 us).  What keeps this version several times above
// them: a __syncthreads between stages with the warps unevenly loaded,
// few warps per SM to hide the ldmatrix -> mma latency, and stage 4's
// 4-byte stores straight from the accumulators.  wgmma on the tap
// stacks, the output staged through shared memory for 16-byte stores,
// and two tiles in flight per SM are the next steps.
#include "common.cuh"

using namespace erfk;

namespace {

template <int C>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int TH = 8, TW = 16, CTAS_PER_SM = 1, NS = 2;
  static constexpr int THREADS = 384;
};
template <>
struct Tile<16> {
  static constexpr int TH = 16, TW = 32, CTAS_PER_SM = 2, NS = 1;
  static constexpr int THREADS = 256;
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int C, int D>
struct Cfg {
  static constexpr int TH = Tile<C>::TH, TW = Tile<C>::TW;
  static constexpr int THREADS = Tile<C>::THREADS, WARPS = THREADS / 32;
  static constexpr int MT = 2;            // m16 tiles per warp job
  static constexpr int NS = Tile<C>::NS;  // output-channel parts per job
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
  static_assert(smem * Tile<C>::CTAS_PER_SM <= 227 * 1024, "shared memory");
};

// Start copying the x window of the tile whose output corner is (h0, w0)
// of image `img` (pointer to its first pixel): zero where it leaves the
// map.
template <int C, int D>
__device__ __forceinline__ void load_window(bf16* Xs, const bf16* img,
                                            int h0, int w0, int H, int W) {
  using G = Cfg<C, D>;
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

// One conv stage of a tile.  The output region is ROWS x COLS pixels whose
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
// warps idle in the last stage.
template <int C, int D, int ROWS, int COLS, int IN_COLS, int SR, int SC,
          bool LAST>
__device__ __forceinline__ void stage(const bf16* in, const bf16* Ws,
                                      const float* Bs, bf16* out_s,
                                      bf16* out_g, const bf16* x_g, int gh0,
                                      int gw0, int H, int W) {
  using G = Cfg<C, D>;
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
__global__ void __launch_bounds__(Tile<C>::THREADS, Tile<C>::CTAS_PER_SM)
nb1d_halo_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int H, int W, int tiles_h, int tiles_w, int tiles) {
  using G = Cfg<C, D>;
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
    load_window<C, D>(Xs, x + b * img_elems, (r / tiles_w) * G::TH,
                      (r % tiles_w) * G::TW, H, W);
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_img, r = tile % per_img;
    const int h0 = (r / tiles_w) * G::TH, w0 = (r % tiles_w) * G::TW;
    const bf16* xi = x + b * img_elems;
    cp_async_wait_all();  // this tile's window (and, once, the weights)
    __syncthreads();      // ... and the previous tile's stage 4 is done
    stage<C, D, G::R1, G::C1, G::C0, 1, 0, false>(
        Xs, Ws, Bs, T1, nullptr, nullptr, h0 - D, w0 - D - 1, H, W);
    __syncthreads();  // x's window is dead: fetch the next tile's
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int nb = next / per_img, nr = next % per_img;
      load_window<C, D>(Xs, x + nb * img_elems, (nr / tiles_w) * G::TH,
                        (nr % tiles_w) * G::TW, H, W);
    }
    stage<C, D, G::R2, G::C2, G::C1, 0, 1, false>(
        T1, Ws + WS, Bs + C, T2, nullptr, nullptr, h0 - D, w0 - D, H, W);
    __syncthreads();
    stage<C, D, G::R3, G::C3, G::C2, D, 0, false>(
        T2, Ws + 2 * WS, Bs + 2 * C, T1, nullptr, nullptr, h0, w0 - D, H,
        W);
    __syncthreads();
    stage<C, D, G::TH, G::TW, G::C3, 0, D, true>(
        T1, Ws + 3 * WS, Bs + 3 * C, nullptr, out + b * img_elems, xi, h0,
        w0, H, W);
  }
  cp_async_wait_all();
}

template <int C, int D>
int launch(const void* x, const void* w, const void* bias, void* out, int B,
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
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), H, W,
      tiles_h, tiles_w, tiles);
  return cudaGetLastError();
}

}  // namespace

// One block: out = nb1d(x).  x, out: (B, H, W, C) bf16; w: (4, 3, C, C)
// bf16 [conv, tap, cin, cout]; bias: (4, C) f32.  C in {16, 64} at
// dilation 1 (every block the JAX package sends to its blocked kernel at
// 1024x2048); anything else returns cudaErrorInvalidValue.  Returns the
// launch's error (cudaGetLastError()).
extern "C" int erf_nb1d_halo(const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int W, int C, int dil,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dil != 1) return cudaErrorInvalidValue;
  switch (C) {
    case 16: return launch<16, 1>(x, w, bias, out, B, H, W, s);
    case 64: return launch<64, 1>(x, w, bias, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}
