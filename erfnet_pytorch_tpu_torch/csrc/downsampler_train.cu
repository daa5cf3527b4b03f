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
// Forward (bf16, down_fwd.cuh, which the eval block in downsampler.cu
// shares): the stride-2 conv over the parity planes of a halo patch
// (parity_plane.cuh, PFPatch): a tile of TH x 32 output pixels of one image
// (TH = 2 at Cin = 64, 4 at 16, 8 at 3) stages its (2 TH + 1) x 65 input
// pixels once with 16-byte cp.async straight into four parity planes,
// where each of the nine taps is a shifted, unit-stride ldmatrix view
// (9 Cin Cc MACs a pixel on mma.sync, the (9 Cin x Cc) tap stack resident
// in shared memory, read from w as it is); the pool is taps 4, 5, 7, 8 of
// the same patch.  Persistent CTAs: the next tile's patch is in flight
// while this one multiplies.  The epilogue stages whole output pixels
// (conv channels rounded from f32, then the pool channels) and writes them
// 16 bytes a thread; the sums come from the stored values, reduced across
// the CTA in a fixed order into one partial per tile, and a second launch
// adds the partials in a fixed order.  At Cin = 3 (PFRaw) a patch row is
// one run of 65 x 3 values staged in 4-byte words (the stem's shifted by
// its translate, rounded to bf16 once in an im2col tile of K = 27 padded
// to 32); the stem writes the translated image's tile interior from the
// patch.
//
// Input gradient (bf16): the conv's input gradient is the transposed
// conv's parity-plane product (parity_plane.cuh): g pixel (i, j) gives
// the 2x2 input block (2i + a, 2j + b) from g at (i, j), (i+1, j),
// (i, j+1), (i+1, j+1) and nine (Cc x Cin) blocks, each a flipped,
// transposed tap (the wrapper's wt, the taps as they are: 9 Cin Cc MACs a
// g pixel where a 3x3 implicit GEMM per input pixel with the stride's
// zeros does 36).  The tile's g patch is gathered once for all four
// planes, the weight blocks stream through a cp.async ring, persistent
// CTAs; the epilogue adds the pool's share from x's 2x2 window and g's
// pool channels and writes whole output rows, 16 bytes a thread.  The
// stats fold stays a launch of its own (adjust_grad, into a g scratch):
// folded into both products' loads it read y beside gy in each, three
// times in the weight gradient, and cost more than the pass (PERF.md §6).
//
// Weight gradient (bf16): per (chunk of ROWS output rows, kh) partials:
// a block of BP output pixels of one row stages its g tile once and the
// one input-row segment (2 BP + 1 pixels) its kh needs; the three kw taps
// are stride-2 views of it, so g is read three times (once per kh), not
// nine; double-buffered; the partials reduced in a fixed order.
//
// Bound on this card: bytes (the products are small next to the maps they
// read).  What is left: the input gradient's epilogue reads x's window once
// per output pixel, four times in all; the weight gradient's partials (a
// chunk of 4 rows at 64 -> 64 is 144 CTAs, 1.1 per SM) and its scalar
// loads of the 3-channel image; wgmma and TMA nowhere.
//
// The f32 forms (erf_down_train_*_f32, the JAX package's default compute
// dtype): the same function with every map in f32 and nothing rounded to
// bf16; the stem translates the f32 image without a cast and saves it in
// f32.  Products on the CUDA cores (FFMA micro-tiles, common.cuh
// ffma_tile; no TF32).  The forward at Cin = 3 (the stem,
// and the stats-free 3-channel map; down_fwd32.cuh down_fwd3_f32_kernel,
// which the f32 eval block runs too) is the bf16 form's tile kept in f32:
// persistent CTAs over tiles of 8 x 32 output pixels, each tile's raw f32
// patch (PFRaw<true>: rows of 65 x 3 values, the stem's shifted by its
// translate with zero fill) staged once with coalesced 4-byte cp.async
// while the previous tile computes, tile coordinates computed once a tile
// (no per-element 64-bit division); an im2col tile of K = 27 (padded to
// 28) built from the patch, the 13 conv channels one FFMA chain per
// output in the plain version's (tap, ci) order and the pool channels
// from the same patch; whole 64-byte output pixels written 16 bytes a
// thread, the sums from the stored values in a fixed butterfly, one
// partial per tile (3072 at the B=6 stem, 6144 before); the stem's
// translated image written from the patch interior.  The forwards at Cin
// = 16 and 64 are the bf16 form's halo-patch conv on FFMA micro-tiles
// (Fwd32, down_fwd32_kernel): tiles of 4 x 32 / 2 x 32 output pixels, each
// (2 TH + 1) x 65 patch staged once in four parity planes with XOR-
// swizzled 16-byte chunks (parity_plane.cuh: the patch loader, the tap
// ring and the micro-tile of the f32 upsampler's dx), each tap a
// unit-stride view, 9 Cin Cc
// MACs a pixel against the tap stack as it is; at Cin = 16 the 27 KB
// stack resident and two CTAs an SM, at 64 a tap (16 KB) a stage through
// a 3-stage ring beside two 83 KB patches; the pool from the same patch;
// one FMA chain per kh row (Cin = 16) or tap (64), added in tap order.
// They replaced an im2col implicit GEMM (each input pixel gathered about
// 2.25 times a tap at a time, no copy overlapping the product, a zero-
// padded weight matrix built per call, the pool read again from the map;
// 0.448 ms a B=6 step against cuDNN's 0.347, PERF.md §6).
// The input gradient at Cin = 16 and 64 is the bf16 form's parity-plane
// product on FFMA micro-tiles (Dx32): per tile of TH x 32 g pixels (TH =
// 4 at Cin = 16, 2 at 64) the (TH + 1) x 33 patch of g's conv channels is
// staged once, the four neighbour operands views of it, the nine
// flipped, transposed taps resident (27 KB and 147 KB, beside two
// patches), persistent CTAs with the next patch in flight; 9 Cin Cc MACs
// a g pixel where the implicit GEMM per input pixel this replaced
// multiplied the stride's zero taps too (36); one FMA chain per unit, the
// units added to each plane in a fixed order; the pool's share from x's
// window and g's pool channels read once per g pixel, 16 bytes a lane.
// The weight gradient keeps the bf16 form's (chunk of output rows, kh)
// grid in f32 at every (Cin, Cc): per block of output pixels the g tile
// and each kh's input-row segment, which is the kh's im2col tile as it is
// (row pitch 2 Cin), staged through a cp.async ring (coalesced 4-byte
// copies of the 3-channel run at Cin = 3, 16-byte ones at 16 and 64); an
// FFMA micro-tile product with the pixels as its depth; one partial per
// (row chunk), the chunks sized to one wave from the SM count.  The same
// launches as the bf16 forms, the partials reduced in a fixed order.
// Bound at f32: bytes for the stem, operations for the others (9 Cin Cc
// MACs per output pixel against 67 TFLOP/s; 0.0947 ms for the two
// forwards at Cin = 16 and 64 of a B=6 step).  What is left at f32: the
// forwards' products read a 16-byte operand for every 7 or 8 FMAs; in
// the input gradient the pool's share (x's windows, g's pool channels)
// and the dx stores follow the product in each CTA, and at Cin = 64 one
// CTA an SM leaves nothing to run beside them: the maps' traffic and the
// product add up (PERF.md §6, scripts/cuda_down_dx32_variants.py).
//
// The stats-free forms (with_stats = 0) replace downsampler_packed
// (_down_fwd_kernel via _call_fwd_local, with the pool lanes that
// down_pool_packed adds in XLA, and _down_bwd_kernel via _call_bwd_local
// on g = gy with the pool's VJP): the forward writes the same y without
// the per-tile partials and skips their reduction; the backward starts
// from gy (no g fold) and always gives dx, also at Cin = 3 (an ordinary
// 3-channel map, not the stem's translated image: the stem mode is a
// flag of its own, apart from the channel count).  At Cin = 3 the input
// gradient is a direct sum (down_dx_small_kernel): its K of 9 x 13 and
// N of 3 are too narrow for the tiled products.
#include "down_fwd.cuh"
#include "down_fwd32.cuh"

using namespace erfk;

namespace {

constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// Input gradient: the conv's, as the parity-plane product
// (parity_plane.cuh, FLIP) of g's CC conv channels (the A map, (B, Ho, Wo)
// at channel stride CIN + CC) and the (3, 3, CC, CIN) transposed tap
// stack, rounded to bf16, plus the pool's share: for g pixel (i, j), the
// 2x2 input block (2i + a, 2j + b) is
//   dx = bf16(bf16(sum_q g[(i, j) + e_q] @ W(q, plane)) + pool share)
template <int CIN, int CC>
using DxCfg = PPCfg<CC, CIN, CIN == 64 ? 2 : 4, CIN == 64 ? 4 : 9>;

template <class C>
struct DownDxEpi {
  static constexpr int CIN = C::N, CC = C::K, COUT = CIN + CC;
  int tiles, H, W;  // the g map's (Ho, Wo)
  const bf16* g;    // (B, Ho, Wo, COUT)
  const bf16* x;    // the forward's input (B, 2 Ho, 2 Wo, CIN)
  bf16* dx;
  __device__ float pre(float v, int) const { return v; }
  // half a: input rows 2 i + a of the tile; a thread: 8 channels of one
  // input pixel at a time, its pool window's x and g's pool channels read
  // from the maps
  __device__ void out(int a, PPTile tl, const bf16* Cs) const {
    const int H2 = 2 * H, W2 = 2 * W;
    for (int e = threadIdx.x; e < C::TH * 2 * C::TW * C::VN;
         e += C::THREADS) {
      const int pix = e / C::VN, j = e % C::VN;
      const int r = pix / (2 * C::TW), pc = pix % (2 * C::TW);
      const int i = tl.i0 + r, jj = tl.j0 + pc / 2, b = pc & 1;
      if (i >= H || jj >= W) continue;
      float conv[8], x00[8], x01[8], x10[8], x11[8], gp[8], o[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(Cs + pix * C::LDN + j * 8),
                    conv);
      const bf16* win =
          x + (((long long)tl.b * H2 + 2 * i) * W2 + 2 * jj) * CIN + j * 8;
      load8(win, x00);
      load8(win + CIN, x01);
      load8(win + (long long)W2 * CIN, x10);
      load8(win + (long long)W2 * CIN + CIN, x11);
      load8(g + (((long long)tl.b * H + i) * W + jj) * COUT + CC + j * 8, gp);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float m0v = fmaxf(x00[k], x01[k]);
        const float m1v = fmaxf(x10[k], x11[k]);
        const float mp = fmaxf(m0v, m1v), mr = a ? m1v : m0v;
        const float x0 = a ? x10[k] : x00[k], x1 = a ? x11[k] : x01[k];
        float share = 0.0f;
        if (mr == mp) {
          const float gr = gp[k] / (float)((m0v == mp) + (m1v == mp));
          if ((b ? x1 : x0) == mr)
            share = gr / (float)((x0 == mr) + (x1 == mr));
        }
        o[k] = conv[k] + share;
      }
      *reinterpret_cast<uint4*>(
          dx + (((long long)tl.b * H2 + 2 * i + a) * W2 + 2 * tl.j0 + pc) *
                   CIN + j * 8) = pack_bf16x8(o);
    }
  }
  __device__ void end_tile(int) const {}
};

template <int CIN, int CC>
__host__ __device__ constexpr int dx_tiles_per_image(int Ho, int Wo) {
  return ((Ho + DxCfg<CIN, CC>::TH - 1) / DxCfg<CIN, CC>::TH) *
         ((Wo + 31) / 32);
}

template <int CIN, int CC>
__global__ void __launch_bounds__(256, 2)
down_dx_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
               const bf16* __restrict__ wt, bf16* __restrict__ dx, int B,
               int Ho, int Wo) {
  using C = DxCfg<CIN, CC>;
  extern __shared__ __align__(128) unsigned char smem[];
  DownDxEpi<C> epi;
  epi.tiles = B * dx_tiles_per_image<CIN, CC>(Ho, Wo);
  epi.H = Ho;
  epi.W = Wo;
  epi.g = g;
  epi.x = x;
  epi.dx = dx;
  const PPSrc src{g, CIN + CC};
  pp_run<C, true>(smem, src, wt, Ho, Wo, epi);
}

// Input gradient at Cin = 3 (the stats-free downsampler on a 3-channel
// map): one thread per input pixel and all its channels; f32 sums over
// the taps whose output pixel exists (the stride leaves 1, 2 or 4 of the
// nine) in tap order, rounded to T, plus the pool's share, as in
// DownDxEpi.  wt (9 CC, CIN) as the tiled kernels take it.
template <typename T, int CIN, int CC>
__global__ void __launch_bounds__(256)
down_dx_small_kernel(const T* __restrict__ g, const T* __restrict__ x,
                     const T* __restrict__ wt, T* __restrict__ dx, int B,
                     int H, int W) {
  constexpr int COUT = CIN + CC;
  __shared__ float ws[9 * CC * CIN];
  for (int i = threadIdx.x; i < 9 * CC * CIN; i += blockDim.x)
    ws[i] = to_f32(wt[i]);
  __syncthreads();
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= (long long)B * H * W) return;
  const int Ho = H / 2, Wo = W / 2;
  const long long b = m / ((long long)H * W);
  const int rem = (int)(m % ((long long)H * W));
  const int h = rem / W, w = rem % W;
  float acc[CIN];
#pragma unroll
  for (int ci = 0; ci < CIN; ++ci) acc[ci] = 0.0f;
  for (int tap = 0; tap < 9; ++tap) {
    const int hh = h + 1 - tap / 3, ww = w + 1 - tap % 3;
    if (hh < 0 || ww < 0 || hh % 2 || ww % 2 || hh / 2 >= Ho || ww / 2 >= Wo)
      continue;
    const T* gp = g + ((b * Ho + hh / 2) * Wo + ww / 2) * COUT;
    for (int co = 0; co < CC; ++co) {
      const float gv = to_f32(gp[co]);
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci)
        acc[ci] = fmaf(gv, ws[(tap * CC + co) * CIN + ci], acc[ci]);
    }
  }
  const int ho = h / 2, wo = w / 2, pr = h % 2, pc = w % 2;
#pragma unroll
  for (int ci = 0; ci < CIN; ++ci) {
    const T* win = x + ((b * H + 2 * ho) * W + 2 * wo) * CIN + ci;
    float xv[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 2; ++k)
        xv[i][k] = to_f32(win[((long long)i * W + k) * CIN]);
    const float m0v = fmaxf(xv[0][0], xv[0][1]);
    const float m1v = fmaxf(xv[1][0], xv[1][1]);
    const float mp = fmaxf(m0v, m1v);
    const float gpool = to_f32(g[((b * Ho + ho) * Wo + wo) * COUT + CC + ci]);
    const float mr = pr ? m1v : m0v;
    float share = 0.0f;
    if (mr == mp) {
      const float gr = gpool / (float)((m0v == mp) + (m1v == mp));
      if (xv[pr][pc] == mr)
        share = gr / (float)((xv[pr][0] == mr) + (xv[pr][1] == mr));
    }
    dx[m * CIN + ci] = from_f32<T>(round_as<T>(acc[ci]) + share);
  }
}

// Weight gradient: blockIdx.y = kh, blockIdx.x = a chunk of ROWS output
// rows (row b Ho + ho, flattened over the batch), each row in blocks of
// BP output pixels.  A block stages its g tile (BP x CC) and the one
// input-row segment kh needs: slot s of
// 2 BP + 1 holds input column 2 wo0 - 1 + s of row 2 ho - 1 + kh, even
// slots in XE, odd ones in XO, so tap kw's operand is a stride-2 view
// (kw = 0: XE rows [0, BP), 1: XO, 2: XE rows [1, BP]).  The products
// dW[kh, kw] += view_kw^T G run as ITEMS = 3 (MB / 16) (NP / 16) m16 x n16
// items: each warp owns IPW items over every 16-pixel step (WARPS_K = 1),
// or every item over one step of eight (WARPS_K = 8, the warps' sums
// added in order at the end).  Double-buffered: block j + 1 copies while
// block j multiplies.  part[chunk] = [dW (9, CIN, CC) | db (CC)]: each
// (chunk, kh) CTA writes taps kh * 3 + kw, the kh = 0 CTAs also db.

template <int CIN, int CC>
struct Wg {
  static constexpr int COUT = CIN + CC, MB = round16(CIN), NP = round16(CC);
  static constexpr int MT16 = MB / 16, NT16 = NP / 16;
  static constexpr int ITEMS = 3 * MT16 * NT16;
  static constexpr int WARPS_K = ITEMS % 8 == 0 ? 1 : 8;
  static constexpr int IPW = ITEMS / (8 / WARPS_K);
  static constexpr int BP = WARPS_K == 1 ? 64 : 128;
  static constexpr int ROWS = CIN == 3 ? 2 : 4;  // output rows per chunk
  static constexpr int LDA = MB + 8, LDG = NP + 8, VG = (CC + 7) / 8;
  static constexpr size_t xe_bytes = pp_align((size_t)(BP + 1) * LDA * 2);
  static constexpr size_t xo_bytes = pp_align((size_t)BP * LDA * 2);
  static constexpr size_t g_bytes = pp_align((size_t)BP * LDG * 2);
  static constexpr size_t stage_bytes = xe_bytes + xo_bytes + g_bytes;
  static constexpr size_t main_bytes = 2 * stage_bytes;
  static constexpr size_t red_bytes =
      WARPS_K > 1 ? (size_t)WARPS_K * ITEMS * 256 * 4 : 0;
  static constexpr size_t smem =
      main_bytes > red_bytes ? main_bytes : red_bytes;
  static constexpr int PLEN = 9 * CIN * CC + CC;
  static_assert(ITEMS % (8 / WARPS_K) == 0 && BP % (16 * WARPS_K) == 0 &&
                    VG * 8 <= COUT,
                "wgrad items");
};

template <int CIN, int CC>
__global__ void __launch_bounds__(256)
down_wgrad_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ part, int B, int Ho, int Wo) {
  using G = Wg<CIN, CC>;
  constexpr int COUT = G::COUT, BP = G::BP, LDA = G::LDA, LDG = G::LDG;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh = blockIdx.y, H = 2 * Ho, W = 2 * Wo;
  const int row0 = blockIdx.x * G::ROWS;
  const int rows = B * Ho - row0 < G::ROWS ? B * Ho - row0 : G::ROWS;
  const int bpr = (Wo + BP - 1) / BP, nb = rows * bpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  auto xe_of = [&](int j) {
    return reinterpret_cast<bf16*>(smem + (j & 1) * G::stage_bytes);
  };
  auto xo_of = [&](int j) { return xe_of(j) + G::xe_bytes / 2; };
  auto g_of = [&](int j) { return xo_of(j) + G::xo_bytes / 2; };
  // start staging block j (rows of the chunk, then blocks of a row)
  auto issue = [&](int j) {
    if (j < nb) {
      const int row = row0 + j / bpr, wo0 = (j % bpr) * BP;
      const int hi = 2 * (row % Ho) - 1 + kh;
      const bool hv = hi >= 0 && hi < H;
      const bf16* xrow = x + ((long long)(row / Ho) * H + (hv ? hi : 0)) *
                                 W * CIN;
      bf16* xe = xe_of(j);
      bf16* xo = xo_of(j);
      if constexpr (CIN % 8 == 0) {
        constexpr int V = CIN / 8;
        for (int v = threadIdx.x; v < (2 * BP + 1) * V; v += 256) {
          const int sl = v / V, e = v % V, wi = 2 * wo0 - 1 + sl;
          const bool ok = hv && wi >= 0 && wi < W;
          cp_async16((sl & 1 ? xo : xe) + (sl >> 1) * LDA + e * 8,
                     xrow + (ok ? (long long)wi * CIN + e * 8 : 0), ok);
        }
      } else {  // the segment is (2 BP + 1) CIN contiguous values
        for (int v = threadIdx.x; v < (2 * BP + 1) * CIN; v += 256) {
          const int sl = v / CIN, c = v % CIN, wi = 2 * wo0 - 1 + sl;
          const bool ok = hv && wi >= 0 && wi < W;
          (sl & 1 ? xo : xe)[(sl >> 1) * LDA + c] =
              ok ? xrow[(long long)wi * CIN + c] : __float2bfloat16(0.0f);
        }
      }
      const long long g0 = ((long long)row * Wo + wo0) * COUT;
      for (int v = threadIdx.x; v < BP * G::VG; v += 256) {
        const int r = v / G::VG, e = v % G::VG;
        const bool ok = wo0 + r < Wo;
        const long long src = ok ? g0 + (long long)r * COUT + e * 8 : 0;
        cp_async16(g_of(j) + r * LDG + e * 8, g + src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[G::IPW][2][4];
#pragma unroll
  for (int i = 0; i < G::IPW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.0f;
  float dbs = 0.0f;  // thread t < CC: channel t, kh = 0 only
  issue(0);
  for (int j = 0; j < nb; ++j) {
    issue(j + 1);
    cp_async_wait_group<1>();
    __syncthreads();
    // G: the block's g rows (channels past CC and rows past the map's
    // width are dropped or zero)
    const bf16* gs = g_of(j);
    if (kh == 0 && threadIdx.x < CC)
      for (int r = 0; r < BP; ++r)
        dbs += __bfloat162float(gs[r * LDG + threadIdx.x]);
    const bf16* xe = xe_of(j);
    const bf16* xo = xo_of(j);
#pragma unroll
    for (int ks = 0; ks < BP / 16; ++ks) {
      if (G::WARPS_K > 1 && ks % G::WARPS_K != warp) continue;
#pragma unroll
      for (int i = 0; i < G::IPW; ++i) {
        const int it = (G::WARPS_K == 1 ? warp * G::IPW : 0) + i;
        const int kw = it / (G::MT16 * G::NT16);
        const int mt = (it / G::NT16) % G::MT16, nt = it % G::NT16;
        const bf16* view = (kw == 1 ? xo : xe) + (kw == 2 ? LDA : 0);
        unsigned a[4], bq[4];
        ldsm_x4_trans(a, view + (ks * 16 + lane % 8 + (lane / 16) * 8) * LDA +
                             mt * 16 + ((lane / 8) % 2) * 8);
        ldsm_x4_trans(bq, gs + (ks * 16 + lane % 16) * LDG + nt * 16 +
                               (lane / 16) * 8);
        mma_bf16_16816(acc[i][0], a, bq[0], bq[1]);
        mma_bf16_16816(acc[i][1], a, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the stage is consumed before block j + 2 refills it
  }
  cp_async_wait_all();
  float* dst = part + (long long)blockIdx.x * G::PLEN;
  if (kh == 0 && threadIdx.x < CC) dst[9 * CIN * CC + threadIdx.x] = dbs;
  // thread (g8, t4) of an m16 x n8 tile: rows g8, g8 + 8, columns 2 t4, + 1
  const int g8 = lane / 4, t4 = lane % 4;
  auto put = [&](int it, int loc, float v) {  // loc: row * 16 + col
    const int kw = it / (G::MT16 * G::NT16);
    const int ci = ((it / G::NT16) % G::MT16) * 16 + loc / 16;
    const int co = (it % G::NT16) * 16 + loc % 16;
    if (ci < CIN && co < CC)
      dst[(kh * 3 + kw) * CIN * CC + ci * CC + co] = v;
  };
  if constexpr (G::WARPS_K == 1) {
#pragma unroll
    for (int i = 0; i < G::IPW; ++i)
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            put(warp * G::IPW + i, (g8 + 8 * h) * 16 + n8 * 8 + 2 * t4 + c,
                acc[i][n8][2 * h + c]);
  } else {
    float* red = reinterpret_cast<float*>(smem);  // the stages are dead
#pragma unroll
    for (int i = 0; i < G::IPW; ++i)
#pragma unroll
      for (int n8 = 0; n8 < 2; ++n8)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            red[(warp * G::ITEMS + i) * 256 + (g8 + 8 * h) * 16 + n8 * 8 +
                2 * t4 + c] = acc[i][n8][2 * h + c];
    __syncthreads();
    for (int e = threadIdx.x; e < G::ITEMS * 256; e += 256) {
      float v = 0.0f;
      for (int w = 0; w < G::WARPS_K; ++w) v += red[w * G::ITEMS * 256 + e];
      put(e / 256, e % 256, v);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 forms
// ---------------------------------------------------------------------------

constexpr int round4(int v) { return (v + 3) / 4 * 4; }

// Forward at Cin = 3 (the stem, or a stats-free 3-channel map): Fwd3F32
// and down_fwd3_f32_kernel in down_fwd32.cuh (the f32 eval block's first
// downsampler runs the same tile with the BatchNorm and ReLU).

// Forward at Cin = 16, 64 (f32): the bf16 form's stride-2 conv over each
// tile's halo patch (down_fwd.cuh) on FFMA micro-tiles, the geometry of the
// f32 upsampler's dx (upsampler_train.cu UpsDx32).  A tile of TH x 32
// output pixels of one image (TH = 4 at Cin = 16, 2 at 64) stages its (2 TH
// + 1) x 65 input pixels once, 16-byte cp.async into four parity planes
// (parity_plane.cuh pf_load_patch_f32: PFPatch's geometry, f32 chunks
// swizzled by f32_swz, zero past the map); tap (kh, kw) is a unit-stride
// view of one plane, w[kh, kw] (CIN x CC, the tap stack as it is) its B
// operand.  The copies (PFRing) and the FFMA micro-tile (pf32_fma) are
// the f32 upsampler's dx's; only the B operand's indexing is this
// kernel's.  Thread (rg, tc) owns output pixels rg + i RS (i < TM) and
// conv channels 4 tc + g CS + (0 .. 3) (g < TN / 4): per four input
// channels TM float4 of the patch and TN float4 of the tap, 4 TM TN FMAs.
// Sum order: one FMA chain per group of TPG taps over the group's (tap,
// ci) in increasing order, the groups added in tap order (a kh row a
// chain at Cin = 16, a tap at 64), then the bias.
// * Cin = 16: the 27 KB stack stays resident beside two 37 KB patches, two
//   CTAs an SM; the next tile's patch is in flight while this one
//   multiplies.
// * Cin = 64: the 147 KB stack does not fit beside two 83 KB patches; a tap
//   (16 KB) a stage streams through a ring of NS = 3 stages (two in
//   flight, 216 KB in all), and the next tile's patch travels whole with
//   its first tap, two stages ahead (spread over the stages it was 4 %
//   slower, PERF.md §6; scripts/cuda_down_fwd_variants.py times the
//   ring's depth and other tilings).
// The pool is taps 4, 5, 7 and 8 of the same patch.  The epilogue stages
// whole output pixels (conv channels + bias, then the pool channels; chunk
// e of pixel m at e ^ 4 (m & 1)) in the tile's own patch buffer once it is
// read, writes them 16 bytes a thread and takes the sums from the stored
// values (thread t always holds channels 4 (t % VC) ..: a chain over its
// pixels, the lanes of one channel group in a fixed butterfly, the warps
// in order), one partial per tile.
template <int CIN, int CC>
struct Fwd32 {
  static constexpr bool WIDE = CIN == 64;
  static constexpr int K = CIN, N = CC, COUT = CIN + CC;
  static constexpr int TH = WIDE ? 2 : 4, TW = 32, BM = TH * TW;
  // a thread 4 pixels x 12 channels at Cin = 16 (128 threads, 246
  // registers), 4 x 4 at 64 (256)
  static constexpr int THREADS = WIDE ? 256 : 128, WARPS = THREADS / 32;
  static constexpr int TN = WIDE ? 4 : 12, TC = N / TN, CS = 4 * TC;
  static constexpr int RS = THREADS / TC, TM = BM / RS;
  static constexpr int NS = WIDE ? 3 : 9;      // ring stages (9: resident)
  static constexpr int TPG = WIDE ? 1 : 3;     // taps a chain
  static constexpr int CTAS = WIDE ? 1 : 2;    // CTAs an SM
  static constexpr int VK = K / 4, VC = COUT / 4;
  static constexpr int PV = BM * VK / THREADS;  // pool chunks a thread
  using Geo = PFPatch<K, TH>;
  static constexpr size_t patch_bytes = pp_align((size_t)Geo::PIXELS * K * 4);
  static constexpr size_t stage_bytes = (size_t)K * N * 4;   // a tap
  static constexpr size_t ring_off = 2 * patch_bytes;        // two patches
  static constexpr size_t smem = ring_off + NS * stage_bytes;
  // the output staging and the sums' scratch, in the tile's patch buffer
  static constexpr size_t red_off = (size_t)BM * COUT * 4;
  static_assert(N % TN == 0 && TN % 4 == 0 && THREADS % TC == 0 &&
                    BM % RS == 0 && 9 % TPG == 0 && BM * VK % THREADS == 0 &&
                    THREADS % VC == 0 && VC >= 8 && VC <= 32 &&
                    red_off + (size_t)WARPS * 2 * COUT * 4 <= patch_bytes &&
                    CTAS * (smem + 1024) <= 233472,
                "f32 forward tile at Cin = 16, 64");
};

// the staged output: chunk e of pixel m at chunk e ^ fwd32_swz(m)
__device__ __forceinline__ int fwd32_swz(int m) { return 4 * (m & 1); }

template <int CIN, int CC, bool S>
__global__ void __launch_bounds__(Fwd32<CIN, CC>::THREADS,
                                  Fwd32<CIN, CC>::CTAS)
down_fwd32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ part, int B, int Ho, int Wo) {
  using G = Fwd32<CIN, CC>;
  using P = typename G::Geo;
  using Ring = PFRing<9, G::NS>;
  constexpr int K = G::K, N = G::N, TM = G::TM, TN = G::TN;
  constexpr int COUT = G::COUT, VK = G::VK, VC = G::VC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = 2 * Ho, W = 2 * Wo;
  const int tiles =
      B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = tid % G::TC, rg = tid / G::TC;
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * G::patch_bytes);
  };
  auto stage_of = [&](int r) {
    return reinterpret_cast<float*>(smem + G::ring_off + r * G::stage_bytes);
  };
  auto patch = [&](int kk) {
    pf_load_patch_f32<P>(patch_of(kk), x,
                         pp_tile_of<G>(blockIdx.x + kk * gridDim.x, Ho, Wo),
                         H, W, G::THREADS);
  };
  // stage s: tap s of w, (K x N) as it is
  auto stage = [&](int r, int s) {
    float* dst = stage_of(r);
    const float* src = w + (size_t)s * K * N;
    for (int c = tid; c < K * N / 4; c += G::THREADS)
      cp_async16(dst + 4 * c, src + 4 * c, true);
  };
  int pr[TM], pc[TM];  // this thread's pixels in the tile
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = rg + i * G::RS;
    pr[i] = m / G::TW;
    pc[i] = m % G::TW;
  }

  Ring::start(tiles, patch, stage);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
    float* pb = patch_of(kk);
    float acc[TM][TN], psum[TM][TN];
    zero_tile(acc);
    zero_tile(psum);
#pragma unroll 1
    for (int s = 0; s < 9; ++s) {
      // B: the tap's row ci, this thread's columns 4 tc + g CS + (0 .. 3)
      const float* bb = stage_of(Ring::next(kk, s, tiles, patch, stage)) +
                        4 * tc;
      pf32_fma<VK>(pb, PF32Tap<P, TM>(pr, pc, s / 3, s % 3), 0,
                   [&](int e, float (&bv)[4][TN]) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int g = 0; g < TN / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(
                bb + (4 * e + k) * N + g * G::CS);
            bv[k][4 * g] = v.x; bv[k][4 * g + 1] = v.y;
            bv[k][4 * g + 2] = v.z; bv[k][4 * g + 3] = v.w;
          }
      }, psum);
      if (s % G::TPG == G::TPG - 1) {  // the group's chain ends
        add_tile(acc, psum);
        zero_tile(psum);
      }
    }
    // the pool: taps 4, 5, 7, 8 of the same patch, PV chunks a thread
    float4 pool[G::PV];
#pragma unroll
    for (int p = 0; p < G::PV; ++p) {
      const int v = tid + p * G::THREADS, m = v / VK, e = v % VK;
      const int r = m / G::TW, c = m % G::TW;
      const float4 a = *reinterpret_cast<const float4*>(
          pf32_at<P>(pb, P::tap(r, c, 1, 1), e));
      const float4 b = *reinterpret_cast<const float4*>(
          pf32_at<P>(pb, P::tap(r, c, 1, 2), e));
      const float4 d = *reinterpret_cast<const float4*>(
          pf32_at<P>(pb, P::tap(r, c, 2, 1), e));
      const float4 f = *reinterpret_cast<const float4*>(
          pf32_at<P>(pb, P::tap(r, c, 2, 2), e));
      pool[p] = make_float4(fmaxf(fmaxf(a.x, b.x), fmaxf(d.x, f.x)),
                            fmaxf(fmaxf(a.y, b.y), fmaxf(d.y, f.y)),
                            fmaxf(fmaxf(a.z, b.z), fmaxf(d.z, f.z)),
                            fmaxf(fmaxf(a.w, b.w), fmaxf(d.w, f.w)));
    }
    __syncthreads();  // the patch is read: its buffer stages the output
    float* Cs = pb;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = rg + i * G::RS;
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const int e = tc + g * G::TC;  // channels 4 e .. 4 e + 3
        *reinterpret_cast<float4*>(Cs + m * COUT + 4 * (e ^ fwd32_swz(m))) =
            make_float4(acc[i][4 * g] + __ldg(bias + 4 * e),
                        acc[i][4 * g + 1] + __ldg(bias + 4 * e + 1),
                        acc[i][4 * g + 2] + __ldg(bias + 4 * e + 2),
                        acc[i][4 * g + 3] + __ldg(bias + 4 * e + 3));
      }
    }
#pragma unroll
    for (int p = 0; p < G::PV; ++p) {
      const int v = tid + p * G::THREADS, m = v / VK, e = N / 4 + v % VK;
      *reinterpret_cast<float4*>(Cs + m * COUT + 4 * (e ^ fwd32_swz(m))) =
          pool[p];
    }
    __syncthreads();

    // whole output pixels, 16 bytes a thread: thread t always holds
    // channels 4 (t % VC) .. + 3, its sums in registers
    float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = tid; v < G::BM * VC; v += G::THREADS) {
      const int m = v / VC, j = v % VC;
      const int i = tl.i0 + m / G::TW, jj = tl.j0 + m % G::TW;
      if (i >= Ho || jj >= Wo) continue;
      const float4 q = *reinterpret_cast<const float4*>(
          Cs + m * COUT + 4 * (j ^ fwd32_swz(m)));
      *reinterpret_cast<float4*>(
          out + (((long long)tl.b * Ho + i) * Wo + jj) * COUT + 4 * j) = q;
      if constexpr (S) {
        const float f[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s0[k] += f[k];
          s1[k] += __fmul_rn(f[k], f[k]);
        }
      }
    }
    if constexpr (S) {
      // lanes of one channel group (lane % VC) in a fixed butterfly, the
      // warps in order: the tile's partial part[t] = [sum y | sum y^2]
#pragma unroll
      for (int o = VC; o < 32; o *= 2)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], o);
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        }
      float* red = Cs + G::red_off / 4;
      if (lane < VC)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red[warp * 2 * COUT + 4 * lane + k] = s0[k];
          red[warp * 2 * COUT + COUT + 4 * lane + k] = s1[k];
        }
      __syncthreads();
      for (int c = tid; c < 2 * COUT; c += G::THREADS) {
        float a = 0.0f;
        for (int wi = 0; wi < G::WARPS; ++wi) a += red[wi * 2 * COUT + c];
        part[(long long)t * 2 * COUT + c] = a;
      }
    }
    // Cs is rewritten only by tile kk + 2's patch, issued after the next
    // tile's first barrier
  }
  cp_async_wait_all();
}

// Input gradient, f32: the bf16 form's parity-plane product (FLIP) on the
// CUDA cores.  A tile of TH x 32 g pixels of one image stages its
// (TH + 1) x 33 patch of g's CC conv channels (channel stride CIN + CC,
// zero past the bottom and right edges) once with 16-byte cp.async; the
// four neighbour operands e_q of the product are views of it shifted by
// one row and / or one column.  The nine (CC x CIN) blocks, the flipped,
// transposed taps of wt read through pp_unit_tap(s, FLIP), stay resident
// (27 KB at (16, 48), 147 KB at (64, 64), beside two patches), loaded once
// by each persistent CTA (two an SM at (16, 48)); the next tile's patch is
// in flight while this one multiplies.  Thread (rowg, tc) owns g pixels
// rowg + i RS (i < TM) and input channels 4 tc .. 4 tc + 3 of all four
// planes, so the pixel's 2x2 input block is its own: FFMA micro-tiles,
// the units grouped by
// their neighbour q (the A operand loaded once for the group's units), one
// FMA chain per unit over its CC terms, and each plane the sum of its
// units in the fixed order q = 0, 1, 2, 3.  The epilogue adds the pool's
// share from x's 2x2 window and g's pool channels, each read once per g
// pixel, 16 bytes a lane, and writes the four dx pixels 16 bytes a lane.
template <int CIN, int CC>
struct Dx32 {
  static constexpr int K = CC, N = CIN, COUT = CIN + CC;
  static constexpr int TH = CIN == 64 ? 2 : 4, TW = 32, BM = TH * TW;
  // CTAs an SM: at Cin = 16 two, so that one's copies and epilogue run
  // under the other's product (0.149 -> 0.134 ms at B=6, PERF.md §6); at
  // 64 the resident taps leave room for one
  static constexpr int CTAS = CIN == 64 ? 1 : 2;
  static constexpr int THREADS = 256, TN = 4, TC = N / TN;
  static constexpr int RS = THREADS / TC, TM = BM / RS;
  static constexpr int PH = TH + 1, PW = TW + 1;
  // the patch's pixel pitch (floats): an odd number of 16-byte chunks, so
  // the float4 reads of up to 8 consecutive pixels fall on distinct banks
  static constexpr int LDK = (K / 4) % 2 ? K : K + 4;
  static constexpr size_t patch_bytes = pp_align((size_t)PH * PW * LDK * 4);
  static constexpr size_t w_off = 2 * patch_bytes;  // two patches
  static constexpr size_t smem = w_off + (size_t)9 * K * N * 4;
  static_assert(K % 4 == 0 && N % TN == 0 && THREADS % TC == 0 &&
                    BM % RS == 0 && TW % (32 / TC) == 0 &&
                    CTAS * (smem + 1024) <= 233472,
                "f32 dx tile");
};

// p[u] += the view of neighbour Q (this thread's pixels pix[i], shifted
// by e_Q) @ the block of unit S_u (this thread's 4 columns), one FMA chain
// per output in increasing k.
template <class G, int Q, int... S>
__device__ __forceinline__ void dx32_units(
    const float* patch, const float* Ws, const int (&pix)[G::TM],
    float (&p)[sizeof...(S)][G::TM][G::TN]) {
  constexpr int K = G::K, N = G::N, NU = sizeof...(S);
  constexpr int OFF = (Q & 1) * G::PW + (Q >> 1);
  constexpr int taps[NU] = {pp_unit_tap(S, true)...};
  const float* wb = Ws + 4 * (threadIdx.x % G::TC);
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float av[G::TM][4];
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(
          patch + (pix[i] + OFF) * G::LDK + k);
      av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = *reinterpret_cast<const float4*>(
            wb + (taps[u] * K + k + kk) * N);
        const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < G::TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p[u][i][j] = fmaf(av[i][kk], bv[j], p[u][i][j]);
      }
  }
}

template <int CIN, int CC>
__global__ void __launch_bounds__(256, Dx32<CIN, CC>::CTAS)
down_dx_f32_kernel(const float* __restrict__ g, const float* __restrict__ x,
                   const float* __restrict__ wt, float* __restrict__ dx,
                   int B, int Ho, int Wo) {
  using G = Dx32<CIN, CC>;
  constexpr int K = G::K, TM = G::TM, TN = G::TN, COUT = G::COUT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem + G::w_off);
  const int H = 2 * Ho, W = 2 * Wo;
  const int tiles =
      B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  const int tc = threadIdx.x % G::TC, rowg = threadIdx.x / G::TC;

  // the (3, 3, CC, CIN) stack as it is: block s is tap pp_unit_tap(s, true)
  for (int v = threadIdx.x; v < 9 * K * G::N / 4; v += G::THREADS)
    cp_async16(Ws + 4 * v, wt + 4 * v, true);
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * G::patch_bytes);
  };
  auto issue = [&](int t, int kk) {
    if (t < tiles) {
      const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
      float* dst = patch_of(kk);
      for (int v = threadIdx.x; v < G::PH * G::PW * (K / 4);
           v += G::THREADS) {
        const int pix = v / (K / 4), e = v % (K / 4);
        const int i = tl.i0 + pix / G::PW, j = tl.j0 + pix % G::PW;
        const bool valid = i < Ho && j < Wo;
        const long long off =
            valid ? (((long long)tl.b * Ho + i) * Wo + j) * COUT + 4 * e : 0;
        cp_async16(dst + pix * G::LDK + 4 * e, g + off, valid);
      }
    }
    cp_async_commit();
  };
  int pix[TM];  // this thread's tile pixels, as patch pixels
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = rowg + i * G::RS;
    pix[i] = (m / G::TW) * G::PW + m % G::TW;
  }

  issue(blockIdx.x, 0);  // with the weights
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
    issue(t + gridDim.x, kk + 1);  // into the buffer tile kk - 1 left
    cp_async_wait_group<1>();
    __syncthreads();
    const float* pb = patch_of(kk);
    // acc[plane]: neighbour 0's units 0, 1, 3, 4 (planes 0 .. 3) start
    // each plane's sum; then neighbour 1's units 5, 6 (planes 2, 3), 2's
    // units 2, 7 (planes 1, 3), 3's unit 8 (plane 3), each added in turn
    float acc[4][TM][TN], part[2][TM][TN];
#pragma unroll
    for (int pl = 0; pl < 4; ++pl) zero_tile(acc[pl]);
    dx32_units<G, 0, 0, 1, 3, 4>(pb, Ws, pix, acc);
    zero_tile(part[0]);
    zero_tile(part[1]);
    dx32_units<G, 1, 5, 6>(pb, Ws, pix, part);
    add_tile(acc[2], part[0]);
    add_tile(acc[3], part[1]);
    zero_tile(part[0]);
    zero_tile(part[1]);
    dx32_units<G, 2, 2, 7>(pb, Ws, pix, part);
    add_tile(acc[1], part[0]);
    add_tile(acc[3], part[1]);
    {
      float p3[1][TM][TN];
      zero_tile(p3[0]);
      dx32_units<G, 3, 8>(pb, Ws, pix, p3);
      add_tile(acc[3], p3[0]);
    }
    __syncthreads();  // the patch is read: tile kk + 1's copies may refill it

    // the pool's share and the stores: pixel (gi, gj) is the pool window
    // of input pixels (2 gi + a, 2 gj + b)
    const int ci = 4 * tc;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = rowg + i * G::RS;
      const int gi = tl.i0 + m / G::TW, gj = tl.j0 + m % G::TW;
      if (gi >= Ho || gj >= Wo) continue;
      const float* win =
          x + (((long long)tl.b * H + 2 * gi) * W + 2 * gj) * CIN + ci;
      float xv[2][2][4], gp[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              win + ((long long)a * W + b) * CIN));
          xv[a][b][0] = v.x; xv[a][b][1] = v.y;
          xv[a][b][2] = v.z; xv[a][b][3] = v.w;
        }
      {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            g + (((long long)tl.b * Ho + gi) * Wo + gj) * COUT + CC + ci));
        gp[0] = v.x; gp[1] = v.y; gp[2] = v.z; gp[3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float m0v = fmaxf(xv[0][0][q], xv[0][1][q]);
            const float m1v = fmaxf(xv[1][0][q], xv[1][1][q]);
            const float mp = fmaxf(m0v, m1v), mr = a ? m1v : m0v;
            const float x0 = xv[a][0][q], x1 = xv[a][1][q];
            float share = 0.0f;
            if (mr == mp) {
              const float gr = gp[q] / (float)((m0v == mp) + (m1v == mp));
              if ((b ? x1 : x0) == mr)
                share = gr / (float)((x0 == mr) + (x1 == mr));
            }
            o[q] = acc[a * 2 + b][i][q] + share;
          }
          *reinterpret_cast<float4*>(
              dx + (((long long)tl.b * H + 2 * gi + a) * W + 2 * gj + b) *
                       CIN + ci) = make_float4(o[0], o[1], o[2], o[3]);
        }
    }
  }
  cp_async_wait_all();
}

// Weight gradient, f32: the bf16 form's (chunk of output rows, kh) grid
// kept in f32, on the CUDA cores.  blockIdx.x = a chunk of `rows_per`
// output rows (row b Ho + ho, flattened over the batch; the wrapper sizes
// the chunks so that the grid is one wave, erf_down_train_wg_rows_f32),
// blockIdx.y = khg: the CTA owns the KHN kernel rows kh = khg KHN .. +
// KHN - 1.  At Cin = 3 and 16 one CTA takes all three kh (x and g read
// once), at 64 one kh (x read three times; the taps of all three would
// not fit its registers).  Each row in blocks of BP output pixels: a
// block stages its g tile (BP x NG, the conv channels rounded up to 4)
// once and, per kh, the one input-row segment its kh needs, slot s the
// CIN values of column 2 wo0 - 1 + s (s < 2 BP + 1), zero past the map.
// Output pixel k of the block reads slots 2 k + kw, kw < 3, one run of 3
// CIN values at 2 k CIN: the segment is the kh's im2col tile as it is,
// with a row pitch of 2 CIN (row m = kw CIN + ci).  At Cin = 3 a segment
// is one contiguous run of (2 BP + 1) x 3 values, copied with coalesced
// 4-byte cp.async; at 16 and 64, 16-byte copies.  Coordinates are
// computed once a block.  The blocks stream through a ring of NS stages
// (NS - 1 in flight).  The product dW[kh] (3 CIN x NG) += A^T G runs as
// FFMA micro-tiles (no TF32), the pixels as the depth: the threads form
// WK groups of an (RG x TC) grid, thread (rg, tc) owns TM consecutive
// rows (within one kh) and the columns 4 tc + 4 TC q + (0 .. 3), and
// group w takes pixels [w KL, (w + 1) KL) of every block; each output is
// one FMA chain per group, the groups added in order at the end.  db sums
// every g pixel once, in the kh = 0 CTAs: the rg = 0 threads add the g
// values they load.  part[chunk] = [dW (9, CIN, CC) | db (CC)]: each
// (chunk, khg) CTA writes taps kh 3 + kw of its kh, the kh = 0 one db.
template <int CIN, int CC>
struct Wg32R {
  static constexpr bool RAW = CIN == 3;
  static constexpr int COUT = CIN + CC, NG = round4(CC), MK = 3 * CIN;
  static constexpr int KHN = CIN == 64 ? 1 : 3, KHG = 3 / KHN;
  static constexpr int M = KHN * MK;  // product rows: kh, kw, ci
  static constexpr int TM = RAW ? 9 : 12, TN = 8;
  static constexpr int RG = M / TM, TC = NG / TN, GT = RG * TC;
  static constexpr int THREADS = CIN == 3 ? 192 : CIN == 16 ? 288 : 256;
  static constexpr int WK = THREADS / GT;
  static constexpr int BP = RAW ? 128 : 64, KL = BP / WK;
  static constexpr int NS = RAW ? 4 : 3;    // ring stages
  static constexpr int CTAS = RAW ? 2 : 1;  // CTAs an SM
  static constexpr int SEG = (2 * BP + 1) * CIN;  // values of a segment
  static constexpr size_t seg_bytes = pp_align((size_t)SEG * 4);
  static constexpr size_t g_bytes = pp_align((size_t)BP * NG * 4);
  static constexpr size_t stage_bytes = KHN * seg_bytes + g_bytes;
  static constexpr size_t red_bytes = ((size_t)WK * M * NG + WK * NG) * 4;
  static constexpr size_t smem =
      NS * stage_bytes > red_bytes ? NS * stage_bytes : red_bytes;
  static constexpr int PLEN = 9 * CIN * CC + CC;
  static_assert(MK % TM == 0 && NG % TN == 0 && TN % 4 == 0 &&
                    (RAW || TM % 4 == 0) && THREADS % GT == 0 &&
                    BP % WK == 0 && NG <= COUT &&
                    CTAS * (smem + 1024) <= 233472,
                "f32 wgrad tile");
};

template <int CIN, int CC>
__global__ void __launch_bounds__(Wg32R<CIN, CC>::THREADS,
                                  Wg32R<CIN, CC>::CTAS)
down_wgrad_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ g, float* __restrict__ part,
                      int B, int Ho, int Wo, int rows_per) {
  using G = Wg32R<CIN, CC>;
  constexpr int BP = G::BP, NS = G::NS, KHN = G::KHN, NG = G::NG;
  constexpr int TM = G::TM, TN = G::TN, THREADS = G::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int kh0 = blockIdx.y * KHN, H = 2 * Ho, W = 2 * Wo;
  const int row0 = blockIdx.x * rows_per;
  const int rows = B * Ho - row0 < rows_per ? B * Ho - row0 : rows_per;
  const int bpr = (Wo + BP - 1) / BP, nb = rows * bpr;
  // kernel row kh0 + l's segment of block j, and its g tile
  auto seg_of = [&](int j, int l) {
    return reinterpret_cast<float*>(smem + (j % NS) * G::stage_bytes +
                                    l * G::seg_bytes);
  };
  auto g_of = [&](int j) {
    return reinterpret_cast<float*>(smem + (j % NS) * G::stage_bytes +
                                    KHN * G::seg_bytes);
  };
  // start staging block j (rows of the chunk, then blocks of a row)
  auto issue = [&](int j) {
    if (j < nb) {
      const int row = row0 + j / bpr, wo0 = (j % bpr) * BP;
      const int img = row / Ho, ho = row % Ho;
#pragma unroll
      for (int l = 0; l < KHN; ++l) {
        const int hi = 2 * ho - 1 + kh0 + l;
        const bool hv = hi >= 0 && hi < H;
        const float* xrow =
            x + ((long long)img * H + (hv ? hi : 0)) * W * CIN;
        float* seg = seg_of(j, l);
        if constexpr (G::RAW) {  // values from column 2 wo0 - 1 on
          const int e0 = (2 * wo0 - 1) * CIN;
          for (int v = threadIdx.x; v < G::SEG; v += THREADS) {
            const int e = e0 + v;
            const bool ok = hv && e >= 0 && e < W * CIN;
            cp_async4(seg + v, xrow + (ok ? e : 0), ok);
          }
        } else {
          constexpr int V = CIN / 4;
          for (int v = threadIdx.x; v < (2 * BP + 1) * V; v += THREADS) {
            const int sl = v / V, q = v % V, wi = 2 * wo0 - 1 + sl;
            const bool ok = hv && wi >= 0 && wi < W;
            cp_async16(seg + sl * CIN + q * 4,
                       xrow + (ok ? (long long)wi * CIN + q * 4 : 0), ok);
          }
        }
      }
      const float* grow = g + ((long long)row * Wo + wo0) * G::COUT;
      float* gs = g_of(j);
      constexpr int VG = NG / 4;
      for (int v = threadIdx.x; v < BP * VG; v += THREADS) {
        const int r = v / VG, q = v % VG;
        const bool ok = wo0 + r < Wo;
        cp_async16(gs + r * NG + q * 4,
                   grow + (ok ? (long long)r * G::COUT + q * 4 : 0), ok);
      }
    }
    cp_async_commit();
  };

  const int w = threadIdx.x / G::GT, rg = (threadIdx.x % G::GT) / G::TC,
            tc = threadIdx.x % G::TC;
  // this thread's rows: rg TM .. + TM - 1, in kernel row kh0 + l at m0
  const int l = rg * TM / G::MK, m0 = rg * TM % G::MK;
  const bool dbt = kh0 == 0 && rg == 0;
  float acc[TM][TN], dba[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.0f;
#pragma unroll
  for (int n = 0; n < TN; ++n) dba[n] = 0.0f;
  for (int j = 0; j < NS - 1; ++j) issue(j);
  for (int j = 0; j < nb; ++j) {
    cp_async_wait_group<NS - 2>();
    __syncthreads();  // block j landed; block j - 1's stage is free
    issue(j + NS - 1);
    const float* a = seg_of(j, l) + w * G::KL * 2 * CIN + m0;
    const float* b = g_of(j) + w * G::KL * NG + 4 * tc;
#pragma unroll 4
    for (int k = 0; k < G::KL; ++k) {
      float av[TM], bv[TN];
      if constexpr (G::RAW) {
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = a[k * 2 * CIN + i];
      } else {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(a + k * 2 * CIN + i);
          av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
        }
      }
#pragma unroll
      for (int n = 0; n < TN; n += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            b + k * NG + n * G::TC);
        bv[n] = v.x; bv[n + 1] = v.y; bv[n + 2] = v.z; bv[n + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(av[i], bv[n], acc[i][n]);
      if (dbt)
#pragma unroll
        for (int n = 0; n < TN; ++n) dba[n] += bv[n];
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the stages are dead: the groups' sums take their place
  float* red = reinterpret_cast<float*>(smem);  // WK x M x NG
  float* dbr = red + G::WK * G::M * NG;         // WK x NG
#pragma unroll
  for (int n = 0; n < TN; ++n) {
    const int col = 4 * tc + (n / 4) * 4 * G::TC + n % 4;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      red[(w * G::M + rg * TM + i) * NG + col] = acc[i][n];
    if (rg == 0) dbr[w * NG + col] = dba[n];
  }
  __syncthreads();
  float* dst = part + (long long)blockIdx.x * G::PLEN;
  for (int e = threadIdx.x; e < G::M * CC; e += THREADS) {
    const int row = e / CC, co = e % CC;
    float v = 0.0f;
    for (int k = 0; k < G::WK; ++k) v += red[(k * G::M + row) * NG + co];
    const int kh = kh0 + row / G::MK, m = row % G::MK;  // m = kw CIN + ci
    dst[(kh * 3 + m / CIN) * CIN * CC + (m % CIN) * CC + co] = v;
  }
  if (kh0 == 0)
    for (int co = threadIdx.x; co < CC; co += THREADS) {
      float v = 0.0f;
      for (int k = 0; k < G::WK; ++k) v += dbr[k * NG + co];
      dst[9 * CIN * CC + co] = v;
    }
}

// ------------------------------- launchers --------------------------------

template <class Kernel>
cudaError_t grid_for(Kernel k, int threads, size_t smem, bool* ok, int* gm) {
  cudaError_t e = allow_smem(k, smem, ok);
  if (e != cudaSuccess) return e;
  if (*gm == 0) return resident_ctas(k, threads, smem, gm);
  return cudaSuccess;
}

// S: with the statistics (part and their reduction into stats)
template <int CIN, int CC, bool STEM, bool S>
int fwd(const void* x, const void* shifts, const void* w, const void* bias,
        void* out, void* xa, void* part, void* stats, int B, int H, int W,
        cudaStream_t s) {
  using G = Fwd<CIN, CC, STEM>;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = grid_for(down_fwd_kernel<CIN, CC, STEM, S>, G::THREADS,
                           G::smem, &ok, &gm);
  if (e != cudaSuccess) return e;
  const int Ho = H / 2, Wo = W / 2;
  const int tpi = ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  const int tiles = B * tpi;
  down_fwd_kernel<CIN, CC, STEM, S>
      <<<tiles < gm ? tiles : gm, G::THREADS, G::smem, s>>>(
          x, static_cast<const int*>(shifts), static_cast<const bf16*>(w),
          static_cast<const float*>(bias), static_cast<bf16*>(out),
          static_cast<bf16*>(xa), static_cast<float*>(part), B, Ho, Wo,
          nullptr, nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * G::COUT, s);
}

// dx at Cin = 3 (either form)
template <typename T, int CIN, int CC>
cudaError_t dx_small(const void* g, const void* x, const void* wt, void* dx,
                     int B, int H, int W, cudaStream_t s) {
  const long long n = (long long)B * H * W;
  down_dx_small_kernel<T, CIN, CC><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const T*>(wt), static_cast<T*>(dx), B, H, W);
  return cudaGetLastError();
}

// stats: from the stats fold g = bf16(gy + gs1 + 2 y gs2), else from gy.
// Launches: the fold (stats), the input gradient (DX), the weight
// gradient, the reduction of its partials.
template <int CIN, int CC, bool DX>
int bwd(int stats, const void* gy, const void* y, const void* gs1,
        const void* gs2, const void* x, const void* wt, void* g, void* dx,
        void* part, void* grads, int B, int H, int W, cudaStream_t s) {
  constexpr int COUT = CIN + CC;
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t e = cudaSuccess;
  const void* gg = stats ? g : gy;
  if (stats && (e = adjust_grad(gy, y, gs1, gs2, g, B, Ho * Wo, COUT, s)) !=
                   cudaSuccess)
    return e;
  if constexpr (DX && CIN % 16 != 0) {
    if ((e = dx_small<bf16, CIN, CC>(gg, x, wt, dx, B, H, W, s)) !=
        cudaSuccess)
      return e;
  } else if constexpr (DX) {
    using C = DxCfg<CIN, CC>;
    static bool ok = false;
    static int gm = 0;
    if ((e = grid_for(down_dx_kernel<CIN, CC>, C::THREADS, C::smem, &ok,
                      &gm)) != cudaSuccess)
      return e;
    const int tiles = B * dx_tiles_per_image<CIN, CC>(Ho, Wo);
    down_dx_kernel<CIN, CC><<<tiles < gm ? tiles : gm, C::THREADS, C::smem,
                              s>>>(
        static_cast<const bf16*>(gg), static_cast<const bf16*>(x),
        static_cast<const bf16*>(wt), static_cast<bf16*>(dx), B, Ho, Wo);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  using G = Wg<CIN, CC>;
  static bool wg_ok = false;
  if ((e = allow_smem(down_wgrad_kernel<CIN, CC>, G::smem, &wg_ok)) !=
      cudaSuccess)
    return e;
  const int chunks = (B * Ho + G::ROWS - 1) / G::ROWS;
  down_wgrad_kernel<CIN, CC><<<dim3(chunks, 3), 256, G::smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gg),
      static_cast<float*>(part), B, Ho, Wo);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks, G::PLEN, s);
}

template <int CIN, int CC, bool STEM, bool S>
int fwd_f32(const void* x, const void* shifts, const void* w,
            const void* bias, void* out, void* xa, void* part, void* stats,
            int B, int H, int W, cudaStream_t s) {
  const int Ho = H / 2, Wo = W / 2;
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = cudaSuccess;
  int tpi;
  if constexpr (CIN == 3) {
    using G = Fwd3F32;
    if ((e = grid_for(down_fwd3_f32_kernel<STEM, S>, G::THREADS, G::smem,
                      &ok, &gm)) != cudaSuccess)
      return e;
    tpi = ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
    down_fwd3_f32_kernel<STEM, S>
        <<<B * tpi < gm ? B * tpi : gm, G::THREADS, G::smem, s>>>(
            static_cast<const float*>(x), static_cast<const int*>(shifts),
            static_cast<const float*>(w), static_cast<const float*>(bias),
            static_cast<float*>(out), static_cast<float*>(xa),
            static_cast<float*>(part), B, Ho, Wo);
  } else {
    using G = Fwd32<CIN, CC>;
    if ((e = grid_for(down_fwd32_kernel<CIN, CC, S>, G::THREADS, G::smem,
                      &ok, &gm)) != cudaSuccess)
      return e;
    tpi = ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
    down_fwd32_kernel<CIN, CC, S>
        <<<B * tpi < gm ? B * tpi : gm, G::THREADS, G::smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(w),
            static_cast<const float*>(bias), static_cast<float*>(out),
            static_cast<float*>(part), B, Ho, Wo);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, tpi, 2 * (CIN + CC), s);
}

template <int CIN, int CC, bool DX>
int bwd_f32(int stats, const void* gy, const void* y, const void* gs1,
            const void* gs2, const void* x, const void* wt, void* g, void* dx,
            void* part, void* grads, int B, int H, int W, int rows,
            cudaStream_t s) {
  constexpr int COUT = CIN + CC;
  const int Ho = H / 2, Wo = W / 2;
  cudaError_t e = cudaSuccess;
  const void* gg = stats ? g : gy;
  if (stats && (e = adjust_grad_f32(gy, y, gs1, gs2, g, B, Ho * Wo, COUT,
                                    s)) != cudaSuccess)
    return e;
  if constexpr (DX && CIN % 4 != 0) {
    if ((e = dx_small<float, CIN, CC>(gg, x, wt, dx, B, H, W, s)) !=
        cudaSuccess)
      return e;
  } else if constexpr (DX) {
    using G = Dx32<CIN, CC>;
    static bool ok = false;
    static int gm = 0;
    if ((e = grid_for(down_dx_f32_kernel<CIN, CC>, G::THREADS, G::smem, &ok,
                      &gm)) != cudaSuccess)
      return e;
    const int tiles =
        B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
    down_dx_f32_kernel<CIN, CC>
        <<<tiles < gm ? tiles : gm, G::THREADS, G::smem, s>>>(
            static_cast<const float*>(gg), static_cast<const float*>(x),
            static_cast<const float*>(wt), static_cast<float*>(dx), B, Ho,
            Wo);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  using G = Wg32R<CIN, CC>;
  static bool wg_ok = false;
  if ((e = allow_smem(down_wgrad_f32_kernel<CIN, CC>, G::smem, &wg_ok)) !=
      cudaSuccess)
    return e;
  const int chunks = (B * Ho + rows - 1) / rows;
  down_wgrad_f32_kernel<CIN, CC>
      <<<dim3(chunks, G::KHG), G::THREADS, G::smem, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(gg),
          static_cast<float*>(part), B, Ho, Wo, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks, G::PLEN, s);
}

bool shape_ok(int B, int H, int W, int cin) {
  return B > 0 && H > 0 && W > 0 && H % 2 == 0 && W % 2 == 0 &&
         (long long)B * H * W * (cin > 64 ? cin : 64) < (1LL << 31);
}

// (cin, cc) pairs: (3, 13) (the stem, or a 3-channel map), (16, 48),
// (64, 64); the stem mode only at (3, 13)
bool pair_ok(int cin, int cc, int stem) {
  return (cin == 3 && cc == 13) ||
         (!stem && ((cin == 16 && cc == 48) || (cin == 64 && cc == 64)));
}

// FN<CIN, CC, STEM, S>(ARGS) for the runtime with_stats flag
#define ERF_DOWN_FWD(FN, CIN, CC, STEM)                                  \
  (with_stats ? FN<CIN, CC, STEM, true>(ARGS)                            \
              : FN<CIN, CC, STEM, false>(ARGS))

}  // namespace

// ------------------------------ C interface -------------------------------
//
// (cin, cc) in {(3, 13), (16, 48), (64, 64)}, the stem mode only at
// (3, 13).  x: (B, H, W, cin) f32 in the stem mode (the flipped image),
// else bf16; shifts: (B, 2) int32 (tx, ty), stem mode only; w: (3, 3,
// cin, cc) bf16, the tap stack as it is (row (kh * 3 + kw) cin + ci),
// 16-byte aligned; bias: (cc,) f32; out: (B, H/2, W/2, cin + cc) bf16; xa:
// (B, H, W, 3) bf16, the translated image (stem mode); part: (B *
// ceil(H/2 / th) * ceil(W/2 / 32), 2 (cin + cc)) f32 scratch, th = 8, 4, 2
// at cin = 3, 16, 64; stats: (B, 2 (cin + cc)) f32 = [sum y, sum y^2] per
// image; with_stats 0: part and stats are not touched.
extern "C" int erf_down_train_fwd(const void* x, const void* shifts,
                                  const void* w, const void* bias,
                                  void* out, void* xa, void* part,
                                  void* stats, int B, int H, int W, int cin,
                                  int cc, int stem, int with_stats,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin) || !pair_ok(cin, cc, stem))
    return cudaErrorInvalidValue;
#define ARGS x, shifts, w, bias, out, xa, part, stats, B, H, W, s
  if (cin == 3)
    return stem ? ERF_DOWN_FWD(fwd, 3, 13, true)
                : ERF_DOWN_FWD(fwd, 3, 13, false);
  if (cin == 16) return ERF_DOWN_FWD(fwd, 16, 48, false);
  return ERF_DOWN_FWD(fwd, 64, 64, false);
#undef ARGS
}

// gy, y: (B, H/2, W/2, cin + cc) bf16; gs1, gs2: (B, cin + cc) f32; x:
// the forward's bf16 input (the translated image in the stem mode); wt:
// (3, 3, cc, cin) bf16, the transposed taps: row (kh * 3 + kw) cc + co,
// column ci (not read in the stem mode); g: (B, H/2, W/2, cin + cc) bf16
// scratch (with_stats 0: gy is g, and y, gs1, gs2 and g are not read); dx:
// (B, H, W, cin) bf16 (not written in the stem mode); part: (ceil(B H/2 /
// rows), 9 cin cc + cc) f32 scratch, rows = 2 output rows at cin = 3, else
// 4; grads: (9 cin cc + cc) f32 = [dW in HWIO order, db].
extern "C" int erf_down_train_bwd(const void* gy, const void* y,
                                  const void* gs1, const void* gs2,
                                  const void* x, const void* wt, void* g,
                                  void* dx, void* part, void* grads, int B,
                                  int H, int W, int cin, int cc, int stem,
                                  int with_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin) || !pair_ok(cin, cc, stem))
    return cudaErrorInvalidValue;
#define ARGS with_stats, gy, y, gs1, gs2, x, wt, g, dx, part, grads, B, H, W, s
  if (cin == 3)
    return stem ? bwd<3, 13, false>(ARGS) : bwd<3, 13, true>(ARGS);
  if (cin == 16) return bwd<16, 48, true>(ARGS);
  return bwd<64, 64, true>(ARGS);
#undef ARGS
}


// The f32 forms: the same operands with x (the f32 image in the stem
// mode), w, out, xa in f32 (w the (3, 3, cin, cc) f32 tap stack as it is,
// 16-byte aligned); part as the bf16 form's (th = 8, 4, 2 at cin = 3, 16,
// 64).
extern "C" int erf_down_train_fwd_f32(const void* x, const void* shifts,
                                      const void* w, const void* bias,
                                      void* out, void* xa, void* part,
                                      void* stats, int B, int H, int W,
                                      int cin, int cc, int stem,
                                      int with_stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin) || !pair_ok(cin, cc, stem))
    return cudaErrorInvalidValue;
#define ARGS x, shifts, w, bias, out, xa, part, stats, B, H, W, s
  if (cin == 3)
    return stem ? ERF_DOWN_FWD(fwd_f32, 3, 13, true)
                : ERF_DOWN_FWD(fwd_f32, 3, 13, false);
  if (cin == 16) return ERF_DOWN_FWD(fwd_f32, 16, 48, false);
  return ERF_DOWN_FWD(fwd_f32, 64, 64, false);
#undef ARGS
}

// The f32 backward: gy, y, x, wt (9 cc, cin), g, dx in f32; rows: output
// rows per weight-gradient partial (erf_down_train_wg_rows_f32); part:
// (ceil(B H/2 / rows), 9 cin cc + cc) f32 scratch.
extern "C" int erf_down_train_bwd_f32(const void* gy, const void* y,
                                      const void* gs1, const void* gs2,
                                      const void* x, const void* wt, void* g,
                                      void* dx, void* part, void* grads,
                                      int B, int H, int W, int cin, int cc,
                                      int stem, int with_stats, int rows,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, cin) || !pair_ok(cin, cc, stem) || rows < 1)
    return cudaErrorInvalidValue;
#define ARGS \
  with_stats, gy, y, gs1, gs2, x, wt, g, dx, part, grads, B, H, W, rows, s
  if (cin == 3)
    return stem ? bwd_f32<3, 13, false>(ARGS) : bwd_f32<3, 13, true>(ARGS);
  if (cin == 16) return bwd_f32<16, 48, true>(ARGS);
  return bwd_f32<64, 64, true>(ARGS);
#undef ARGS
}

// Output rows per f32 weight-gradient partial for a (B, H/2 = Ho) map
// (the f32 backward's `rows`): chunks of ceil(B Ho KHG / (SMs CTAS))
// rows, so that the grid of chunks x KHG CTAs is one wave of CTAS CTAs an
// SM of the current device; 0 on a CUDA error or an unsupported cin.
extern "C" int erf_down_train_wg_rows_f32(int B, int Ho, int cin) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    return 0;
  int khg, ctas;
  if (cin == 3) {
    khg = Wg32R<3, 13>::KHG;
    ctas = Wg32R<3, 13>::CTAS;
  } else if (cin == 16) {
    khg = Wg32R<16, 48>::KHG;
    ctas = Wg32R<16, 48>::CTAS;
  } else if (cin == 64) {
    khg = Wg32R<64, 64>::KHG;
    ctas = Wg32R<64, 64>::CTAS;
  } else {
    return 0;
  }
  return (int)(((long long)B * Ho * khg + sms * ctas - 1) / (sms * ctas));
}
