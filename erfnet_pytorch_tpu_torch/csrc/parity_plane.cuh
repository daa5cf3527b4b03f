// The parity-plane product of a stride-2 3x3 transposed convolution, on
// the tensor cores, shared by the train upsampler's forward
// (upsampler_train.cu), the eval upsampler (upsampler.cu, with a bias +
// ReLU epilogue) and the train downsampler's input gradient
// (downsampler_train.cu); and, at the end of this file, the staging of
// the forward direction, a stride-2 3x3 conv over the parity planes of a
// halo patch (the train downsampler's forward, and the train upsampler's
// input gradient, a stride-2 conv of its g).  The f32 forms of the
// upsampler's forward run the same product in ups_fwd32.cuh.
//
// For input pixel p = (i, j) of an (H, W) map a with K channels it forms
//
//   out4[p][plane a*2+b] = sum_q a[p + e_q] @ Wblk(q, plane)      (N wide)
//   e_q = (q & 1, q >> 1): q = 0 (0,0), 1 (1,0), 2 (0,1), 3 (1,1)
//
// with a zero past the map's bottom and right edges; out4's plane (a, b)
// is output pixel (2i + a, 2j + b).  Block (q, plane) is non-zero iff
// dh(q) <= a and dw(q) <= b: nine of the sixteen, each one tap of a 3x3
// weight (K x N) along each axis: parity 0 takes tap 1 at offset 0,
// parity 1 tap 0 at offset 0 and tap 2 at offset 1 (ops/convt_mm.py
// UPS_TAPS); FLIP takes 2 - tap, the input gradient of a 3x3 stride-2
// pad-1 conv (its weight's taps flipped and transposed, K = Cc, N = Cin).
// The weight is read straight from its (3, 3, K, N) tap stack through
// that table (ops/convt_mm.py PARITY_TAPS is the same table).
//
// A CTA (256 threads, persistent over tiles of TH x 32 input pixels of
// one image) runs the nine products of a tile as nine units:
//   half a = 0: (q0, pl0) (q0, pl1) (q2, pl1);
//   half a = 1: (q0, pl2) (q0, pl3) (q1, pl2) (q1, pl3) (q2, pl3) (q3, pl3)
// * The A patch, the tile's (TH + 1) x 33 pixels with a one-row and one-
//   column halo, is staged once (cp.async, zero fill past the edges); the
//   four neighbour operands are views of it shifted by e_q: ldmatrix takes
//   each row's address, so a view costs no copy.
// * The weight blocks stream through a ring of NS stages of one block each
//   (cp.async groups, NS - 1 in flight): the next units' blocks, and the
//   next tile's patch NS - 1 units ahead, copy while this unit runs.  At
//   (64, 16) and (48, 16) the ring has nine stages: the blocks stay
//   resident and only the CTA's first tile loads them.
// * Each warp owns WM pixels of one tile row and the same WN columns of
//   both planes of a half, so every unit keeps every warp busy: ldmatrix +
//   mma.sync m16n8k16, f32 accumulators.
// * After each half the sums go, rounded by the caller's epilogue rule, to
//   a staging tile in output order (whole output rows of the tile: the 2 x
//   32 output pixels of each input row for the half's parity a), and the
//   caller's epilogue writes them out 16 bytes a thread.
//
// Bound: bytes on every shape of the train path (9 K N MACs per input
// pixel against 2 K + 8 N bytes; at most 192 operations per byte, under
// the card's 295).  Each tile reads its 9 K N bf16 weights from L2: 0.6
// KB a pixel at (128, 64) (TH = 4), 1.2 KB at (64, 64) (TH = 2), 0.2 KB
// at (64, 16) and (48, 16) (TH = 4).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace erfk {

// unit s -> neighbour q(s) and plane pl(s), two bits each
constexpr int PP_Q = (0 << 0) | (0 << 2) | (2 << 4) | (0 << 6) | (0 << 8) |
                     (1 << 10) | (1 << 12) | (2 << 14) | (3 << 16);
constexpr int PP_PL = (0 << 0) | (1 << 2) | (1 << 4) | (2 << 6) | (3 << 8) |
                      (2 << 10) | (3 << 12) | (3 << 14) | (3 << 16);
__host__ __device__ constexpr int pp_q(int s) { return (PP_Q >> (2 * s)) & 3; }
__host__ __device__ constexpr int pp_pl(int s) {
  return (PP_PL >> (2 * s)) & 3;
}

// the tap along one axis of a block: parity 0 -> 1; parity 1 -> 0 at
// offset 0, 2 at offset 1 (FLIP: 2 - tap)
__host__ __device__ constexpr int pp_tap(int parity, int off, bool flip) {
  return parity == 0 ? 1 : ((off == 1) != flip ? 2 : 0);
}

// tap index kh * 3 + kw of unit s's weight block
__host__ __device__ constexpr int pp_unit_tap(int s, bool flip) {
  return pp_tap(pp_pl(s) >> 1, pp_q(s) & 1, flip) * 3 +
         pp_tap(pp_pl(s) & 1, pp_q(s) >> 1, flip);
}

constexpr size_t pp_align(size_t b) { return (b + 127) / 128 * 128; }

// NS_: the ring's stages; 9 keeps every block resident (loaded by the
// CTA's first tile only), so the later tiles' units run without a barrier
// each.
template <int K_, int N_, int TH_, int NS_ = 4>
struct PPCfg {
  static constexpr int K = K_, N = N_, TH = TH_, TW = 32, BM = TH * TW;
  static constexpr int THREADS = 256, WARPS = 8;
  static constexpr int WN = N < 32 ? N : 32;   // columns of each plane
  static constexpr int WCOLS = N / WN, WROWS = WARPS / WCOLS;
  static constexpr int WM = BM / WROWS, MT = WM / 16, NT = WN / 8;
  static constexpr int PH = TH + 1, PW = TW + 1;
  static constexpr int LDK = K + 8, LDB = N + 8, LDN = N + 8;
  static constexpr int NS = NS_, D = NS - 1;   // ring stages, in flight
  static constexpr bool RESIDENT = NS == 9;
  static constexpr int VK = K / 8, VN = N / 8;
  static constexpr size_t patch_bytes = pp_align((size_t)PH * PW * LDK * 2);
  static constexpr size_t block_bytes = pp_align((size_t)K * LDB * 2);
  static constexpr size_t out_bytes = pp_align((size_t)TH * 2 * TW * LDN * 2);
  static constexpr size_t ring_off = 2 * patch_bytes;  // two patches
  static constexpr size_t out_off = ring_off + NS * block_bytes;
  static constexpr size_t red_off = out_off + out_bytes;
  static constexpr size_t smem = red_off + (size_t)WARPS * 2 * N * 4;
  static_assert(K % 16 == 0 && N % 8 == 0 && WN % 16 == 0 && N % WN == 0 &&
                    WARPS % WCOLS == 0 && WM % 16 == 0 && TW % WM == 0 &&
                    THREADS % VN == 0 && smem <= 232448,
                "parity-plane tile");
};

// The map a tile reads: pixel (b, i, j) channel c at
// base[((b H + i) W + j) ld + c], c < K.
struct PPSrc {
  const bf16* base;
  int ld;
};

// Tile t -> image b and the first input pixel (i0, j0).
struct PPTile {
  int b, i0, j0;
};

template <class C>
__device__ __forceinline__ PPTile pp_tile_of(int t, int H, int W) {
  const int th = (H + C::TH - 1) / C::TH, tw = (W + C::TW - 1) / C::TW;
  PPTile r;
  r.b = t / (th * tw);
  const int l = t % (th * tw);
  r.i0 = (l / tw) * C::TH;
  r.j0 = (l % tw) * C::TW;
  return r;
}

// Start copying the (TH + 1) x 33 patch of tile tl into dst (pitch LDK),
// zero past the map.
template <class C>
__device__ __forceinline__ void pp_load_patch(bf16* dst, const PPSrc& src,
                                              PPTile tl, int H, int W) {
  for (int v = threadIdx.x; v < C::PH * C::PW * C::VK; v += C::THREADS) {
    const int pix = v / C::VK, e = v % C::VK;
    const int i = tl.i0 + pix / C::PW, j = tl.j0 + pix % C::PW;
    const bool valid = i < H && j < W;
    const long long off =
        valid ? (((long long)tl.b * H + i) * W + j) * src.ld + e * 8 : 0;
    cp_async16(dst + pix * C::LDK + e * 8, src.base + off, valid);
  }
}

// Start copying unit s's weight block (K x N, tap pp_unit_tap(s) of the
// (3, 3, K, N) stack w) into Bs (pitch LDB).
template <class C, bool FLIP>
__device__ __forceinline__ void pp_load_block(bf16* Bs, const bf16* w,
                                              int s) {
  const bf16* src = w + (size_t)pp_unit_tap(s, FLIP) * C::K * C::N;
  for (int v = threadIdx.x; v < C::K * C::VN; v += C::THREADS) {
    const int r = v / C::VN, e = v % C::VN;
    cp_async16(Bs + r * C::LDB + e * 8, src + (size_t)r * C::N + e * 8, true);
  }
}

// acc[b] += view q of the patch (this warp's WM pixels, one tile row) @
// Bs (this warp's WN columns); b = the unit's plane & 1.
template <class C, int Q, int B>
__device__ __forceinline__ void pp_mma_unit(
    const bf16* patch, const bf16* Bs, float (&acc)[2][C::MT][C::NT][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WCOLS, wn = warp % C::WCOLS;
  const int m = wm * C::WM + lane % 16;
  const int pr = m / C::TW + (Q & 1), pc = m % C::TW + (Q >> 1);
  const bf16* a_row = patch + (pr * C::PW + pc) * C::LDK + (lane / 16) * 8;
  const bf16* b_row = Bs + (lane % 16) * C::LDB + wn * C::WN + (lane / 16) * 8;
#pragma unroll
  for (int k = 0; k < C::K; k += 16) {
    unsigned a[C::MT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      ldsm_x4(a[mt], a_row + mt * 16 * C::LDK + k);
#pragma unroll
    for (int n = 0; n < C::WN / 16; ++n) {
      unsigned bb[4];
      ldsm_x4_trans(bb, b_row + k * C::LDB + n * 16);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        mma_bf16_16816(acc[B][mt][2 * n], a[mt], bb[0], bb[1]);
        mma_bf16_16816(acc[B][mt][2 * n + 1], a[mt], bb[2], bb[3]);
      }
    }
  }
}

// The half's sums -> Cs (TH rows x 64 output pixels x N, pitch LDN), each
// value rounded to bf16 after pol.pre(sum, column), then zero the sums.  Cs
// pixel 2c + b of row r is output pixel (2 (i0 + r) + a, 2 (j0 + c) + b).
template <class C, class P>
__device__ __forceinline__ void pp_stage_half(
    bf16* Cs, float (&acc)[2][C::MT][C::NT][4], const P& pol) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WCOLS, wn = warp % C::WCOLS;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * C::WM + mt * 16 + lane / 4 + 8 * h;
      const int r = m / C::TW, c = m % C::TW;
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          const int n = wn * C::WN + nt * 8 + 2 * (lane % 4);
          float* v = acc[b][mt][nt] + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              Cs + (r * 2 * C::TW + 2 * c + b) * C::LDN + n) =
              __floats2bfloat162_rn(pol.pre(v[0], n), pol.pre(v[1], n + 1));
          v[0] = v[1] = 0.0f;
        }
    }
}

// The persistent loop.  P (the caller's policy) provides:
//   tiles                               the tile count
//   float pre(float sum, int n) const   the value before its bf16 rounding
//   void out(int a, PPTile, const bf16* Cs)   write half a's output rows
//                                       from their staging Cs (every
//                                       thread; Cs is synchronised, and
//                                       rewritten only after the next
//                                       units' barriers)
//   void end_tile(int t)                after both halves (every thread)
template <class C, bool FLIP, class P>
__device__ __forceinline__ void pp_run(unsigned char* smem, const PPSrc& src,
                                       const bf16* w, int H, int W, P& pol) {
  bf16* patches = reinterpret_cast<bf16*>(smem);
  unsigned char* ring = smem + C::ring_off;
  bf16* Cs = reinterpret_cast<bf16*>(smem + C::out_off);
  constexpr int PE = C::patch_bytes / 2;
  const int tiles = pol.tiles;
  // unit v of this CTA: its (v / 9)-th tile's unit v % 9
  auto issue = [&](int v) {
    const int kk = v / 9, s = v % 9;
    const int t = blockIdx.x + kk * gridDim.x;
    if (t < tiles) {
      if (s == 0)
        pp_load_patch<C>(patches + (kk & 1) * PE, src,
                         pp_tile_of<C>(t, H, W), H, W);
      if (!C::RESIDENT || kk == 0)
        pp_load_block<C, FLIP>(
            reinterpret_cast<bf16*>(ring + (v % C::NS) * C::block_bytes), w,
            s);
    }
    cp_async_commit();
  };
  float acc[2][C::MT][C::NT][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int n = 0; n < C::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][mt][n][e] = 0.0f;
  for (int v = 0; v < C::D; ++v) issue(v);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<C>(t, H, W);
    const bf16* patch = patches + (kk & 1) * PE;
    auto step = [&](auto S_) {
      constexpr int S = decltype(S_)::value;
      const int u = kk * 9 + S;
      cp_async_wait_group<C::NS - 2>();
      // resident blocks: after the first tile only the patch (S = 0) needs
      // the barrier
      if (!C::RESIDENT || S == 0 || kk == 0) __syncthreads();
      issue(u + C::D);
      pp_mma_unit<C, pp_q(S), pp_pl(S) & 1>(
          patch,
          reinterpret_cast<const bf16*>(ring + (u % C::NS) * C::block_bytes),
          acc);
      if constexpr (S == 2 || S == 8) {
        constexpr int a = S == 8;
        if (C::RESIDENT && a) __syncthreads();  // half 0's reads of Cs
        pp_stage_half<C>(Cs, acc, pol);
        __syncthreads();
        pol.out(a, tl, Cs);
      }
    };
    step(std::integral_constant<int, 0>{});
    step(std::integral_constant<int, 1>{});
    step(std::integral_constant<int, 2>{});
    step(std::integral_constant<int, 3>{});
    step(std::integral_constant<int, 4>{});
    step(std::integral_constant<int, 5>{});
    step(std::integral_constant<int, 6>{});
    step(std::integral_constant<int, 7>{});
    step(std::integral_constant<int, 8>{});
    pol.end_tile(t);
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// The forward direction: a stride-2 3x3 pad-1 conv over a halo patch split
// into parity planes (the train downsampler's forward, downsampler_train.cu;
// the train upsampler's input gradient, upsampler_train.cu, with PFPatch).
//
// A tile is TH x 32 output pixels (i0 + r, j0 + c), r < TH, c < 32, of one
// image (PPTile, pp_tile_of).  Its input halo patch, input rows 2 i0 - 1 ..
// 2 (i0 + TH) - 1 and columns 2 j0 - 1 .. 2 j0 + 63 ((2 TH + 1) x 65
// pixels), is staged once per tile with cp.async, zero past the map, so
// each input pixel crosses L2 once per tile (the halo's row and column
// once more).  Tap (kh, kw) of output pixel (r, c) is patch pixel
// (2 r + kh, 2 c + kw).
// * PFPatch (Cin = 16, 64): 16-byte copies straight into four parity
//   planes, patch pixel (pr, pc) to plane p = 2 (pr & 1) + (pc & 1) at
//   (pr >> 1, pc >> 1).  Tap (kh, kw) is then plane 2 (kh & 1) + (kw & 1)
//   at (r + (kh >> 1), c + (kw >> 1)): each tap's operand is a unit-stride
//   view of one plane, shifted by 0 or 1, and ldmatrix takes it a pixel
//   row at a time (PFPatch::tap).  The 2x2 pool window of (r, c) is taps
//   4, 5, 7 and 8, read from the same patch.
// * PFRaw (Cin = 3): a patch row is one contiguous run of 65 x 3 values,
//   staged as it is in 4-byte words (cp_async4); the stem's translate
//   shifts the run by tx pixels and the row by ty.  Value e of
//   patch row pr is pixel column 2 j0 - 1 + e / 3, channel e % 3
//   (PFRaw::at).

// plane p = 2 (row parity) + column parity of a TH x 32 tile's patch:
// TH + 1 - (p >> 1) rows of 33 - (p & 1) pixels.  A pixel's CIN
// channels are VK = CIN / 8 chunks of 16 bytes, unpadded; chunk e of plane
// pixel q is stored at chunk e ^ ((q / (8 / VK)) % VK) of the pixel, so the
// 8 rows of an ldmatrix (any 8 consecutive plane pixels) fall on the 8
// bank groups of a 128-byte line.
template <int CIN, int TH_>
struct PFPatch {
  static_assert(CIN == 16 || CIN == 64, "2 or 8 chunks a pixel");
  static constexpr int TH = TH_, TW = 32, PR = 2 * TH + 1, PC = 2 * TW + 1;
  static constexpr int LDK = CIN, VK = CIN / 8, PER_LINE = 8 / VK;
  static constexpr int PIXELS = PR * PC;
  static constexpr size_t bytes = pp_align((size_t)PIXELS * LDK * 2);
  __host__ __device__ static constexpr int cols(int p) {
    return TW + 1 - (p & 1);
  }
  __host__ __device__ static constexpr int plane_off(int p) {  // pixels
    return p < 2 ? p * (TH + 1) * (TW + 1)
                 : (TH + 1) * PC + (p - 2) * TH * (TW + 1);
  }
  // the plane pixel of patch pixel (pr, pc)
  __host__ __device__ static constexpr int pixel(int pr, int pc) {
    return plane_off((pr & 1) * 2 + (pc & 1)) +
           (pr >> 1) * cols((pr & 1) * 2 + (pc & 1)) + (pc >> 1);
  }
  // tap (kh, kw) of output pixel (r, c): the plane pixel of patch pixel
  // (2 r + kh, 2 c + kw), plane 2 (kh & 1) + (kw & 1) at (r + (kh >> 1),
  // c + (kw >> 1))
  __host__ __device__ static constexpr int tap(int r, int c, int kh,
                                               int kw) {
    return pixel(2 * r + kh, 2 * c + kw);
  }
  // chunk e (channels 8 e .. 8 e + 7) of plane pixel q
  __device__ static const bf16* at(const bf16* patch, int q, int e) {
    return patch + q * LDK + (e ^ ((q / PER_LINE) % VK)) * 8;
  }
};

// Start copying tile tl's patch of the bf16 map x (B, H, W, CIN) into its
// planes at dst.
template <class P>
__device__ __forceinline__ void pf_load_patch(bf16* dst, const bf16* x,
                                              PPTile tl, int H, int W,
                                              int nthreads) {
  for (int v = threadIdx.x; v < P::PIXELS * P::VK; v += nthreads) {
    const int pix = v / P::VK, e = v % P::VK;
    const int pr = pix / P::PC, pc = pix % P::PC;
    const int h = 2 * tl.i0 - 1 + pr, w = 2 * tl.j0 - 1 + pc;
    const bool valid = h >= 0 && h < H && w >= 0 && w < W;
    const long long src =
        valid ? (((long long)tl.b * H + h) * W + w) * (P::VK * 8) + e * 8 : 0;
    cp_async16(const_cast<bf16*>(P::at(dst, P::pixel(pr, pc), e)), x + src,
               valid);
  }
}

// The 3-channel patch: STEM, an f32 map (the stem's image, translated;
// the f32 forward's 3-channel map, untranslated), staged unrounded; else
// a bf16 map, whose rows start on a word (W even) and whose patch run
// starts on the second half of one (LEAD).
template <bool STEM_, int TH_>
struct PFRaw {
  static constexpr bool STEM = STEM_;
  using T = std::conditional_t<STEM, float, bf16>;
  static constexpr int TH = TH_, TW = 32, PR = 2 * TH + 1;
  static constexpr int RUN = (2 * TW + 1) * 3, LEAD = STEM ? 0 : 1;
  static constexpr int WORDS = ((LEAD + RUN) * (int)sizeof(T) + 3) / 4;
  static constexpr int LDR = (WORDS * 4 + 15) / 16 * 16;  // row pitch, bytes
  static constexpr size_t bytes = pp_align((size_t)PR * LDR);
  __device__ static float at(const unsigned char* raw, int pr, int e) {
    return to_f32(reinterpret_cast<const T*>(raw + pr * LDR)[LEAD + e]);
  }
};

// Start copying tile tl's patch rows into dst.  STEM: x is an f32 (B, H,
// W, 3) map and the patch is of its translate by (tx, ty) = shifts[b]
// (out[h, w] = x[h - ty, w - tx], zero outside either map; no translate
// when shifts is null); else x is a bf16 (B, H, W, 3) map, read a word
// (two values) at a time.
template <class R>
__device__ __forceinline__ void pf_load_raw(unsigned char* dst,
                                            const void* x, const int* shifts,
                                            PPTile tl, int H, int W,
                                            int nthreads) {
  int tx = 0, ty = 0;
  if constexpr (R::STEM) {
    if (shifts) {
      tx = __ldg(shifts + 2 * tl.b);
      ty = __ldg(shifts + 2 * tl.b + 1);
    }
  }
  for (int v = threadIdx.x; v < R::PR * R::WORDS; v += nthreads) {
    const int pr = v / R::WORDS, k = v % R::WORDS;
    const int h = 2 * tl.i0 - 1 + pr;
    bool valid;
    long long src;
    if constexpr (R::STEM) {
      const int w = 2 * tl.j0 - 1 + k / 3;  // the translated image's column
      valid = h >= 0 && h < H && w >= 0 && w < W && h - ty >= 0 &&
              h - ty < H && w - tx >= 0 && w - tx < W;
      src = valid ? (((long long)tl.b * H + h - ty) * W + w - tx) * 3 + k % 3
                  : 0;
    } else {
      const int q = 3 * tl.j0 - 2 + k;  // the row's word: values 2 q, 2 q + 1
      valid = h >= 0 && h < H && q >= 0 && q < 3 * W / 2;
      src = valid ? ((long long)tl.b * H + h) * (3 * W / 2) + q : 0;
    }
    cp_async4(dst + pr * R::LDR + 4 * k,
              static_cast<const uint32_t*>(x) + src, valid);
  }
}

// ---------------------------------------------------------------------------
// f32 halo patches: PFPatch's geometry with f32 channels, the staging of
// the f32 forms of the halo-patch stride-2 conv (the train upsampler's dx,
// upsampler_train.cu dx32_kernel, and the f32 train downsampler forward,
// downsampler_train.cu down_fwd32_kernel).  A pixel's CIN f32 channels are
// VK = CIN / 4 chunks of 16 bytes, unpadded, chunk e of plane pixel q at
// chunk e ^ f32_swz(q, VK).
// ---------------------------------------------------------------------------

// 16-byte chunk e of row q of an f32 array of V chunks a row (V = 4, 8 or
// 16) is stored at chunk e ^ f32_swz(q, V) of the row, so that the same
// chunk of any 8 consecutive rows falls on the 8 bank groups of a
// 128-byte line.
__host__ __device__ constexpr int f32_swz(int q, int V) {
  return V >= 8 ? (q & 7) : (q / (8 / V)) % V;
}

// Start copying tile tl's patch of the f32 map x (B, H, W, CIN) into its
// planes at dst (P = PFPatch<CIN, TH>), zero past the map.
template <class P>
__device__ __forceinline__ void pf_load_patch_f32(float* dst, const float* x,
                                                  PPTile tl, int H, int W,
                                                  int nthreads) {
  constexpr int CIN = P::LDK, VK = CIN / 4;
  for (int c = threadIdx.x; c < P::PIXELS * VK; c += nthreads) {
    const int pix = c / VK, e = c % VK;
    const int pr = pix / P::PC, pc = pix % P::PC;
    const int h = 2 * tl.i0 - 1 + pr, col = 2 * tl.j0 - 1 + pc;
    const bool valid = h >= 0 && h < H && col >= 0 && col < W;
    const long long src =
        valid ? (((long long)tl.b * H + h) * W + col) * CIN + 4 * e : 0;
    const int q = P::pixel(pr, pc);
    cp_async16(dst + q * CIN + 4 * (e ^ f32_swz(q, VK)), x + src, valid);
  }
}

// chunk e (channels 4 e .. 4 e + 3) of plane pixel q of an f32 patch
template <class P>
__device__ __forceinline__ const float* pf32_at(const float* patch, int q,
                                                int e) {
  return patch + q * P::LDK + 4 * (e ^ f32_swz(q, P::LDK / 4));
}

// The copies of the f32 halo-patch convs' persistent CTAs.  A tile's
// weights are STAGES stages (a tap, or part of one, each), streamed
// through a ring of NS stage buffers with NS - 1 cp.async groups in
// flight; NS == STAGES keeps them resident, loaded by the CTA's first
// tile only.  Group v holds stage v % STAGES of the CTA's tile kk = v /
// STAGES and, with the tile's first stage, its patch (into patch buffer
// kk & 1), so the next tile's patch is in flight through this tile's last
// NS - 1 stages.  A patch buffer is next written by the patch of the tile
// two on, issued after the next tile's first barrier: a tile may stage
// its output in its own patch buffer once its stages are done.  The
// caller's copies:
//   patch(kk)      start copying the patch of the CTA's tile kk
//   stage(r, s)    start copying stage s into ring buffer r
template <int STAGES, int NS>
struct PFRing {
  static constexpr bool RESIDENT = NS == STAGES;
  static_assert(NS >= 2 && NS <= STAGES, "f32 stage ring");

  template <class Patch, class Stage>
  __device__ __forceinline__ static void issue(int v, int tiles,
                                               const Patch& patch,
                                               const Stage& stage) {
    const int kk = v / STAGES, s = v % STAGES;
    if (blockIdx.x + kk * gridDim.x < tiles) {
      if (s == 0) patch(kk);
      if (!RESIDENT || kk == 0) stage(v % NS, s);
    }
    cp_async_commit();
  }
  // the first NS - 1 groups
  template <class Patch, class Stage>
  __device__ __forceinline__ static void start(int tiles, const Patch& patch,
                                               const Stage& stage) {
    for (int v = 0; v < NS - 1; ++v) issue(v, tiles, patch, stage);
  }
  // Before stage s of the CTA's tile kk: its group landed and seen by
  // every thread, then the group NS - 1 ahead issued (into the buffer
  // that stage s - 1 left).  Returns the ring buffer of stage s.
  template <class Patch, class Stage>
  __device__ __forceinline__ static int next(int kk, int s, int tiles,
                                             const Patch& patch,
                                             const Stage& stage) {
    const int u = kk * STAGES + s;
    cp_async_wait_group<NS - 2>();
    // resident stages: after the first tile only the patch needs a barrier
    if (!RESIDENT || s == 0 || kk == 0) __syncthreads();
    issue(u + NS - 1, tiles, patch, stage);
    return u % NS;
  }
};

// Tap (kh, kw) of this thread's TM output pixels (pr[i], pc[i]) in an f32
// patch (P = PFPatch): chunk e of pixel i at patch + off[i] + 4 (e ^
// swz[i]).
template <class P, int TM>
struct PF32Tap {
  int off[TM], swz[TM];
  __device__ __forceinline__ PF32Tap(const int (&pr)[TM],
                                     const int (&pc)[TM], int kh, int kw) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int q = P::tap(pr[i], pc[i], kh, kw);
      off[i] = q * P::LDK;
      swz[i] = f32_swz(q, P::LDK / 4);
    }
  }
};

// The FFMA micro-tile of the f32 halo-patch convs: part[i][j] += the tap's
// chunks e0 .. e0 + VS - 1 of pixel i (channels 4 e0 .. 4 (e0 + VS) - 1)
// times the matching rows of the B operand, output j.  Per chunk, TM
// float4 of the patch and b(e, bv), the caller's 4 x TN block of B (bv[k]
// [j]: the stage's channel 4 e + k, this thread's output j), then 4 TM TN
// FMAs; each output is one FMA chain in increasing channel.  The tap a:
// PF32Tap, or any view with the same off[TM] and swz[TM] (nb1d_pair.cu's
// line patches).  UNROLL: the chunks unrolled (all of them by default;
// nb1d_pair.cu's convs take 4, scripts/cuda_pair_variants.py times others).
template <int VS, int UNROLL = VS, class Tap, int TM, int TN, class BLoad>
__device__ __forceinline__ void pf32_fma(const float* patch, const Tap& a,
                                         int e0, const BLoad& b,
                                         float (&part)[TM][TN]) {
#pragma unroll (UNROLL)
  for (int e = 0; e < VS; ++e) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      av[i] = *reinterpret_cast<const float4*>(patch + a.off[i] +
                                               4 * ((e0 + e) ^ a.swz[i]));
    float bv[4][TN];
    b(e, bv);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float x = k == 0   ? av[i].x
                        : k == 1 ? av[i].y
                        : k == 2 ? av[i].z
                                 : av[i].w;
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = fmaf(x, bv[k][j], part[i][j]);
      }
  }
}

}  // namespace erfk
