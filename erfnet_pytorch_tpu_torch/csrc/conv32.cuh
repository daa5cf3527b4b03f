// The halo-patch convs along one axis, shared by the train NB1d conv pair
// (nb1d_pair.cu: its four bf16 convs use the tiling, its f32 convs all of
// it) and the f32 eval NB1d block (nb1d.cu: its four stages); at the end,
// the 3xTF32 product's TF32 split and wgmma, which the f32 upsampler
// forward (ups_fwd32.cuh) shares.
//
// Tiling (Geo, make_geo, tile_at): a conv of dilation d along H or W runs
// over tiles of L positions along x TA across of one image; a tile's halo
// patch, the L + 2d positions along (clamped to the map) x TA, is staged
// once and the three taps are views of it shifted by -d, 0 and d (Taps,
// taps_of), a row off the map reading a zero pixel (which also covers d >=
// H or W).  Tiles span the axis where the patch fits, else take the least
// halo that fits, else three bands of L for a dilation too large for one
// patch.
//
// f32 patches (stage_patch32): 16-byte cp.async (cp.async.cg: through L2,
// so a map written earlier in the same launch is read correctly) into f32
// rows whose 16-byte chunks are swizzled (parity_plane.cuh f32_swz), a zero
// pixel after the patch.  conv32_tiles: persistent CTAs walk their tiles
// (t = blockIdx.x, + gridDim.x, ...) with the next tile's patch in flight
// (parity_plane.cuh PFRing), the (3C x C) tap stack resident (at C = 128
// the output channels split over blockIdx.y), each thread 4 pixels x 8
// channels on the FFMA micro-tile pf32_fma, and an epilogue functor on
// each group of 4 channels (EpiReluBias32 here; the pair's own beside its
// kernels).
#pragma once

#include "common.cuh"
#include "parity_plane.cuh"

namespace erfk {

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// A conv's tiling along its axis (0: H, the H conv and its transpose; 1:
// W).  n, m: the map's extent along and across the axis; d: the dilation,
// at most n (a tap at or past n reads zeros, as one at n does).  A tile is
// L positions along x TA across of one image (TA = 2^lg), tile pixel q =
// i TA + a (i < L, a < TA) at along s0 + i, across a0 + a; segs x ablk
// tiles an image.  Its patch: band = 0, the along positions [lo, lo + ext) = [max(0, s0 -
// d), min(n, s0 + L + d)) x TA, patch pixel (p - lo) TA + a; band = 1 (a d
// too large for that to fit), three bands of L positions, band t at s0 +
// (t - 1) d, patch pixel (t L + i) TA + a.  Tap t of tile pixel (i, a)
// reads along p = s0 + i + (t - 1) d, a zero pixel where p is off the map.
struct Geo {
  int axis, d, n, m, L, TA, lg, band, segs, ablk;
};

// The tiling of a conv of dilation d along axis of an (H, W) map, for
// tiles of at most bm pixels whose patch holds at most cap pixels, at
// least ta_min across (a power of two): the tile spans the axis where it
// can (no halo is read); else the smallest TA (the longest L, the least
// halo) whose patch fits; else bands.
inline Geo make_geo(int H, int W, int axis, int d, int bm, int cap, int ta_min) {
  Geo g;
  g.axis = axis;
  g.n = axis ? W : H;
  g.m = axis ? H : W;
  g.d = d < g.n ? d : g.n;
  g.band = 0;
  if ((long long)g.n * ta_min <= bm) {
    g.L = g.n;
    const int most = bm / g.n < g.m ? bm / g.n : g.m;
    for (g.TA = 1; 2 * g.TA <= most;) g.TA *= 2;
  } else {
    g.band = 1;
    for (int ta = ta_min; ta <= bm; ta *= 2) {
      const int L = bm / ta;
      const int ext = L + 2 * g.d < g.n ? L + 2 * g.d : g.n;
      if ((long long)ext * ta <= cap) {
        g.L = L;
        g.TA = ta;
        g.band = 0;
        break;
      }
    }
    if (g.band) {
      g.TA = ta_min;
      g.L = cap / (3 * ta_min);
    }
  }
  for (g.lg = 0; (1 << g.lg) < g.TA;) ++g.lg;
  g.segs = (g.n + g.L - 1) / g.L;
  g.ablk = (g.m + g.TA - 1) / g.TA;
  return g;
}

// Tile t of a tiling: its image, first along and across positions, and
// its patch's along positions (band 0: [lo, lo + ext); band 1: 3 L).
struct Tile {
  int b, s0, a0, lo, ext;
};

__device__ __forceinline__ Tile tile_at(const Geo& g, int t) {
  const int per = g.segs * g.ablk, l = t % per;
  Tile r;
  r.b = t / per;
  r.s0 = (l / g.ablk) * g.L;
  r.a0 = (l % g.ablk) * g.TA;
  if (g.band) {
    r.lo = 0;
    r.ext = 3 * g.L;
  } else {
    r.lo = r.s0 > g.d ? r.s0 - g.d : 0;
    const int hi = r.s0 + g.L + g.d;
    r.ext = (hi < g.n ? hi : g.n) - r.lo;
  }
  return r;
}

// The map pixel of image b at along p, across c.
__device__ __forceinline__ long long geo_pixel(const Geo& g, int b, int p,
                                               int c) {
  return g.axis == 0 ? ((long long)b * g.n + p) * g.m + c
                     : ((long long)b * g.m + c) * g.n + p;
}

// Tile pixel q -> (i, a); false past the tile or the map.
__device__ __forceinline__ bool tile_pixel(const Geo& g, const Tile& tl,
                                           int q, int& i, int& a) {
  i = q >> g.lg;
  a = q & (g.TA - 1);
  return i < g.L && tl.s0 + i < g.n && tl.a0 + a < g.m;
}

// Tap t of tile pixel q = (i, a) reads patch pixel q + shift[t] where
// lo[t] <= i < hi[t] (else the zero pixel): the tile's three views.
struct Taps {
  int shift[3], lo[3], hi[3];
};

__device__ __forceinline__ Taps taps_of(const Geo& g, const Tile& tl) {
  Taps r;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const int off = tl.s0 + (t - 1) * g.d;  // along of (i = 0, tap t)
    r.shift[t] = (g.band ? t * g.L : off - tl.lo) << g.lg;
    r.lo[t] = -off;
    r.hi[t] = g.n - off;
  }
  return r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Start copying tile tl's patch of the (B, H, W, C) f32 map src into dst
// (C floats a pixel, chunk e of patch pixel px at chunk e ^ f32_swz(px, C /
// 4) with SWZ, else at e), zero where a position is off the map: the f32
// form of stage_patch.
template <int C, int THREADS, bool SWZ>
__device__ __forceinline__ void stage_patch32(float* dst, const float* src,
                                              const Geo& g, const Tile& tl) {
  constexpr int VK = C / 4;
  static_assert(THREADS % VK == 0, "a thread copies one chunk of pixels");
  const int npx = tl.ext << g.lg, e = threadIdx.x % VK;
  for (int px = threadIdx.x / VK; px < npx; px += THREADS / VK) {
    const int j = px >> g.lg, c = tl.a0 + (px & (g.TA - 1));
    int p;
    if (g.band)
      p = tl.s0 + j % g.L + (j / g.L - 1) * g.d;
    else
      p = tl.lo + j;
    const bool valid = p >= 0 && p < g.n && c < g.m;
    const long long off = valid ? geo_pixel(g, tl.b, p, c) * C + e * 4 : 0;
    cp_async16(dst + px * C + 4 * (SWZ ? e ^ f32_swz(px, VK) : e), src + off,
               valid);
  }
}

// The f32 conv's tile (conv32_tiles).  A CTA computes the N = C / NSPLIT
// output channels of its split (blockIdx.y) over BM = TM RS tile pixels:
// thread (rg, tc) = (tid / TC, tid % TC) owns tile pixels rg + i RS (i <
// TM = 4) and channels split N + 4 tc + g CS + (0 .. 3) (g < TN / 4 = 2,
// CS = 4 TC).  Two patch buffers of CAP pixels and a zero pixel after
// them; the split's share of the tap stack as STAGES stages of KS k rows x
// N (PFRing: resident where NS == STAGES, loaded by the CTA's first tile
// only).  The product runs at 1.7-1.8x its FMA bound, the variants
// alike (8 x 8 a thread, two CTAs an SM, other unrolls: PERF.md).
// * C = 64: the 48 KB stack resident beside two 34 KB patches (tiles of
//   128 pixels: the H conv 128 x 1, the W conv 128 of 256 positions with
//   a halo of 2), one CTA an SM.
// * C = 128: the stack is 192 KB; the output channels split over two CTAs,
//   each with its 96 KB share resident beside two 64 KB patches (the H
//   conv 64 x 2, the W conv 1 x 128: no halo), 225 KB, one CTA an SM
//   (scripts/cuda_pair_variants.py --forms f32 times the other way: one CTA
//   for all 128 channels over 64-pixel tiles, half a tap a stage streamed
//   through a 3-stage ring).
// * C = 16: tiles of 512 pixels (the H conv 256 x 2, the W conv 1 x 512),
//   the 3 KB stack resident, two CTAs an SM where the epilogue reads no
//   map.
// Sum order: one FMA chain per group of TPG taps over (tap, ci) in
// increasing order, the groups added in tap order (C = 128: a chain a tap,
// as the plain version adds its per-tap products).
template <int C>
struct Conv32 {
  static constexpr int THREADS = 256, TM = 4, TN = 8;
  // C = 128: two splits, each its share of the stack resident
  static constexpr int NSPLIT = C == 128 ? 2 : 1, N = C / NSPLIT;
  static constexpr int KS = C, NS = 3;  // k rows a stage, ring stages
  static constexpr int CAP = C == 16 ? 544 : C == 64 ? 136 : 128;  // pixels
  static constexpr int TA_MIN = C == 16 ? 2 : 1;  // H conv: 128-byte runs
  static constexpr int TPG = C == 128 ? 1 : 3;    // taps a chain
  static constexpr int UNROLL = 4;  // chunks of 4 k unrolled (pf32_fma)
  static constexpr int minb(int naux) { return C == 16 && naux == 0 ? 2 : 1; }
  static constexpr int TC = N / TN, RS = THREADS / TC, BM = TM * RS;
  static constexpr int CS = 4 * TC, VK = C / 4, VS = KS / 4;
  static constexpr int SPT = C / KS, STAGES = 3 * SPT;  // a tap's, a tile's
  static constexpr size_t patch_bytes = align128((size_t)(CAP + 1) * C * 4);
  static constexpr size_t stage_bytes = (size_t)KS * N * 4;
  static constexpr size_t ring_off = 2 * patch_bytes;
  static constexpr size_t smem = ring_off + NS * stage_bytes;
  static_assert(N % TN == 0 && THREADS % TC == 0 && TC <= 32 &&
                    C % KS == 0 && KS % 4 == 0 && 3 % TPG == 0 &&
                    NS <= STAGES && CAP >= BM &&
                    (size_t)(THREADS / 32) * 2 * N * 4 <= (size_t)CAP * C * 4 &&
                    smem <= 232448,
                "f32 pair conv tile");
};

template <int C>
Geo conv32_geo(int H, int W, int axis, int d) {
  using K = Conv32<C>;
  return make_geo(H, W, axis, d, K::BM, K::CAP, axis == 0 ? K::TA_MIN : 1);
}

// Tap t's view for this thread's TM pixels: chunk e of pixel i at patch +
// off[i] + 4 (e ^ swz[i]) (pf32_fma), the zero pixel where it is off the
// map or the pixel past the tile.
template <int TM>
struct LineTap32 {
  int off[TM], swz[TM];
};

// One f32 conv over this CTA's tiles (t = blockIdx.x, + gridDim.x, ...):
// acc = sum_t view_t(patch) @ w[t] for the split's channels; then epi(pixel,
// b, c0, v, s0, s1, centre, av) for every map pixel of the tile and each
// group of 4 channels c0 .. c0 + 3 a thread holds (centre: the conv's input
// there, tap 1 of the patch; av: the epilogue's Epi::NAUX maps there, loaded
// before the product, which hides their latency).  The next tile's patch
// copies while this one
// multiplies.  With Epi::SUMS the per-thread sums s0, s1 are added over the
// CTA's tiles, then over the CTA in a fixed order (flush32: the lanes of a
// column by an xor tree, then the warps in order, through the finished
// tile's patch buffer): per (image, CTA) at part[(b gridDim.x + cta) 2C]
// with Epi::PER_IMAGE (zero for the images the CTA has no tile of), else per
// CTA at part[cta 2C]; a split writes its N columns of each half.
template <int C, class Epi>
__device__ __forceinline__ void conv32_tiles(unsigned char* smem,
                                             const float* src, const float* w,
                                             const Geo g, int B,
                                             const Epi& epi, float* part) {
  using K = Conv32<C>;
  using Ring = PFRing<K::STAGES, K::NS>;
  constexpr int TM = K::TM, TN = K::TN, N = K::N, VK = K::VK;
  constexpr int NA = Epi::NAUX > 0 ? Epi::NAUX : 1;
  const int tiles = B * g.segs * g.ablk;
  const int split = blockIdx.y, tc = threadIdx.x % K::TC;
  const int rg = threadIdx.x / K::TC, lane = threadIdx.x % 32;
  const int cb = split * N + 4 * tc;  // this thread's first channel
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * K::patch_bytes);
  };
  auto stage_of = [&](int r) {
    return reinterpret_cast<float*>(smem + K::ring_off + r * K::stage_bytes);
  };
  for (int v = threadIdx.x; v < 2 * VK; v += K::THREADS)  // the zero pixels
    reinterpret_cast<float4*>(patch_of(v / VK) + K::CAP * C)[v % VK] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto patch = [&](int kk) {
    stage_patch32<C, K::THREADS, true>(
        patch_of(kk), src, g, tile_at(g, blockIdx.x + kk * (int)gridDim.x));
  };
  // stage s: k rows (s % SPT) KS .. + KS of tap s / SPT, the split's N
  // columns
  auto stage = [&](int r, int s) {
    float* dst = stage_of(r);
    const float* from =
        w + ((size_t)(s / K::SPT) * C + (s % K::SPT) * K::KS) * C + split * N;
    for (int c = threadIdx.x; c < K::KS * N / 4; c += K::THREADS) {
      const int k = c / (N / 4), j = c % (N / 4);
      cp_async16(dst + k * N + 4 * j, from + (size_t)k * C + 4 * j, true);
    }
  };
  float s0[TN], s1[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) s0[j] = s1[j] = 0.0f;
  auto image_row = [&](int b) {
    return part + ((long long)b * gridDim.x + blockIdx.x) * 2 * C;
  };
  // column c < 2N of the split's [s0 | s1] -> its place in a 2C row
  auto col = [&](int c) { return c < N ? split * N + c : C + split * N + c - N; };
  auto zero_rows = [&](int from, int to) {
    for (int b = from; b < to; ++b)
      for (int c = threadIdx.x; c < 2 * N; c += K::THREADS)
        image_row(b)[col(c)] = 0.0f;
  };
  // the sums over the CTA into dst[0, 2C) (this split's columns), zeroed;
  // red: a dead patch buffer.  Every thread calls it.
  auto flush32 = [&](float* red, float* dst) {
    __syncthreads();  // every warp is done with red's patch
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float a = s0[j], b = s1[j];
#pragma unroll
      for (int o = K::TC; o < 32; o *= 2) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane < K::TC) {
        const int c = 4 * tc + (j / 4) * K::CS + j % 4;
        red[warp * 2 * N + c] = a;
        red[warp * 2 * N + N + c] = b;
      }
      s0[j] = s1[j] = 0.0f;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * N; c += K::THREADS) {
      float s = 0.0f;
      for (int wp = 0; wp < K::THREADS / 32; ++wp) s += red[wp * 2 * N + c];
      dst[col(c)] = s;
    }
    __syncthreads();
  };

  Ring::start(tiles, patch, stage);
  int next_img = 0;  // PER_IMAGE: the first image row not yet written
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const Tile tl = tile_at(g, t);
    const Taps tv = taps_of(g, tl);
    int q[TM], along[TM];
    bool ok[TM];
    long long pix[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      int a;
      q[i] = rg + i * K::RS;
      ok[i] = tile_pixel(g, tl, q[i], along[i], a);
      pix[i] = ok[i] ? geo_pixel(g, tl.b, tl.s0 + along[i], tl.a0 + a) : 0;
    }
    // the epilogue's maps, loaded before the product
    float4 aux[TM][TN / 4][NA];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int x = 0; x < TN / 4; ++x)
#pragma unroll
        for (int y = 0; y < Epi::NAUX; ++y)
          aux[i][x][y] = ok[i] ? ld4(epi.aux(y) + pix[i] * C + cb + x * K::CS)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* pb = patch_of(kk);
    float acc[TM][TN], psum[TM][TN];
    zero_tile(acc);
    zero_tile(psum);
#pragma unroll 1
    for (int s = 0; s < K::STAGES; ++s) {
      const float* bs =
          stage_of(Ring::next(kk, s, tiles, patch, stage)) + 4 * tc;
      const int tp = s / K::SPT;
      LineTap32<TM> a;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ok[i] && along[i] >= tv.lo[tp] && along[i] < tv.hi[tp]
                          ? q[i] + tv.shift[tp]
                          : K::CAP;
        a.off[i] = r * C;
        a.swz[i] = f32_swz(r, VK);
      }
      // B: the stage's row 4 e + k, this thread's columns 4 tc + x CS ..
      auto bload = [&](int e, float (&bv)[4][TN]) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int x = 0; x < TN / 4; ++x) {
            const float4 v = *reinterpret_cast<const float4*>(
                bs + (4 * e + k) * N + x * K::CS);
            bv[k][4 * x] = v.x; bv[k][4 * x + 1] = v.y;
            bv[k][4 * x + 2] = v.z; bv[k][4 * x + 3] = v.w;
          }
      };
      if constexpr (K::TPG == 3 && K::SPT == 1) {  // one chain: straight in
        pf32_fma<K::VS, K::UNROLL>(pb, a, 0, bload, acc);
      } else {
        pf32_fma<K::VS, K::UNROLL>(pb, a, (s % K::SPT) * K::VS, bload, psum);
        if (s % K::SPT == K::SPT - 1 && tp % K::TPG == K::TPG - 1) {
          add_tile(acc, psum);  // the group's chain ends
          zero_tile(psum);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (!ok[i]) continue;
      const int rc = q[i] + tv.shift[1];  // the centre tap's patch pixel
#pragma unroll
      for (int x = 0; x < TN / 4; ++x) {
        const int c0 = cb + x * K::CS;
        float v[4] = {acc[i][4 * x], acc[i][4 * x + 1], acc[i][4 * x + 2],
                      acc[i][4 * x + 3]};
        epi(pix[i], tl.b, c0, v, s0 + 4 * x, s1 + 4 * x,
            pb + rc * C + 4 * ((c0 / 4) ^ f32_swz(rc, VK)), aux[i][x]);
      }
    }
    if constexpr (Epi::SUMS) {
      // the CTA's last tile, or (per image) its last tile of this image
      const int tn = t + (int)gridDim.x;
      if (tn >= tiles || (Epi::PER_IMAGE && tile_at(g, tn).b != tl.b)) {
        float* red = patch_of(kk);  // read: patch kk + 2 comes after the
                                    // next tile's first barrier
        if constexpr (Epi::PER_IMAGE) {
          zero_rows(next_img, tl.b);
          flush32(red, image_row(tl.b));
          next_img = tl.b + 1;
        } else {
          flush32(red, part + (long long)blockIdx.x * 2 * C);
        }
      }
    }
  }
  if constexpr (Epi::SUMS && Epi::PER_IMAGE) zero_rows(next_img, B);
  cp_async_wait_all();
}

// The f32 epilogues, on channels c0 .. c0 + 3 of map pixel m: v the sums,
// av[y] the NAUX maps loaded there before the product, ctr the conv's input
// there (the patch's centre tap).
// t1 = relu(acc + bh)
template <int C>
struct EpiReluBias32 {
  static constexpr bool SUMS = false, PER_IMAGE = false;
  static constexpr int NAUX = 0;
  const float* bias;
  float* out;
  __device__ const float* aux(int) const { return nullptr; }
  __device__ void operator()(long long m, int, int c0, float (&v)[4], float*,
                             float*, const float*,
                             const float4 (&)[1]) const {
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = fmaxf(v[k] + __ldg(bias + c0 + k), 0.0f);
    st4(out + m * C + c0, o);
  }
};

// ---------------------------------------------------------------------------
// The 3xTF32 product's pieces (nb1d.cu tc_tiles, ups_fwd32.cuh): the TF32
// split of an f32 value and wgmma m64nNk8 with A, TF32, in registers.
// ---------------------------------------------------------------------------

// x = hi + lo + r: hi = x rounded to TF32 (10 mantissa bits, to nearest,
// ties away), lo = (x - hi) rounded the same way (x - hi is exact in f32),
// |r| <= 2^-22 |x|.  (ops/cuda/nb1d.py tc_taps splits the weights so.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  hi &= 0xffffe000u;
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// wgmma: d (64 x n, the warpgroup's accumulator fragments) = a (64 x 8,
// TF32 in registers) b (8 x n, TF32 in shared memory at the descriptor b)
// + (scale_d ? d : 0), n = 2 x the floats of d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %13, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %21, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[24],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %28, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %29, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %37, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b));
}

}  // namespace erfk
