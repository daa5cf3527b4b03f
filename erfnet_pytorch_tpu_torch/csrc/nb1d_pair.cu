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
//   t1 = bf16(relu(conv_h(t0) + bh))      3 taps along H, dilation dh
//   z  = bf16(conv_w(t1) + bw)            3 taps along W, dilation dw
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
// conv (t1), the W conv (z and the statistic partials), the reduction of
// the partials.  Backward: the g fold, the transposed W conv (dz1, bias
// partials), the transposed H conv (the lead's backward and its partials),
// the weight-gradient product (six (C x C) products as per-chunk
// partials), and two fixed-order reductions.  t0 and t1 are kept from the
// forward instead of recomputed: memory for one conv per backward.
//
// Each bf16 conv is an implicit GEMM (K = 3C) over tiles of pixels along
// its axis (conv_tiles, conv32.cuh's Geo): a tile is L positions along
// the axis x TA across it, and its halo patch, the L + 2d positions along
// (clamped to the map) x TA, is staged once with cp.async; the three taps
// are views of the patch shifted by -d, 0 and d along the axis (ldmatrix
// takes each lane's row address: a view costs no copy, a row off the map
// reads a zero pixel, which also covers d >= H or W).  Tiles span the
// axis where the patch fits (the B=6 path: the C = 128 H conv 64 x 2, its
// W conv 1 x 128, the C = 64 H conv 128 x 1; no halo is read), else take the
// least halo that fits (the C = 64 W conv 128 of 256 positions, the C =
// 16 convs 64 x 4 and 256 of 512: 1-3 % more), else three bands of L for
// a dilation too large for one patch.  So each input pixel crosses L2
// about once a conv, where the im2col tile of 64 pixels x 3 taps took it
// three times.  The (3C x C) tap stack is resident; a persistent CTA
// walks its tiles with a ring of NS patches, the next tiles' patches
// copying while this one multiplies (three at C = 64, two CTAs an SM for
// the forward convs; three at C = 128, one CTA; four at C = 16, whose
// 256-pixel tiles move 8 KB).  Eight warps of 32 rows x C / 2 columns (C
// = 16: all 16) multiply with ldmatrix + mma.sync, f32 accumulators, and
// the epilogue runs from the accumulator fragments: at C = 64 and 128 the
// fragments of four n8 tiles are transposed across each quad by shuffles
// (quad_gather), so that a lane holds 8 consecutive channels of a pixel
// and loads and stores 16 bytes; bias, ReLU, the [t1 > 0] mask, the
// lead's backward and the bf16 rounding happen in registers, g for dbw is
// read from the patch's centre tap, and the maps the epilogue reads (t1;
// x, the mask, gy) are loaded before the product, which hides their
// latency.  The statistic and bias partials are per CTA (the forward's
// per (image, CTA)): each thread adds its columns over all its tiles,
// then an xor tree over the lanes and the warps in order (flush_sums), so
// reduce_parts adds grid-many rows (the resident CTAs,
// erf_pair_part_rows), where one row a 64-pixel tile took 768-12288.  The
// grid comes from the SM count and the occupancy, so the order is fixed on
// a card and a step is bit-reproducible.  The transposed convs are the
// same kernel with the tap stack flipped and each tap transposed (the
// wrapper prepares it).
//
// The weight gradient (wgrad_kernel) runs on a (chunk of tiles, axis)
// grid: a CTA stages each tile's dz1 or g rows and the halo patch of t0
// or t1 along its axis once, the three taps shifted views of the patch,
// through a ring of stages; at C = 128 the output columns split in four
// (see Wg).  Chunks are one wave of its CTAs from the SM count, at most 9
// MiB of partials (erf_pair_wg_chunks).
//
// Bound on this card: 6 C^2 MACs per pixel forward and 12 C^2 backward
// against 4 C to 10 C bytes per pixel read and written once, so
// operations at C = 128 and bytes at C = 64 and at C = 16 (the decoder's
// last run).  What is left: t1, g and dz1 still pass through device
// memory between launches, the lead and the g fold are passes of their
// own, mma.sync, not wgmma, multiplies, and 16-byte cp.async copies (a
// CTA's requests in flight) pace the memory-bound kernels: TMA tensor
// copies of whole patches are the next step.

// The f32 forms (erf_pair_*_f32, the JAX package's default compute dtype):
// the same launches and the same function with every map in f32 and
// nothing rounded to bf16 (t0, t1, z, g, dz1 and the outputs stay f32; the
// lead stage's a, b and mask are not rounded), and the bf16 forms' design
// on the CUDA cores (no TF32).  The four convs (conv32_tiles, Conv32; they,
// the tiling, the patch loader stage_patch32 and t1's epilogue live in
// conv32.cuh, which the f32 eval block nb1d.cu shares) run over the bf16
// tiling (make_geo) at the f32 pixel budget: a tile's halo
// patch is staged once with 16-byte cp.async into f32 rows whose chunks
// are swizzled (parity_plane.cuh f32_swz), a zero pixel after it; the
// three taps are shifted views, and persistent CTAs walk their tiles with
// the next tile's patch in flight (PFRing).  Each thread multiplies 4
// pixels x 8 channels on an FFMA micro-tile (pf32_fma): one chain over the
// three taps at C = 64 and 16; at C = 128 a chain a tap, the taps added in
// order (as the plain version adds its per-tap products; one 384-term chain
// took the backward's dx to 4.6e-7 of a 5e-7 limit, PERF.md §6).  The tap
// stack is resident (48 KB at C = 64, 3 KB at 16); at C = 128 (192 KB) the
// output channels split over two CTAs, each with its 96 KB share.  The
// epilogues' maps are loaded before the product; the statistic and bias
// partials are per CTA, the forward's per (image, CTA)
// (erf_pair_part_rows_f32).  The weight gradient (wgrad_f32_kernel, WgF32)
// runs on the (chunk of tiles, axis) grid of wgrad_kernel: per tile the A
// patch and the G rows staged once, the taps as views, a thread 4 input x
// 8 output channels of the three taps; at C = 128 the output columns
// split in four; chunks from erf_pair_wg_chunks_f32, partials per (chunk,
// axis, tap).  Bound at f32: operations (6 C^2 MACs per pixel forward, 12
// C^2 backward, against 67 TFLOP/s), but bytes for the C = 16 epi lead.
//
// The stats-free forms (erf_pair_* with with_stats = 0) replace fused_pair,
// fused_pair_affine and fused_pair_epi (_fwd_kernel / _bwd_kernel and
// their _affine / _epi twins): the W conv's epilogue writes z without
// per-tile partials and the statistics' reduction launch is skipped; the
// backward starts from g = gz (the JAX bwd casts gz to the maps' dtype),
// with no g fold and no read of z.  A fourth lead, relu (lead_relu=True:
// t0 = relu(x), an elementwise launch like the affine lead's), masks dt0
// where x > 0 in its backward, with no sums.  Every form takes the H and
// W dilations apart (dh for the H conv, its transpose and dwh; dw for the
// W ones), on the unpacked map: a tap at or beyond the map's extent reads
// the zero fill.
#include "conv16.cuh"

using namespace erfk;

namespace {

// ---------------------------------------------------------------------------
// bf16: the four convs over halo patches, and the weight gradient
// ---------------------------------------------------------------------------

// The tiling (Geo, make_geo, tile_at, Taps) is conv32.cuh's; the patch
// loader (stage_patch), ldmatrix and quad_gather are conv16.cuh's.

// Two bf16 channels as loaded (packed) and of shared memory, as f32.
__device__ __forceinline__ float2 bf2(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

__device__ __forceinline__ float2 lds2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The conv's tile: BM pixels, a patch of at most CAP pixels (pitch LDK:
// an odd multiple of 16 bytes, so any 8 consecutive patch pixels of an
// ldmatrix fall on 8 bank groups), a ring of NS patches (NS - 1 in flight:
// three at C = 64 and 128, four at C = 16, whose 256-pixel tiles move 8
// KB each), the (3C x C) tap stack resident, a zero pixel, and the sums'
// scratch: 113 KB at C = 64 (two CTAs an SM), 209 KB at C = 128 (one).
// CAP holds the path's patches (C = 128: 64 x 2 and 1 x 128 pixels, C =
// 64: 128 x 1 and 130 x 1).  Eight warps: C = 16 one column band (WN =
// 16), C = 64 and 128 two; WM = 32 rows each.  minb(naux): the CTAs an SM
// the launch bounds ask for; one where the epilogue prefetches naux maps
// at C = 64 (16 registers each), so that they need not spill.
template <int C>
struct Conv {
  static constexpr int THREADS = 256, BM = C == 16 ? 256 : 128;
  static constexpr int CAP = C == 16 ? 512 : C == 64 ? 192 : 128;
  static constexpr int NS = C == 16 ? 4 : 3;
  static constexpr int minb(int naux) {
    return C == 128 || (C == 64 && naux > 0) ? 1 : 2;
  }
  static constexpr int TA_MIN = C == 16 ? 4 : 1;  // H conv: 128-byte runs
  static constexpr int WCOLS = C == 16 ? 1 : 2, WROWS = 8 / WCOLS;
  static constexpr int WN = C / WCOLS, WM = BM / WROWS;
  static constexpr int MT = WM / 16, NT = WN / 8, LDK = C + 8;
  static constexpr size_t patch_bytes = align128((size_t)CAP * LDK * 2);
  static constexpr size_t w_off = NS * patch_bytes;
  static constexpr size_t zero_off = w_off + align128((size_t)3 * C * LDK * 2);
  static constexpr size_t red_off = zero_off + align128((size_t)LDK * 2);
  static constexpr size_t smem = red_off + (size_t)WROWS * 2 * C * 4;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && CAP >= 3 * TA_MIN &&
                    smem <= 232448,
                "pair conv tile");
};

template <int C>
Geo conv_geo(int H, int W, int axis, int d) {
  using K = Conv<C>;
  return make_geo(H, W, axis, d, K::BM, K::CAP, axis == 0 ? K::TA_MIN : 1);
}

// The epilogue's layout: after the product a lane holds, for each of its
// rows, NG groups of E consecutive channels.  C = 64 and 128 (four or
// more n8 tiles a warp): E = 8, the fragments of four n8 tiles transposed
// across the four lanes of a quad (quad_gather), so that each lane's
// loads and stores are 16 bytes; C = 16: E = 2, the fragment's own pair.
template <int C>
struct Epl {
  using K = Conv<C>;
  static constexpr int E = K::NT % 4 == 0 ? 8 : 2, NG = 2 * K::NT / E;
  // the first channel of group x of lane
  __device__ static int chan(int wn, int lane, int x) {
    return wn * K::WN +
           (E == 8 ? (4 * x + lane % 4) * 8 : x * 8 + 2 * (lane % 4));
  }
};

// E bf16 channels: from a map (read-only path), to floats, to a map
// (rounded to nearest even), from shared memory.
template <int E>
__device__ __forceinline__ void ldg_bf16(const bf16* p, unsigned (&u)[E / 2]) {
  if constexpr (E == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
  } else {
    u[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  }
}

template <int E>
__device__ __forceinline__ void unpack(const unsigned (&u)[E / 2],
                                       float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E / 2; ++k) {
    const float2 t = bf2(u[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

template <int E>
__device__ __forceinline__ void st_bf16(bf16* p, const float (&f)[E]) {
  if constexpr (E == 8) {
    *reinterpret_cast<uint4*>(p) = pack_bf16x8(f);
  } else {
    st2(p, f[0], f[1]);
  }
}

template <int E>
__device__ __forceinline__ void lds_bf16(const bf16* p, float (&f)[E]) {
  if constexpr (E == 8) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(p), f);
  } else {
    const float2 t = lds2(p);
    f[0] = t.x;
    f[1] = t.y;
  }
}

// Add this thread's column sums over the CTA in a fixed order (the 8
// lanes of a column by an xor tree, then the WROWS warps of a column band
// in order) into dst[0, 2C) = [s0 | s1], and zero them.  s[x][k] is column
// Epl::chan(wn, lane, x) + k.  Every thread calls it.
template <int C>
__device__ __forceinline__ void flush_sums(
    float (&s0)[Epl<C>::NG][Epl<C>::E], float (&s1)[Epl<C>::NG][Epl<C>::E],
    float* red, float* dst) {
  using K = Conv<C>;
  using P = Epl<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / K::WCOLS, wn = warp % K::WCOLS;
#pragma unroll
  for (int x = 0; x < P::NG; ++x)
#pragma unroll
    for (int k = 0; k < P::E; ++k) {
      float a = s0[x][k], b = s1[x][k];
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (lane < 4) {
        const int col = P::chan(wn, lane, x) + k;
        red[wm * 2 * C + col] = a;
        red[wm * 2 * C + C + col] = b;
      }
      s0[x][k] = s1[x][k] = 0.0f;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += K::THREADS) {
    float s = 0.0f;
    for (int w = 0; w < K::WROWS; ++w) s += red[w * 2 * C + c];
    dst[c] = s;
  }
  __syncthreads();
}

// One conv over this CTA's tiles (t = blockIdx.x, + gridDim.x, ...):
// acc = sum_t view_t(patch) @ w[t]; then epi(pixel, b, c0, v, s0, s1,
// centre, av) for every map pixel of the tile and each group of E
// channels c0 .. c0 + E a lane holds (Epl; centre: the conv's input at
// the pixel, tap 1 of the patch; av: the epilogue's Epi::NAUX maps there,
// loaded before the product, which hides their latency).  The next tiles'
// patches copy while this one multiplies (NS - 1 in flight).  With
// Epi::SUMS the per-thread sums s0, s1 are added over the CTA's tiles and
// stored by flush_sums: per (image, CTA) at part[(b gridDim.x + cta) 2C]
// with Epi::PER_IMAGE (zero rows for the images the CTA has no tile of),
// else per CTA at part[cta 2C].
template <int C, class Epi>
__device__ __forceinline__ void conv_tiles(unsigned char* smem,
                                           const bf16* src, const bf16* w,
                                           const Geo g, int B, const Epi& epi,
                                           float* part) {
  using K = Conv<C>;
  using P = Epl<C>;
  constexpr int E = P::E, NG = P::NG;
  const int tiles = B * g.segs * g.ablk;
  bf16* Ws = reinterpret_cast<bf16*>(smem + K::w_off);
  bf16* zero = reinterpret_cast<bf16*>(smem + K::zero_off);
  float* red = reinterpret_cast<float*>(smem + K::red_off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / K::WCOLS, wn = warp % K::WCOLS;
  for (int v = threadIdx.x; v < K::LDK / 8; v += K::THREADS)
    reinterpret_cast<uint4*>(zero)[v] = zero_vec();
  load_matrix(Ws, K::LDK, w, 3 * C, C);
  auto patch = [&](int k) {
    return reinterpret_cast<bf16*>(smem + (k % K::NS) * K::patch_bytes);
  };
  auto issue = [&](int k) {
    const int t = blockIdx.x + k * (int)gridDim.x;
    if (t < tiles)
      stage_patch<C, K::THREADS, K::LDK, 8>(patch(k), src, g,
                                            tile_at(g, t));
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < K::NS - 1; ++k) issue(k);
  const uint32_t zero_a = smem_addr(zero) + (lane / 16) * 16;
  const uint32_t w_a =
      smem_addr(Ws) + ((lane % 16) * K::LDK + wn * K::WN + (lane / 16) * 8) * 2;
  float s0[NG][E], s1[NG][E];
#pragma unroll
  for (int x = 0; x < NG; ++x)
#pragma unroll
    for (int k = 0; k < E; ++k) s0[x][k] = s1[x][k] = 0.0f;
  int cur = -1, next_img = 0;  // PER_IMAGE: the image in s0, s1; the next row
  auto image_row = [&](int b) {
    return part + ((long long)b * gridDim.x + blockIdx.x) * 2 * C;
  };
  auto zero_rows = [&](int from, int to) {
    for (int b = from; b < to; ++b)
      for (int c = threadIdx.x; c < 2 * C; c += K::THREADS) image_row(b)[c] = 0.0f;
  };
  for (int k = 0, t = blockIdx.x; t < tiles; ++k, t += gridDim.x) {
    cp_async_wait_group<K::NS - 2>();
    __syncthreads();  // tile k's patch is in; tile k - 1's reads are done
    issue(k + K::NS - 1);
    const Tile tl = tile_at(g, t);
    if constexpr (Epi::SUMS && Epi::PER_IMAGE) {
      if (tl.b != cur) {
        if (cur >= 0) {
          zero_rows(next_img, cur);
          flush_sums<C>(s0, s1, red, image_row(cur));
          next_img = cur + 1;
        }
        cur = tl.b;
      }
    }
    const bf16* pt = patch(k);
    const Taps tv = taps_of(g, tl);
    const uint32_t pa = smem_addr(pt) + (lane / 16) * 16;
    uint32_t a_addr[3][K::MT];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt) {
      int i, a;
      const int q = wm * K::WM + mt * 16 + lane % 16;
      const bool ok = tile_pixel(g, tl, q, i, a);
#pragma unroll
      for (int tp = 0; tp < 3; ++tp)
        a_addr[tp][mt] = ok && i >= tv.lo[tp] && i < tv.hi[tp]
                             ? pa + (q + tv.shift[tp]) * (K::LDK * 2)
                             : zero_a;
    }
    // the fragments' rows: lane / 4 and + 8 of each m16 tile
    constexpr int NA = Epi::NAUX > 0 ? Epi::NAUX : 1;
    unsigned aux[K::MT][2][NG][NA][E / 2];
    if constexpr (Epi::NAUX > 0) {
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int i, a;
          const bool ok = tile_pixel(
              g, tl, wm * K::WM + mt * 16 + lane / 4 + 8 * h, i, a);
          const long long pix =
              ok ? geo_pixel(g, tl.b, tl.s0 + i, tl.a0 + a) * C : 0;
#pragma unroll
          for (int x = 0; x < NG; ++x)
#pragma unroll
            for (int y = 0; y < NA; ++y) {
              if (ok)
                ldg_bf16<E>(epi.aux(y) + pix + P::chan(wn, lane, x),
                            aux[mt][h][x][y]);
              else
#pragma unroll
                for (int z = 0; z < E / 2; ++z) aux[mt][h][x][y][z] = 0u;
            }
        }
    }
    float acc[K::MT][K::NT][4];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;
#pragma unroll
    for (int tp = 0; tp < 3; ++tp)
#pragma unroll
      for (int kk = 0; kk < C; kk += 16) {
        unsigned af[K::MT][4];
#pragma unroll
        for (int mt = 0; mt < K::MT; ++mt) ldsm4(af[mt], a_addr[tp][mt] + kk * 2);
#pragma unroll
        for (int n = 0; n < K::WN / 16; ++n) {
          unsigned bb[4];
          ldsm4t(bb, w_a + ((tp * C + kk) * K::LDK + n * 16) * 2);
#pragma unroll
          for (int mt = 0; mt < K::MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * n], af[mt], bb[0], bb[1]);
            mma_bf16_16816(acc[mt][2 * n + 1], af[mt], bb[2], bb[3]);
          }
        }
      }
    // the epilogue, from the fragments (every lane gathers: quad_gather
    // shuffles across the quad, whose four lanes share a row)
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int i, a;
        const int q = wm * K::WM + mt * 16 + lane / 4 + 8 * h;
        const bool ok = tile_pixel(g, tl, q, i, a);
        const long long pix =
            ok ? geo_pixel(g, tl.b, tl.s0 + i, tl.a0 + a) : 0;
        const bf16* ctr = pt + (q + tv.shift[1]) * K::LDK;
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          float v[E];
          if constexpr (E == 8) {
            float p4[4][2];
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              p4[s][0] = acc[mt][4 * x + s][2 * h];
              p4[s][1] = acc[mt][4 * x + s][2 * h + 1];
            }
            quad_gather(p4, v, lane);
          } else {
            v[0] = acc[mt][x][2 * h];
            v[1] = acc[mt][x][2 * h + 1];
          }
          const int c0 = P::chan(wn, lane, x);
          if (ok)
            epi(pix, tl.b, c0, v, s0[x], s1[x], ctr + c0, aux[mt][h][x]);
        }
      }
  }
  if constexpr (Epi::SUMS) {
    if constexpr (Epi::PER_IMAGE) {
      if (cur >= 0) {
        zero_rows(next_img, cur);
        flush_sums<C>(s0, s1, red, image_row(cur));
        next_img = cur + 1;
      }
      zero_rows(next_img, B);
    } else {
      flush_sums<C>(s0, s1, red, part + (long long)blockIdx.x * 2 * C);
    }
  }
  cp_async_wait_all();
}

// The epilogues, on E channels c0 .. c0 + E of map pixel m: v the sums,
// av[y] the NAUX maps prefetched there (aux(y), bf16 pairs packed), ctr
// the conv's input there (shared memory).
// t1 = bf16(relu(acc + bh))
template <int C>
struct EpiReluBias {
  static constexpr bool SUMS = false, PER_IMAGE = false;
  static constexpr int NAUX = 0, E = Epl<C>::E;
  const float* bias;
  bf16* out;
  __device__ const bf16* aux(int) const { return nullptr; }
  __device__ void operator()(long long m, int, int c0, float (&v)[E],
                             float (&)[E], float (&)[E], const bf16*,
                             const unsigned (&)[1][E / 2]) const {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = fmaxf(v[k] + __ldg(bias + c0 + k), 0.0f);
    st_bf16<E>(out + m * C + c0, v);
  }
};

// z = bf16(acc + bw); with S: s0 += z, s1 += z^2 (of the rounded z), per
// image
template <int C, bool S>
struct EpiStats {
  static constexpr bool SUMS = S, PER_IMAGE = true;
  static constexpr int NAUX = 0, E = Epl<C>::E;
  const float* bias;
  bf16* out;
  __device__ const bf16* aux(int) const { return nullptr; }
  __device__ void operator()(long long m, int, int c0, float (&v)[E],
                             float (&s0)[E], float (&s1)[E], const bf16*,
                             const unsigned (&)[1][E / 2]) const {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      v[k] = round_bf16(v[k] + __ldg(bias + c0 + k));
      if constexpr (S) {
        s0[k] += v[k];
        s1[k] += __fmul_rn(v[k], v[k]);
      }
    }
    st_bf16<E>(out + m * C + c0, v);
  }
};

// dz1 = acc [t1 > 0] -> bf16; s0 += dz1 (f32, before rounding), s1 += g
// (g: the conv's input at the pixel, from the patch)
template <int C>
struct EpiDz1 {
  static constexpr bool SUMS = true, PER_IMAGE = false;
  static constexpr int NAUX = 1, E = Epl<C>::E;
  const bf16* t1;
  bf16* out;
  __device__ const bf16* aux(int) const { return t1; }
  __device__ void operator()(long long m, int, int c0, float (&v)[E],
                             float (&s0)[E], float (&s1)[E], const bf16* ctr,
                             const unsigned (&av)[1][E / 2]) const {
    float tv[E], gv[E];
    unpack<E>(av[0], tv);
    lds_bf16<E>(ctr, gv);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      v[k] = tv[k] > 0.0f ? v[k] : 0.0f;
      s0[k] += v[k];
      s1[k] += gv[k];
    }
    st_bf16<E>(out + m * C + c0, v);
  }
};

enum Lead { NONE = 0, AFFINE = 1, EPI = 2, RELU = 3 };

constexpr bool lead_sums(int mode) { return mode == AFFINE || mode == EPI; }

constexpr int lead_maps(int mode) {
  return mode == EPI ? 3 : mode == AFFINE ? 2 : mode == RELU ? 1 : 0;
}

// the lead stage's backward from dt0 = acc (see the file comment); the
// prefetched maps: relu the mask; affine x, the mask; epi x, the mask, gy
template <int C, int MODE>
struct EpiLeadBwd {
  static constexpr bool SUMS = lead_sums(MODE), PER_IMAGE = false;
  static constexpr int NAUX = lead_maps(MODE), E = Epl<C>::E;
  static constexpr int NA = NAUX > 0 ? NAUX : 1;
  const bf16* x;      // affine: x; epi: t
  const bf16* mask;   // affine: t0; epi: y_next; relu: x
  const bf16* gy;     // epi
  const float* drop;  // epi: (B, C) f32
  const float* a;     // f32 (C,)
  bf16* out;          // dx (none, affine) or dt (epi)
  bf16* out2;         // epi: dy_res
  __device__ const bf16* aux(int k) const {
    if constexpr (MODE == RELU) return mask;
    return k == 0 ? x : k == 1 ? mask : gy;
  }
  __device__ void operator()(long long m, int b, int c0, float (&v)[E],
                             float (&s0)[E], float (&s1)[E], const bf16*,
                             const unsigned (&av)[NA][E / 2]) const {
    if constexpr (MODE == NONE) {
      st_bf16<E>(out + m * C + c0, v);
    } else if constexpr (MODE == RELU) {
      float mv[E];
      unpack<E>(av[0], mv);
#pragma unroll
      for (int k = 0; k < E; ++k) v[k] = mv[k] > 0.0f ? v[k] : 0.0f;
      st_bf16<E>(out + m * C + c0, v);
    } else {
      float xv[E], mv[E];
      unpack<E>(av[0], xv);
      unpack<E>(av[1], mv);
      if constexpr (MODE == EPI) {
        float gv[E];
        unpack<E>(av[2], gv);
#pragma unroll
        for (int k = 0; k < E; ++k) v[k] = mv[k] > 0.0f ? v[k] + gv[k] : 0.0f;
        st_bf16<E>(out2 + m * C + c0, v);
#pragma unroll
        for (int k = 0; k < E; ++k) v[k] = v[k] * __ldg(drop + b * C + c0 + k);
      } else {
#pragma unroll
        for (int k = 0; k < E; ++k) v[k] = mv[k] > 0.0f ? v[k] : 0.0f;
      }
      float o[E];
#pragma unroll
      for (int k = 0; k < E; ++k) {
        o[k] = v[k] * __ldg(a + c0 + k);
        s0[k] += __fmul_rn(v[k], xv[k]);
        s1[k] += v[k];
      }
      st_bf16<E>(out + m * C + c0, o);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(256, Conv<C>::minb(0))
fwd_h_kernel(const bf16* t0, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* t1, Geo g, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, t0, w, g, B, EpiReluBias<C>{bias, t1}, nullptr);
}

template <int C, bool S>
__global__ void __launch_bounds__(256, Conv<C>::minb(0))
fwd_w_kernel(const bf16* t1, const bf16* __restrict__ w,
             const float* __restrict__ bias, bf16* z, float* part, Geo g,
             int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, t1, w, g, B, EpiStats<C, S>{bias, z}, part);
}

template <int C>
__global__ void __launch_bounds__(256, Conv<C>::minb(1))
bwd_w_kernel(const bf16* g, const bf16* __restrict__ wt, const bf16* t1,
             bf16* dz1, float* part, Geo geo, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, g, wt, geo, B, EpiDz1<C>{t1, dz1}, part);
}

template <int C, int MODE>
__global__ void __launch_bounds__(256, Conv<C>::minb(lead_maps(MODE)))
bwd_h_kernel(const bf16* dz1, const bf16* __restrict__ wt, const bf16* x,
             const bf16* mask, const bf16* gy, const float* drop,
             const float* a, bf16* out, bf16* out2, float* part, Geo g,
             int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv_tiles<C>(smem, dz1, wt, g, B,
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

// t0 = relu(x), exact in either dtype (T = bf16 or float), 8 elements a
// thread (n8 of them)
template <typename T>
__global__ void __launch_bounds__(256)
lead_relu_kernel(const T* __restrict__ x, T* __restrict__ t0, long long n8) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n8) return;
  float o[8];
  load8(x + v * 8, o);  // both dtypes
#pragma unroll
  for (int k = 0; k < 8; ++k) o[k] = fmaxf(o[k], 0.0f);
  store_vec8(t0 + v * 8, o);
}

// Weight gradients on a (pixel chunk, axis) grid: blockIdx.y = axis
// NSPLIT + split, axis 0: dwh[k] = shift_h(t0, k)^T dz1, axis 1: dww[k] =
// shift_w(t1, k)^T g, for k = 0, 1, 2 and the output columns [split NC,
// + NC); blockIdx.x = a chunk of the axis's tiles (the conv's tiling at BP
// pixels a tile).  Per tile the CTA stages the G rows of its pixels
// (dz1 or g, its NC columns) and the A patch along the axis (t0 or t1, all
// C channels) once, and forms the three taps as shifted views of the
// patch (ldmatrix.trans of each lane's own pixel row), so a chunk reads
// each input pixel once (the halo of a tile that does not span the axis
// once more).  The tiles stream through a ring of NS stages (NS - 1 in
// flight, no wait for all copies between tiles).  256 threads; the three
// (C x NC) f32 accumulators of a CTA:
// * C = 16: eight groups of one warp on alternate 16-pixel steps, their
//   sums added in group order at the end (24 registers a thread); tiles
//   of 256 pixels, three stages, two CTAs an SM.
// * C = 64: two groups of four warps, each warp 16 input x 64 output
//   channels of the three taps (96 registers; 3 + 4 ldmatrix for 24
//   mma.sync a 16-pixel step); tiles of 256 pixels (the H axis' 128 x 2,
//   the W axis' 1 x 256: no halo), two stages, one CTA an SM.
// * C = 128: the output columns split in four (NSPLIT = 4), each warp 32
//   x 16 (48 registers), tiles of 128 pixels, two stages, two CTAs an SM:
//   each quarter stages the whole A patch and its quarter of G, so A
//   crosses L2 four times and G once.
// Chunks = the resident CTAs / (2 NSPLIT), at most 9 MiB of partials: one
// wave (at C = 128 the cap leaves 24 chunks, 192 of 264 CTA slots).  The
// partial of (chunk, axis, tap) goes to part[chunk][axis 3 + k][C][C].
// Its time is the sum of its copies and its product, which overlap little
// (other splits and CTA counts, a fourth stage and bulk copies a pixel
// were tried and were no faster: PERF.md).
template <int C>
struct Wg {
  static constexpr int THREADS = 256;
  static constexpr int NSPLIT = C == 128 ? 4 : 1, NC = C / NSPLIT;
  static constexpr int BP = C == 128 ? 128 : 256;
  static constexpr int CAP = C == 16 ? 512 : C == 64 ? 320 : 128;
  static constexpr int NS = C == 16 ? 3 : 2, MINB = C == 64 ? 1 : 2;
  static constexpr int WM = C == 128 ? 32 : 16;
  static constexpr int WN = C == 16 ? 16 : C == 64 ? 64 : 16;
  static constexpr int WGM = C / WM, WGN = NC / WN;
  static constexpr int WARPS_K = THREADS / 32 / (WGM * WGN);
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = C + 8, LDG = NC + 8, VG = NC / 8;
  static constexpr size_t patch_bytes = align128((size_t)CAP * LDA * 2);
  static constexpr size_t stage_bytes =
      patch_bytes + align128((size_t)BP * LDG * 2);
  static constexpr size_t zero_off = NS * stage_bytes;
  static constexpr size_t smem = zero_off + align128((size_t)LDA * 2);
  static constexpr size_t red_bytes = (size_t)WARPS_K * 3 * C * NC * 4;
  static_assert(WGM * WGN * WARPS_K * 32 == THREADS &&
                    BP % (16 * WARPS_K) == 0 && red_bytes <= zero_off &&
                    smem <= 232448,
                "pair weight gradient");
};

template <int C>
Geo wg_geo(int H, int W, int axis, int d) {
  using Q = Wg<C>;
  return make_geo(H, W, axis, d, Q::BP, Q::CAP,
                  axis == 0 ? Conv<C>::TA_MIN : 1);
}

template <int C>
__global__ void __launch_bounds__(Wg<C>::THREADS, Wg<C>::MINB)
wgrad_kernel(const bf16* __restrict__ t0, const bf16* __restrict__ dz1,
             const bf16* __restrict__ t1, const bf16* __restrict__ g,
             float* __restrict__ part, Geo gh, Geo gw, int B, int chunks) {
  using Q = Wg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int axis = blockIdx.y / Q::NSPLIT, split = blockIdx.y % Q::NSPLIT;
  const Geo geo = axis ? gw : gh;
  const bf16* A = axis ? t1 : t0;
  const bf16* G = axis ? g : dz1;
  const long long T = (long long)B * geo.segs * geo.ablk;
  const int k0 = (int)(T * blockIdx.x / chunks);
  const int k1 = (int)(T * (blockIdx.x + 1) / chunks);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / (Q::WGM * Q::WGN), wmn = warp % (Q::WGM * Q::WGN);
  const int wm = wmn / Q::WGN, wn = wmn % Q::WGN;
  bf16* zero = reinterpret_cast<bf16*>(smem + Q::zero_off);
  for (int v = threadIdx.x; v < Q::LDA / 8; v += Q::THREADS)
    reinterpret_cast<uint4*>(zero)[v] = zero_vec();
  auto stage = [&](int k) { return smem + (k % Q::NS) * Q::stage_bytes; };
  auto issue = [&](int k) {
    if (k0 + k < k1) {
      const Tile tl = tile_at(geo, k0 + k);
      unsigned char* st = stage(k);
      stage_patch<C, Q::THREADS, Q::LDA, 8>(reinterpret_cast<bf16*>(st), A,
                                            geo, tl);
      bf16* Gs = reinterpret_cast<bf16*>(st + Q::patch_bytes);
      for (int v = threadIdx.x; v < Q::BP * Q::VG; v += Q::THREADS) {
        const int e = v % Q::VG, q = v / Q::VG;
        int i, a;
        const bool valid = tile_pixel(geo, tl, q, i, a);
        const long long off =
            valid ? geo_pixel(geo, tl.b, tl.s0 + i, tl.a0 + a) * C +
                        split * Q::NC + e * 8
                  : 0;
        cp_async16(Gs + q * Q::LDG + e * 8, G + off, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < Q::NS - 1; ++k) issue(k);
  float acc[3][Q::MT][Q::NT][4];
#pragma unroll
  for (int tp = 0; tp < 3; ++tp)
#pragma unroll
    for (int mt = 0; mt < Q::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Q::NT; ++nt)
        acc[tp][mt][nt][0] = acc[tp][mt][nt][1] = acc[tp][mt][nt][2] =
            acc[tp][mt][nt][3] = 0.0f;
  // A (ldmatrix.trans): this lane's pixel row of a 16-pixel step and its
  // 8 channels; G: row lane % 16, column half lane / 16
  const int r = (lane % 8) + (lane / 16) * 8;
  const uint32_t col_a = (wm * Q::WM + ((lane / 8) % 2) * 8) * 2;
  const uint32_t zero_a = smem_addr(zero) + col_a;
  for (int k = 0; k0 + k < k1; ++k) {
    cp_async_wait_group<Q::NS - 2>();
    __syncthreads();  // tile k is in; tile k - 1's reads are done
    issue(k + Q::NS - 1);
    const Tile tl = tile_at(geo, k0 + k);
    const Taps tv = taps_of(geo, tl);
    const unsigned char* st = stage(k);
    const uint32_t pa = smem_addr(st) + col_a;
    const uint32_t ga =
        smem_addr(st + Q::patch_bytes) +
        ((lane % 16) * Q::LDG + wn * Q::WN + (lane / 16) * 8) * 2;
#pragma unroll
    for (int ks = 0; ks < Q::BP / 16; ++ks) {
      if (ks % Q::WARPS_K != wk) continue;
      int i, a;
      const int q = ks * 16 + r;
      const bool ok = tile_pixel(geo, tl, q, i, a);
      uint32_t ta[3];
#pragma unroll
      for (int tp = 0; tp < 3; ++tp)
        ta[tp] = ok && i >= tv.lo[tp] && i < tv.hi[tp]
                     ? pa + (q + tv.shift[tp]) * (Q::LDA * 2)
                     : zero_a;
      unsigned bb[Q::WN / 16][4];
#pragma unroll
      for (int n = 0; n < Q::WN / 16; ++n)
        ldsm4t(bb[n], ga + (ks * 16 * Q::LDG + n * 16) * 2);
#pragma unroll
      for (int tp = 0; tp < 3; ++tp)
#pragma unroll
        for (int mt = 0; mt < Q::MT; ++mt) {
          unsigned af[4];
          ldsm4t(af, ta[tp] + mt * 16 * 2);
#pragma unroll
          for (int n = 0; n < Q::WN / 16; ++n) {
            mma_bf16_16816(acc[tp][mt][2 * n], af, bb[n][0], bb[n][1]);
            mma_bf16_16816(acc[tp][mt][2 * n + 1], af, bb[n][2], bb[n][3]);
          }
        }
    }
  }
  cp_async_wait_all();
  // thread (lane / 4, lane % 4): rows (input channels) lane / 4 and + 8 of
  // each m16 tile, columns 2 (lane % 4) and + 1 of each n8 tile; with
  // several groups their sums are added in group order through shared
  // memory (the dead stages)
  const int gq = lane / 4, tq = lane % 4;
  float* dst0 = part + ((long long)blockIdx.x * 6 + axis * 3) * C * C +
                split * Q::NC;
  if constexpr (Q::WARPS_K == 1) {
#pragma unroll
    for (int tp = 0; tp < 3; ++tp)
#pragma unroll
      for (int mt = 0; mt < Q::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < Q::NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * Q::WM + mt * 16 + gq + 8 * h;
            const int col = wn * Q::WN + nt * 8 + 2 * tq;
            *reinterpret_cast<float2*>(dst0 + ((long long)tp * C + row) * C +
                                       col) =
                make_float2(acc[tp][mt][nt][2 * h], acc[tp][mt][nt][2 * h + 1]);
          }
    return;
  }
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the stages
#pragma unroll
  for (int tp = 0; tp < 3; ++tp)
#pragma unroll
    for (int mt = 0; mt < Q::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Q::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * Q::WM + mt * 16 + gq + 8 * h;
          const int col = wn * Q::WN + nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(
              red + ((wk * 3 + tp) * C + row) * Q::NC + col) =
              make_float2(acc[tp][mt][nt][2 * h], acc[tp][mt][nt][2 * h + 1]);
        }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C * Q::NC; e += Q::THREADS) {
    float s = 0.0f;
    for (int w = 0; w < Q::WARPS_K; ++w) s += red[w * 3 * C * Q::NC + e];
    const int tp = e / (C * Q::NC), row = (e / Q::NC) % C, col = e % Q::NC;
    dst0[((long long)tp * C + row) * C + col] = s;
  }
}


// ---------------------------------------------------------------------------
// f32 forms: the four convs over halo patches on FFMA micro-tiles, and the
// weight gradient
// ---------------------------------------------------------------------------

// The convs' tiles (conv32_tiles, Conv32), patches and t1's epilogue
// (EpiReluBias32) are conv32.cuh's; its epilogue interface: channels c0 ..
// c0 + 3 of map pixel m, v the sums, av[y] the NAUX maps loaded there
// before the product, ctr the conv's input there (the patch's centre tap).

// z = acc + bw; with S: s0 += z, s1 += z^2, per image
template <int C, bool S>
struct EpiStats32 {
  static constexpr bool SUMS = S, PER_IMAGE = true;
  static constexpr int NAUX = 0;
  const float* bias;
  float* out;
  __device__ const float* aux(int) const { return nullptr; }
  __device__ void operator()(long long m, int, int c0, float (&v)[4],
                             float* s0, float* s1, const float*,
                             const float4 (&)[1]) const {
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[k] = v[k] + __ldg(bias + c0 + k);
      if constexpr (S) {
        s0[k] += o[k];
        s1[k] += __fmul_rn(o[k], o[k]);
      }
    }
    st4(out + m * C + c0, o);
  }
};

__device__ __forceinline__ void unpack4(const float4& q, float (&f)[4]) {
  f[0] = q.x, f[1] = q.y, f[2] = q.z, f[3] = q.w;
}

// dz1 = acc [t1 > 0]; s0 += dz1, s1 += g (g: the conv's input at the
// pixel, from the patch)
template <int C>
struct EpiDz1_32 {
  static constexpr bool SUMS = true, PER_IMAGE = false;
  static constexpr int NAUX = 1;
  const float* t1;
  float* out;
  __device__ const float* aux(int) const { return t1; }
  __device__ void operator()(long long m, int, int c0, float (&v)[4],
                             float* s0, float* s1, const float* ctr,
                             const float4 (&av)[1]) const {
    float tv[4], gv[4];
    unpack4(av[0], tv);
    unpack4(*reinterpret_cast<const float4*>(ctr), gv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = tv[k] > 0.0f ? v[k] : 0.0f;
      s0[k] += v[k];
      s1[k] += gv[k];
    }
    st4(out + m * C + c0, v);
  }
};

// the lead stage's backward from dt0 = acc, f32 (see the file comment); the
// maps: relu the mask; affine x, the mask; epi x, the mask, gy
template <int C, int MODE>
struct EpiLeadBwd32 {
  static constexpr bool SUMS = lead_sums(MODE), PER_IMAGE = false;
  static constexpr int NAUX = lead_maps(MODE);
  static constexpr int NA = NAUX > 0 ? NAUX : 1;
  const float* x;     // affine: x; epi: t
  const float* mask;  // affine: t0; epi: y_next; relu: x
  const float* gy;    // epi
  const float* drop;  // epi: (B, C)
  const float* a;     // (C,)
  float* out;         // dx (none, affine) or dt (epi)
  float* out2;        // epi: dy_res
  __device__ const float* aux(int k) const {
    if constexpr (MODE == RELU) return mask;
    return k == 0 ? x : k == 1 ? mask : gy;
  }
  __device__ void operator()(long long m, int b, int c0, float (&v)[4],
                             float* s0, float* s1, const float*,
                             const float4 (&av)[NA]) const {
    if constexpr (MODE == NONE) {
      st4(out + m * C + c0, v);
    } else if constexpr (MODE == RELU) {
      float mv[4];
      unpack4(av[0], mv);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = mv[k] > 0.0f ? v[k] : 0.0f;
      st4(out + m * C + c0, v);
    } else {
      float xv[4], mv[4], o[4];
      unpack4(av[0], xv);
      unpack4(av[1], mv);
      if constexpr (MODE == EPI) {
        float gv[4];
        unpack4(av[2], gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = mv[k] > 0.0f ? v[k] + gv[k] : 0.0f;
        st4(out2 + m * C + c0, v);
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = v[k] * __ldg(drop + b * C + c0 + k);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = mv[k] > 0.0f ? v[k] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = v[k] * __ldg(a + c0 + k);
        s0[k] += __fmul_rn(v[k], xv[k]);
        s1[k] += v[k];
      }
      st4(out + m * C + c0, o);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(256, Conv32<C>::minb(0))
fwd_h_f32_kernel(const float* t0, const float* __restrict__ w,
                 const float* __restrict__ bias, float* t1, Geo g, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv32_tiles<C>(smem, t0, w, g, B, EpiReluBias32<C>{bias, t1}, nullptr);
}

template <int C, bool S>
__global__ void __launch_bounds__(256, Conv32<C>::minb(0))
fwd_w_f32_kernel(const float* t1, const float* __restrict__ w,
                 const float* __restrict__ bias, float* z, float* part, Geo g,
                 int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv32_tiles<C>(smem, t1, w, g, B, EpiStats32<C, S>{bias, z}, part);
}

template <int C>
__global__ void __launch_bounds__(256, Conv32<C>::minb(1))
bwd_w_f32_kernel(const float* g, const float* __restrict__ wt,
                 const float* t1, float* dz1, float* part, Geo geo, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv32_tiles<C>(smem, g, wt, geo, B, EpiDz1_32<C>{t1, dz1}, part);
}

template <int C, int MODE>
__global__ void __launch_bounds__(256, Conv32<C>::minb(lead_maps(MODE)))
bwd_h_f32_kernel(const float* dz1, const float* __restrict__ wt,
                 const float* x, const float* mask, const float* gy,
                 const float* drop, const float* a, float* out, float* out2,
                 float* part, Geo g, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  conv32_tiles<C>(smem, dz1, wt, g, B,
                  EpiLeadBwd32<C, MODE>{x, mask, gy, drop, a, out, out2},
                  part);
}

// Weight gradients, f32, on the bf16 form's (chunk of tiles, axis) grid
// (wgrad_kernel): blockIdx.y = axis NSPLIT + split, axis 0: dwh[k] =
// shift_h(t0, k)^T dz1, axis 1: dww[k] = shift_w(t1, k)^T g, for k = 0, 1,
// 2 and the output columns [split NC, + NC); blockIdx.x = a chunk of the
// axis's tiles (the f32 conv's tiling).  Per tile the CTA stages the G rows
// of its pixels (dz1 or g, its NC columns) and the A patch along the axis
// (t0 or t1, all C channels, unswizzled: every thread reads one pixel row at
// a time) once, through a ring of NS stages (NS - 1 in flight); the three
// taps are views of the patch, the zero pixel after it where a tap is off
// the map.  The product (3 x C x NC) += A_t^T G runs on FFMA micro-tiles
// with the pixels as its depth: thread (r, c, w) owns input channels 4 r ..
// 4 r + 3 and output channels 4 c + (0 .. 3) and 4 c + 4 CG + (0 .. 3) of
// the three taps (96 accumulators), four r and CL c a warp (so a pixel's A
// chunks and each G half are one 64- or 128-byte run); K-group w of WK
// takes every WK-th pixel.  Per pixel 3 + 2 float4 of shared memory feed
// 96 FMAs; a tile's pixels run in segments with the same taps on the map
// (a tap off it reads the zero pixel), so no pixel is tested (but in a
// tile ragged across the map).  Each output is one FMA chain per K-group
// over the chunk's pixels in order, the groups added in order at the end
// (through the dead stages).
// * C = 64: tiles of 128 pixels, two stages (67 KB each), two K-groups,
//   one CTA an SM.
// * C = 128: the output columns split in four, each quarter staging the
//   whole A patch (64 KB) and its quarter of G; two stages, two K-groups,
//   one CTA an SM.
// * C = 16: tiles of 512 pixels, 32 K-groups, three stages.
// Chunks = the resident CTAs / (2 NSPLIT), at most 9 MiB of partials: one
// wave.  The partial of (chunk, axis, tap) goes to part[chunk][axis 3 +
// k][C][C].
template <int C>
struct WgF32 {
  static constexpr int THREADS = 256, TM = 4, TN = 8;
  static constexpr int NSPLIT = C == 128 ? 4 : 1, NC = C / NSPLIT;
  static constexpr int BP = C == 16 ? 512 : 128;
  static constexpr int CAP = C == 16 ? 544 : C == 64 ? 136 : 128;
  static constexpr int NS = C == 16 ? 3 : 2;
  static constexpr int RG = C / TM, CG = NC / TN, CL = CG < 8 ? CG : 8;
  static constexpr int WK = THREADS / (RG * CG);
  static constexpr size_t patch_bytes = align128((size_t)(CAP + 1) * C * 4);
  static constexpr size_t stage_bytes =
      patch_bytes + align128((size_t)BP * NC * 4);
  static constexpr size_t smem = NS * stage_bytes;
  static_assert(TM == 4 && TN == 8 && RG % 4 == 0 && CG % CL == 0 &&
                    THREADS % (RG * CG) == 0 &&
                    4 * CL * (RG / 4) * (CG / CL) * WK == THREADS &&
                    (size_t)WK * 3 * C * NC * 4 <= smem && smem <= 232448,
                "f32 pair weight gradient");
};

template <int C>
Geo wg32_geo(int H, int W, int axis, int d) {
  using Q = WgF32<C>;
  return make_geo(H, W, axis, d, Q::BP, Q::CAP,
                  axis == 0 ? Conv32<C>::TA_MIN : 1);
}

template <int C>
__global__ void __launch_bounds__(WgF32<C>::THREADS, 1)
wgrad_f32_kernel(const float* __restrict__ t0, const float* __restrict__ dz1,
                 const float* __restrict__ t1, const float* __restrict__ g,
                 float* __restrict__ part, Geo gh, Geo gw, int B,
                 int chunks) {
  using Q = WgF32<C>;
  constexpr int NC = Q::NC, CAP = Q::CAP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int axis = blockIdx.y / Q::NSPLIT, split = blockIdx.y % Q::NSPLIT;
  const Geo geo = axis ? gw : gh;
  const float* A = axis ? t1 : t0;
  const float* G = axis ? g : dz1;
  const long long T = (long long)B * geo.segs * geo.ablk;
  const int k0 = (int)(T * blockIdx.x / chunks);
  const int k1 = (int)(T * (blockIdx.x + 1) / chunks);
  // thread (r, c, wk): four r and CL c a warp
  const int tid = threadIdx.x;
  const int rest = tid / (4 * Q::CL), rest2 = rest / (Q::RG / 4);
  const int r = tid % 4 + 4 * (rest % (Q::RG / 4));
  const int c = (tid / 4) % Q::CL + Q::CL * (rest2 % (Q::CG / Q::CL));
  const int wk = rest2 / (Q::CG / Q::CL);
  auto stage = [&](int k) { return smem + (k % Q::NS) * Q::stage_bytes; };
  for (int v = tid; v < Q::NS * C / 4; v += Q::THREADS)  // the zero pixels
    reinterpret_cast<float4*>(reinterpret_cast<float*>(stage(v / (C / 4))) +
                              CAP * C)[v % (C / 4)] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto issue = [&](int k) {
    if (k0 + k < k1) {
      const Tile tl = tile_at(geo, k0 + k);
      unsigned char* st = stage(k);
      stage_patch32<C, Q::THREADS, false>(reinterpret_cast<float*>(st), A,
                                          geo, tl);
      float* Gs = reinterpret_cast<float*>(st + Q::patch_bytes);
      const int e = tid % (NC / 4);
      for (int q = tid / (NC / 4); q < Q::BP; q += Q::THREADS / (NC / 4)) {
        int i, a;
        const bool valid = tile_pixel(geo, tl, q, i, a);
        const long long off =
            valid ? geo_pixel(geo, tl.b, tl.s0 + i, tl.a0 + a) * C +
                        split * NC + e * 4
                  : 0;
        cp_async16(Gs + q * NC + e * 4, G + off, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < Q::NS - 1; ++k) issue(k);
  float acc[3][4][8];
#pragma unroll
  for (int tp = 0; tp < 3; ++tp) zero_tile(acc[tp]);
  // pixel q of the tile: its G row, and the three taps' patch rows at
  // a[t] + q st[t] (st 0: the zero pixel)
  auto step = [&](const float* Gs, int q, const float* (&a)[3],
                  int (&st)[3]) {
    const float4 gv = *reinterpret_cast<const float4*>(Gs + q * NC + 4 * c);
    const float4 gw = *reinterpret_cast<const float4*>(Gs + q * NC + 4 * c +
                                                       4 * Q::CG);
    const float g8[8] = {gv.x, gv.y, gv.z, gv.w, gw.x, gw.y, gw.z, gw.w};
#pragma unroll
    for (int tp = 0; tp < 3; ++tp) {
      const float4 av = *reinterpret_cast<const float4*>(a[tp] + q * st[tp]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[tp][i][j] = fmaf(a4[i], g8[j], acc[tp][i][j]);
    }
  };
  auto first = [&](int q0) { return q0 + ((wk - q0) % Q::WK + Q::WK) % Q::WK; };
  for (int k = 0; k0 + k < k1; ++k) {
    cp_async_wait_group<Q::NS - 2>();
    __syncthreads();  // tile k is in; tile k - 1's reads are done
    issue(k + Q::NS - 1);
    const Tile tl = tile_at(geo, k0 + k);
    const Taps tv = taps_of(geo, tl);
    const float* As =
        reinterpret_cast<const float*>(stage(k)) + 4 * r;  // chunk r
    const float* Gs = reinterpret_cast<const float*>(stage(k) + Q::patch_bytes);
    const float* zero = As + CAP * C;
    if (tl.a0 + geo.TA > geo.m) {  // ragged across: every pixel tested
      for (int q = first(0); q < (geo.L << geo.lg); q += Q::WK) {
        int i, a;
        const bool ok = tile_pixel(geo, tl, q, i, a);
        const float* ap[3];
        int st[3] = {0, 0, 0};
#pragma unroll
        for (int tp = 0; tp < 3; ++tp)
          ap[tp] = ok && i >= tv.lo[tp] && i < tv.hi[tp]
                       ? As + (q + tv.shift[tp]) * C
                       : zero;
        step(Gs, q, ap, st);
      }
      continue;
    }
    // tap t reads the map for tile pixels q in [qlo[t], qhi[t]) (whole rows
    // of TA); the pixels in segments of the same taps on the map, the
    // others reading the zero pixel (pixels past the map add nothing)
    const int len = geo.n - tl.s0 < geo.L ? geo.n - tl.s0 : geo.L;
    const int qend = len << geo.lg;
    int qlo[3], qhi[3];
#pragma unroll
    for (int tp = 0; tp < 3; ++tp) {
      const int lo = tv.lo[tp] > 0 ? tv.lo[tp] : 0;
      const int hi = tv.hi[tp] < len ? tv.hi[tp] : len;
      qlo[tp] = lo << geo.lg;
      qhi[tp] = (hi > lo ? hi : lo) << geo.lg;
    }
    for (int q0 = 0; q0 < qend;) {
      int q1 = qend;
      const float* ap[3];
      int st[3];
#pragma unroll
      for (int tp = 0; tp < 3; ++tp) {
        const bool on = q0 >= qlo[tp] && q0 < qhi[tp];
        ap[tp] = on ? As + tv.shift[tp] * C : zero;
        st[tp] = on ? C : 0;
        if (qlo[tp] > q0 && qlo[tp] < q1) q1 = qlo[tp];
        if (qhi[tp] > q0 && qhi[tp] < q1) q1 = qhi[tp];
      }
#pragma unroll 4
      for (int q = first(q0); q < q1; q += Q::WK) step(Gs, q, ap, st);
      q0 = q1;
    }
  }
  cp_async_wait_all();
  // the K-groups' sums added in group order through the dead stages
  float* red = reinterpret_cast<float*>(smem);
  __syncthreads();
#pragma unroll
  for (int tp = 0; tp < 3; ++tp)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        *reinterpret_cast<float4*>(
            red + (((size_t)wk * 3 + tp) * C + 4 * r + i) * NC + 4 * c +
            4 * Q::CG * x) =
            make_float4(acc[tp][i][4 * x], acc[tp][i][4 * x + 1],
                        acc[tp][i][4 * x + 2], acc[tp][i][4 * x + 3]);
  __syncthreads();
  for (int e = tid; e < 3 * C * NC; e += Q::THREADS) {
    float s = 0.0f;
    for (int w = 0; w < Q::WK; ++w) s += red[(size_t)w * 3 * C * NC + e];
    const int tp = e / (C * NC), row = (e / NC) % C, cc = e % NC;
    part[((long long)blockIdx.x * 6 + axis * 3 + tp) * C * C +
         (long long)row * C + split * NC + cc] = s;
  }
}

// t0 = relu(x a + b), f32 (nothing rounded)
__global__ void __launch_bounds__(256)
lead_affine_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ t0,
                       long long n4, int C) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const int c0 = (int)(v % (C / 4)) * 4;
  const float4 x4 = ld4(x + v * 4);
  const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = fmaxf(__fadd_rn(__fmul_rn(xv[k], __ldg(a + c0 + k)),
                           __ldg(b + c0 + k)),
                 0.0f);
  st4(t0 + v * 4, o);
}

// y_next = relu((t a + b) m + y_res), f32
__global__ void __launch_bounds__(256)
lead_epi_f32_kernel(const float* __restrict__ t,
                    const float* __restrict__ yres,
                    const float* __restrict__ drop,
                    const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ ynext, long long n4, int HW, int C) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n4) return;
  const int c0 = (int)(v % (C / 4)) * 4;
  const int img = (int)(v / ((long long)HW * (C / 4)));
  const float4 t4 = ld4(t + v * 4), y4 = ld4(yres + v * 4);
  const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
  const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float p = __fadd_rn(__fmul_rn(tv[k], __ldg(a + c0 + k)), __ldg(b + c0 + k));
    p = __fmul_rn(p, __ldg(drop + img * C + c0 + k));
    o[k] = fmaxf(__fadd_rn(p, yv[k]), 0.0f);
  }
  st4(ynext + v * 4, o);
}

// ------------------------------- launchers --------------------------------

// Resident CTAs of a conv kernel (its shared memory allowed first): the
// grid of its persistent CTAs and the number of its partial rows; a CUDA
// error as a negative number.
template <int C, class Kernel>
int conv_ctas(Kernel k) {
  bool ok = false;
  int gm = 0;
  cudaError_t e = allow_smem(k, Conv<C>::smem, &ok);
  if (e == cudaSuccess)
    e = resident_ctas(k, Conv<C>::THREADS, Conv<C>::smem, &gm);
  return e == cudaSuccess ? gm : -(int)e;
}

int grid_of(const Geo& g, int B, int grid_max) {
  const int tiles = B * g.segs * g.ablk;
  return tiles < grid_max ? tiles : grid_max;
}

cudaError_t bad_grid(int gm) {
  return gm < 0 ? (cudaError_t)-gm : cudaErrorInvalidConfiguration;
}

// Rows of statistic partials a bf16 conv of this C may write: the most
// resident CTAs of the kernels that write them.
template <int C>
int part_rows() {
  static const int rows = [] {
    const int r[4] = {conv_ctas<C>(fwd_w_kernel<C, true>),
                      conv_ctas<C>(bwd_w_kernel<C>),
                      conv_ctas<C>(bwd_h_kernel<C, AFFINE>),
                      conv_ctas<C>(bwd_h_kernel<C, EPI>)};
    int m = r[0];
    for (int v : r) {
      if (v <= 0) return v;
      m = v > m ? v : m;
    }
    return m;
  }();
  return rows;
}

// The weight gradient's chunks a axis: one wave of its CTAs on this
// device, at most WG_PART_BYTES of partials and at most the tiles of
// either axis; a CUDA error as a negative number.
constexpr long long WG_PART_BYTES = 9LL << 20;

template <int C>
int wg_chunks(int B, int H, int W, int dh, int dw) {
  using Q = Wg<C>;
  static const int ctas = [] {
    bool ok = false;
    int gm = 0;
    cudaError_t e = allow_smem(wgrad_kernel<C>, Q::smem, &ok);
    if (e == cudaSuccess)
      e = resident_ctas(wgrad_kernel<C>, Q::THREADS, Q::smem, &gm);
    return e == cudaSuccess ? gm : -(int)e;
  }();
  if (ctas <= 0) return ctas;
  const Geo gh = wg_geo<C>(H, W, 0, dh), gw = wg_geo<C>(H, W, 1, dw);
  long long n = ctas / (2 * Q::NSPLIT);
  const long long cap = WG_PART_BYTES / (24LL * C * C);
  const long long th = (long long)B * gh.segs * gh.ablk;
  const long long tw = (long long)B * gw.segs * gw.ablk;
  n = n < cap ? n : cap;
  n = n < th ? n : th;
  n = n < tw ? n : tw;
  return n > 0 ? (int)n : 1;
}

// S: with the statistics (part and their reduction into stats)
template <int C, bool S>
int fwd(const void* t0, const void* wh, const void* bh, const void* ww,
        const void* bw, void* t1, void* z, void* part, void* stats, int B,
        int H, int W, int dh, int dw, cudaStream_t s) {
  using K = Conv<C>;
  static const int gm_h = conv_ctas<C>(fwd_h_kernel<C>);
  static const int gm_w = conv_ctas<C>(fwd_w_kernel<C, S>);
  if (gm_h <= 0) return bad_grid(gm_h);
  if (gm_w <= 0) return bad_grid(gm_w);
  const Geo gh = conv_geo<C>(H, W, 0, dh), gw = conv_geo<C>(H, W, 1, dw);
  fwd_h_kernel<C><<<grid_of(gh, B, gm_h), K::THREADS, K::smem, s>>>(
      static_cast<const bf16*>(t0), static_cast<const bf16*>(wh),
      static_cast<const float*>(bh), static_cast<bf16*>(t1), gh, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int grid_w = grid_of(gw, B, gm_w);
  fwd_w_kernel<C, S><<<grid_w, K::THREADS, K::smem, s>>>(
      static_cast<const bf16*>(t1), static_cast<const bf16*>(ww),
      static_cast<const float*>(bw), static_cast<bf16*>(z),
      static_cast<float*>(part), gw, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, grid_w, 2 * C, s);
}

template <int C, int MODE>
int bwd_h(const void* dz1, const void* wht, const void* x, const void* mask,
          const void* gy, const void* drop, const void* a, void* out,
          void* out2, float* part, const Geo& g, int B, int* grid,
          cudaStream_t s) {
  using K = Conv<C>;
  static const int gm = conv_ctas<C>(bwd_h_kernel<C, MODE>);
  if (gm <= 0) return bad_grid(gm);
  *grid = grid_of(g, B, gm);
  bwd_h_kernel<C, MODE><<<*grid, K::THREADS, K::smem, s>>>(
      static_cast<const bf16*>(dz1), static_cast<const bf16*>(wht),
      static_cast<const bf16*>(x), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(gy), static_cast<const float*>(drop),
      static_cast<const float*>(a), static_cast<bf16*>(out),
      static_cast<bf16*>(out2), part, g, B);
  return cudaGetLastError();
}

template <int C>
int bwd(int mode, int stats, const void* gz, const void* z, const void* gs1,
        const void* gs2, const void* t0, const void* t1, const void* wht,
        const void* wwt, const void* x, const void* mask, const void* gy,
        const void* drop, const void* a, void* g, void* dz1, void* out,
        void* out2, void* part_b, void* part_w, void* grads, int B, int H,
        int W, int dh, int dw, cudaStream_t s) {
  using K = Conv<C>;
  using Q = Wg<C>;
  static const int gm_w = conv_ctas<C>(bwd_w_kernel<C>);
  static bool wg_ok = false;
  if (gm_w <= 0) return bad_grid(gm_w);
  const int rows = part_rows<C>();
  if (rows <= 0) return bad_grid(rows);
  const int chunks = wg_chunks<C>(B, H, W, dh, dw);
  if (chunks <= 0) return bad_grid(chunks);
  const Geo gh = conv_geo<C>(H, W, 0, dh), gw = conv_geo<C>(H, W, 1, dw);
  float* pb = static_cast<float*>(part_b);
  cudaError_t e = cudaSuccess;
  // the stats fold writes g; without the statistics g is gz itself
  const void* gg = stats ? g : gz;
  if (stats && (e = adjust_grad(gz, z, gs1, gs2, g, B, H * W, C, s)) !=
                   cudaSuccess)
    return e;
  // bias partials: part_b holds two (rows, 2C) halves, [dbh, dbw] per CTA
  // of bwd_w and [da, db] per CTA of bwd_h
  const int grid_w = grid_of(gw, B, gm_w);
  bwd_w_kernel<C><<<grid_w, K::THREADS, K::smem, s>>>(
      static_cast<const bf16*>(gg), static_cast<const bf16*>(wwt),
      static_cast<const bf16*>(t1), static_cast<bf16*>(dz1), pb, gw, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* ph = pb + (long long)rows * 2 * C;
  int grid_h = 0;
  switch (mode) {
    case NONE:
      e = (cudaError_t)bwd_h<C, NONE>(dz1, wht, x, mask, gy, drop, a, out,
                                      out2, ph, gh, B, &grid_h, s);
      break;
    case AFFINE:
      e = (cudaError_t)bwd_h<C, AFFINE>(dz1, wht, x, mask, gy, drop, a, out,
                                        out2, ph, gh, B, &grid_h, s);
      break;
    case EPI:
      e = (cudaError_t)bwd_h<C, EPI>(dz1, wht, x, mask, gy, drop, a, out,
                                     out2, ph, gh, B, &grid_h, s);
      break;
    case RELU:
      e = (cudaError_t)bwd_h<C, RELU>(dz1, wht, x, mask, gy, drop, a, out,
                                      out2, ph, gh, B, &grid_h, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(wgrad_kernel<C>, Q::smem, &wg_ok)) != cudaSuccess)
    return e;
  wgrad_kernel<C><<<dim3(chunks, 2 * Q::NSPLIT), Q::THREADS, Q::smem, s>>>(
      static_cast<const bf16*>(t0), static_cast<const bf16*>(dz1),
      static_cast<const bf16*>(t1), static_cast<const bf16*>(gg),
      static_cast<float*>(part_w), wg_geo<C>(H, W, 0, dh),
      wg_geo<C>(H, W, 1, dw), B, chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // grads = [dwh (3CC), dww (3CC) | dbh, dbw | da, db]
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        6 * C * C, s)) != cudaSuccess)
    return e;
  if ((e = reduce_parts(pb, gr + 6 * C * C, 1, grid_w, 2 * C, s)) !=
      cudaSuccess)
    return e;
  if (lead_sums(mode))
    e = reduce_parts(ph, gr + 6 * C * C + 2 * C, 1, grid_h, 2 * C, s);
  return e;
}

// f32 launchers: the same sequence as the bf16 ones.  Resident CTAs of an
// f32 conv kernel a split (its shared memory allowed first): the x extent
// of its persistent grid and the number of its partial rows; a CUDA error
// as a negative number.
template <int C, class Kernel>
int conv32_ctas(Kernel k) {
  using K = Conv32<C>;
  bool ok = false;
  int gm = 0;
  cudaError_t e = allow_smem(k, K::smem, &ok);
  if (e == cudaSuccess) e = resident_ctas(k, K::THREADS, K::smem, &gm);
  if (e != cudaSuccess) return -(int)e;
  return gm / K::NSPLIT > 0 ? gm / K::NSPLIT : -(int)cudaErrorInvalidConfiguration;
}

template <int C>
dim3 grid32(const Geo& g, int B, int gm) {
  return dim3(grid_of(g, B, gm), Conv32<C>::NSPLIT);
}

// Rows of statistic partials an f32 conv of this C may write.
template <int C>
int part_rows32() {
  static const int rows = [] {
    const int r[4] = {conv32_ctas<C>(fwd_w_f32_kernel<C, true>),
                      conv32_ctas<C>(bwd_w_f32_kernel<C>),
                      conv32_ctas<C>(bwd_h_f32_kernel<C, AFFINE>),
                      conv32_ctas<C>(bwd_h_f32_kernel<C, EPI>)};
    int m = r[0];
    for (int v : r) {
      if (v <= 0) return v;
      m = v > m ? v : m;
    }
    return m;
  }();
  return rows;
}

// The f32 weight gradient's chunks: one wave, as wg_chunks.
template <int C>
int wg32_chunks(int B, int H, int W, int dh, int dw) {
  using Q = WgF32<C>;
  static const int ctas = [] {
    bool ok = false;
    int gm = 0;
    cudaError_t e = allow_smem(wgrad_f32_kernel<C>, Q::smem, &ok);
    if (e == cudaSuccess)
      e = resident_ctas(wgrad_f32_kernel<C>, Q::THREADS, Q::smem, &gm);
    return e == cudaSuccess ? gm : -(int)e;
  }();
  if (ctas <= 0) return ctas;
  const Geo gh = wg32_geo<C>(H, W, 0, dh), gw = wg32_geo<C>(H, W, 1, dw);
  long long n = ctas / (2 * Q::NSPLIT);
  const long long cap = WG_PART_BYTES / (24LL * C * C);
  const long long th = (long long)B * gh.segs * gh.ablk;
  const long long tw = (long long)B * gw.segs * gw.ablk;
  n = n < cap ? n : cap;
  n = n < th ? n : th;
  n = n < tw ? n : tw;
  return n > 0 ? (int)n : 1;
}

template <int C, bool S>
int fwd_f32(const void* t0, const void* wh, const void* bh, const void* ww,
            const void* bw, void* t1, void* z, void* part, void* stats, int B,
            int H, int W, int dh, int dw, cudaStream_t s) {
  using K = Conv32<C>;
  static const int gm_h = conv32_ctas<C>(fwd_h_f32_kernel<C>);
  static const int gm_w = conv32_ctas<C>(fwd_w_f32_kernel<C, S>);
  if (gm_h <= 0) return bad_grid(gm_h);
  if (gm_w <= 0) return bad_grid(gm_w);
  const Geo gh = conv32_geo<C>(H, W, 0, dh), gw = conv32_geo<C>(H, W, 1, dw);
  fwd_h_f32_kernel<C><<<grid32<C>(gh, B, gm_h), K::THREADS, K::smem, s>>>(
      static_cast<const float*>(t0), static_cast<const float*>(wh),
      static_cast<const float*>(bh), static_cast<float*>(t1), gh, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_w = grid32<C>(gw, B, gm_w);
  fwd_w_f32_kernel<C, S><<<grid_w, K::THREADS, K::smem, s>>>(
      static_cast<const float*>(t1), static_cast<const float*>(ww),
      static_cast<const float*>(bw), static_cast<float*>(z),
      static_cast<float*>(part), gw, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if constexpr (!S) return cudaSuccess;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(stats), B, grid_w.x, 2 * C, s);
}

template <int C, int MODE>
int bwd_h_f32(const void* dz1, const void* wht, const void* x,
              const void* mask, const void* gy, const void* drop,
              const void* a, void* out, void* out2, float* part, const Geo& g,
              int B, int* grid, cudaStream_t s) {
  using K = Conv32<C>;
  static const int gm = conv32_ctas<C>(bwd_h_f32_kernel<C, MODE>);
  if (gm <= 0) return bad_grid(gm);
  const dim3 grid_h = grid32<C>(g, B, gm);
  *grid = grid_h.x;
  bwd_h_f32_kernel<C, MODE><<<grid_h, K::THREADS, K::smem, s>>>(
      static_cast<const float*>(dz1), static_cast<const float*>(wht),
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(gy), static_cast<const float*>(drop),
      static_cast<const float*>(a), static_cast<float*>(out),
      static_cast<float*>(out2), part, g, B);
  return cudaGetLastError();
}

template <int C>
int bwd_f32(int mode, int stats, const void* gz, const void* z,
            const void* gs1, const void* gs2, const void* t0, const void* t1,
            const void* wht, const void* wwt, const void* x, const void* mask,
            const void* gy, const void* drop, const void* a, void* g,
            void* dz1, void* out, void* out2, void* part_b, void* part_w,
            void* grads, int B, int H, int W, int dh, int dw,
            cudaStream_t s) {
  using K = Conv32<C>;
  using Q = WgF32<C>;
  static const int gm_w = conv32_ctas<C>(bwd_w_f32_kernel<C>);
  static bool wg_ok = false;
  if (gm_w <= 0) return bad_grid(gm_w);
  const int rows = part_rows32<C>();
  if (rows <= 0) return bad_grid(rows);
  const int chunks = wg32_chunks<C>(B, H, W, dh, dw);
  if (chunks <= 0) return bad_grid(chunks);
  const Geo gh = conv32_geo<C>(H, W, 0, dh), gw = conv32_geo<C>(H, W, 1, dw);
  float* pb = static_cast<float*>(part_b);
  cudaError_t e = cudaSuccess;
  // the stats fold writes g; without the statistics g is gz itself
  const void* gg = stats ? g : gz;
  if (stats && (e = adjust_grad_f32(gz, z, gs1, gs2, g, B, H * W, C, s)) !=
                   cudaSuccess)
    return e;
  // bias partials: part_b holds two (rows, 2C) halves, [dbh, dbw] per CTA
  // of bwd_w and [da, db] per CTA of bwd_h
  const dim3 grid_w = grid32<C>(gw, B, gm_w);
  bwd_w_f32_kernel<C><<<grid_w, K::THREADS, K::smem, s>>>(
      static_cast<const float*>(gg), static_cast<const float*>(wwt),
      static_cast<const float*>(t1), static_cast<float*>(dz1), pb, gw, B);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  float* ph = pb + (long long)rows * 2 * C;
  int grid_h = 0;
  switch (mode) {
    case NONE:
      e = (cudaError_t)bwd_h_f32<C, NONE>(dz1, wht, x, mask, gy, drop, a, out,
                                          out2, ph, gh, B, &grid_h, s);
      break;
    case AFFINE:
      e = (cudaError_t)bwd_h_f32<C, AFFINE>(dz1, wht, x, mask, gy, drop, a,
                                            out, out2, ph, gh, B, &grid_h, s);
      break;
    case EPI:
      e = (cudaError_t)bwd_h_f32<C, EPI>(dz1, wht, x, mask, gy, drop, a, out,
                                         out2, ph, gh, B, &grid_h, s);
      break;
    case RELU:
      e = (cudaError_t)bwd_h_f32<C, RELU>(dz1, wht, x, mask, gy, drop, a, out,
                                          out2, ph, gh, B, &grid_h, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(wgrad_f32_kernel<C>, Q::smem, &wg_ok)) != cudaSuccess)
    return e;
  wgrad_f32_kernel<C><<<dim3(chunks, 2 * Q::NSPLIT), Q::THREADS, Q::smem,
                        s>>>(
      static_cast<const float*>(t0), static_cast<const float*>(dz1),
      static_cast<const float*>(t1), static_cast<const float*>(gg),
      static_cast<float*>(part_w), wg32_geo<C>(H, W, 0, dh),
      wg32_geo<C>(H, W, 1, dw), B, chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // grads = [dwh (3CC), dww (3CC) | dbh, dbw | da, db]
  float* gr = static_cast<float*>(grads);
  if ((e = reduce_parts(static_cast<const float*>(part_w), gr, 1, chunks,
                        6 * C * C, s)) != cudaSuccess)
    return e;
  if ((e = reduce_parts(pb, gr + 6 * C * C, 1, grid_w.x, 2 * C, s)) !=
      cudaSuccess)
    return e;
  if (lead_sums(mode))
    e = reduce_parts(ph, gr + 6 * C * C + 2 * C, 1, grid_h, 2 * C, s);
  return e;
}

bool shape_ok(int B, int H, int W, int C, int dh, int dw) {
  return (C == 16 || C == 64 || C == 128) && B > 0 && H > 0 && W > 0 &&
         dh > 0 && dw > 0 && (long long)B * H * W * C < (1LL << 31);
}

// The relu lead (x -> t0), either form.
template <typename T>
cudaError_t lead_relu(const void* x, void* t0, long long n8, cudaStream_t s) {
  lead_relu_kernel<T><<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(t0), n8);
  return cudaGetLastError();
}

template <int C>
int fwd_any(int stats, const void* t0, const void* wh, const void* bh,
            const void* ww, const void* bw, void* t1, void* z, void* part,
            void* st, int B, int H, int W, int dh, int dw, cudaStream_t s) {
  return stats ? fwd<C, true>(t0, wh, bh, ww, bw, t1, z, part, st, B, H, W,
                              dh, dw, s)
               : fwd<C, false>(t0, wh, bh, ww, bw, t1, z, part, st, B, H, W,
                               dh, dw, s);
}

template <int C>
int fwd_any_f32(int stats, const void* t0, const void* wh, const void* bh,
                const void* ww, const void* bw, void* t1, void* z, void* part,
                void* st, int B, int H, int W, int dh, int dw,
                cudaStream_t s) {
  return stats ? fwd_f32<C, true>(t0, wh, bh, ww, bw, t1, z, part, st, B, H,
                                  W, dh, dw, s)
               : fwd_f32<C, false>(t0, wh, bh, ww, bw, t1, z, part, st, B, H,
                                   W, dh, dw, s);
}

}  // namespace
// ------------------------------ C interface -------------------------------
//
// Maps are (B, H, W, C) bf16, NHWC, C in {16, 64, 128}; tap stacks (3, C, C)
// bf16 [tap, cin, cout]; biases, a, b (C,) f32; the dropout mask (B, C)
// f32; dh, dw the H and W dilations (>= 1); stats 1 for the forms with the
// per-image statistics, 0 for the stats-free ones.  Scratch (from the
// wrapper): part (B * rows, 2C) f32 in the forward (not read without the
// statistics), part_b (2 * rows, 2C) and part_w (chunks, 6, C, C) f32 in
// the backward, with rows = erf_pair_part_rows(C) and chunks =
// erf_pair_wg_chunks(B, H, W, C, dh, dw).  Each entry point returns the
// first CUDA error.

// The rows of statistic partials of a bf16 pair call at this C: the most
// resident CTAs of its conv kernels on the current device; 0 on a CUDA
// error or another C.
extern "C" int erf_pair_part_rows(int C) {
  const int r = C == 16 ? part_rows<16>()
                : C == 64 ? part_rows<64>()
                : C == 128 ? part_rows<128>() : 0;
  return r > 0 ? r : 0;
}

// The bf16 weight gradient's chunks (one wave of its CTAs on the current
// device, at most 9 MiB of partials); 0 on a CUDA error or a bad shape.
extern "C" int erf_pair_wg_chunks(int B, int H, int W, int C, int dh,
                                  int dw) {
  if (!shape_ok(B, H, W, C, dh, dw)) return 0;
  const int n = C == 16   ? wg_chunks<16>(B, H, W, dh, dw)
                : C == 64 ? wg_chunks<64>(B, H, W, dh, dw)
                          : wg_chunks<128>(B, H, W, dh, dw);
  return n > 0 ? n : 0;
}

// The bf16 tiling of a conv (kind 0) or of the weight gradient (kind 1)
// along axis (0: H, 1: W) of dilation d on an (H, W) map: out = [L, TA,
// band, segs, ablk, d] (Geo).  Host only; 0, or cudaErrorInvalidValue.
extern "C" int erf_pair_geometry(int C, int kind, int H, int W, int axis,
                                 int d, int* out) {
  if (!shape_ok(1, H, W, C, d, d) || (axis != 0 && axis != 1) ||
      (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  Geo g;
  if (C == 16)
    g = kind ? wg_geo<16>(H, W, axis, d) : conv_geo<16>(H, W, axis, d);
  else if (C == 64)
    g = kind ? wg_geo<64>(H, W, axis, d) : conv_geo<64>(H, W, axis, d);
  else
    g = kind ? wg_geo<128>(H, W, axis, d) : conv_geo<128>(H, W, axis, d);
  const int v[6] = {g.L, g.TA, g.band, g.segs, g.ablk, g.d};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
  return 0;
}

// t0 = lead(x): mode 1 affine (x, a, b), 2 epi (x = t, yres, drop, a, b),
// 3 relu (x).  Pointers first, then ints, then the stream, in every entry
// point.
extern "C" int erf_pair_lead(const void* x, const void* yres,
                             const void* drop, const void* a, const void* b,
                             void* t0, int mode, int B, int H, int W, int C,
                             void* stream) {
  if (!shape_ok(B, H, W, C, 1, 1)) return cudaErrorInvalidValue;
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
  else if (mode == RELU)
    return lead_relu<bf16>(x, t0, n8, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// t1 = bf16(relu(conv_h(t0) + bh)); z = bf16(conv_w(t1) + bw); with the
// statistics, stats (B, 2C) = [sum z, sum z^2] per image
extern "C" int erf_pair_fwd(const void* t0, const void* wh, const void* bh,
                            const void* ww, const void* bw, void* t1,
                            void* z, void* part, void* stats, int B, int H,
                            int W, int C, int dh, int dw, int with_stats,
                            void* stream) {
  if (!shape_ok(B, H, W, C, dh, dw)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return fwd_any<16>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats, B,
                       H, W, dh, dw, s);
  if (C == 64)
    return fwd_any<64>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats, B,
                       H, W, dh, dw, s);
  return fwd_any<128>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats, B,
                      H, W, dh, dw, s);
}

// The backward.  wht, wwt: the tap stacks flipped and transposed
// (w[2 - k]^T).  mode 0: out = dx; 1: x, mask = t0, out = dx; 2: x = t,
// mask = y_next, gy, drop, out = dt, out2 = dy_res; 3: mask = x, out = dx.
// With the statistics g (B, H, W, C) bf16 scratch receives the adjusted
// gradient; without them gz is g, and z, gs1, gs2 and g are not read.
// dz1: (B, H, W, C) bf16 scratch.  grads (6CC + 4C) f32 = [dwh, dww, dbh,
// dbw, da, db] (da, db left as they are in modes 0 and 3).
extern "C" int erf_pair_bwd(const void* gz, const void* z, const void* gs1,
                            const void* gs2, const void* t0, const void* t1,
                            const void* wht, const void* wwt, const void* x,
                            const void* mask, const void* gy,
                            const void* drop, const void* a, void* g,
                            void* dz1, void* out, void* out2, void* part_b,
                            void* part_w, void* grads, int mode, int B,
                            int H, int W, int C, int dh, int dw,
                            int with_stats, void* stream) {
  if (!shape_ok(B, H, W, C, dh, dw)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return bwd<16>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                   mask, gy, drop, a, g, dz1, out, out2, part_b, part_w,
                   grads, B, H, W, dh, dw, s);
  if (C == 64)
    return bwd<64>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                   mask, gy, drop, a, g, dz1, out, out2, part_b, part_w,
                   grads, B, H, W, dh, dw, s);
  return bwd<128>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                  mask, gy, drop, a, g, dz1, out, out2, part_b, part_w, grads,
                  B, H, W, dh, dw, s);
}


// The f32 forms: the same operands with every map (x, y_res, t0, t1, z,
// g, dz1, gz, gy, out, out2) and tap stack in f32.  The scratch has the
// bf16 layout, sized by the f32 kernels: rows = erf_pair_part_rows_f32(C),
// chunks = erf_pair_wg_chunks_f32(B, H, W, C, dh, dw).
extern "C" int erf_pair_part_rows_f32(int C) {
  const int r = C == 16 ? part_rows32<16>()
                : C == 64 ? part_rows32<64>()
                : C == 128 ? part_rows32<128>() : 0;
  return r > 0 ? r : 0;
}

extern "C" int erf_pair_wg_chunks_f32(int B, int H, int W, int C, int dh,
                                      int dw) {
  if (!shape_ok(B, H, W, C, dh, dw)) return 0;
  const int n = C == 16   ? wg32_chunks<16>(B, H, W, dh, dw)
                : C == 64 ? wg32_chunks<64>(B, H, W, dh, dw)
                          : wg32_chunks<128>(B, H, W, dh, dw);
  return n > 0 ? n : 0;
}

// The f32 tilings, as erf_pair_geometry.
extern "C" int erf_pair_geometry_f32(int C, int kind, int H, int W,
                                     int axis, int d, int* out) {
  if (!shape_ok(1, H, W, C, d, d) || (axis != 0 && axis != 1) ||
      (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  Geo g;
  if (C == 16)
    g = kind ? wg32_geo<16>(H, W, axis, d) : conv32_geo<16>(H, W, axis, d);
  else if (C == 64)
    g = kind ? wg32_geo<64>(H, W, axis, d) : conv32_geo<64>(H, W, axis, d);
  else
    g = kind ? wg32_geo<128>(H, W, axis, d) : conv32_geo<128>(H, W, axis, d);
  const int v[6] = {g.L, g.TA, g.band, g.segs, g.ablk, g.d};
  for (int k = 0; k < 6; ++k) out[k] = v[k];
  return 0;
}

extern "C" int erf_pair_lead_f32(const void* x, const void* yres,
                                 const void* drop, const void* a,
                                 const void* b, void* t0, int mode, int B,
                                 int H, int W, int C, void* stream) {
  if (!shape_ok(B, H, W, C, 1, 1)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = (long long)B * H * W * C / 4;
  const unsigned grid = (unsigned)((n4 + 255) / 256);
  if (mode == AFFINE)
    lead_affine_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(t0), n4, C);
  else if (mode == EPI)
    lead_epi_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(yres),
        static_cast<const float*>(drop), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(t0), n4, H * W, C);
  else if (mode == RELU)
    return lead_relu<float>(x, t0, n4 / 2, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int erf_pair_fwd_f32(const void* t0, const void* wh,
                                const void* bh, const void* ww,
                                const void* bw, void* t1, void* z, void* part,
                                void* stats, int B, int H, int W, int C,
                                int dh, int dw, int with_stats,
                                void* stream) {
  if (!shape_ok(B, H, W, C, dh, dw)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return fwd_any_f32<16>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats,
                           B, H, W, dh, dw, s);
  if (C == 64)
    return fwd_any_f32<64>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats,
                           B, H, W, dh, dw, s);
  return fwd_any_f32<128>(with_stats, t0, wh, bh, ww, bw, t1, z, part, stats,
                          B, H, W, dh, dw, s);
}

extern "C" int erf_pair_bwd_f32(const void* gz, const void* z,
                                const void* gs1, const void* gs2,
                                const void* t0, const void* t1,
                                const void* wht, const void* wwt,
                                const void* x, const void* mask,
                                const void* gy, const void* drop,
                                const void* a, void* g, void* dz1, void* out,
                                void* out2, void* part_b, void* part_w,
                                void* grads, int mode, int B, int H, int W,
                                int C, int dh, int dw, int with_stats,
                                void* stream) {
  if (!shape_ok(B, H, W, C, dh, dw)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 16)
    return bwd_f32<16>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                       mask, gy, drop, a, g, dz1, out, out2, part_b, part_w,
                       grads, B, H, W, dh, dw, s);
  if (C == 64)
    return bwd_f32<64>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                       mask, gy, drop, a, g, dz1, out, out2, part_b, part_w,
                       grads, B, H, W, dh, dw, s);
  return bwd_f32<128>(mode, with_stats, gz, z, gs1, gs2, t0, t1, wht, wwt, x,
                      mask, gy, drop, a, g, dz1, out, out2, part_b, part_w,
                      grads, B, H, W, dh, dw, s);
}
