// The f32 forward of the UpsamplerBlock conv, ConvTranspose2d(Cin, Cout,
// 3, s2, p1, op1), as one parity-plane product over halo patches, shared
// by the train upsampler's f32 forward (upsampler_train.cu: y = sum +
// bias, with or without the per-tile statistic partials) and the f32 eval
// upsampler (upsampler.cu: y = relu(sum + bias), BN folded), each with its
// own epilogue.  (Cin, Cout) in {(128, 64), (64, 16)}.
//
// The function is parity_plane.cuh's: input pixel p = (i, j) gives output
// pixel (2i + a, 2j + b) as the sum over the non-zero blocks (q, plane a*2
// + b) of x[p + e_q] @ w[tap(q, plane)], e_q = (q & 1, q >> 1), nine of
// the sixteen blocks, each one (Cin x Cout) tap of the (3, 3, Cin, Cout)
// stack w read through pp_tap's table (no Wcat), x zero past the bottom
// and right edges.  Nothing is rounded but f32's own.
//
// Tiles and copies.  Persistent CTAs of 256 threads (two warpgroups) walk
// tiles of 4 x 32 input pixels of one image (pp_tile_of); at 128 -> 64 the
// output channels split over two CTAs (blockIdx.y, 32 each).  A tile's 5 x
// 33 f32 halo patch is staged once with 16-byte cp.async into rows of Cin
// floats whose 16-byte chunks are swizzled (f32_swz), zero past the map;
// the four neighbour operands are views of it.  The next tile's patch is
// issued early in this tile (its buffer's last reader, the tile before, is
// behind the tile's first barrier), so that it has a tile's time to land:
// at 64 -> 16 at the first stage, the only copies in flight, waited for
// whole at the next tile's first stage; at 128 -> 64 at the second stage,
// in the ring's group of the stage NS - 1 on, which the next tile's first
// stage waits for (PATCH_STAGE).
//
// Units.  A unit is one view q times the taps of its non-zero planes side
// by side (N = the planes' columns), so each view is read once for the
// planes of its group and the seven zero blocks are never multiplied.  The
// groups are the halves a = 0 and a = 1, their sums live at once (N = 2
// Cout / NSPLIT columns), in the plane orders 1 0 and 3 2, so that every
// unit's planes start the group's columns: (q0: 1 0) (q2: 1) | (q0: 3 2)
// (q1: 3 2) (q2: 3) (q3: 3).  (With a unit's sums at an offset, plane
// order 0 1, ptxas serialized the wgmma for want of registers; a group a
// plane at 128 -> 64, nine units of N = 32, took 1.3x as long: PERF.md
// §6.)  After a group's last unit its sums are staged in
// shared memory (16-byte chunk e of tile pixel m at e ^ (m & 7)) and go out
// through the caller's epilogue 16 bytes a thread, the group's output
// rows whole; with STATS the stored values are summed per channel, over a
// warp's lanes by a fixed xor tree, then over the warps in order, into the
// tile's row of partials (a step stays bit-reproducible).
//
// The product: 3xTF32 in wgmma (the eval NB1d block's, nb1d.cu
// tc_tiles): a = a_hi + a_lo and w = w_hi + w_lo, each half TF32
// (split_tf32), out = a_hi w_hi + a_hi w_lo + a_lo w_hi in f32.
// * A is the unit's view, split in registers (wgmma m64nNk8 with A in
//   registers, warpgroup g tile pixels [64 g, 64 g + 64)): a group a k8
//   step, the next step's fragments loaded while it issues and split while
//   it runs (a stage split first and issued as one group was no faster:
//   PERF.md §6).
// * B is the unit's taps as TF32 hi and lo images in K-major core matrices
//   ((k4, n8) at (k4 N / 8 + n8) 128 bytes), split and laid out in the
//   kernel from the f32 tap stack as it is (no host op per call).  At 64 ->
//   16 the whole split stack (72 KB) is resident, made by a CTA once from
//   global memory.  At 128 -> 64 (288 KB a split) the taps stream as
//   stages of KS = 32 k rows of a unit, raw f32 through a 3-stage cp.async
//   ring in 4 x 2 blocks, each block split by the thread that copied it
//   (no barrier before the split) into one of two image buffers, one
//   barrier a stage.
// * Sum order: the cross products chained into sm over the group; the
//   high parts' product chained over a stage from zero (big) and added to
//   the group's sums on the CUDA cores (the tensor cores' f32 sums
//   truncate; over a unit's 16 k8 steps, as fast, the output was 1.4x as
//   far from the plain version: chain16); out = acc + sm.
// An FFMA product in the same frame was 1.6-1.7x as slow at both shapes
// (PERF.md §6; the variants script's ffma).
//
// Bound on this card: operations at f32 (9 Cin Cout MACs per input pixel
// against 67 TFLOP/s; the three TF32 products against 494.7 TFLOP/s take
// 0.41 of that, below the bytes at 64 -> 16).  What is left
// (scripts/cuda_ups_fwd32_variants.py): at 128 -> 64 the frame without
// the product (copies, splits, barriers, stores) takes five eighths of
// the time; at 64 -> 16 the product half, its N = 16 and 32 wgmma far from
// the tensor cores' rate.
#pragma once

#include <utility>

#include "conv16.cuh"
#include "parity_plane.cuh"

namespace erfk {

template <int CIN, int COUT>
struct Ups32 {
  static_assert((CIN == 128 && COUT == 64) || (CIN == 64 && COUT == 16),
                "f32 upsampler shapes");
  static constexpr bool WIDE = CIN == 128;
  static constexpr int THREADS = 256, WARPS = 8, TH = 4, TW = 32;
  static constexpr int BM = TH * TW, PH = TH + 1, PW = TW + 1, VK = CIN / 4;
  // output channels a CTA (NP, a plane's columns), planes a group
  static constexpr int NSPLIT = WIDE ? 2 : 1, NP = COUT / NSPLIT;
  static constexpr int GP = 2, NG = GP * NP, UNITS = 6;
  // k rows a stage (raw stages of KS x NG floats: 8 KB at 128 -> 64),
  // stages a unit and a tile; 64 -> 16: resident
  static constexpr int KS = WIDE ? 32 : CIN, KC = CIN / KS;
  static constexpr int STAGES = UNITS * KC;
  static constexpr bool RESIDENT = !WIDE;
  static constexpr int CH = NP / 4;   // channels a thread holds a plane
  static constexpr int NA = NG / 2;   // sums a thread holds
  // The unit table: view q, group, planes (the group's first cnt_of).  The
  // groups are the halves a = 0 in the plane order 1 0 and a = 1 in 3 2,
  // so that each view's planes start the group's columns (a wgmma's
  // accumulators start at the first sum): units (q0: 1 0) (q2: 1) | (q0: 3
  // 2) (q1: 3 2) (q2: 3) (q3: 3).
  __host__ __device__ static constexpr int q_of(int u) {
    return u == 0 || u == 2 ? 0 : u == 3 ? 1 : u == 5 ? 3 : 2;
  }
  __host__ __device__ static constexpr int group_of(int u) { return u >= 2; }
  __host__ __device__ static constexpr int cnt_of(int u) {
    return u == 1 || u >= 4 ? 1 : 2;
  }
  __host__ __device__ static constexpr int nu(int u) {
    return cnt_of(u) * NP;
  }
  // the plane at position pos of group g
  __host__ __device__ static constexpr int plane_of(int g, int pos) {
    return 2 * g + 1 - pos;
  }
  __host__ __device__ static constexpr bool ends_group(int u) {
    return u == UNITS - 1 || group_of(u + 1) != group_of(u);
  }
  // tap kh * 3 + kw of view q's block of plane pl
  __host__ __device__ static constexpr int tap_of(int q, int pl) {
    return pp_tap(pl >> 1, q & 1, false) * 3 + pp_tap(pl & 1, q >> 1, false);
  }
  // every non-zero block exactly once, no zero block
  static constexpr bool table_ok() {
    int seen = 0, n = 0;
    for (int u = 0; u < UNITS; ++u)
      for (int k = 0; k < cnt_of(u); ++k) {
        const int q = q_of(u), pl = plane_of(group_of(u), k);
        if ((q & 1) > (pl >> 1) || (q >> 1) > (pl & 1) ||
            (seen >> (q * 4 + pl)) & 1 || k >= GP)
          return false;
        seen |= 1 << (q * 4 + pl);
        ++n;
      }
    return n == 9;
  }
  // floats before unit u's resident image (hi, then lo: 2 CIN nu floats)
  __host__ __device__ static constexpr int img_at(int u) {
    return u == 0 ? 0 : img_at(u - 1) + 2 * CIN * nu(u - 1);
  }
  static constexpr size_t patch_bytes = align128((size_t)PH * PW * CIN * 4);
  static constexpr size_t raw_bytes = (size_t)KS * NG * 4;  // a raw stage
  static constexpr size_t red_bytes = (size_t)WARPS * 2 * NP * 4;
};

// The shared memory: two patches; at 128 -> 64 the raw ring of NS stages
// and two stage buffers of B images, at 64 -> 16 the whole stack's B
// images; the output staging of a group (BM x NG floats: at 128 -> 64 in
// the two image buffers, free between the group's last stage and the next
// stage's split); the statistics' warp sums.
template <int CIN, int COUT>
struct Ups32Smem {
  using C = Ups32<CIN, COUT>;
  static_assert(C::table_ok(), "the f32 upsampler's unit table");
  static constexpr int NS = 3;   // the raw ring's stages (128 -> 64)
  // the next tile's patch is issued at this stage of a tile (128 -> 64),
  // so in the ring's group PATCH_STAGE + NS - 1 stages on, which the next
  // tile's first stage must wait for (it waits for its own stage's group)
  static constexpr int PATCH_STAGE = 1;
  static_assert(C::RESIDENT || PATCH_STAGE + NS - 1 <= C::STAGES,
                "the patch lands before the next tile's first stage");
  static constexpr size_t raw_off = 2 * C::patch_bytes;
  static constexpr size_t img_off =
      raw_off + (C::RESIDENT ? 0 : NS * C::raw_bytes);
  static constexpr size_t img_bytes = C::RESIDENT
                                          ? (size_t)C::img_at(C::UNITS) * 4
                                          : 2 * 2 * C::raw_bytes;
  static constexpr size_t out_bytes = (size_t)C::BM * C::NG * 4;
  static constexpr size_t out_off = img_off + img_bytes;
  static constexpr size_t red_off = out_off + (C::RESIDENT ? out_bytes : 0);
  static constexpr size_t smem = red_off + C::red_bytes;
  static_assert(smem <= 232448 && (C::RESIDENT || out_bytes <= img_bytes),
                "f32 upsampler tile");
};

// d[0 .. N / 2) (+)= a b, wgmma m64nNk8 tf32 (conv32.cuh wgmma_tf32) on
// the first of a thread's accumulators
template <int N, int NA>
__device__ __forceinline__ void ups32_wgmma(float (&d)[NA],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  static_assert(N / 2 <= NA, "accumulator range");
  wgmma_tf32(*reinterpret_cast<float(*)[N / 2]>(&d[0]), a, b, scale_d);
}

template <int... U, class F>
__device__ __forceinline__ void ups32_each(std::integer_sequence<int, U...>,
                                           F&& f) {
  (f(std::integral_constant<int, U>{}), ...);
}

// The routine.  Epi (the caller's):
//   static constexpr bool STATS       per-tile partials of the stored y
//   float* part                       (STATS) the partials, a row of 2 COUT
//                                     ([sum y | sum y^2]) a tile
//   float4 operator()(long long o, int ch, float4 v) const
//                                     stores channels ch .. ch + 3 of
//                                     output element o (pixel * COUT + ch)
//                                     from the sums v, returns what it
//                                     stored
template <int CIN, int COUT, class Epi>
__device__ __forceinline__ void ups_fwd32(unsigned char* smem,
                                          const float* __restrict__ x,
                                          const float* __restrict__ w, int B,
                                          int H, int W, const Epi& epi) {
  using C = Ups32<CIN, COUT>;
  using L = Ups32Smem<CIN, COUT>;
  using Ring = PFRing<C::STAGES, L::NS>;
  constexpr int NP = C::NP, NA = C::NA, CH = C::CH, KS = C::KS;
  const int tiles =
      B * ((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW);
  const int split = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lq = lane >> 2, lc = lane & 3;
  float* raw = reinterpret_cast<float*>(smem + L::raw_off);
  float* img = reinterpret_cast<float*>(smem + L::img_off);
  float* out = reinterpret_cast<float*>(smem + L::out_off);
  float* red = reinterpret_cast<float*>(smem + L::red_off);
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * C::patch_bytes);
  };
  auto patch = [&](int kk) {
    const PPTile tl = pp_tile_of<C>(blockIdx.x + kk * gridDim.x, H, W);
    float* dst = patch_of(kk);
    for (int v = threadIdx.x; v < C::PH * C::PW * C::VK; v += C::THREADS) {
      const int pix = v / C::VK, e = v % C::VK;
      const int i = tl.i0 + pix / C::PW, j = tl.j0 + pix % C::PW;
      const bool ok = i < H && j < W;
      const long long src =
          ok ? (((long long)tl.b * H + i) * W + j) * CIN + 4 * e : 0;
      cp_async16(dst + pix * CIN + 4 * (e ^ f32_swz(pix, C::VK)), x + src,
                 ok);
    }
  };
  // 128 -> 64: raw stage s (unit s / KC, k rows (s % KC) KS .. + KS)
  // into ring slot r: row k the unit's nu columns, plane by plane, this
  // split's channels; thread t copies the 4 x 2 blocks (k4, n2) = t, t +
  // THREADS, ... (so that it splits what it copied itself, every thread a
  // block at N = 64)
  auto stage = [&](int r, int s) {
    const int u = s / C::KC, k0 = (s % C::KC) * KS, n_u = C::nu(u);
    float* dst = raw + r * (C::raw_bytes / 4);
    for (int v = threadIdx.x; v < KS * n_u / 8; v += C::THREADS) {
      const int k = v / (n_u / 2) * 4, n = (v % (n_u / 2)) * 2;
      const int pl = C::plane_of(C::group_of(u), n / NP);
      const float* src =
          w + ((size_t)C::tap_of(C::q_of(u), pl) * CIN + k0 + k) * COUT +
          split * NP + n % NP;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async8(dst + (k + j) * n_u + n, src + j * COUT);
    }
  };
  // The 3xTF32 B image of KROWS k rows x NU columns at dst (hi, then lo
  // KROWS NU floats on): value(k, n) split, 4 k of a column one 16-byte
  // row of core matrix (k / 4, n / 8).
  auto split_image = [&](auto NU_, int krows, float* dst, const auto& value) {
    constexpr int NU = decltype(NU_)::value;
    for (int v = threadIdx.x; v < krows / 4 * NU; v += C::THREADS) {
      const int k4 = v / NU, n = v % NU;
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) split_tf32(value(4 * k4 + j, n), h[j], l[j]);
      const int o = ((k4 * (NU / 8) + n / 8) * 8 + n % 8) * 4;
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(dst + krows * NU + o) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  };
  if constexpr (C::RESIDENT) {
    // the whole split stack, once a CTA, straight from w
    ups32_each(std::make_integer_sequence<int, C::UNITS>{}, [&](auto U_) {
      constexpr int U = decltype(U_)::value;
      split_image(std::integral_constant<int, C::nu(U)>{}, CIN,
                  img + C::img_at(U), [&](int k, int n) {
                    const int pl = C::plane_of(C::group_of(U), n / NP);
                    return __ldg(w + ((size_t)C::tap_of(C::q_of(U), pl) *
                                          CIN + k) * COUT + split * NP +
                                 n % NP);
                  });
    });
    fence_async_smem();   // wgmma reads them after the first barrier
  }

  // this thread's two tile pixels m[h] (rows lq and lq + 8 of its warp's
  // 16 of warpgroup warp / 4's 64) and the channel of its sum k of a pixel
  // and plane (the accumulator fragments' columns of the n8 tiles)
  int pr[2], pc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = (warp / 4) * 64 + (warp % 4) * 16 + lq + 8 * h;
    pr[h] = m / C::TW;
    pc[h] = m % C::TW;
  }
  auto chan = [&](int k) { return 8 * (k / 2) + 2 * lc + k % 2; };
  float acc[NA], sm[NA], big[NA];
  float s0[4], s1[4];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = sm[i] = big[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s0[k] = s1[k] = 0.0f;

  // The patches travel apart from the ring's stages (the file comment):
  // 64 -> 16 a group each, 128 -> 64 inside the ring's groups.
  const auto no_patch = [](int) {};
  if ((int)blockIdx.x < tiles) patch(0);
  if constexpr (C::RESIDENT)
    cp_async_commit();
  else
    Ring::start(tiles, no_patch, stage);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<C>(t, H, W);
    const float* pb = patch_of(kk);
    auto unit = [&](auto U_) {
      constexpr int U = decltype(U_)::value;
      constexpr int Q = C::q_of(U), NU = C::nu(U);
      // this thread's pixels in view Q: patch row offset and swizzle
      int aoff[2], aswz[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = (pr[h] + (Q & 1)) * C::PW + pc[h] + (Q >> 1);
        aoff[h] = q * CIN + lc;
        aswz[h] = f32_swz(q, C::VK);
      }
#pragma unroll 1
      for (int kc = 0; kc < C::KC; ++kc) {
        const int s = U * C::KC + kc;
        const float* bi;
        if constexpr (C::RESIDENT) {
          bi = img + C::img_at(U);
          if constexpr (U == 0) {
            // this tile's patch, the one group in flight, landed and seen
            // by every thread (at kk = 0 the images too); the tile before
            // is done with the other buffer, which takes the next tile's
            cp_async_wait_all();
            __syncthreads();
            if (t + (int)gridDim.x < tiles) patch(kk + 1);
            cp_async_commit();
          }
        } else {
          // this thread's blocks of raw stage s (its own copies: no
          // barrier before) split into image buffer s & 1 (its last
          // reader, stage s - 2, ended before stage s - 1), then one
          // barrier for the images and the patch
          const int u = kk * C::STAGES + s;
          cp_async_wait_group<L::NS - 2>();
          const float* src = raw + (u % L::NS) * (C::raw_bytes / 4);
          float* dst = img + (s & 1) * (2 * C::raw_bytes / 4);
          for (int v = threadIdx.x; v < KS * NU / 8; v += C::THREADS) {
            const int k4 = v / (NU / 2), n = (v % (NU / 2)) * 2;
            float2 rw[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              rw[j] = *reinterpret_cast<const float2*>(
                  src + (4 * k4 + j) * NU + n);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              uint32_t h[4], l[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                split_tf32(c == 0 ? rw[j].x : rw[j].y, h[j], l[j]);
              const int o =
                  ((k4 * (NU / 8) + (n + c) / 8) * 8 + (n + c) % 8) * 4;
              *reinterpret_cast<uint4*>(dst + o) =
                  make_uint4(h[0], h[1], h[2], h[3]);
              *reinterpret_cast<uint4*>(dst + KS * NU + o) =
                  make_uint4(l[0], l[1], l[2], l[3]);
            }
          }
          fence_async_smem();
          __syncthreads();
          if (s == L::PATCH_STAGE && t + (int)gridDim.x < tiles)
            patch(kk + 1);
          Ring::issue(u + L::NS - 1, tiles, no_patch, stage);
          bi = dst;
        }
        // k8 step ks: core matrices (2 ks, n8) at ks NU 32 bytes;
        // K-adjacent ones NU 16 bytes apart, N-adjacent 128
        const uint64_t dhi = wgmma_desc(bi, NU * 16, 128);
        const uint64_t dlo = wgmma_desc(bi + KS * NU, NU * 16, 128);
        const uint64_t koff = (uint64_t)((NU * 32) >> 4);  // a k8 step
        // a group a k8 step: the next step's A loaded while it is
        // issued, split while it runs
        auto load = [&](int ks, float (&v)[4]) {
          const int e = 2 * (kc * (KS / 8) + ks);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pb[aoff[i & 1] + 4 * ((e + (i >> 1)) ^ aswz[i & 1])];
        };
        float av[4];
        load(0, av);
        auto step = [&](int ks, uint32_t (&a_h)[1][4],
                        uint32_t (&a_l)[1][4], uint32_t (&p_h)[1][4],
                        uint32_t (&p_l)[1][4]) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(av[i], a_h[0][i], a_l[0][i]);
          wgmma_fence();
          ups32_wgmma<NU>(sm, a_l[0], dhi + ks * koff, 1);
          ups32_wgmma<NU>(sm, a_h[0], dlo + ks * koff, 1);
          ups32_wgmma<NU>(big, a_h[0], dhi + ks * koff, ks != 0);
          wgmma_commit();
          if (ks + 1 < KS / 8) load(ks + 1, av);
          wgmma_wait<1>();
          reg_fence(p_h);
          reg_fence(p_l);
        };
        uint32_t ah[2][1][4] = {}, al[2][1][4] = {};
#pragma unroll
        for (int ks = 0; ks < KS / 8; ks += 2) {
          step(ks, ah[0], al[0], ah[1], al[1]);
          step(ks + 1, ah[1], al[1], ah[0], al[0]);
        }
        wgmma_wait<0>();   // the stage's chain of high parts ends
        reg_fence(ah[0]);
        reg_fence(al[0]);
        reg_fence(ah[1]);
        reg_fence(al[1]);
        reg_fence(sm);
        reg_fence(big);
#pragma unroll
        for (int i = 0; i < NU / 2; ++i) acc[i] += big[i];
      }
      if constexpr (C::ends_group(U)) {
        // The group's sums, staged as BM rows of NG floats (16-byte chunk
        // e of row m at e ^ (m & 7)), then written out whole: thread v's
        // float4 is chunk v % 8 of tile pixel v / 8, output rows of 128
        // contiguous bytes (128 -> 64) or whole (64 -> 16).
        constexpr int G = C::group_of(U);
        float* st = C::RESIDENT ? out : img;   // img: both buffers free
        __syncthreads();   // its wgmma and the last group's reads are done
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = pr[h] * C::TW + pc[h];
#pragma unroll
          for (int pos = 0; pos < C::GP; ++pos)
#pragma unroll
            for (int k = 0; k < CH; k += 2) {
              const int d = (pos * (NP / 8) + k / 2) * 4 + 2 * h;
              const float2 v =
                  make_float2(acc[d] + sm[d], acc[d + 1] + sm[d + 1]);
              const int n = pos * NP + chan(k);
              *reinterpret_cast<float2*>(
                  st + m * C::NG + 4 * ((n / 4) ^ (m & 7)) + n % 4) = v;
            }
        }
#pragma unroll
        for (int n = 0; n < NA; ++n) acc[n] = sm[n] = 0.0f;
        __syncthreads();
        const int e = threadIdx.x % (C::NG / 4);   // this thread's chunk
        const int pl = C::plane_of(G, 4 * e / NP), ch = 4 * e % NP;
        for (int m = threadIdx.x / (C::NG / 4); m < C::BM;
             m += C::THREADS / (C::NG / 4)) {
          const int i = tl.i0 + m / C::TW, j = tl.j0 + m % C::TW;
          if (i >= H || j >= W) continue;
          const float4 v = *reinterpret_cast<const float4*>(
              st + m * C::NG + 4 * (e ^ (m & 7)));
          const float4 y = epi(
              (((long long)tl.b * 2 * H + 2 * i + (pl >> 1)) * 2 * W + 2 * j +
               (pl & 1)) * COUT + split * NP + ch,
              split * NP + ch, v);
          if constexpr (Epi::STATS) {
            s0[0] += y.x;
            s0[1] += y.y;
            s0[2] += y.z;
            s0[3] += y.w;
            s1[0] += __fmul_rn(y.x, y.x);
            s1[1] += __fmul_rn(y.y, y.y);
            s1[2] += __fmul_rn(y.z, y.z);
            s1[3] += __fmul_rn(y.w, y.w);
          }
        }
        // the next stage splits into an image buffer before its barrier
        if constexpr (!C::RESIDENT) __syncthreads();
      }
    };
    ups32_each(std::make_integer_sequence<int, C::UNITS>{}, unit);
    if constexpr (Epi::STATS) {
      // the tile's partials: over the lanes that hold the same channels
      // (lane % (NP / 4)) by a fixed xor tree, then over the warps in order
      // (a row a warp, each reduced by the caller, was slower: the
      // reduction's rows grew eightfold)
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = NP / 4; o < 32; o <<= 1) {
          s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], o);
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        }
      if (lane < NP / 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red[warp * 2 * NP + 4 * lane + k] = s0[k];
          red[warp * 2 * NP + NP + 4 * lane + k] = s1[k];
        }
      __syncthreads();
      for (int q = threadIdx.x; q < 2 * NP; q += C::THREADS) {
        float v = 0.0f;
#pragma unroll
        for (int w8 = 0; w8 < C::WARPS; ++w8) v += red[w8 * 2 * NP + q];
        epi.part[(long long)t * 2 * COUT + (q / NP) * COUT + split * NP +
                 q % NP] = v;
      }
      // red is rewritten after the next tile's first barrier
#pragma unroll
      for (int k = 0; k < 4; ++k) s0[k] = s1[k] = 0.0f;
    }
  }
  cp_async_wait_all();
}

}  // namespace erfk
