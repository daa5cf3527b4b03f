// The f32 DownsamplerBlock forward, cat[conv3x3 s2 p1 (x; Cin -> Cc) + b,
// maxpool2x2(x)], each value handed to the caller's epilogue, as a
// stride-2 conv over each tile's halo patch: the f32 eval block
// (downsampler.cu: the BatchNorm and ReLU in the epilogue) runs it at
// (Cin, Cc) = (16, 48) and (64, 64) (down_fwd32 below, 3xTF32 in wgmma),
// and at (3, 13) over raw patches (down_fwd3_f32_kernel, FFMA; the train
// forward's f32 stem and 3-channel map run it too, downsampler_train.cu).
//
// Tiles and copies (down_fwd32).  Persistent CTAs walk tiles of TH x 32
// output pixels of one image (TH = 4 at Cin = 16, 2 at 64; pp_tile_of).
// A tile's (2 TH + 1) x 65 input patch is staged once with 16-byte
// cp.async into four parity planes whose 16-byte chunks are swizzled
// (parity_plane.cuh PFPatch, pf_load_patch_f32, f32_swz), zero off the
// map; tap (kh, kw) of output pixel (r, c) is plane pixel PFPatch::tap(r,
// c, kh, kw), so each of the nine taps is a unit-stride view.  The next
// tile's patch is issued early in this tile (its buffer's last reader,
// the tile before, is behind the tile's first barrier), so that it has a
// tile's time to land: at Cin = 16 at the first stage in a group of its
// own, waited for whole at the next tile's first stage; at Cin = 64 at
// stage PATCH_STAGE, in the ring's group NS - 1 stages on, which the next
// tile's first stage waits for.
//
// The product: 3xTF32 in wgmma (ups_fwd32.cuh's): a = a_hi + a_lo and w =
// w_hi + w_lo, each half TF32 (conv32.cuh split_tf32), out = a_hi w_hi +
// a_hi w_lo + a_lo w_hi in f32.
// * A is a tap's view, split in registers (wgmma m64nNk8 with A in
//   registers): warpgroup (gm, gn) takes tile pixels [64 gm, 64 gm + 64)
//   and conv channels [NW gn, NW gn + NW): at Cin = 16 two warpgroups
//   along the pixels (N = 48 each), at 64 two along the channels (N = 32
//   each, each splitting the same A), 256 threads either way.
// * B is the taps as TF32 hi and lo images in K-major core matrices
//   ((k4, n8) at (k4 N / 8 + n8) 128 bytes), split in the kernel from the
//   (3, 3, Cin, Cc) f32 tap stack as it is.  At Cin = 16 the split stack
//   (55 KB) is resident, made by a CTA once.  At Cin = 64 (288 KB split)
//   the taps stream as stages of KS = 32 k rows (half a tap: the images of
//   a whole tap, double-buffered beside two 83 KB patches, would not
//   fit), raw f32 through a 3-stage cp.async ring in 4 x 2 blocks, each
//   split by the thread that copied it into one of two image buffers, one
//   barrier a stage.
// * Sum order: the cross products chained into sm over the tile; the high
//   parts' products chained from zero over a stage (big: a kh row, 6 k8
//   steps, at Cin = 16; half a tap, 4 k8 steps, at 64) and added to acc on
//   the CUDA cores (the tensor cores' f32 sums truncate); conv = (acc +
//   sm) + b.
// * The pool channels are the max of taps 4, 5, 7 and 8 of the same patch.
// * Epilogue: each stored value is epi(v, c), v the conv sum + bias or the
//   pool max of channel c; whole output pixels staged in the tile's own
//   patch buffer once it is read (16-byte chunk e of pixel m at e ^ (m &
//   7)) and written 16 bytes a thread, a tile row's pixels contiguous.
//   The eval block's epi is relu(v * scale[c] + shift[c]); the train
//   forward's would be y = v with the per-tile sums of down_fwd32_kernel
//   (downsampler_train.cu), which still multiplies on FFMA micro-tiles.
//
// Bound on this card: at f32, operations (9 Cin Cc MACs per output pixel
// against 67 TFLOP/s: 0.063 ms for the two blocks of a B=4 512x1024
// forward); under 3xTF32 (three TF32 products against 494.7 TFLOP/s,
// 0.026 ms) their bytes (4 Cin + 4 Cout per output pixel, 117 MB, 0.035
// ms) bound them.
#pragma once

#include "conv16.cuh"
#include "parity_plane.cuh"

namespace erfk {

template <int CIN, int CC>
struct Down32 {
  static_assert((CIN == 16 && CC == 48) || (CIN == 64 && CC == 64),
                "f32 downsampler shapes");
  static constexpr bool WIDE = CIN == 64;
  static constexpr int K = CIN, N = CC, COUT = CIN + CC;
  static constexpr int TH = WIDE ? 2 : 4, TW = 32, BM = TH * TW;
  // warpgroups along the tile's pixels and along the conv channels
  static constexpr int WGM = BM / 64, WGN = WIDE ? 2 : 1;
  // a warpgroup's channels, a thread's sums
  static constexpr int NW = N / WGN, NA = NW / 2;
  static constexpr int THREADS = 128 * WGM * WGN;
  static constexpr int VK = K / 4, VC = COUT / 4;
  // a stage: TPS taps of SPT k8 steps, or (SPS > 1) 1 / SPS of a tap
  static constexpr int TPS = WIDE ? 1 : 3, SPS = WIDE ? 2 : 1;
  static constexpr int SPT = K / 8 / SPS, KSTEPS = TPS * SPT;
  static constexpr int STAGES = 9 * SPS / TPS;
  static constexpr int KS = K / SPS;   // k rows of a streamed stage
  static constexpr bool RESIDENT = !WIDE;
  static constexpr int NS = 3;         // the raw ring's stages (Cin = 64)
  // the next tile's patch is issued at this stage of a tile (Cin = 64),
  // in the ring's group PATCH_STAGE + NS - 1 stages on, which the next
  // tile's first stage waits for (it waits for its own stage's group)
  static constexpr int PATCH_STAGE = 1;
  static constexpr int PV = BM * VK / THREADS;   // pool chunks a thread
  using Geo = PFPatch<K, TH>;
  static constexpr size_t patch_bytes = pp_align((size_t)Geo::PIXELS * K * 4);
  static constexpr size_t raw_bytes = (size_t)KS * N * 4;   // a raw stage
  static constexpr size_t ring_off = 2 * patch_bytes;       // two patches
  static constexpr size_t img_off = ring_off + (RESIDENT ? 0 : NS * raw_bytes);
  // resident: 9 taps of (hi, lo) K x N images; streamed: two stage buffers
  static constexpr size_t img_bytes =
      RESIDENT ? (size_t)9 * 2 * K * N * 4 : 2 * 2 * raw_bytes;
  static constexpr size_t smem = img_off + img_bytes;
  static constexpr int CTAS = 2 * (smem + 1024) <= 233472 ? 2 : 1;
  static_assert(BM % 64 == 0 && NW % 8 == 0 && KSTEPS % 2 == 0 &&
                    BM * VK % THREADS == 0 && VC >= 8 &&
                    (RESIDENT || KS * N / 8 == THREADS) &&
                    (RESIDENT || PATCH_STAGE + NS - 1 <= STAGES) &&
                    (size_t)BM * COUT * 4 <= patch_bytes && smem <= 232448,
                "f32 downsampler tile");
};

// The routine.  Epi (the caller's):
//   float operator()(float v, int c) const   the value stored for channel c
//                                            (c < CC: v = conv sum + b[c];
//                                            else the pool max of input
//                                            channel c - CC)
// x (B, 2 Ho, 2 Wo, CIN) f32; w (3, 3, CIN, CC) f32, 16-byte aligned; b
// (CC,) f32; out (B, Ho, Wo, CIN + CC) f32.
template <int CIN, int CC, class Epi>
__device__ __forceinline__ void down_fwd32(unsigned char* smem,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int B,
                                           int Ho, int Wo, const Epi& epi) {
  using C = Down32<CIN, CC>;
  using P = typename C::Geo;
  using Ring = PFRing<C::STAGES, C::NS>;
  constexpr int K = C::K, N = C::N, NW = C::NW, NA = C::NA;
  constexpr int COUT = C::COUT, VK = C::VK, VC = C::VC, KS = C::KS;
  const int H = 2 * Ho, W = 2 * Wo;
  const int tiles =
      B * ((Ho + C::TH - 1) / C::TH) * ((Wo + C::TW - 1) / C::TW);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lq = lane >> 2, lc = lane & 3;
  const int gm = (warp / 4) % C::WGM, gn = (warp / 4) / C::WGM;
  float* raw = reinterpret_cast<float*>(smem + C::ring_off);
  float* img = reinterpret_cast<float*>(smem + C::img_off);
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * C::patch_bytes);
  };
  auto patch = [&](int kk) {
    pf_load_patch_f32<P>(patch_of(kk), x,
                         pp_tile_of<C>(blockIdx.x + kk * gridDim.x, Ho, Wo),
                         H, W, C::THREADS);
  };
  // Cin = 64: raw stage s (tap s / SPS, k rows (s % SPS) KS .. + KS) into
  // ring slot r, row k the N columns; thread t copies the 4 x 2 block
  // (k4, n2) = t, so that it splits what it copied itself
  auto stage = [&](int r, int s) {
    const int k = tid / (N / 2) * 4, n = (tid % (N / 2)) * 2;
    const float* src = w + ((size_t)(s / C::SPS) * K + (s % C::SPS) * KS +
                            k) * N + n;
    float* dst = raw + r * (C::raw_bytes / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) cp_async8(dst + (k + j) * N + n, src + j * N);
  };
  // 4 k of column n: one 16-byte row of core matrix (k4, n / 8) of an image
  // of N columns
  auto img_at = [](int k4, int n) {
    return ((k4 * (N / 8) + n / 8) * 8 + n % 8) * 4;
  };
  if constexpr (C::RESIDENT) {
    // the whole split stack, once a CTA, straight from w: tap t's hi image
    // at img + 2 t K N, its lo K N floats on
    for (int v = tid; v < 9 * (K / 4) * N; v += C::THREADS) {
      const int t = v / ((K / 4) * N), k4 = v / N % (K / 4), n = v % N;
      uint32_t h[4], l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_tf32(__ldg(w + ((size_t)t * K + 4 * k4 + j) * N + n), h[j],
                   l[j]);
      float* dst = img + 2 * t * K * N + img_at(k4, n);
      *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(dst + K * N) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
    fence_async_smem();   // wgmma reads them after the first barrier
  }

  // this thread's two tile pixels (rows lq and lq + 8 of its warp's 16 of
  // warpgroup gm's 64) and the channel of its sum i (the accumulator
  // fragments' columns of the n8 tiles)
  int pr[2], pc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = gm * 64 + (warp % 4) * 16 + lq + 8 * h;
    pr[h] = m / C::TW;
    pc[h] = m % C::TW;
  }
  auto chan = [&](int i) { return gn * NW + 8 * (i / 4) + 2 * lc + i % 2; };
  float acc[NA], sm[NA], big[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = sm[i] = big[i] = 0.0f;

  const auto no_patch = [](int) {};
  if ((int)blockIdx.x < tiles) patch(0);
  if constexpr (C::RESIDENT)
    cp_async_commit();
  else
    Ring::start(tiles, no_patch, stage);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<C>(t, Ho, Wo);
    float* pb = patch_of(kk);
#pragma unroll 1
    for (int s = 0; s < C::STAGES; ++s) {
      const float* bhi;   // the stage's hi image (+ this warpgroup's columns)
      int klo;            // floats from a hi image to its lo
      if constexpr (C::RESIDENT) {
        bhi = img + 2 * (s * C::TPS) * K * N;
        klo = K * N;
        if (s == 0) {
          // this tile's patch, the one group in flight, landed and seen
          // by every thread (at kk = 0 the images too); the tile before
          // is done with the other buffer, which takes the next tile's
          cp_async_wait_all();
          __syncthreads();
          if (t + (int)gridDim.x < tiles) patch(kk + 1);
          cp_async_commit();
        }
      } else {
        // this thread's block of raw stage s (its own copies: no barrier
        // before) split into image buffer s & 1 (its last reader, stage s
        // - 2, ended before stage s - 1), then one barrier for the images
        // and the patch
        const int u = kk * C::STAGES + s;
        cp_async_wait_group<C::NS - 2>();
        const float* src = raw + (u % C::NS) * (C::raw_bytes / 4);
        float* dst = img + (s & 1) * (2 * C::raw_bytes / 4);
        const int k4 = tid / (N / 2), n = (tid % (N / 2)) * 2;
        float2 rw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rw[j] = *reinterpret_cast<const float2*>(src + (4 * k4 + j) * N + n);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t h[4], l[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split_tf32(c == 0 ? rw[j].x : rw[j].y, h[j], l[j]);
          *reinterpret_cast<uint4*>(dst + img_at(k4, n + c)) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(dst + KS * N + img_at(k4, n + c)) =
              make_uint4(l[0], l[1], l[2], l[3]);
        }
        fence_async_smem();
        __syncthreads();
        if (s == C::PATCH_STAGE && t + (int)gridDim.x < tiles) patch(kk + 1);
        Ring::issue(u + C::NS - 1, tiles, no_patch, stage);
        bhi = dst;
        klo = KS * N;
      }
      bhi += gn * (NW / 8) * 32;
      // this thread's pixels in the stage's taps: patch offset, swizzle
      int aoff[C::TPS][2], aswz[C::TPS][2];
#pragma unroll
      for (int tp = 0; tp < C::TPS; ++tp) {
        const int tap = (s / C::SPS) * C::TPS + tp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = P::tap(pr[h], pc[h], tap / 3, tap % 3);
          aoff[tp][h] = q * K + lc;
          aswz[tp][h] = f32_swz(q, VK);
        }
      }
      // k8 step st: tap st / SPT of the stage, its k8 step (s % SPS) SPT +
      // st % SPT; B: the stage's images at st N 32 bytes (resident: tap
      // images 2 K N floats apart); K-adjacent core matrices N 16 bytes
      // apart, N-adjacent 128
      const uint64_t dhi = wgmma_desc(bhi, N * 16, 128);
      const uint64_t dlo = wgmma_desc(bhi + klo, N * 16, 128);
      auto boff = [&](int st) {
        const int floats =
            C::RESIDENT
                ? (st / C::SPT) * 2 * K * N + (st % C::SPT) * N * 8
                : st * N * 8;
        return (uint64_t)(floats >> 2);   // 16-byte units
      };
      // a group a k8 step: the next step's A loaded while it is issued,
      // split while it runs
      auto load = [&](int st, float (&v)[4]) {
        const int tp = st / C::SPT;
        const int e = 2 * ((s % C::SPS) * C::SPT + st % C::SPT);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = pb[aoff[tp][i & 1] + 4 * ((e + (i >> 1)) ^ aswz[tp][i & 1])];
      };
      float av[4];
      load(0, av);
      auto step = [&](int st, uint32_t (&a_h)[1][4], uint32_t (&a_l)[1][4],
                      uint32_t (&p_h)[1][4], uint32_t (&p_l)[1][4]) {
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], a_h[0][i], a_l[0][i]);
        wgmma_fence();
        wgmma_tf32(sm, a_l[0], dhi + boff(st), 1);
        wgmma_tf32(sm, a_h[0], dlo + boff(st), 1);
        wgmma_tf32(big, a_h[0], dhi + boff(st), st != 0);
        wgmma_commit();
        if (st + 1 < C::KSTEPS) load(st + 1, av);
        wgmma_wait<1>();
        reg_fence(p_h);
        reg_fence(p_l);
      };
      uint32_t ah[2][1][4] = {}, al[2][1][4] = {};
#pragma unroll
      for (int st = 0; st < C::KSTEPS; st += 2) {
        step(st, ah[0], al[0], ah[1], al[1]);
        step(st + 1, ah[1], al[1], ah[0], al[0]);
      }
      wgmma_wait<0>();   // the stage's chain of high parts ends
      reg_fence(ah[0]);
      reg_fence(al[0]);
      reg_fence(ah[1]);
      reg_fence(al[1]);
      reg_fence(sm);
      reg_fence(big);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += big[i];
    }

    // the pool: taps 4, 5, 7, 8 of the same patch, PV chunks a thread
    float4 pool[C::PV];
#pragma unroll
    for (int p = 0; p < C::PV; ++p) {
      const int v = tid + p * C::THREADS, m = v / VK, e = v % VK;
      const int r = m / C::TW, c = m % C::TW;
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
    auto cs_at = [&](int m, int c) {
      return Cs + m * COUT + 4 * ((c / 4) ^ (m & 7)) + c % 4;
    };
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = pr[h] * C::TW + pc[h];
#pragma unroll
      for (int i = 2 * h; i < NA; i += 4) {
        const int c = chan(i);   // i = 4 j + 2 h: channels c, c + 1
        const float v0 = (acc[i] + sm[i]) + __ldg(bias + c);
        const float v1 = (acc[i + 1] + sm[i + 1]) + __ldg(bias + c + 1);
        *reinterpret_cast<float2*>(cs_at(m, c)) =
            make_float2(epi(v0, c), epi(v1, c + 1));
      }
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = sm[i] = 0.0f;
#pragma unroll
    for (int p = 0; p < C::PV; ++p) {
      const int v = tid + p * C::THREADS, m = v / VK, c = CC + 4 * (v % VK);
      *reinterpret_cast<float4*>(cs_at(m, c)) =
          make_float4(epi(pool[p].x, c), epi(pool[p].y, c + 1),
                      epi(pool[p].z, c + 2), epi(pool[p].w, c + 3));
    }
    __syncthreads();

    // whole output pixels, 16 bytes a thread
    for (int v = tid; v < C::BM * VC; v += C::THREADS) {
      const int m = v / VC, j = v % VC;
      const int i = tl.i0 + m / C::TW, jj = tl.j0 + m % C::TW;
      if (i >= Ho || jj >= Wo) continue;
      *reinterpret_cast<float4*>(
          out + (((long long)tl.b * Ho + i) * Wo + jj) * COUT + 4 * j) =
          *reinterpret_cast<const float4*>(cs_at(m, 4 * j));
    }
    // Cs is rewritten only by tile kk + 2's patch, issued after the next
    // tile's first barrier
  }
  cp_async_wait_all();
}

// ---------------------------------------------------------------------------
// Cin = 3 (the stem; the train forward's f32 stem and 3-channel map, and
// the f32 eval block's first downsampler)
// ---------------------------------------------------------------------------

// Tiles of TH x 32 output pixels of one image over a raw f32 patch
// (parity_plane.cuh PFRaw<true>: each patch row one run of 65 x 3 values
// in 4-byte words, the stem's shifted by its translate with zero fill;
// tile coordinates computed once a tile), persistent CTAs with the next
// tile's patch in flight.  A thread a pixel builds its im2col row (K = 27,
// (tap, ci) order, padded to 28) from the patch, unrounded; the 13 conv
// channels are an FFMA micro-tile (common.cuh ffma_tile, TM = 4 pixels x
// TN = 4 channels a thread) over the padded (28 x 16) tap stack, one FFMA
// chain per output in the plain version's (tap, ci) order; the 3 pool
// channels are the max of taps 4, 5, 7, 8 of the same patch.  The
// epilogue stages whole 64-byte output pixels, writes them 16 bytes a
// thread and (S) takes the sums from the stored values in a fixed
// butterfly (one partial per tile); the stem writes the translated
// image's tile interior from the patch.  K = 27 and N = 13 are too narrow
// for wgmma.
struct Fwd3F32 {
  static constexpr int TH = 8, TW = 32, BM = TH * TW, THREADS = 256;
  static constexpr int CC = 13, COUT = 16, KP = 28, NP = 16;
  static constexpr int TN = 4, TC = NP / TN, RS = THREADS / TC, TM = BM / RS;
  static constexpr int LDA = pitch4(KP);
  using Patch = PFRaw<true, TH>;
  static constexpr size_t a_off = 2 * Patch::bytes;  // two patches
  static constexpr size_t w_off = a_off + pp_align((size_t)BM * LDA * 4);
  static constexpr size_t o_off = w_off + pp_align((size_t)KP * NP * 4);
  static constexpr size_t smem = o_off + (size_t)BM * COUT * 4;
  static_assert(BM == THREADS && BM % RS == 0 && 2 * COUT <= 32 &&
                    (size_t)8 * 2 * COUT * 4 <= (size_t)BM * LDA * 4,
                "f32 forward tile at Cin = 3: a thread a pixel");
};

// STEM: the translate by shifts and the translated image into xa; S: the
// per-tile sums of y into part; EVAL: y = relu(v * scale + shift) per
// channel of the f32 value v (conv sum + bias, or the pool max), the eval
// block's BatchNorm and ReLU (scale, shift: (16,) f32, read by the eval
// form only), in place of the train forms' y = v.
template <bool STEM, bool S, bool EVAL = false>
__global__ void __launch_bounds__(256, 2)
down_fwd3_f32_kernel(const float* __restrict__ x,
                     const int* __restrict__ shifts,
                     const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ xa, float* __restrict__ part, int B,
                     int Ho, int Wo, const float* __restrict__ scale = nullptr,
                     const float* __restrict__ shift = nullptr) {
  static_assert(!(EVAL && (S || STEM)), "the eval form: no sums, no stem");
  using G = Fwd3F32;
  using P = G::Patch;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem + G::a_off);
  float* Ws = reinterpret_cast<float*>(smem + G::w_off);
  float* Cs = reinterpret_cast<float*>(smem + G::o_off);
  const int H = 2 * Ho, W = 2 * Wo;
  const int tiles =
      B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int colg = threadIdx.x % G::TC, rowg = threadIdx.x / G::TC;

  // the tap stack (27 x 13, row (kh * 3 + kw) 3 + ci), zero padded
  for (int e = threadIdx.x; e < G::KP * G::NP; e += G::THREADS) {
    const int k = e / G::NP, n = e % G::NP;
    Ws[e] = k < 27 && n < G::CC ? __ldg(w + k * G::CC + n) : 0.0f;
  }
  float bv[4];  // this thread's conv channels 4 colg + q
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bv[q] = 4 * colg + q < G::CC ? __ldg(bias + 4 * colg + q) : 0.0f;
  // the value stored for channel c (EVAL: no fma contraction, as in the
  // plain version: the product, then the sum, each rounded)
  auto fin = [&](float v, int c) {
    if constexpr (EVAL)
      return fmaxf(__fadd_rn(__fmul_rn(v, __ldg(scale + c)),
                             __ldg(shift + c)), 0.0f);
    else
      return v;
  };

  auto patch_of = [&](int kk) { return smem + (kk & 1) * P::bytes; };
  auto issue = [&](int t, int kk) {
    if (t < tiles)
      pf_load_raw<P>(patch_of(kk), x, STEM ? shifts : nullptr,
                     pp_tile_of<G>(t, Ho, Wo), H, W, G::THREADS);
    cp_async_commit();
  };

  issue(blockIdx.x, 0);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
    issue(t + gridDim.x, kk + 1);  // into the buffer tile kk - 1 left
    cp_async_wait_group<1>();
    __syncthreads();
    const unsigned char* patch = patch_of(kk);
    // im2col row m: K index kh * 9 + kw * 3 + ci is value 6 c + kw * 3 +
    // ci of patch row 2 r + kh; and the pool of the same patch
    const int m = threadIdx.x, r = m / G::TW, c = m % G::TW;
    {
      float v[G::KP];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh)
#pragma unroll
        for (int q = 0; q < 9; ++q)
          v[kh * 9 + q] = P::at(patch, 2 * r + kh, 6 * c + q);
      v[27] = 0.0f;
#pragma unroll
      for (int j = 0; j < G::KP / 4; ++j)
        *reinterpret_cast<float4*>(As + m * G::LDA + 4 * j) =
            make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    float pv[3];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
      pv[ci] = fmaxf(fmaxf(P::at(patch, 2 * r + 1, (2 * c + 1) * 3 + ci),
                           P::at(patch, 2 * r + 1, (2 * c + 2) * 3 + ci)),
                     fmaxf(P::at(patch, 2 * r + 2, (2 * c + 1) * 3 + ci),
                           P::at(patch, 2 * r + 2, (2 * c + 2) * 3 + ci)));
    __syncthreads();
    float acc[G::TM][G::TN];
    zero_tile(acc);
    ffma_tile<G::TM, G::TN, G::KP, 4 * G::TC>(
        acc, As + rowg * G::LDA, G::RS * G::LDA, Ws + 4 * colg, G::NP);
    // stage whole pixels: conv channels sum + b, then the pool channels
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      float* dst = Cs + (rowg + i * G::RS) * G::COUT + 4 * colg;
      if (4 * colg + 3 < G::CC)
        *reinterpret_cast<float4*>(dst) =
            make_float4(fin(acc[i][0] + bv[0], 4 * colg),
                        fin(acc[i][1] + bv[1], 4 * colg + 1),
                        fin(acc[i][2] + bv[2], 4 * colg + 2),
                        fin(acc[i][3] + bv[3], 4 * colg + 3));
      else  // channel 12; 13 .. 15 are the pool's
        dst[0] = fin(acc[i][0] + bv[0], 4 * colg);
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
      Cs[m * G::COUT + G::CC + ci] = fin(pv[ci], G::CC + ci);
    if constexpr (STEM) {
      // the translated image's tile interior (patch rows 1 .. 2 TH, values
      // 3 .. 6 TW + 2), an f32 pair a thread: each input pixel lies in
      // exactly one tile
      const int n3 = 3 * min(2 * G::TW, W - 2 * tl.j0);  // even
      for (int v = threadIdx.x; v < 2 * G::TH * 3 * G::TW;
           v += G::THREADS) {
        const int pr = 1 + v / (3 * G::TW), k = v % (3 * G::TW);
        const int h = 2 * tl.i0 + pr - 1;
        if (h < H && 2 * k < n3)
          *reinterpret_cast<float2*>(
              xa + (((long long)tl.b * H + h) * W + 2 * tl.j0) * 3 + 2 * k) =
              make_float2(P::at(patch, pr, 3 + 2 * k),
                          P::at(patch, pr, 4 + 2 * k));
      }
    }
    __syncthreads();

    // whole output pixels, 16 bytes a thread: thread t always holds
    // channels 4 (t % 4) .. + 3, its sums in registers
    float s0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int v = threadIdx.x; v < G::BM * 4; v += G::THREADS) {
      const int p = v / 4, j = v % 4;
      const int i = tl.i0 + p / G::TW, jj = tl.j0 + p % G::TW;
      if (i >= Ho || jj >= Wo) continue;
      const float4 q = *reinterpret_cast<const float4*>(Cs + p * G::COUT +
                                                        4 * j);
      *reinterpret_cast<float4*>(
          out + (((long long)tl.b * Ho + i) * Wo + jj) * G::COUT + 4 * j) = q;
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
      // lanes of one channel group (lane % 4) in a fixed butterfly, the
      // warps in order: the tile's partial part[t] = [sum y | sum y^2]
#pragma unroll
      for (int o = 4; o < 32; o *= 2)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], o);
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        }
      float* red = As;  // read by every thread before the last barrier
      if (lane < 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          red[warp * 2 * G::COUT + 4 * lane + k] = s0[k];
          red[warp * 2 * G::COUT + G::COUT + 4 * lane + k] = s1[k];
        }
      __syncthreads();
      if (threadIdx.x < 2 * G::COUT) {
        float a = 0.0f;
        for (int wi = 0; wi < G::THREADS / 32; ++wi)
          a += red[wi * 2 * G::COUT + threadIdx.x];
        part[(long long)t * 2 * G::COUT + threadIdx.x] = a;
      }
    }
    __syncthreads();  // As, Cs and this patch consumed
  }
  cp_async_wait_all();
}

}  // namespace erfk
