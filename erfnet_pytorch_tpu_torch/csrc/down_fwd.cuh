// The bf16 DownsamplerBlock forward, cat[conv3x3 s2 p1 (x; Cin -> Cc) + b,
// maxpool2x2(x)], as a stride-2 conv over the parity planes of each
// tile's halo patch (parity_plane.cuh PFPatch, PFRaw): shared by the train
// forward (downsampler_train.cu: y rounded to bf16, with the per-tile BN
// sums and the stem's translate) and the eval block (downsampler.cu: the
// BatchNorm scale and shift and the ReLU applied to the f32 values before
// their one bf16 rounding).  (Cin, Cc) in {(3, 13), (16, 48), (64, 64)};
// the design and its bound are in downsampler_train.cu's header comment.
#pragma once

#include "parity_plane.cuh"

namespace erfk {

// Tiles of TH x 32 output pixels of one image, the halo patch in parity
// planes (parity_plane.cuh PFPatch; PFRaw and an im2col tile at Cin = 3),
// the (9 Cin x Cc) tap stack resident; persistent CTAs of 256 threads, the
// next tile's patch in flight while this one multiplies.  Warps: WROWS x
// WCOLS, each WM pixels (of one tile row) x WN conv channels.  Epilogue:
// the conv channels rounded from f32 and the pool channels staged in Cs
// (whole output pixels), written 16 bytes a thread, the sums taken from
// the stored values.
template <int CIN, int CC, bool STEM>
struct Fwd {
  static constexpr int TH = CIN == 64 ? 2 : CIN == 16 ? 4 : 8, TW = 32;
  static constexpr int BM = TH * TW, THREADS = 256, WARPS = 8;
  static constexpr int COUT = CIN + CC, NP = (CC + 15) / 16 * 16;
  static constexpr int VC = COUT / 8;
  static constexpr int KP = CIN == 3 ? 32 : 9 * CIN;  // Cin = 3: K = 27, padded
  static constexpr int WN = NP <= 48 ? NP : 32, WCOLS = NP / WN;
  static constexpr int WROWS = WARPS / WCOLS, WM = BM / WROWS;
  static constexpr int MT = WM / 16, NT = WN / 8;
  // the tap stack: at Cc = 64 a row is 8 chunks, chunk e of row k stored
  // at e ^ (k & 7) (no padding); else the pitch is an odd multiple of 16
  // bytes
  static constexpr bool SWZ_W = NP == 64;
  static constexpr int LDA = KP + 8, LDB = SWZ_W ? NP : NP + 8;
  static constexpr int LDO = COUT + 8;
  __device__ static bf16* w_at(bf16* Ws, int k, int e) {
    return Ws + k * LDB + (SWZ_W ? e ^ (k & 7) : e) * 8;
  }
  static constexpr int MIN_CTAS = CIN == 64 ? 1 : CIN == 16 ? 2 : 3;
  using Patch =
      std::conditional_t<CIN == 3, PFRaw<STEM, TH>, PFPatch<CIN, TH>>;
  static constexpr size_t patch_bytes = Patch::bytes;
  static constexpr size_t a_off = 2 * patch_bytes;  // two patches
  static constexpr size_t w_off =
      a_off + (CIN == 3 ? pp_align((size_t)BM * LDA * 2) : 0);
  static constexpr size_t o_off = w_off + pp_align((size_t)KP * LDB * 2);
  static constexpr size_t smem = o_off + pp_align((size_t)BM * LDO * 2);
  // the sums' scratch lives in the tile's own patch, read by then
  static constexpr size_t red_bytes = (size_t)WARPS * VC * 16 * 4;
  static_assert((CIN == 3 || CIN % 16 == 0) && COUT % 8 == 0 &&
                    WM % 16 == 0 && TW % WM == 0,
                "forward tile: a warp's pixels in one tile row");
  static_assert(CIN != 3 || BM == THREADS, "Cin = 3: a thread a pixel");
  static_assert(VC <= 32 && 2 * COUT <= THREADS && smem <= 232448 &&
                    red_bytes <= patch_bytes,
                "forward epilogue");
};

// S: the per-tile sums of y into part.  EVAL: y = bf16(relu(v * scale +
// shift)) per channel from the f32 value v (conv sum + bias, or the pool
// max), the eval block's BatchNorm and ReLU (scale, shift: (CIN + CC,)
// f32, not read by the train forms), in place of the train form's
// bf16(v).
template <int CIN, int CC, bool STEM, bool S, bool EVAL = false>
__global__ void __launch_bounds__(256, (Fwd<CIN, CC, STEM>::MIN_CTAS))
down_fwd_kernel(const void* __restrict__ x, const int* __restrict__ shifts,
                const bf16* __restrict__ w, const float* __restrict__ bias,
                bf16* __restrict__ out, bf16* __restrict__ xa,
                float* __restrict__ part, int B, int Ho, int Wo,
                const float* __restrict__ scale,
                const float* __restrict__ shift) {
  static_assert(!(EVAL && (S || STEM)), "the eval form: no sums, no stem");
  using G = Fwd<CIN, CC, STEM>;
  using P = typename G::Patch;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + G::a_off);
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::w_off);
  bf16* Cs = reinterpret_cast<bf16*>(smem + G::o_off);
  const int H = 2 * Ho, W = 2 * Wo;
  const int tiles =
      B * ((Ho + G::TH - 1) / G::TH) * ((Wo + G::TW - 1) / G::TW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / G::WCOLS, wn = warp % G::WCOLS;

  // the tap stack, row (kh * 3 + kw) CIN + ci, zero in the padding
  if constexpr (CC % 8 == 0) {
    static_assert(G::NP == CC, "no column padding");
    for (int v = threadIdx.x; v < 9 * CIN * (CC / 8); v += G::THREADS) {
      const int r = v / (CC / 8), e = v % (CC / 8);
      cp_async16(G::w_at(Ws, r, e), w + (size_t)r * CC + e * 8, true);
    }
  } else {
    for (int e = threadIdx.x; e < G::KP * G::NP; e += G::THREADS) {
      const int k = e / G::NP, n = e % G::NP;
      Ws[k * G::LDB + n] =
          k < 9 * CIN && n < CC ? w[k * CC + n] : __float2bfloat16(0.0f);
    }
  }
  // thread (g8, t4) of an m16 x n8 tile: columns 2 t4, 2 t4 + 1; EVAL,
  // their scale and shift
  float bv[G::NT][2], sc[G::NT][2], sh[G::NT][2];
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = wn * G::WN + nt * 8 + 2 * (lane % 4) + q;
      bv[nt][q] = n < CC ? __ldg(bias + n) : 0.0f;
      if constexpr (EVAL) {
        sc[nt][q] = n < CC ? __ldg(scale + n) : 0.0f;
        sh[nt][q] = n < CC ? __ldg(shift + n) : 0.0f;
      }
    }
  // the value stored for channel c: EVAL, the BatchNorm and ReLU (no fma
  // contraction: the plain version rounds the product, then the sum)
  auto eval_of = [&](float v, float s, float t) {
    return fmaxf(__fadd_rn(__fmul_rn(v, s), t), 0.0f);
  };

  auto patch_of = [&](int kk) { return smem + (kk & 1) * G::patch_bytes; };
  auto issue = [&](int t, int kk) {
    if (t < tiles) {
      const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
      if constexpr (CIN == 3)
        pf_load_raw<P>(patch_of(kk), x, shifts, tl, H, W, G::THREADS);
      else
        pf_load_patch<P>(reinterpret_cast<bf16*>(patch_of(kk)),
                         static_cast<const bf16*>(x), tl, H, W, G::THREADS);
    }
    cp_async_commit();
  };

  issue(blockIdx.x, 0);  // with the tap stack
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const PPTile tl = pp_tile_of<G>(t, Ho, Wo);
    issue(t + gridDim.x, kk + 1);  // into the buffer tile kk - 1 left
    cp_async_wait_group<1>();
    __syncthreads();
    unsigned char* patch = patch_of(kk);
    float acc[G::MT][G::NT][4];
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.0f;

    // the product: B fragments of rows krow .. krow + 15 of the tap stack
    // against this warp's A fragments (the tap's plane pixels at Cin = 16,
    // 64; the im2col tile at Cin = 3)
    auto mma_k16 = [&](const unsigned (&a)[G::MT][4], int krow) {
#pragma unroll
      for (int n = 0; n < G::WN / 16; ++n) {
        unsigned bb[4];
        ldsm_x4_trans(bb, G::w_at(Ws, krow + lane % 16,
                                  (wn * G::WN + n * 16) / 8 + lane / 16));
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * n], a[mt], bb[0], bb[1]);
          mma_bf16_16816(acc[mt][2 * n + 1], a[mt], bb[2], bb[3]);
        }
      }
    };
    const bf16* pb = reinterpret_cast<const bf16*>(patch);
    if constexpr (CIN == 3) {
      // im2col from the patch rows: K index kh * 9 + kw * 3 + ci is value
      // 6 c + kw * 3 + ci of patch row 2 r + kh, rounded to bf16 once
      {
        const int m = threadIdx.x, r = m / G::TW, c = m % G::TW;
        float v[G::KP];
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int q = 0; q < 9; ++q)
            v[kh * 9 + q] = P::at(patch, 2 * r + kh, 6 * c + q);
#pragma unroll
        for (int k = 27; k < G::KP; ++k) v[k] = 0.0f;
#pragma unroll
        for (int j = 0; j < G::KP / 8; ++j)
          *reinterpret_cast<uint4*>(As + m * G::LDA + j * 8) =
              pack_bf16x8(v + j * 8);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < G::KP; k += 16) {
        unsigned a[G::MT][4];
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt)
          ldsm_x4(a[mt], As + (wm * G::WM + mt * 16 + lane % 16) * G::LDA +
                             k + (lane / 16) * 8);
        mma_k16(a, k);
      }
    } else {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        int q[G::MT];  // this lane's A row: the tap's plane pixel
#pragma unroll
        for (int mt = 0; mt < G::MT; ++mt) {
          const int m = wm * G::WM + mt * 16 + lane % 16;
          q[mt] = P::tap(m / G::TW, m % G::TW, tap / 3, tap % 3);
        }
#pragma unroll
        for (int k = 0; k < CIN; k += 16) {
          unsigned a[G::MT][4];
#pragma unroll
          for (int mt = 0; mt < G::MT; ++mt)
            ldsm_x4(a[mt], P::at(pb, q[mt], k / 8 + lane / 16));
          mma_k16(a, tap * CIN + k);
        }
      }
    }

    // stage: the conv channels, bf16(sum + b) (EVAL: its BatchNorm and
    // ReLU first)
#pragma unroll
    for (int mt = 0; mt < G::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * G::WM + mt * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          const int n = wn * G::WN + nt * 8 + 2 * (lane % 4);
          float v0 = acc[mt][nt][2 * h] + bv[nt][0];
          float v1 = acc[mt][nt][2 * h + 1] + bv[nt][1];
          if constexpr (EVAL) {
            v0 = eval_of(v0, sc[nt][0], sh[nt][0]);
            v1 = eval_of(v1, sc[nt][1], sh[nt][1]);
          }
          bf16* dst = Cs + m * G::LDO + n;
          if constexpr (CC % 2 == 0) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < CC) dst[0] = __float2bfloat16(v0);
            if (n + 1 < CC) dst[1] = __float2bfloat16(v1);
          }
        }
      }
    // the pool channels: max of taps 4, 5, 7, 8 (bf16 values; the max of
    // the stem's f32 values rounds as the max of their roundings)
    if constexpr (CIN == 3) {
      const int m = threadIdx.x, r = m / G::TW, c = m % G::TW;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        float v = P::at(patch, 2 * r + 1, (2 * c + 1) * 3 + ci);
        v = fmaxf(v, P::at(patch, 2 * r + 1, (2 * c + 2) * 3 + ci));
        v = fmaxf(v, fmaxf(P::at(patch, 2 * r + 2, (2 * c + 1) * 3 + ci),
                           P::at(patch, 2 * r + 2, (2 * c + 2) * 3 + ci)));
        if constexpr (EVAL)
          v = eval_of(v, __ldg(scale + CC + ci), __ldg(shift + CC + ci));
        Cs[m * G::LDO + CC + ci] = __float2bfloat16(v);
      }
    } else {
      for (int v = threadIdx.x; v < G::BM * P::VK; v += G::THREADS) {
        const int m = v / P::VK, j = v % P::VK;
        const int r = m / G::TW, c = m % G::TW;
        float t4[8], t5[8], t7[8], t8[8], o[8];
        auto tap8 = [&](int kh, int kw, float (&t)[8]) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(
                            P::at(pb, P::tap(r, c, kh, kw), j)), t);
        };
        tap8(1, 1, t4);
        tap8(1, 2, t5);
        tap8(2, 1, t7);
        tap8(2, 2, t8);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          o[k] = fmaxf(fmaxf(t4[k], t5[k]), fmaxf(t7[k], t8[k]));
          if constexpr (EVAL)
            o[k] = eval_of(o[k], __ldg(scale + CC + j * 8 + k),
                           __ldg(shift + CC + j * 8 + k));
        }
        *reinterpret_cast<uint4*>(Cs + m * G::LDO + CC + j * 8) =
            pack_bf16x8(o);
      }
    }
    if constexpr (STEM) {
      // the translated image's tile interior (patch rows 1 .. 2 TH, values
      // 3 .. 6 TW + 2), a bf16 pair a thread: each input pixel lies in
      // exactly one tile
      const int n3 = 3 * min(2 * G::TW, W - 2 * tl.j0);  // even
      for (int v = threadIdx.x; v < 2 * G::TH * 3 * G::TW;
           v += G::THREADS) {
        const int pr = 1 + v / (3 * G::TW), k = v % (3 * G::TW);
        const int h = 2 * tl.i0 + pr - 1;
        if (h < H && 2 * k < n3)
          *reinterpret_cast<__nv_bfloat162*>(
              xa + (((long long)tl.b * H + h) * W + 2 * tl.j0) * 3 + 2 * k) =
              __floats2bfloat162_rn(P::at(patch, pr, 3 + 2 * k),
                                    P::at(patch, pr, 4 + 2 * k));
      }
    }
    __syncthreads();

    // write whole output pixels, 16 bytes a thread; thread t always holds
    // channels 8 (t % VC) .. + 7, its sums in registers
    float s0[8], s1[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s0[k] = s1[k] = 0.0f;
    for (int v = threadIdx.x; v < G::BM * G::VC; v += G::THREADS) {
      const int m = v / G::VC, j = v % G::VC;
      const int i = tl.i0 + m / G::TW, jj = tl.j0 + m % G::TW;
      if (i >= Ho || jj >= Wo) continue;
      const uint4 q = *reinterpret_cast<const uint4*>(Cs + m * G::LDO + j * 8);
      *reinterpret_cast<uint4*>(
          out + (((long long)tl.b * Ho + i) * Wo + jj) * G::COUT + j * 8) = q;
      if constexpr (S) {
        float f[8];
        unpack_bf16x8(q, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s0[k] += f[k];
          s1[k] += __fmul_rn(f[k], f[k]);
        }
      }
    }
    if constexpr (S) {
      // lanes of one channel group (lane % VC) in a fixed butterfly, the
      // warps in order: the tile's partial part[t] = [sum y | sum y^2]
#pragma unroll
      for (int o = G::VC; o < 32; o *= 2)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s0[k] += __shfl_xor_sync(0xffffffffu, s0[k], o);
          s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], o);
        }
      float* red = reinterpret_cast<float*>(patch);
      if (lane < G::VC)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          red[(warp * G::VC + lane) * 16 + k] = s0[k];
          red[(warp * G::VC + lane) * 16 + 8 + k] = s1[k];
        }
      __syncthreads();
      if (threadIdx.x < 2 * G::COUT) {
        const int q = threadIdx.x / G::COUT, c = threadIdx.x % G::COUT;
        float a = 0.0f;
        for (int wi = 0; wi < G::WARPS; ++wi)
          a += red[(wi * G::VC + c / 8) * 16 + q * 8 + c % 8];
        part[(long long)t * 2 * G::COUT + threadIdx.x] = a;
      }
    }
    __syncthreads();  // Cs, red and this patch consumed
  }
  cp_async_wait_all();
}

}  // namespace erfk
