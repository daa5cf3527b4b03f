// w8a8 int8 non_bottleneck_1d inference: one launch per block.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:_nb1d_q8_kernel (:149,
// via nb1d_infer_q8 / nb1d_infer_packed_q8) and :_nb1d_q8_stack_kernel
// (:223, via nb1d_stack_infer_q8, as one launch per block with an f32
// carry between launches).  With BN folded, per-column int8 weight codes
// w_k, and per-tensor activation scales, a block is
//
//   qx = clip(rint(x * inv_in), 0, 127)                        int8
//   t1 = clip(rint(conv3x1(qx)   * m1 + f1), 0, 127)           int8
//   t2 = clip(rint(conv1x3(t1)   * m2 + f2), 0, 127)           int8
//   t3 = clip(rint(conv3x1_d(t2) * m3 + f3), 0, 127)           int8
//   y  = relu((conv1x3_d(t3) * m4 + f4) + x)                   bf16 or f32
//
// where each conv is a sum of three shifted (pixels, C) x (C, C) int8
// products into int32 (zero fill outside the map, also for d >= H or W),
// m_k and f_k are per-column f32 vectors, and x is the block input, bf16 or
// f32, added unquantized.  The int32 sums are exact in any order and
// |sum| <= 127^2 * 3 * 128 < 2^24 converts to f32 exactly; every epilogue
// is written as __fmul_rn then __fadd_rn (never contracted into an FMA) and
// rounds half to even (code_bits), as the plain version (ops/cuda/
// nb1d_q8.py) and the TPU kernel do.  So both kernels below are
// bit-identical to the plain version, in all four pairs of bf16 / f32 in
// and out.
//
// Two kernels, by C (the wrapper picks one; each block is one launch):
//
// * C = 64 and C = 16 (d = 1, any H and W): the halo-tile block, the
//   frame of csrc/nb1d_halo.cu over int8 codes.  A persistent CTA owns one
//   TH x TW output tile of one image at a time and runs all four stages in
//   shared memory.  Every region of a tile is a run of whole rows of the x
//   window's frame (CW = TW + 2d + 2 columns): x rows [0, TH + 2d + 2), t1
//   and t2 rows [1, TH + 2d + 1), t3 and y rows [d + 1, d + 1 + TH), so
//   each tap of each stage is its input region shifted by a constant (t1:
//   +-CW, t2: +-1, t3: +-d CW, y: +-d).  The codes sit in chunk-major
//   planes (16 bytes, 16 channels, of every pixel in a plane, pixel after
//   pixel), so at C = 64 a tap's 64 rows are an s8 wgmma A operand as they
//   stand: each stage is wgmma m64n64k32 (a tap two k32 steps) with both
//   operands in shared memory, B the stage's tap stack (ops/cuda/
//   nb1d_q8.py wg_taps_q8: the four stacks, 48 KB, resident for the CTA's
//   life).  At C = 16 a pixel is one 16-byte row and a tap half a k32 step:
//   the product is mma.sync m16n8k16 s8, a tap a step, the A fragments
//   ldmatrix'd straight from the shifted region, B the stage's taps in
//   registers.  Stage 0 reads the x window once (bf16 or f32, 16 channels
//   a thread) and quantizes it once into the x planes; stages 1-3 store
//   their codes into the next region's planes (a column pair a 2-byte
//   store, from the accumulators as they lie, m and f in registers), code
//   0 at every pixel outside the true map (the next conv's zero
//   padding; the requant of the bias there need not be 0); stage 4 works
//   in real units, adds the residual x, loaded from device memory before
//   its product, and stores 8 channels a lane (quad_gather) of the tile's
//   pixels inside the map.  The columns a region computes past what the
//   next stage needs read past their input region and are never read by a
//   pixel that matters (ops/cuda/nb1d_q8.py nb1d_q8_halo_tiled_plain
//   reads a sentinel code there and equals the plain version).  Tiles:
//   C = 64 16 x 32 at one CTA of four warpgroups an SM (178 KB), C = 16
//   32 x 32 at three CTAs an SM (the variants script times others: 12 x
//   16 at two CTAs of two warpgroups took 1.2-1.3x as long at C = 64).
//
// * C = 128 (any d, also d >= H or W): the halo-patch stages of nb1d.cu's
//   bf16 form over int8 codes.  Four stages on a persistent cooperative
//   grid, a grid-wide barrier between two, t1 and t2 through two int8
//   scratch maps in device memory (4 MB at B = 4, in L2).  Each stage
//   copies a tile's halo patch along its axis (conv16.cuh patch_geo: its
//   positions and d on each side, zeros off the map) once into chunk-major
//   int8 planes, so that each tap is a constant shift of the patch and an
//   s8 wgmma A operand: wgmma m64n128k32, a tap four k32 steps, B the
//   stage's 48 KB tap stack, copied in beside the stage's first patch.
//   Stage 1 quantizes each patch pixel once while it stages the patch
//   (loads, code, shared stores), the next tile's patch while this one's
//   product is in flight; stages 2-4 copy code patches with cp.async, the
//   next one while this one multiplies.  Two warpgroups take a tile's two
//   m64 blocks with all 128 channels.
//
// Bound on this card at the serving shapes (B = 4, 512 x 1024): every
// block moves more bytes than its products need time (12 C^2 MACs a pixel
// at 1979 TOP/s against x read once and y written once at 3.35 TB/s), but
// for C = 128 with bf16 in and out, close to even.  What is left
// (scripts/cuda_nb1d_q8_variants.py): the stages run one after another
// behind a barrier each.
#include <cooperative_groups.h>

#include "conv16.cuh"

using namespace erfk;
namespace cg = cooperative_groups;

namespace {

// Exact conversions on the FP32 and integer pipes: this card converts
// between int32 and f32 (I2F, F2I) at 16 a clock an SM, an eighth of an
// FP32 add's rate, and the epilogues convert every sum twice (the
// variants script's conv_unit times them with I2F and F2I).  MAGIC =
// 1.5 * 2^23: its ulp is 1, and the float of bits MAGIC_BITS + k is MAGIC
// + k for |k| < 2^22.
constexpr float MAGIC = 12582912.0f;
constexpr int MAGIC_BITS = 0x4B400000;

// The code clip(rint(y), 0, 127) in the low byte of the result: y clamped
// to [0, 127] first (rint is monotone and keeps 0 and 127), then rounded
// to an integer, half to even as __float2int_rn, by the add (a NaN clamps
// to 0, as __float2int_rn's 0 clips).
__device__ __forceinline__ uint32_t code_bits(float y) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, 0.0f), 127.0f), MAGIC));
}

// The codes in the low bytes of a, b, c, d as one word, a first.
__device__ __forceinline__ uint32_t pack_codes(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The int32 sum of a conv over C channels as f32, exactly: |sum| <= 127^2
// 3 C, below 2^22 for C <= 64 (the bits of MAGIC + sum, less MAGIC); I2F
// at C = 128.
template <int C>
__device__ __forceinline__ float sum_f32(int acc) {
  if constexpr (127 * 127 * 3 * C < (1 << 22))
    return __fsub_rn(__int_as_float(MAGIC_BITS + acc), MAGIC);
  else
    return __int2float_rn(acc);
}

// A stage's requant: the sum in the units of the next code, multiplied
// then added, each rounded (no FMA), to a code (code_bits).
template <int C>
__device__ __forceinline__ uint32_t requant(int acc, float m, float f) {
  return code_bits(__fadd_rn(__fmul_rn(sum_f32<C>(acc), m), f));
}

// 8 and 16 consecutive values of a map that no kernel writes in this launch
// (the block input x), kept as loaded until they are needed.
template <typename T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 r;
  __device__ void load(const bf16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void zero() { r = zero_vec(); }
  __device__ void get(float* v) const { unpack_bf16x8(r, v); }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void zero() { a = b = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ void get(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

template <typename T>
struct Vec16 {
  Vec8<T> lo, hi;
  __device__ void load(const T* p) {
    lo.load(p);
    hi.load(p + 8);
  }
  // the 16 codes of v * inv, 16 bytes
  __device__ uint4 codes(float inv) const {
    float v[16];
    lo.get(v);
    hi.get(v + 8);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = pack_codes(code_bits(__fmul_rn(v[4 * i], inv)),
                        code_bits(__fmul_rn(v[4 * i + 1], inv)),
                        code_bits(__fmul_rn(v[4 * i + 2], inv)),
                        code_bits(__fmul_rn(v[4 * i + 3], inv)));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Stage 4's epilogue on 8 channels c0 .. c0 + 7 of a pixel: the sums in
// real units, plus the residual, ReLU.
__device__ __forceinline__ void last_epilogue(float (&o)[8], const float* m,
                                              const float* f,
                                              const float (&r)[8]) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    o[c] = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(o[c], m[c]), f[c]), r[c]),
                 0.0f);
}

// The codes of one accumulator row of 8 n8 tiles (64 channels: tile j
// holds channels 8 j + 2 tq, + 1 of this lane) as 16 bytes of the chunk tq
// (channels 16 tq .. 16 tq + 15) of the row's pixel: the requant of each
// pair, the pairs of tiles 2 s and 2 s + 1 in word s, transposed across
// the quad.
template <int C>
__device__ __forceinline__ uint4 chunk_codes(const int* acc, int stride,
                                             const float* m, const float* f,
                                             int lane) {
  const int tq = lane & 3;
  uint32_t w[4], r[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t q[4];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = 2 * s + k, c = 8 * j + 2 * tq;
      const float2 mm = *reinterpret_cast<const float2*>(m + c);
      const float2 ff = *reinterpret_cast<const float2*>(f + c);
      q[2 * k] = requant<C>(acc[stride * j], mm.x, ff.x);
      q[2 * k + 1] = requant<C>(acc[stride * j + 1], mm.y, ff.y);
    }
    w[s] = pack_codes(q[0], q[1], q[2], q[3]);
  }
  quad_transpose(w, r, lane);
  // chunk tq: tile 2 tq's columns (lane l's pair at bytes 2 l, 2 l + 1),
  // then tile 2 tq + 1's
  return make_uint4(__byte_perm(r[0], r[1], 0x5410),
                    __byte_perm(r[2], r[3], 0x5410),
                    __byte_perm(r[0], r[1], 0x7632),
                    __byte_perm(r[2], r[3], 0x7632));
}

// ---------------------------------------------------------------------------
// C = 64 and C = 16: the halo-tile block
// ---------------------------------------------------------------------------

// The output tile (TH x TW) and the CTA, by C.
template <int C>
struct Halo;
template <>
struct Halo<64> {
  static constexpr int TH = 16, TW = 32, THREADS = 512, CTAS_PER_SM = 1;
};
template <>
struct Halo<16> {
  static constexpr int TH = 32, TW = 32, THREADS = 256, CTAS_PER_SM = 3;
};

// The frame at d = 1: CW = TW + 2D + 2 columns for every region; frame
// row rho of the x window at map row h0 - D - 1 + rho, column kappa at w0
// - D - 1 + kappa.  Shared memory: the four tap stacks (wg_taps_q8), m and
// f (4, C) f32, then x (PX pixels a plane), t1 (P1; t3 after stage 2) and
// t2 (P2) in chunk-major int8 planes (PX and P2 odd: the 16-byte stores of
// a pixel's chunks fall on distinct bank groups), then slack for the reads
// of the rows past a region's last m64 block.
template <int C>
struct HCfg {
  using T = Halo<C>;
  static constexpr int D = 1, TH = T::TH, TW = T::TW, THREADS = T::THREADS;
  static constexpr int WARPS = THREADS / 32, WGS = THREADS / 128;
  static constexpr int VK = C / 16;  // 16-byte chunks of a pixel's codes
  static constexpr int CW = TW + 2 * D + 2, R0 = TH + 2 * D + 2;
  static constexpr int MX = R0 * CW;            // x: rows [0, R0)
  static constexpr int M1 = (TH + 2 * D) * CW;  // t1, t2: rows [1, R0 - 1)
  static constexpr int M3 = TH * CW;            // t3, y: rows [D + 1, + TH)
  static constexpr int PX = MX | 1, P1 = M1, P2 = M1 | 1;
  static constexpr int SLACK = 128;  // pixels
  static constexpr size_t mf_off = (size_t)4 * 3 * C * C;
  static constexpr size_t x_off = mf_off + (size_t)2 * 4 * C * 4;
  static constexpr size_t t1_off = x_off + (size_t)VK * PX * 16;
  static constexpr size_t t2_off = t1_off + (size_t)VK * P1 * 16;
  static constexpr size_t smem = t2_off + (size_t)(VK * P2 + SLACK) * 16;
  // the rows past stage 3's last m64 block read into the slack
  static_assert(C == 16 || (M3 + 63) / 64 * 64 + 2 * D * CW <= P2 + SLACK,
                "halo slack");
  static_assert(M3 <= M1 && (smem + 1024) * T::CTAS_PER_SM <= 233472 &&
                    THREADS % 128 == 0,
                "int8 halo tile");
};

// Stage 0 of a tile: the x window of the tile whose output corner is (h0,
// w0) of image img, quantized once into the x planes (chunk e of frame
// pixel pix at X + (e PX + pix) 16), code 0 where it leaves the map.  U
// (pixel, chunk) loads of a thread in flight at once.
template <int C, typename InT>
__device__ __forceinline__ void quantize_window(int8_t* X, const InT* img,
                                                int h0, int w0, int H, int W,
                                                float inv) {
  using G = HCfg<C>;
  constexpr int N = G::MX * G::VK, U = C == 16 ? 2 : 4;
  for (int v0 = threadIdx.x; v0 < N; v0 += U * G::THREADS) {
    Vec16<InT> v[U];
    bool ok[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = v0 + k * G::THREADS, pix = i / G::VK, e = i % G::VK;
      const int gh = h0 - G::D - 1 + pix / G::CW;
      const int gw = w0 - G::D - 1 + pix % G::CW;
      ok[k] = i < N && gh >= 0 && gh < H && gw >= 0 && gw < W;
      if (ok[k]) v[k].load(img + ((long long)gh * W + gw) * C + e * 16);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = v0 + k * G::THREADS;
      if (i >= N) break;
      const uint4 v4 = ok[k] ? v[k].codes(inv) : zero_vec();
      int8_t* dst = X + ((i % G::VK) * G::PX + i / G::VK) * 16;
      *reinterpret_cast<uint4*>(dst) = v4;
    }
  }
}

// Where region pixel u (frame row FIRST + u / CW) lies on the map: its
// map pixel, whether it is inside the map (and u < M), and whether it is
// one of the tile's outputs (stage 4).
template <int C, int M, int FIRST>
__device__ __forceinline__ void region_pixel(int u, int h0, int w0, int H,
                                             int W, long long& pix,
                                             bool& in_map, bool& out) {
  using G = HCfg<C>;
  const int rho = FIRST + u / G::CW, kap = u % G::CW;
  const int gh = h0 - G::D - 1 + rho, gw = w0 - G::D - 1 + kap;
  in_map = u < M && gh >= 0 && gh < H && gw >= 0 && gw < W;
  out = in_map && kap > G::D && kap <= G::D + G::TW;
  pix = (long long)gh * W + gw;
}

// The code pair of accumulators a, b (columns c, c + 1 of a row) in the
// low half, 0 outside the map.
template <int C>
__device__ __forceinline__ uint32_t code_pair(int a, int b, float2 m,
                                              float2 f, bool in_map) {
  return in_map ? __byte_perm(requant<C>(a, m.x, f.x),
                              requant<C>(b, m.y, f.y), 0x0040)
                : 0u;
}

// One C = 64 stage of a tile: output pixels [0, M) of a region whose pixel
// u is frame pixel u + FIRST CW, each the sum over taps t of in[u + t TAP +
// OFF] @ w[t], in chunk-major planes of pitch PIN; the warpgroups take its
// m64 blocks in turn.
//   !LAST: codes, 0 outside the map (the next conv's padding), into planes
//          of pitch POUT (out_s): each lane stores its pairs as they lie in
//          the accumulators, 2 bytes a column pair (m and f of its
//          columns in registers for the stage).
//   LAST:  relu(acc m + f + x) into out_g (the image's output), x loaded
//          before the product, at the tile's pixels inside the map.
template <int M, int FIRST, int TAP, int OFF, int PIN, int POUT, bool LAST,
          typename InT, typename OutT>
__device__ __forceinline__ void stage_wg(const int8_t* in, const int8_t* Ws,
                                         const float* mv, const float* fv,
                                         int8_t* out_s, OutT* out_g,
                                         const InT* xi, int h0, int w0,
                                         int H, int W) {
  constexpr int C = 64, NB = (M + 63) / 64, NG = C / 32;
  using G = HCfg<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const uint64_t db = wgmma_desc(Ws, C * 16, 128);
  float2 mr[LAST ? 1 : C / 8], fr[LAST ? 1 : C / 8];
  if constexpr (!LAST) {
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      mr[j] = *reinterpret_cast<const float2*>(mv + 8 * j + 2 * tq);
      fr[j] = *reinterpret_cast<const float2*>(fv + 8 * j + 2 * tq);
    }
  }
  for (int blk = warp / 4; blk < NB; blk += G::WGS) {
    int u[2];
    bool in_map[2], out[2];
    long long pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      u[h] = blk * 64 + (warp % 4) * 16 + gid + 8 * h;
      region_pixel<C, M, FIRST>(u[h], h0, w0, H, W, pix[h], in_map[h],
                                out[h]);
    }
    Vec8<InT> res[2][LAST ? NG : 1];
    if constexpr (LAST) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          if (out[h])
            res[h][x].load(xi + pix[h] * C + (4 * x + tq) * 8);
          else
            res[h][x].zero();
        }
    }
    int acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const uint64_t da =
          wgmma_desc(in + (blk * 64 + t * TAP + OFF) * 16, PIN * 16, 128);
#pragma unroll
      for (int ks = 0; ks < C / 32; ++ks) {
        const uint64_t koff_a = (uint64_t)(2 * ks * PIN);
        const uint64_t koff_b = wg_tap_offset_q8<C>(t, ks) >> 4;
        wgmma_s8(acc, da + koff_a, db + koff_b, ks | t);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (!LAST) {
        // tile j's pair (channels 8 j + 2 tq, + 1) in plane j / 2
        int8_t* dst = out_s + u[h] * 16 + 2 * tq;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          const uint32_t pr = code_pair<C>(acc[4 * j + 2 * h],
                                           acc[4 * j + 2 * h + 1], mr[j],
                                           fr[j], in_map[h]);
          if (u[h] < M)
            *reinterpret_cast<uint16_t*>(dst + (j >> 1) * POUT * 16 +
                                         8 * (j & 1)) = (uint16_t)pr;
        }
      } else {
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          float p4[4][2], o[8], r[8];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            p4[s][0] = sum_f32<C>(acc[4 * (4 * x + s) + 2 * h]);
            p4[s][1] = sum_f32<C>(acc[4 * (4 * x + s) + 2 * h + 1]);
          }
          quad_gather(p4, o, lane);
          const int c0 = (4 * x + tq) * 8;
          res[h][x].get(r);
          last_epilogue(o, mv + c0, fv + c0, r);
          if (out[h]) store8(out_g + pix[h] * C + c0, o);
        }
      }
    }
  }
}

// d += a (16 x 16, row) b (16 x 8, col), s8 operands, s32 sums.
__device__ __forceinline__ void mma_s8_16816(int (&d)[4],
                                             const uint32_t (&a)[2],
                                             uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// One C = 16 stage of a tile (the regions, taps and stores of stage_wg): a
// warp's job MT m16 tiles of output pixels by all 16 channels, a tap a k16
// step; the A fragments ldmatrix'd from the region's shifted rows (a pixel
// one 16-byte row), B (tap t, n8 tile n: this lane's 4 k of column 8 n +
// gid) from the wgmma layout of the taps, in registers for the stage.  The
// last stage transposes each m16 tile's sums across the quad (quad_gather):
// the lane takes row tq / 2 and channels 8 (tq % 2) .. + 7.
template <int M, int FIRST, int TAP, int OFF, bool LAST, typename InT,
          typename OutT>
__device__ __forceinline__ void stage_mma(const int8_t* in, const int8_t* Ws,
                                          const float* mv, const float* fv,
                                          int8_t* out_s, OutT* out_g,
                                          const InT* xi, int h0, int w0,
                                          int H, int W) {
  constexpr int C = 16, MT = 2, CH = 16 * MT, JOBS = (M + CH - 1) / CH;
  using G = HCfg<C>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  uint32_t bw[3][2];
  float2 mr[2], fr[2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
      bw[t][n] = *reinterpret_cast<const uint32_t*>(
          Ws + t * C * C + (8 * n + gid) * 16 + 4 * tq);
    mr[n] = *reinterpret_cast<const float2*>(mv + 8 * n + 2 * tq);
    fr[n] = *reinterpret_cast<const float2*>(fv + 8 * n + 2 * tq);
  }
  // the last stage's channels of this lane after the transpose
  const int c0 = 8 * (tq & 1);
  for (int job = warp; job < JOBS; job += G::WARPS) {
    // lane l gives the address of row l % 8 of matrix l / 8: pixel job CH
    // + l (rows past the region read a pixel inside it, never stored)
    const int ul = min(job * CH + lane, M - 1);
    // the last stage's output row of this lane, one per m16 tile
    int u[MT];
    bool out[MT];
    long long pix[MT];
    Vec8<InT> res[LAST ? MT : 1];
    if constexpr (LAST) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        bool in_map;
        u[mt] = job * CH + mt * 16 + gid + 8 * (tq >> 1);
        region_pixel<C, M, FIRST>(u[mt], h0, w0, H, W, pix[mt], in_map,
                                  out[mt]);
        if (out[mt])
          res[mt].load(xi + pix[mt] * C + c0);
        else
          res[mt].zero();
      }
    }
    uint32_t a[MT][3][2];
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      unsigned r[4];
      ldsm4(r, smem_addr(in + (ul + t * TAP + OFF) * 16));
      a[0][t][0] = r[0];
      a[0][t][1] = r[1];
      a[1][t][0] = r[2];
      a[1][t][1] = r[3];
    }
    int acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0;
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_s8_16816(acc[mt][n], a[mt][t], bw[t][n]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (!LAST) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int uh = job * CH + mt * 16 + gid + 8 * h;
          bool in_map, out_h;
          long long pix_h;
          region_pixel<C, M, FIRST>(uh, h0, w0, H, W, pix_h, in_map, out_h);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const uint32_t pr =
                code_pair<C>(acc[mt][n][2 * h], acc[mt][n][2 * h + 1], mr[n],
                             fr[n], in_map);
            if (uh < M)
              *reinterpret_cast<uint16_t*>(out_s + uh * 16 + 8 * n +
                                           2 * tq) = (uint16_t)pr;
          }
        }
      } else {
        float p4[4][2], o[8], r[8];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            p4[2 * h + n][0] = sum_f32<C>(acc[mt][n][2 * h]);
            p4[2 * h + n][1] = sum_f32<C>(acc[mt][n][2 * h + 1]);
          }
        quad_gather(p4, o, lane);
        res[mt].get(r);
        last_epilogue(o, mv + c0, fv + c0, r);
        if (out[mt]) store8(out_g + pix[mt] * C + c0, o);
      }
    }
  }
}

// One stage of the halo block at C (stage_wg at 64, stage_mma at 16).
template <int C, int M, int FIRST, int TAP, int OFF, int PIN, int POUT,
          bool LAST, typename InT, typename OutT>
__device__ __forceinline__ void hstage(const int8_t* in, const int8_t* Ws,
                                       const float* mv, const float* fv,
                                       int8_t* out_s, OutT* out_g,
                                       const InT* xi, int h0, int w0, int H,
                                       int W) {
  if constexpr (C == 64)
    stage_wg<M, FIRST, TAP, OFF, PIN, POUT, LAST, InT, OutT>(
        in, Ws, mv, fv, out_s, out_g, xi, h0, w0, H, W);
  else
    stage_mma<M, FIRST, TAP, OFF, LAST, InT, OutT>(in, Ws, mv, fv, out_s,
                                                  out_g, xi, h0, w0, H, W);
}

// The shared memory that stage_wg's wgmma reads, after this thread's
// stores, and the CTA's barrier (the mma.sync stages read with ldmatrix:
// the barrier alone).
template <int C>
__device__ __forceinline__ void stage_barrier() {
  if constexpr (C != 16) fence_async_smem();
  __syncthreads();
}

template <int C, typename InT, typename OutT>
__global__ void __launch_bounds__(Halo<C>::THREADS, Halo<C>::CTAS_PER_SM)
nb1d_q8_halo_kernel(const InT* __restrict__ x, const int8_t* __restrict__ wg,
                    const float* __restrict__ mv,
                    const float* __restrict__ fv, OutT* __restrict__ out,
                    int H, int W, int tiles_h, int tiles_w, int tiles,
                    float inv_in) {
  using G = HCfg<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* Ws = reinterpret_cast<int8_t*>(smem);
  float* Ms = reinterpret_cast<float*>(smem + G::mf_off);
  float* Fs = Ms + 4 * C;
  int8_t* X = reinterpret_cast<int8_t*>(smem + G::x_off);
  int8_t* T1 = reinterpret_cast<int8_t*>(smem + G::t1_off);
  int8_t* T2 = reinterpret_cast<int8_t*>(smem + G::t2_off);
  constexpr int WC = 3 * C * C, CW = G::CW, D = G::D;  // WC: a conv's taps
  for (int v = threadIdx.x; v < 4 * WC / 16; v += G::THREADS)
    cp_async16(Ws + v * 16, wg + v * 16, true);
  cp_async_commit();
  for (int i = threadIdx.x; i < 4 * C; i += G::THREADS) {
    Ms[i] = mv[i];
    Fs[i] = fv[i];
  }
  const long long img_elems = (long long)H * W * C;
  const int per_img = tiles_h * tiles_w;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per_img, r = tile % per_img;
    const int h0 = (r / tiles_w) * G::TH, w0 = (r % tiles_w) * G::TW;
    const InT* xi = x + b * img_elems;
    OutT* oi = out + b * img_elems;
    // x's planes are free: the previous tile's stage 1 is behind barriers
    quantize_window<C, InT>(X, xi, h0, w0, H, W, inv_in);
    cp_async_wait_all();  // the taps (the first tile)
    stage_barrier<C>();   // ... and the previous tile's stage 4 is done
    // t1 (frame rows [1, R0 - 1)): x rows rho - 1 .. rho + 1
    hstage<C, G::M1, 1, CW, 0, G::PX, G::P1, false>(
        X, Ws, Ms, Fs, T1, oi, xi, h0, w0, H, W);
    stage_barrier<C>();
    // t2 (rows [1, R0 - 1)): t1 columns kappa - 1 .. kappa + 1
    hstage<C, G::M1, 1, 1, -1, G::P1, G::P2, false>(
        T1, Ws + WC, Ms + C, Fs + C, T2, oi, xi, h0, w0, H, W);
    stage_barrier<C>();
    // t3 (rows [D + 1, + TH), in t1's planes): t2 rows rho - D .. rho + D
    hstage<C, G::M3, D + 1, D * CW, 0, G::P2, G::P1, false>(
        T2, Ws + 2 * WC, Ms + 2 * C, Fs + 2 * C, T1, oi, xi, h0, w0, H, W);
    stage_barrier<C>();
    // y (rows [D + 1, + TH)): t3 columns kappa - D .. kappa + D, + x
    hstage<C, G::M3, D + 1, D, -D, G::P1, G::P1, true>(
        T1, Ws + 3 * WC, Ms + 3 * C, Fs + 3 * C, nullptr, oi, xi, h0, w0, H,
        W);
  }
  cp_async_wait_all();
}

template <int C, typename InT, typename OutT>
int launch_halo(const void* x, const void* wg, const void* mv, const void* fv,
                void* out, int B, int H, int W, float inv_in,
                cudaStream_t stream) {
  using G = HCfg<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: the persistent grid
  auto kernel = nb1d_q8_halo_kernel<C, InT, OutT>;
  cudaError_t e = allow_smem(kernel, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(kernel, G::THREADS, G::smem, &grid_max)) !=
          cudaSuccess)
    return e;
  const int tiles_h = (H + G::TH - 1) / G::TH;
  const int tiles_w = (W + G::TW - 1) / G::TW;
  // map offsets are 64-bit; the tile index is an int
  if ((long long)B * tiles_h * tiles_w >= (1LL << 31))
    return cudaErrorInvalidValue;
  const int tiles = B * tiles_h * tiles_w;
  if (tiles == 0) return cudaSuccess;
  const int grid = tiles < grid_max ? tiles : grid_max;
  kernel<<<grid, G::THREADS, G::smem, stream>>>(
      static_cast<const InT*>(x), static_cast<const int8_t*>(wg),
      static_cast<const float*>(mv), static_cast<const float*>(fv),
      static_cast<OutT*>(out), H, W, tiles_h, tiles_w, tiles, inv_in);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C = 128: the halo-patch stages on a cooperative grid
// ---------------------------------------------------------------------------

// The stage's tile: BM = 128 tile pixels, warpgroup g the m64 block [64 g,
// 64 g + 64), all C output channels (wgmma m64nCk32: C / 2 accumulators a
// thread).  Two halo patches of up to CAP pixels (24 KB), chunk-major in
// int8 planes of P pixels (P odd), the next tile's patch staged while this
// one multiplies; the stage's (3C x C) tap stack in wgmma's core-matrix
// layout (48 KB), after the patches; m and f (4, C) f32; slack.  One CTA
// an SM.  Not faster (PERF.md, the int8 blocks' entry): two CTAs an SM
// (the variants script's c128_2cta), four warpgroups on two channel
// halves, each warpgroup's halves committed apart (the first half's
// epilogue beside the second's product), the next stage's taps copied in
// across the grid-wide barrier.
template <int C>
struct Patch8 {
  static constexpr int THREADS = 256, CTAS_PER_SM = 1;
  static constexpr int WGS = THREADS / 128, BM = 64 * WGS, VK = C / 16;
  static constexpr int CAP = 192, P = CAP + 1;
  static constexpr size_t patch_bytes = align128((size_t)VK * P * 16);
  static constexpr size_t w_off = 2 * patch_bytes;
  static constexpr size_t mf_off = w_off + (size_t)3 * C * C;
  static constexpr size_t smem = mf_off + (size_t)2 * 4 * C * 4 + BM * 16;
  static_assert(CAP >= BM && (smem + 1024) * CTAS_PER_SM <= 233472,
                "int8 patch tile");
};

template <int C>
Geo q8_geo(int H, int W, int axis, int d) {
  using E = Patch8<C>;
  return patch_geo(H, W, axis, d, E::BM, E::CAP, 1);
}

// Stage 1's patch: tile tl's patch of the block input src (bf16 or f32),
// quantized once into int8 planes (chunk e of patch pixel px at dst + (e P
// + px) 16), code 0 off the map; the positions of stage_patch.
template <int C, typename InT>
__device__ __forceinline__ void quantize_patch(int8_t* dst, const InT* src,
                                               const Geo& g, const Tile& tl,
                                               float inv) {
  using E = Patch8<C>;
  constexpr int U = 4;
  const int n = (tl.ext << g.lg) * E::VK;
  for (int v0 = threadIdx.x; v0 < n; v0 += U * E::THREADS) {
    Vec16<InT> v[U];
    bool ok[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = v0 + k * E::THREADS, e = i % E::VK, px = i / E::VK;
      const int j = px >> g.lg, c = tl.a0 + (px & (g.TA - 1));
      const int p =
          g.band ? tl.s0 + j % g.L + (j / g.L - 1) * g.d : tl.lo + j;
      ok[k] = i < n && p >= 0 && p < g.n && c < g.m;
      if (ok[k]) v[k].load(src + geo_pixel(g, tl.b, p, c) * C + e * 16);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int i = v0 + k * E::THREADS;
      if (i >= n) break;
      const uint4 v4 = ok[k] ? v[k].codes(inv) : zero_vec();
      *reinterpret_cast<uint4*>(dst + ((i % E::VK) * E::P + i / E::VK) * 16) =
          v4;
    }
  }
}

// One stage over this CTA's tiles (t = blockIdx.x, + gridDim.x, ...), S =
// 0 .. 3: conv (taps, g's axis and dilation) of
//   S = 0: the block input x, quantized while its patch is staged;
//   S > 0: the code map src (written earlier in the launch: cp.async.cg);
// into
//   S < 3: the codes of the next stage, into the int8 map q;
//   S = 3: relu(acc m + f + x) into out, x loaded before the product.
// mf: m, then f, (C,) each, in shared memory.
template <int C, int S, typename InT, typename OutT>
__device__ __forceinline__ void pstage(unsigned char* smem, const InT* x,
                                       const int8_t* src, const int8_t* taps,
                                       const float* mf, int8_t* q,
                                       OutT* out, const Geo g, int B,
                                       float inv_in) {
  using E = Patch8<C>;
  constexpr int NG = C / 32;
  const int tiles = B * g.segs * g.ablk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const int q0 = (warp / 4) * 64;  // the warpgroup's m64 block
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + E::w_off);
  const float* mv = mf;
  const float* fv = mf + C;
  auto patch_of = [&](int k) {
    return reinterpret_cast<int8_t*>(smem + (k & 1) * E::patch_bytes);
  };
  auto issue = [&](int k, int t) {
    if (t < tiles) {
      if constexpr (S == 0)
        quantize_patch<C, InT>(patch_of(k), x, g, patch_tile(g, t), inv_in);
      else
        stage_patch<C, E::THREADS, 16, E::P * 16, int8_t>(
            patch_of(k), src, g, patch_tile(g, t));
    }
    cp_async_commit();
  };
  if ((int)blockIdx.x >= tiles) return;  // no tile in this stage
  for (int v = threadIdx.x; v < 3 * C * C / 16; v += E::THREADS)
    cp_async16(Ws + v * 16, taps + v * 16, true);  // with the first patch
  issue(0, blockIdx.x);
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // patch k and the taps are in; tile k - 1 is done
    const int tn = t + (int)gridDim.x;
    if constexpr (S > 0) issue(k + 1, tn);
    const Tile tl = patch_tile(g, t);
    bool ok[2];
    long long pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int i, a;
      ok[h] = tile_pixel(g, tl, q0 + (warp % 4) * 16 + gid + 8 * h, i, a);
      pix[h] = ok[h] ? geo_pixel(g, tl.b, tl.s0 + i, tl.a0 + a) : 0;
    }
    Vec8<InT> res[2][S == 3 ? NG : 1];
    if constexpr (S == 3) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int xg = 0; xg < NG; ++xg) {
          if (ok[h])
            res[h][xg].load(x + pix[h] * C + (4 * xg + tq) * 8);
          else
            res[h][xg].zero();
        }
    }
    const int8_t* pb = patch_of(k);
    int acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0;
    wgmma_fence();
#pragma unroll
    for (int tp = 0; tp < 3; ++tp) {
      const int sh = (g.band ? tp * g.L : tp * g.d) << g.lg;
      const uint64_t da = wgmma_desc(pb + (q0 + sh) * 16, E::P * 16, 128);
      const uint64_t db = wgmma_desc(Ws, C * 16, 128);
#pragma unroll
      for (int ks = 0; ks < C / 32; ++ks) {
        const uint64_t koff_a = (uint64_t)(2 * ks * E::P);
        const uint64_t koff_b = wg_tap_offset_q8<C>(tp, ks) >> 4;
        wgmma_s8(acc, da + koff_a, db + koff_b, ks | tp);
      }
    }
    wgmma_commit();
    // stage 1: the next patch is quantized while the product runs
    if constexpr (S == 0) issue(k + 1, tn);
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (S < 3) {
        // two chunk groups of 64 channels: lane tq stores chunks tq, 4 + tq
#pragma unroll
        for (int s2 = 0; s2 < 2; ++s2) {
          const uint4 v4 = chunk_codes<C>(acc + 32 * s2 + 2 * h, 4,
                                       mv + 64 * s2, fv + 64 * s2, lane);
          if (ok[h])
            *reinterpret_cast<uint4*>(q + pix[h] * C + 16 * (4 * s2 + tq)) =
                v4;
        }
      } else {
#pragma unroll
        for (int xg = 0; xg < NG; ++xg) {
          float p4[4][2], o[8], r[8];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            p4[s][0] = sum_f32<C>(acc[4 * (4 * xg + s) + 2 * h]);
            p4[s][1] = sum_f32<C>(acc[4 * (4 * xg + s) + 2 * h + 1]);
          }
          quad_gather(p4, o, lane);
          const int c0 = (4 * xg + tq) * 8;
          res[h][xg].get(r);
          last_epilogue(o, mv + c0, fv + c0, r);
          if (ok[h]) store8(out + pix[h] * C + c0, o);
        }
      }
    }
  }
  cp_async_wait_all();
}

// A block's four stages:
//   x -> t1 (H, d 1) -> t2 (W, d 1) -> t1 (H, d) -> out (W, d, + x)
// with a grid-wide barrier between two.  wg: (4, 3, C C) int8 taps
// (wg_taps_q8), mv, fv (4, C) f32; geo: the stages' tilings.
template <int C, typename InT, typename OutT>
__global__ void __launch_bounds__(Patch8<C>::THREADS, Patch8<C>::CTAS_PER_SM)
nb1d_q8_block_kernel(const InT* x, const int8_t* __restrict__ wg,
                     const float* __restrict__ mv,
                     const float* __restrict__ fv, int8_t* t1, int8_t* t2,
                     OutT* out, int B, const Geo g0, const Geo g1,
                     const Geo g2, const Geo g3, float inv_in) {
  using E = Patch8<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WC = 3 * C * C;  // a conv's taps
  // m and f of the four stages, [stage][m (C), f (C)]; read after the
  // first stage's first barrier
  float* mf = reinterpret_cast<float*>(smem + E::mf_off);
  for (int i = threadIdx.x; i < 4 * C; i += E::THREADS) {
    mf[(i / C) * 2 * C + i % C] = mv[i];
    mf[(i / C) * 2 * C + C + i % C] = fv[i];
  }
  pstage<C, 0, InT, OutT>(smem, x, nullptr, wg, mf, t1, out, g0, B, inv_in);
  cg::this_grid().sync();
  pstage<C, 1, InT, OutT>(smem, x, t1, wg + WC, mf + 2 * C, t2, out, g1, B,
                          inv_in);
  cg::this_grid().sync();
  pstage<C, 2, InT, OutT>(smem, x, t2, wg + 2 * WC, mf + 4 * C, t1, out, g2,
                          B, inv_in);
  cg::this_grid().sync();
  pstage<C, 3, InT, OutT>(smem, x, t1, wg + 3 * WC, mf + 6 * C, nullptr, out,
                          g3, B, inv_in);
}

template <int C, typename InT, typename OutT>
int launch_block(const void* x, const void* wg, const void* mv,
                 const void* fv, void* t1, void* t2, void* out, int B, int H,
                 int W, int dil, float inv_in, cudaStream_t stream) {
  using E = Patch8<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  auto kernel = nb1d_q8_block_kernel<C, InT, OutT>;
  cudaError_t e = allow_smem(kernel, E::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(kernel, E::THREADS, E::smem, &grid_max)) !=
          cudaSuccess)
    return e;
  if (dil < 1) return cudaErrorInvalidValue;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  Geo g[4] = {q8_geo<C>(H, W, 0, 1), q8_geo<C>(H, W, 1, 1),
              q8_geo<C>(H, W, 0, dil), q8_geo<C>(H, W, 1, dil)};
  long long tiles = 0;
  for (const Geo& q : g) {
    const long long n = (long long)B * q.segs * q.ablk;
    tiles = n > tiles ? n : tiles;
  }
  if (tiles == 0) return cudaSuccess;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles < grid_max ? tiles : grid_max));
  const InT* xp = static_cast<const InT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wg);
  const float* mp = static_cast<const float*>(mv);
  const float* fp = static_cast<const float*>(fv);
  int8_t* t1p = static_cast<int8_t*>(t1);
  int8_t* t2p = static_cast<int8_t*>(t2);
  OutT* op = static_cast<OutT*>(out);
  void* args[] = {&xp,   &wp,   &mp,   &fp,   &t1p, &t2p,   &op,
                  &B,    &g[0], &g[1], &g[2], &g[3], &inv_in};
  // refuses (never hangs) a grid that cannot be resident all at once
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                  dim3(E::THREADS), args, E::smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename InT, typename OutT>
int launch_c(const void* x, const void* wg, const void* mv, const void* fv,
             void* t1, void* t2, void* out, int B, int H, int W, int C,
             int dil, float inv_in, cudaStream_t s) {
  switch (C) {
    case 16:
      if (dil != 1) return cudaErrorInvalidValue;
      return launch_halo<16, InT, OutT>(x, wg, mv, fv, out, B, H, W, inv_in,
                                        s);
    case 64:
      if (dil != 1) return cudaErrorInvalidValue;
      return launch_halo<64, InT, OutT>(x, wg, mv, fv, out, B, H, W, inv_in,
                                        s);
    case 128:
      return launch_block<128, InT, OutT>(x, wg, mv, fv, t1, t2, out, B, H,
                                          W, dil, inv_in, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One block: out = nb1d_q8(x).  x: (B, H, W, C) bf16 (in_f32 = 0) or f32;
// out: the same shape, bf16 (out_f32 = 0) or f32; wg: (4, 3, C C) int8,
// the tap stacks' codes laid out for wgmma (ops/cuda/nb1d_q8.py
// wg_taps_q8); mv, fv: (4, C) f32; inv_in: the input's reciprocal scale.
// C = 64 and 16 (the halo-tile block) take d = 1 only; C = 128 (the
// halo-patch stages) any d and t1, t2: (B, H, W, C) int8 scratch (unused
// at C = 64 and 16).  Anything else returns cudaErrorInvalidValue.
// Returns the launch's error (cudaGetLastError()).
extern "C" int erf_nb1d_q8_block(const void* x, const void* wg,
                                 const void* mv, const void* fv, void* t1,
                                 void* t2, void* out, int B, int H, int W,
                                 int C, int dil, int in_f32, int out_f32,
                                 float inv_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_f32)
    return out_f32 ? launch_c<float, float>(x, wg, mv, fv, t1, t2, out, B, H,
                                            W, C, dil, inv_in, s)
                   : launch_c<float, bf16>(x, wg, mv, fv, t1, t2, out, B, H,
                                           W, C, dil, inv_in, s);
  return out_f32 ? launch_c<bf16, float>(x, wg, mv, fv, t1, t2, out, B, H, W,
                                         C, dil, inv_in, s)
                 : launch_c<bf16, bf16>(x, wg, mv, fv, t1, t2, out, B, H, W,
                                        C, dil, inv_in, s);
}

// One tiling of the C=128 block's stages, as the kernel takes it: (L, TA,
// band, segs, ablk) into geo[0..4] of a conv of dilation d along axis of
// an (H, W) map (the card tests hold it against ops/cuda/nb1d_q8.py
// stage_geometry).
extern "C" int erf_nb1d_q8_geometry(int H, int W, int axis, int d,
                                    int* geo) {
  const Geo g = q8_geo<128>(H, W, axis, d);
  geo[0] = g.L;
  geo[1] = g.TA;
  geo[2] = g.band;
  geo[3] = g.segs;
  geo[4] = g.ablk;
  return 0;
}
