// non_bottleneck_1d inference: one block in one launch.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d.py:_nb1d_stack_kernel (:434,
// reached by pl.pallas_call at :475 through nb1d_stack_infer, :456) and
// :_nb1d_kernel (:140, via nb1d_infer / nb1d_infer_packed).  A block with
// BN folded is
//
//   t1 = relu(conv3x1(x)      + b1)   -> bf16
//   t2 = relu(conv1x3(t1)     + b2)   -> bf16
//   t3 = relu(conv3x1_d(t2)   + b3)   -> bf16
//   y  = relu(conv1x3_d(t3)   + b4 + x) -> bf16
//
// with every conv a sum of three shifted (pixels, C) x (C, C) products, f32
// accumulation, zero fill outside the map (including taps at d >= H or W).
// The rounding points are the TPU kernel's: each stage's output is rounded
// to bf16 before the next conv, the last stage adds the residual in f32.
// Layout: NHWC, C in {16, 64, 128}.
//
// bf16 form (erf_nb1d_block).  The serving path runs it for the dilated
// C=128 run, 8 blocks at (B, 64, 128, 128) (twice H and W at 1024x2048),
// one cooperative launch a block: 4 stages on a persistent grid, a
// grid-wide barrier between two, the stage outputs through two scratch
// maps in device memory (8 MB at B=4, in the 50 MB L2).  (The TPU runs the
// whole run in one call; here the 8 blocks in one launch measured 1-2 %
// faster at 512x1024 and within the spread at 1024x2048, PERF.md PR 20,
// so a launch a block stays.)  Each stage is a halo-patch conv
// (stage16): a tile's patch along the stage's axis, its L positions and d
// on each side (zeros off the map), is copied once with cp.async.cg (the
// stage inputs were written earlier in the launch) into chunk-major planes
// (conv16.cuh stage_patch), so that each tap, a constant shift of the
// patch's pixels, is a wgmma A operand as it stands (8 consecutive pixels
// of a plane are one 128-byte core matrix): the product is bf16 wgmma
// m64nCk16 with both operands in shared memory, A the shifted patch and B
// the conv's tap stack, laid out once by the wrapper in core matrices
// (ops/cuda/nb1d.py wg_taps).  Two warpgroups take the tile's two m64
// blocks with all C output channels; the next tile's patch copies while
// this one multiplies; the epilogue (bias, ReLU, the residual loaded
// before the product, bf16) runs from the accumulator fragments, four n8
// tiles gathered across each quad (quad_gather) so that a lane stores 16
// bytes.  A stage's tap stack (96 KB at C = 128) is copied in after the
// grid-wide barrier, beside the stage's first patch (copied ahead of the
// barrier, during the stage before, it measured slower: PERF.md PR 20).
//
// Bound on this card: the C=128 and C=64 blocks are operation-bound (12 C^2
// MACs per pixel against 4 C bytes moved), the C=16 blocks byte-bound; the
// C=128 run a B=4 512x1024 forward 0.104 ms at 989 TFLOP/s.  What is left
// (scripts/cuda_nb1d_bf16_variants.py): each stage's frame (its barrier,
// its first patch, the epilogue, a tap stack a stage) against two tiles a
// CTA at 512x1024.
//
// The f32 form (the JAX package's default compute dtype; the eval CLIs
// without --bf16) serves all 17 blocks of the net, every (C, d) and every
// map up to the 1024x2048 frames' (C=16 at (B, 512, 1024, 16)): the same
// four stages in one cooperative launch, f32 maps, the f32 fold of the
// weights, f32 biases, f32 scratch maps (sized per call by the wrapper),
// no rounding but f32's own.  Each stage is the f32 train pair's
// halo-patch conv (conv32.cuh): a tile's patch along the stage's axis is
// staged once with 16-byte cp.async (cp.async.cg: the stage inputs were
// written earlier in the launch) into swizzled f32 rows with a zero pixel
// after it, the three taps are shifted views, and persistent CTAs walk
// their tiles with the next patch in flight; each stage loads its own tap
// stack.  At C = 64 and 128 the product is 3xTF32 in wgmma (tc_tiles): a
// = a_hi + a_lo and w = w_hi + w_lo, each half TF32, and out = a_hi w_hi +
// a_hi w_lo + a_lo w_hi in f32; the patch's halves are split in registers
// (cvt.rna), the tap stack's are made once by the wrapper (ops/cuda/
// nb1d.py tc_taps) and read from shared memory (at C = 128 the output
// channels split over two CTAs, the halves streamed).  It meets the f32
// limits of chip_smoke.py phase 20 with margin (at most 4.5e-8
// norm-relative, PERF.md §6).  At C = 16, where a tap is two k8
// steps, the FFMA micro-tile of the pair's convs (conv32_tiles) is faster.
// Bound at f32: operations at every C (12 C^2 MACs per pixel against 67
// TFLOP/s f32; the three TF32 products against 494.7 TFLOP/s take 0.41 of
// that).  What is left: the stage's frame (copies, stores, the start of
// each stage after the grid-wide barrier) takes about half the time
// (scripts/cuda_nb1d_f32_variants.py no_product); a producer warp and
// the next stage's weights fetched during the barrier are untried.

#include <cooperative_groups.h>

#include "conv16.cuh"

using namespace erfk;
namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// bf16 form: each stage a halo-patch conv with a bf16 wgmma product, the
// four stages of a block in one cooperative launch
// ---------------------------------------------------------------------------

// The stage's tile: BM = 128 tile pixels, warpgroup g the m64 block [64 g,
// 64 g + 64), all C output channels (wgmma m64nCk16: C / 2 accumulators a
// thread).  Two halo patches of up to CAP pixels (48 KB), chunk-major in
// planes of P pixels (P odd: the 16-byte copies of one pixel's chunks fall
// on distinct bank groups), the next tile's patch copying while this one
// multiplies; the stage's (3C x C) tap stack in wgmma's core-matrix layout
// (96 KB at C = 128), one copy a CTA, after the patches (a read past a
// patch's last plane, by the rows past a ragged tile, stays in the
// allocation: those rows are never stored).  197 KB at C = 128: one CTA
// an SM.  The H conv's tiles take at least TA_MIN pixels across (C = 16:
// 128-byte runs).
template <int C>
struct Eval16 {
  static constexpr int THREADS = 256, WGS = THREADS / 128, BM = 64 * WGS;
  static constexpr int NA = C / 2, VK = C / 8;
  static constexpr int CAP = 24576 / C, P = CAP + 1;
  static constexpr int TA_MIN = C == 16 ? 4 : 1;
  static constexpr size_t patch_bytes = align128((size_t)VK * P * 16);
  static constexpr size_t w_off = 2 * patch_bytes;
  static constexpr size_t smem = w_off + (size_t)3 * C * C * 2 + BM * 16;
  static_assert(CAP >= BM && C % 16 == 0 && smem <= 232448, "bf16 nb1d tile");
};

// A stage's tiling (conv16.cuh patch_geo): tiles of at most BM pixels
// whose patch holds at most CAP pixels, at least TA_MIN across along H.
template <int C>
Geo eval16_geo(int H, int W, int axis, int d) {
  using E = Eval16<C>;
  return patch_geo(H, W, axis, d, E::BM, E::CAP, axis == 0 ? E::TA_MIN : 1);
}

// Start copying a conv's (3C x C) tap stack, laid out for wgmma
// (ops/cuda/nb1d.py wg_taps), into shared memory.
template <int C, int THREADS>
__device__ __forceinline__ void load_taps(bf16* dst, const bf16* src) {
  for (int v = threadIdx.x; v < 3 * C * C / 8; v += THREADS)
    cp_async16(dst + v * 8, src + v * 8, true);
}

// One stage over this CTA's tiles (t = blockIdx.x, + gridDim.x, ...):
//   out = bf16(relu(conv3tap(src; the taps, g's axis and dilation) + bias
//                   [+ res]))
// taps: this stage's tap stack, copied in beside the first patch.  src
// was written earlier in the launch (but for the block's input): the
// patches come through L2 (cp.async.cg), res by __ldcg, loaded before the
// product, which hides its latency.  Every lane's rows store 16 bytes (C
// >= 64: the accumulators of four n8 tiles gathered across the quad,
// quad_gather) or 4 (C = 16).
template <int C, bool RES>
__device__ __forceinline__ void stage16(unsigned char* smem, const bf16* src,
                                        const bf16* res, const float* bias,
                                        bf16* out, const Geo g, int B,
                                        const bf16* taps) {
  using E = Eval16<C>;
  constexpr int NA = E::NA, NG = C >= 64 ? C / 32 : C / 8;
  const int tiles = B * g.segs * g.ablk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const int q0 = (warp / 4) * 64;  // the warpgroup's m64 block
  bf16* Ws = reinterpret_cast<bf16*>(smem + E::w_off);
  auto patch_of = [&](int k) {
    return reinterpret_cast<bf16*>(smem + (k & 1) * E::patch_bytes);
  };
  auto issue = [&](int k, int t) {
    if (t < tiles)
      stage_patch<C, E::THREADS, 8, E::P * 8>(patch_of(k), src, g,
                                             patch_tile(g, t));
    cp_async_commit();
  };
  if ((int)blockIdx.x >= tiles) return;  // no tile in this stage
  load_taps<C, E::THREADS>(Ws, taps);  // committed with the first patch
  issue(0, blockIdx.x);
  int k = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();  // patch k and the taps are in; tile k - 1 is done
    issue(k + 1, t + (int)gridDim.x);
    const Tile tl = patch_tile(g, t);
    int q[2];
    bool ok[2];
    long long pix[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int i, a;
      q[h] = q0 + (warp % 4) * 16 + gid + 8 * h;
      ok[h] = tile_pixel(g, tl, q[h], i, a);
      pix[h] = ok[h] ? geo_pixel(g, tl.b, tl.s0 + i, tl.a0 + a) : 0;
    }
    // the residual at this lane's channels, before the product
    uint4 rv[2][C >= 64 ? NG : 1];
    unsigned rw[2][C >= 64 ? 1 : NG];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < NG; ++x) {
        if constexpr (C >= 64) {
          rv[h][x] = RES && ok[h]
                         ? __ldcg(reinterpret_cast<const uint4*>(
                               res + pix[h] * C + (4 * x + tq) * 8))
                         : zero_vec();
        } else {
          rw[h][x] = RES && ok[h]
                         ? __ldcg(reinterpret_cast<const unsigned*>(
                               res + pix[h] * C + 8 * x + 2 * tq))
                         : 0u;
        }
      }
    const bf16* pb = patch_of(k);
    float acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int tp = 0; tp < 3; ++tp) {
      const int sh = (g.band ? tp * g.L : tp * g.d) << g.lg;
      const uint64_t da = wgmma_desc(pb + (q0 + sh) * 8, E::P * 16, 128);
      const uint64_t db = wgmma_desc(Ws, C * 16, 128);
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        const uint64_t koff_a = (uint64_t)(2 * ks * E::P);
        const uint64_t koff_b = wg_tap_offset<C>(tp, ks) >> 4;
        wgmma_bf16(acc, da + koff_a, db + koff_b, ks | tp);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (C >= 64) {
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          float p4[4][2], o[8];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            p4[s][0] = acc[4 * (4 * x + s) + 2 * h];
            p4[s][1] = acc[4 * (4 * x + s) + 2 * h + 1];
          }
          quad_gather(p4, o, lane);
          const int c0 = (4 * x + tq) * 8;
          float r[8];
          unpack_bf16x8(rv[h][x], r);
#pragma unroll
          for (int c = 0; c < 8; ++c)
            o[c] = fmaxf(o[c] + __ldg(bias + c0 + c) + (RES ? r[c] : 0.0f),
                         0.0f);
          const uint4 v8 = pack_bf16x8(o);
          if (ok[h])
            *reinterpret_cast<uint4*>(out + pix[h] * C + c0) = v8;
        }
      } else {
#pragma unroll
        for (int x = 0; x < NG; ++x) {
          const int c = 8 * x + 2 * tq;
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rw[h][x]));
          const float o0 = fmaxf(acc[4 * x + 2 * h] + __ldg(bias + c) +
                                     (RES ? r.x : 0.0f), 0.0f);
          const float o1 = fmaxf(acc[4 * x + 2 * h + 1] +
                                     __ldg(bias + c + 1) + (RES ? r.y : 0.0f),
                                 0.0f);
          if (ok[h])
            *reinterpret_cast<__nv_bfloat162*>(out + pix[h] * C + c) =
                __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
  cp_async_wait_all();
}

// A block's four stages:
//   x -> t1 (H, d 1) -> t2 (W, d 1) -> t1 (H, d) -> out (W, d, + x)
// with a grid-wide barrier between two.  wg: (4, 3, C C) taps (wg_taps),
// bias (4, C) f32; geo: the stages' tilings (conv32.cuh Geo).
template <int C>
__global__ void __launch_bounds__(256, 1)
nb1d_block_kernel(const bf16* x, const bf16* __restrict__ wg,
                  const float* __restrict__ bias, bf16* t1, bf16* t2,
                  bf16* out, int B, const Geo g0, const Geo g1, const Geo g2,
                  const Geo g3) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WC = 3 * C * C;  // a conv's taps
  stage16<C, false>(smem, x, nullptr, bias, t1, g0, B, wg);
  cg::this_grid().sync();
  stage16<C, false>(smem, t1, nullptr, bias + C, t2, g1, B, wg + WC);
  cg::this_grid().sync();
  stage16<C, false>(smem, t2, nullptr, bias + 2 * C, t1, g2, B, wg + 2 * WC);
  cg::this_grid().sync();
  stage16<C, true>(smem, t1, x, bias + 3 * C, out, g3, B, wg + 3 * WC);
}

template <int C>
int launch_block(const void* x, const void* wg, const void* bias, void* t1,
                 void* t2, void* out, int B, int H, int W, int dil,
                 cudaStream_t stream) {
  using E = Eval16<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  cudaError_t e = allow_smem(nb1d_block_kernel<C>, E::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_block_kernel<C>, E::THREADS, E::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  if (dil < 1) return cudaErrorInvalidValue;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  Geo g[4] = {eval16_geo<C>(H, W, 0, 1), eval16_geo<C>(H, W, 1, 1),
              eval16_geo<C>(H, W, 0, dil), eval16_geo<C>(H, W, 1, dil)};
  long long tiles = 0;
  for (const Geo& q : g) {
    const long long n = (long long)B * q.segs * q.ablk;
    tiles = n > tiles ? n : tiles;
  }
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(tiles < grid_max ? tiles : grid_max));
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wg);
  const float* bp = static_cast<const float*>(bias);
  bf16* t1p = static_cast<bf16*>(t1);
  bf16* t2p = static_cast<bf16*>(t2);
  bf16* op = static_cast<bf16*>(out);
  void* args[] = {&xp, &wp, &bp, &t1p, &t2p, &op, &B,
                  &g[0], &g[1], &g[2], &g[3]};
  // refuses (never hangs) a grid that cannot be resident all at once
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nb1d_block_kernel<C>), grid,
      dim3(E::THREADS), args, E::smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 form: the four stages as halo-patch convs (conv32.cuh) in one
// cooperative launch
// ---------------------------------------------------------------------------

// The f32 stages' product at C: true, 3xTF32 in wgmma (tc_tiles); false,
// the FFMA micro-tile of the f32 pair convs (conv32_tiles).  At C = 16 (K
// = 48, N = 16) a tap's wgmma chain is two k8 steps and FFMA is faster
// (scripts/cuda_nb1d_f32_variants.py).
template <int C>
__host__ __device__ constexpr bool tf32x3() {
  return C != 16;
}

// Stage 4 of the FFMA form: out = relu(acc + b + x), x (the block's input)
// loaded before the product (stages 1-3: conv32.cuh EpiReluBias32).
template <int C>
struct EpiResRelu32 {
  static constexpr bool SUMS = false, PER_IMAGE = false;
  static constexpr int NAUX = 1;
  const float* bias;
  const float* x;
  float* out;
  __device__ const float* aux(int) const { return x; }
  __device__ void operator()(long long m, int, int c0, float (&v)[4], float*,
                             float*, const float*,
                             const float4 (&av)[1]) const {
    const float r[4] = {av[0].x, av[0].y, av[0].z, av[0].w};
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = fmaxf(v[k] + __ldg(bias + c0 + k) + r[k], 0.0f);
    st4(out + m * C + c0, o);
  }
};

// The 3xTF32 conv's tile: Conv32's tiling and patches (the same Geo: BM
// and CAP are Conv32's) and its ring, the product in wgmma.  A CTA (two
// warpgroups) computes the N = C / NSPLIT output channels of its split
// (blockIdx.y); warpgroup g the tile pixels [g MB 64, (g + 1) MB 64) in MB
// m64 blocks.  The weights are STAGES stages of KS k rows x N columns (SPT
// a tap) as TF32 hi then lo (ops/cuda/nb1d.py tc_taps: the wrapper's copy
// of the tap stack, split and laid out once), each image in core matrices
// (k4, n8) at (k4 N / 8 + n8) 128 bytes, row n of a core matrix its 4
// consecutive k; resident where NS == STAGES.  Per k8 step a lane's A
// fragments (4 floats of its two pixel rows of each m64 block, the
// swizzled patch chunks 2 k8 and 2 k8 + 1) are split into TF32 hi and lo
// in registers (NSET register sets: NSET - 1 steps' wgmma in flight while
// the next is split), and each m64 block takes three products:
//   sm += a_lo w_hi;  sm += a_hi w_lo;  big (+)= a_hi w_hi
// with big a chain over the stage from zero, added to acc on the CUDA
// cores (rounded to nearest) when the stage ends; out = acc + sm.  The
// tensor cores' f32 sums truncate: the small products' chain (2^-11 of
// the sum) loses nothing that shows, and a stage's chain of KS / 8 steps
// stays within 7e-8 of the f32 plain version
// (scripts/cuda_nb1d_f32_variants.py).
// * C = 64: warpgroups of one m64 block x 64 channels over 128-pixel
//   tiles, the 96 KB split stack resident beside two 34 KB patches.
// * C = 128: the output channels split over two CTAs, each 64 channels,
//   its 192 KB share streamed half a tap (32 KB) a stage through a
//   3-stage ring beside two 64 KB patches (faster than four splits of 32
//   channels with 96 KB resident: the variants script's c128_split4).
// * C = 16 (the variants script's tf32_c16; FFMA ships there): 512-pixel
//   tiles, warpgroups of four m64 blocks x 16 channels, the 6 KB stack
//   resident.
template <int C>
struct Tc32 {
  using K = Conv32<C>;
  static constexpr int THREADS = 256, WGS = THREADS / 128;
  static constexpr int NSPLIT = C == 128 ? 2 : 1, N = C / NSPLIT;
  static constexpr int KS = C == 128 ? 64 : C, NS = 3;  // k rows a stage
  static constexpr int BM = K::BM, CAP = K::CAP, VK = C / 4;
  static constexpr int MB = BM / (64 * WGS), NA = N / 2;  // NA: d floats
  static constexpr int SPT = C / KS, STAGES = 3 * SPT, KSTEPS = KS / 8;
  // A register sets: NSET - 1 k8 steps' wgmma in flight while the next
  // step's fragments are split (four sets, three in flight, took more
  // registers and more time: the variants script's four_sets)
  static constexpr int NSET = 2;
  static constexpr size_t patch_bytes = K::patch_bytes;
  static constexpr size_t stage_bytes = align128((size_t)2 * KS * N * 4);
  static constexpr size_t ring_off = 2 * patch_bytes;
  static constexpr size_t smem = ring_off + NS * stage_bytes;
  static_assert(BM % (64 * WGS) == 0 && N % 16 == 0 && N <= 64 &&
                    KS % 16 == 0 && NS <= STAGES && smem <= 232448,
                "3xTF32 nb1d tile");
};

// The 3xTF32 form's epilogue, on channels c, c + 1 of map pixel m:
// relu(v + b [+ x]), x loaded before the product.
template <int C, bool RES>
struct EpiTc32 {
  const float* bias;
  const float* x;
  float* out;
  __device__ void operator()(long long m, int c, float v0, float v1,
                             float2 r) const {
    float o0 = v0 + __ldg(bias + c), o1 = v1 + __ldg(bias + c + 1);
    if constexpr (RES) {
      o0 += r.x;
      o1 += r.y;
    }
    *reinterpret_cast<float2*>(out + m * C + c) =
        make_float2(fmaxf(o0, 0.0f), fmaxf(o1, 0.0f));
  }
};

// One 3xTF32 conv over this CTA's tiles (conv32_tiles' walk and copies):
// epi on every map pixel of the tile and each pair of channels a lane
// holds.  wt: this conv's tc_taps image.
template <int C, bool RES>
__device__ __forceinline__ void tc_tiles(unsigned char* smem,
                                         const float* src, const float* wt,
                                         const Geo g, int B,
                                         const EpiTc32<C, RES>& epi) {
  using T = Tc32<C>;
  using Ring = PFRing<T::STAGES, T::NS>;
  constexpr int MB = T::MB, NA = T::NA, N = T::N, VK = T::VK;
  const int tiles = B * g.segs * g.ablk;
  const int split = blockIdx.y, lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32, gid = lane >> 2, tig = lane & 3;
  // this lane's first row of each m64 block, its first channel
  const int row0 = (warp / 4) * MB * 64 + (warp % 4) * 16 + gid;
  const int c0 = split * N + 2 * tig;
  auto patch_of = [&](int kk) {
    return reinterpret_cast<float*>(smem + (kk & 1) * T::patch_bytes);
  };
  auto stage_of = [&](int r) {
    return reinterpret_cast<float*>(smem + T::ring_off + r * T::stage_bytes);
  };
  for (int v = threadIdx.x; v < 2 * VK; v += T::THREADS)  // the zero pixels
    reinterpret_cast<float4*>(patch_of(v / VK) + T::CAP * C)[v % VK] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto patch = [&](int kk) {
    stage_patch32<C, T::THREADS, true>(
        patch_of(kk), src, g, tile_at(g, blockIdx.x + kk * (int)gridDim.x));
  };
  // stage s: k rows (s % SPT) KS .. + KS of tap s / SPT, hi then lo
  auto stage = [&](int r, int s) {
    float* dst = stage_of(r);
    const float* from = wt + ((size_t)split * 3 + s / T::SPT) * 2 * C * N +
                        (size_t)(s % T::SPT) * T::KS * N;
    for (int c = threadIdx.x; c < 2 * T::KS * N / 4; c += T::THREADS) {
      const int h = c / (T::KS * N / 4), j = c % (T::KS * N / 4);
      cp_async16(dst + h * T::KS * N + 4 * j,
                 from + (size_t)h * C * N + 4 * j, true);
    }
  };

  Ring::start(tiles, patch, stage);
  int kk = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++kk) {
    const Tile tl = tile_at(g, t);
    const Taps tv = taps_of(g, tl);
    int q[MB][2], along[MB][2];
    bool ok[MB][2];
    long long pix[MB][2];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int a;
        q[mb][h] = row0 + mb * 64 + 8 * h;
        ok[mb][h] = tile_pixel(g, tl, q[mb][h], along[mb][h], a);
        pix[mb][h] = ok[mb][h] ? geo_pixel(g, tl.b, tl.s0 + along[mb][h],
                                           tl.a0 + a)
                               : 0;
      }
    // stage 4's x, loaded before the product
    float2 res[MB][2][N / 8];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          res[mb][h][j] = RES && ok[mb][h]
                              ? __ldg(reinterpret_cast<const float2*>(
                                    epi.x + pix[mb][h] * C + c0 + 8 * j))
                              : make_float2(0.0f, 0.0f);
    const float* pb = patch_of(kk);
    float acc[MB][NA], sm[MB][NA], big[MB][NA];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[mb][i] = sm[mb][i] = 0.0f;
#pragma unroll 1
    for (int s = 0; s < T::STAGES; ++s) {
      const float* bs = stage_of(Ring::next(kk, s, tiles, patch, stage));
      if (!Ring::RESIDENT || kk == 0) {  // the stage landed: wgmma reads it
        fence_async_smem();
        __syncthreads();
      }
      const int tp = s / T::SPT, e0 = (s % T::SPT) * T::KS / 4;
      int aoff[MB][2], aswz[MB][2];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ok[mb][h] && along[mb][h] >= tv.lo[tp] &&
                                along[mb][h] < tv.hi[tp]
                            ? q[mb][h] + tv.shift[tp]
                            : T::CAP;
          aoff[mb][h] = r * C + tig;
          aswz[mb][h] = f32_swz(r, VK);
        }
      // k8 step ks of the stage: B core matrices (2 ks, n8) at ks N 32
      // bytes; K-adjacent ones N 16 bytes apart, N-adjacent 128
      const uint64_t dhi = wgmma_desc(bs, N * 16, 128);
      const uint64_t dlo = wgmma_desc(bs + T::KS * N, N * 16, 128);
      // step ks with A in (ah, al); (ph, pl): step ks - NSET + 1's set,
      // free once this step's wait leaves NSET - 1 groups in flight
      auto step = [&](int ks, uint32_t (&ah)[MB][4], uint32_t (&al)[MB][4],
                      uint32_t (&ph)[MB][4], uint32_t (&pl)[MB][4]) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i & 1, e = e0 + 2 * ks + (i >> 1);
            split_tf32(pb[aoff[mb][h] + 4 * (e ^ aswz[mb][h])], ah[mb][i],
                       al[mb][i]);
          }
        wgmma_fence();
        const uint64_t koff = (uint64_t)((ks * N * 32) >> 4);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          wgmma_tf32(sm[mb], al[mb], dhi + koff, 1);
          wgmma_tf32(sm[mb], ah[mb], dlo + koff, 1);
          wgmma_tf32(big[mb], ah[mb], dhi + koff, ks > 0);
        }
        wgmma_commit();
        wgmma_wait<T::NSET - 1>();
        reg_fence(ph);
        reg_fence(pl);
      };
      uint32_t ah[T::NSET][MB][4] = {}, al[T::NSET][MB][4] = {};
#pragma unroll 1
      for (int ks = 0; ks < T::KSTEPS; ks += T::NSET) {
#pragma unroll
        for (int u = 0; u < T::NSET; ++u)
          step(ks + u, ah[u], al[u], ah[(u + 1) % T::NSET],
               al[(u + 1) % T::NSET]);
      }
      // the stage's products done (before acc reads big, before the ring
      // refills a streamed stage's buffer)
      wgmma_wait<0>();
#pragma unroll
      for (int u = 0; u < T::NSET; ++u) {
        reg_fence(ah[u]);
        reg_fence(al[u]);
      }
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        reg_fence(sm[mb]);
        reg_fence(big[mb]);
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[mb][i] += big[mb][i];
      }
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[mb][h]) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          epi(pix[mb][h], c0 + 8 * j,
              acc[mb][4 * j + 2 * h] + sm[mb][4 * j + 2 * h],
              acc[mb][4 * j + 2 * h + 1] + sm[mb][4 * j + 2 * h + 1],
              res[mb][h][j]);
      }
  }
  cp_async_wait_all();
}

// The form's launch shape: the shipped product's splits, shared memory
// and CTAs an SM (registers: one CTA an SM but for the FFMA form at C =
// 16, as the f32 pair's convs).
template <int C>
struct Eval32 {
  static constexpr int THREADS = 256;
  static constexpr bool TC = tf32x3<C>();
  static constexpr int NSPLIT = TC ? Tc32<C>::NSPLIT : Conv32<C>::NSPLIT;
  static constexpr int MINB = !TC && C == 16 ? 2 : 1;
  static constexpr size_t smem = TC ? Tc32<C>::smem : Conv32<C>::smem;
  static_assert(Tc32<C>::BM == Conv32<C>::BM, "one tiling for both forms");
};

// One stage: out = relu(conv3tap(src; the conv's taps, g's axis and
// dilation) + bias [+ x]), the taps w (FFMA) or its tc_taps image wt
// (3xTF32).  src was written earlier in the launch (stages 2-4): the
// patches are read through L2 (cp.async.cg); x, the launch's input, by
// __ldg.
template <int C, bool RES>
__device__ __forceinline__ void eval_stage32(unsigned char* smem,
                                             const float* src, const float* w,
                                             const float* wt,
                                             const float* bias,
                                             const float* x, float* out,
                                             const Geo& g, int B) {
  if constexpr (tf32x3<C>())
    tc_tiles<C, RES>(smem, src, wt, g, B, EpiTc32<C, RES>{bias, x, out});
  else if constexpr (RES)
    conv32_tiles<C>(smem, src, w, g, B, EpiResRelu32<C>{bias, x, out},
                    nullptr);
  else
    conv32_tiles<C>(smem, src, w, g, B, EpiReluBias32<C>{bias, out},
                    nullptr);
}

// Stages first .. last of the block (0: x -> t1 along H, 1: t1 -> t2 along
// W, 2: t2 -> t1 along H at the dilation, 3: t1 (+ x) -> out along W), a
// grid-wide barrier between two (the launcher runs all four, cooperative).
template <int C>
__global__ void __launch_bounds__(256, Eval32<C>::MINB)
nb1d_block_f32_kernel(const float* x, const float* __restrict__ w,
                      const float* __restrict__ wt,
                      const float* __restrict__ b, float* t1, float* t2,
                      float* out, Geo g1, Geo g2, Geo g3, Geo g4, int B,
                      int first, int last) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WS = 3 * C * C, WTS = 6 * C * C;  // a conv's w, wt
  for (int s = first; s <= last; ++s) {
    if (s > first) cg::this_grid().sync();
    if (s == 0)
      eval_stage32<C, false>(smem, x, w, wt, b, nullptr, t1, g1, B);
    else if (s == 1)
      eval_stage32<C, false>(smem, t1, w + WS, wt + WTS, b + C, nullptr, t2,
                             g2, B);
    else if (s == 2)
      eval_stage32<C, false>(smem, t2, w + 2 * WS, wt + 2 * WTS, b + 2 * C,
                             nullptr, t1, g3, B);
    else
      eval_stage32<C, true>(smem, t1, w + 3 * WS, wt + 3 * WTS, b + 3 * C,
                            x, out, g4, B);
  }
}

// A stage's tiling: conv32_geo's, except where a tile spanning BM
// positions along the axis cannot hold its halo in the patch (the C = 128
// W convs of the 1024x2048 frames' 128 x 256 maps): there tiles of CAP -
// 2 d positions, whose halo fits, in place of three bands of CAP / 3.
// (The f32 pair keeps conv32_geo: its maps are the 512x1024 step's.)
template <int C>
Geo eval_geo(int H, int W, int axis, int d) {
  using K = Conv32<C>;
  const Geo g = conv32_geo<C>(H, W, axis, d);
  const int fit = K::CAP - 2 * g.d;
  if (!g.band || fit <= g.L) return g;
  return make_geo(H, W, axis, d, fit, K::CAP, axis == 0 ? K::TA_MIN : 1);
}

template <int C>
int launch_f32(const void* x, const void* w, const void* wt,
               const void* bias, void* t1, void* t2, void* out, int B, int H,
               int W, int dil, cudaStream_t stream) {
  using E = Eval32<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  cudaError_t e = allow_smem(nb1d_block_f32_kernel<C>, E::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_block_f32_kernel<C>, E::THREADS, E::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  if (grid_max < E::NSPLIT) return cudaErrorInvalidConfiguration;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  Geo g[4] = {eval_geo<C>(H, W, 0, 1), eval_geo<C>(H, W, 1, 1),
              eval_geo<C>(H, W, 0, dil), eval_geo<C>(H, W, 1, dil)};
  int tiles = 0;
  for (const Geo& q : g)
    tiles = B * q.segs * q.ablk > tiles ? B * q.segs * q.ablk : tiles;
  const int gx = grid_max / E::NSPLIT;
  const dim3 grid((unsigned)(tiles < gx ? tiles : gx), E::NSPLIT);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* wtp = static_cast<const float*>(wt);
  const float* bp = static_cast<const float*>(bias);
  float* t1p = static_cast<float*>(t1);
  float* t2p = static_cast<float*>(t2);
  float* op = static_cast<float*>(out);
  int first = 0, last = 3;
  void* args[] = {&xp,   &wp,   &wtp,  &bp, &t1p,   &t2p, &op,
                  &g[0], &g[1], &g[2], &g[3], &B, &first, &last};
  // refuses (never hangs) a grid that cannot be resident all at once
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nb1d_block_f32_kernel<C>), grid,
      dim3(E::THREADS), args, E::smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// One block: out = nb1d(x).  x, out: (B, H, W, C) bf16; wg: (4, 3, C C)
// bf16, the four tap stacks laid out for wgmma (ops/cuda/nb1d.py
// wg_taps); bias: (4, C) f32; t1, t2: (B, H, W, C) bf16 scratch.  Returns
// the launch's error (cudaGetLastError()).
extern "C" int erf_nb1d_block(const void* x, const void* wg, const void* bias,
                              void* t1, void* t2, void* out, int B, int H,
                              int W, int C, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return launch_block<16>(x, wg, bias, t1, t2, out, B, H, W, dil, s);
    case 64:
      return launch_block<64>(x, wg, bias, t1, t2, out, B, H, W, dil, s);
    case 128:
      return launch_block<128>(x, wg, bias, t1, t2, out, B, H, W, dil, s);
    default: return cudaErrorInvalidValue;
  }
}

// One tiling of the bf16 form, as the kernel takes it: (L, TA, band, segs,
// ablk) into geo[0..4] of a conv of dilation d along axis of an (H, W)
// map with C channels (the CPU tests hold the decomposition with it).
extern "C" int erf_nb1d_geometry(int H, int W, int C, int axis, int d,
                                 int* geo) {
  Geo g;
  switch (C) {
    case 16: g = eval16_geo<16>(H, W, axis, d); break;
    case 64: g = eval16_geo<64>(H, W, axis, d); break;
    case 128: g = eval16_geo<128>(H, W, axis, d); break;
    default: return cudaErrorInvalidValue;
  }
  geo[0] = g.L;
  geo[1] = g.TA;
  geo[2] = g.band;
  geo[3] = g.segs;
  geo[4] = g.ablk;
  return 0;
}

// The f32 form: x, out, t1, t2 (B, H, W, C) f32; w (4, 3, C, C) f32;
// wt (4, erf_nb1d_f32_splits(C), 3, 2, C C / splits) f32, w's TF32 hi and
// lo images (ops/cuda/nb1d.py tc_taps); bias (4, C) f32.
extern "C" int erf_nb1d_block_f32(const void* x, const void* w,
                                  const void* wt, const void* bias, void* t1,
                                  void* t2, void* out, int B, int H, int W,
                                  int C, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16:
      return launch_f32<16>(x, w, wt, bias, t1, t2, out, B, H, W, dil, s);
    case 64:
      return launch_f32<64>(x, w, wt, bias, t1, t2, out, B, H, W, dil, s);
    case 128:
      return launch_f32<128>(x, w, wt, bias, t1, t2, out, B, H, W, dil, s);
    default: return cudaErrorInvalidValue;
  }
}

// The output-channel splits of the f32 form's wt layout at C (0 for a C it
// does not take).
extern "C" int erf_nb1d_f32_splits(int C) {
  switch (C) {
    case 16: return Tc32<16>::NSPLIT;
    case 64: return Tc32<64>::NSPLIT;
    case 128: return Tc32<128>::NSPLIT;
    default: return 0;
  }
}
