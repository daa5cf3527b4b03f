// non_bottleneck_1d inference: one launch per block.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d.py:_nb1d_kernel (via
// nb1d_infer / nb1d_infer_packed) and :_nb1d_stack_kernel (via
// nb1d_stack_infer).  A block with BN folded is
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
//
// Layout: NHWC, C in {16, 64, 128}, no W-packing (a TPU lane device).  A
// stage is an implicit GEMM over tiles of consecutive pixels x all C
// channels (K = 3C): the three tap rows of each pixel are gathered into
// shared memory with cp.async, the (3C x C) tap stack sits beside them,
// eight warps multiply with ldmatrix + mma.sync.
//
// The TPU kernel keeps the whole map in VMEM across the four stages; a
// CTA's shared memory holds a few rows at most, and the dilated stages
// reach 16 rows away.  So the four stages run in one cooperative launch:
// a persistent grid (as many CTAs as can be resident) walks the tiles of a
// stage, then waits at a grid-wide barrier before the next stage reads
// what the previous one wrote.  Stage outputs go through two scratch maps
// in device memory; at serving sizes a map (8 MB at B=4) stays in the 50 MB
// L2.  Each CTA stages a stage's tap stack once, not once per tile.
//
// Bound on this card: the C=128 and C=64 blocks are operation-bound (12 C^2
// MACs per pixel against 4 C bytes moved), the C=16 blocks byte-bound.
// This version gathers every input pixel three times (once per tap) and
// reaches about a tenth of either bound; a band of rows staged once per
// tile, wgmma with TMA-fed tiles, and the next stage's weights fetched
// during the grid-wide barrier are the next steps.
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

#include "conv32.cuh"

using namespace erfk;
namespace cg = cooperative_groups;

namespace {

// BM pixels per tile; the 8 warps split the tile into WM-row x WN-column
// blocks.  C = 16 takes bigger tiles: its products are small, so per-tile
// costs would dominate.  NBUF A buffers: with two, the next tile's gather
// is in flight while this one is multiplied; C = 64 keeps one, which lets
// four CTAs share an SM instead of two (measured faster).
template <int C>
struct Cfg {
  static constexpr int THREADS = 256, BM = C == 16 ? 256 : 64;
  static constexpr int NBUF = C == 64 ? 1 : 2;
  static constexpr int WCOLS = C == 16 ? 1 : 2;  // warps across the columns
  static constexpr int WN = C / WCOLS, WM = BM * WCOLS / (THREADS / 32);
  static constexpr int K = 3 * C, LDA = K + 8, LDB = C + 8, LDC = C + 4;
  static constexpr size_t a_raw = (size_t)BM * LDA * 2 > (size_t)BM * LDC * 4
                                      ? (size_t)BM * LDA * 2
                                      : (size_t)BM * LDC * 4;
  static constexpr size_t a_bytes = (a_raw + 127) / 128 * 128;
  static constexpr size_t smem = NBUF * a_bytes + (size_t)K * LDB * 2;
};

// Start copying the A tile of pixels [m0, m0 + BM): row r holds the three
// taps of pixel m0 + r, zero where a tap leaves the map.
template <int C>
__device__ __forceinline__ void gather(unsigned char* buf, const bf16* src,
                                       int m0, int M, int H, int W, int axis,
                                       int dil) {
  using G = Cfg<C>;
  constexpr int VPT = C / 8;  // 16-byte vectors per (pixel, tap)
  bf16* As = reinterpret_cast<bf16*>(buf);
  const int step = axis == 0 ? W : 1;
  const int lim = axis == 0 ? H : W;
  for (int v = threadIdx.x; v < G::BM * 3 * VPT; v += blockDim.x) {
    const int r = v / (3 * VPT), t = (v / VPT) % 3, j = v % VPT;
    const int m = m0 + r;
    const int off = (t - 1) * dil;
    const int pos = axis == 0 ? (m / W) % H : m % W;
    const bool valid = m < M && pos + off >= 0 && pos + off < lim;
    const long long pix = valid ? m + off * step : 0;
    cp_async16(As + r * G::LDA + t * C + j * 8, src + pix * C + j * 8, valid);
  }
  cp_async_commit();
}

// One stage over the tiles of this CTA's share:
//   out = relu(conv3tap(src; w, axis, dil) + bias [+ res]).
// axis 0: taps along H (pixel step W); axis 1: along W (pixel step 1).
// Each thread owns 8 fixed channels of every (THREADS / VPT)-th tile row:
// its bias is loaded once per stage, its residual vectors before the
// product so that their latency hides behind it.  src and res are read
// through L2 (cp.async.cg, __ldcg), never through the read-only path:
// within the launch an earlier stage wrote them.
template <int C>
__device__ void stage(unsigned char* smem, const bf16* src, const bf16* w,
                      const float* bias, const bf16* res, bf16* out, int M,
                      int H, int W, int axis, int dil) {
  using G = Cfg<C>;
  constexpr int VPT = C / 8, RSTEP = G::THREADS / VPT;
  constexpr int PER = G::BM / RSTEP;  // output vectors per thread per tile
  static_assert(G::THREADS % VPT == 0 && G::BM % RSTEP == 0, "tile shape");
  bf16* Ws = reinterpret_cast<bf16*>(smem + G::NBUF * G::a_bytes);
  const int tiles = (M + G::BM - 1) / G::BM;
  const int j = threadIdx.x % VPT, r0 = threadIdx.x / VPT;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bv[i] = __ldg(bias + j * 8 + i);

  load_matrix(Ws, G::LDB, w, G::K, C);
  int tile = blockIdx.x;
  gather<C>(smem, src, tile * G::BM, M, H, W, axis, dil);
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + (int)gridDim.x;
    unsigned char* cur = smem + (it % G::NBUF) * G::a_bytes;
    if constexpr (G::NBUF == 2) {
      if (next < tiles)
        gather<C>(smem + ((it + 1) % 2) * G::a_bytes, src, next * G::BM, M,
                  H, W, axis, dil);
      else
        cp_async_commit();  // an empty group keeps the count uniform
      cp_async_wait_group<1>();  // this tile's A (and the weights) landed
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();

    const int m0 = tile * G::BM;
    uint4 rv[PER];
    if (res != nullptr) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int m = m0 + r0 + i * RSTEP;
        rv[i] = m < M ? __ldcg(reinterpret_cast<const uint4*>(
                            res + (long long)m * C + j * 8))
                      : zero_vec();
      }
    }
    float* Cs = reinterpret_cast<float*>(cur);
    block_gemm<G::WM, G::WN, G::LDA, C, G::K>(
        reinterpret_cast<const bf16*>(cur), Ws, Cs);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = r0 + i * RSTEP, m = m0 + r;
      if (m >= M) break;  // rows grow with i
      const float4* c = reinterpret_cast<const float4*>(Cs + r * G::LDC + j * 8);
      const float4 c0 = c[0], c1 = c[1];
      float o[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] += bv[k];
      if (res != nullptr) {
        float rf[8];
        unpack_bf16x8(rv[i], rf);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] += rf[k];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = fmaxf(o[k], 0.0f);
      *reinterpret_cast<uint4*>(out + (long long)m * C + j * 8) =
          pack_bf16x8(o);
    }
    __syncthreads();  // this buffer's C read before a gather refills it
    if constexpr (G::NBUF == 1) {
      if (next < tiles)
        gather<C>(smem, src, next * G::BM, M, H, W, axis, dil);
    }
  }
  cp_async_wait_all();
}

template <int C>
__global__ void __launch_bounds__(256)
nb1d_block_kernel(const bf16* x, const bf16* __restrict__ w,
                  const float* __restrict__ b, bf16* t1, bf16* t2, bf16* out,
                  int M, int H, int W, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WS = 3 * C * C;
  cg::grid_group grid = cg::this_grid();
  stage<C>(smem, x, w, b, nullptr, t1, M, H, W, 0, 1);
  grid.sync();
  stage<C>(smem, t1, w + WS, b + C, nullptr, t2, M, H, W, 1, 1);
  grid.sync();
  stage<C>(smem, t2, w + 2 * WS, b + 2 * C, nullptr, t1, M, H, W, 0, dil);
  grid.sync();
  stage<C>(smem, t1, w + 3 * WS, b + 3 * C, x, out, M, H, W, 1, dil);
}

template <int C>
int launch(const void* x, const void* w, const void* bias, void* t1,
           void* t2, void* out, int B, int H, int W, int dil,
           cudaStream_t stream) {
  using G = Cfg<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  cudaError_t e = allow_smem(nb1d_block_kernel<C>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_block_kernel<C>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  int M = B * H * W;
  const int tiles = (M + G::BM - 1) / G::BM;
  const dim3 grid((unsigned)(tiles < grid_max ? tiles : grid_max));
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  const float* bp = static_cast<const float*>(bias);
  bf16* t1p = static_cast<bf16*>(t1);
  bf16* t2p = static_cast<bf16*>(t2);
  bf16* op = static_cast<bf16*>(out);
  void* args[] = {&xp, &wp, &bp, &t1p, &t2p, &op, &M, &H, &W, &dil};
  // refuses (never hangs) a grid that cannot be resident all at once
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nb1d_block_kernel<C>), grid,
      dim3(G::THREADS), args, G::smem, stream);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an in-flight wgmma reads or writes: the compiler
// neither moves nor reuses them across this point (placed after the wait
// that ends the wgmma).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[m][i])::"memory");
}
// shared memory written by this thread (cp.async) made visible to wgmma's
// reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes, lbo bytes between two adjacent
// in K, sbo between two adjacent in N.
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

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

// One block: out = nb1d(x).  x, out: (B, H, W, C) bf16; w: (4, 3, C, C)
// bf16 [conv, tap, cin, cout]; bias: (4, C) f32; t1, t2: (B, H, W, C) bf16
// scratch.  Returns the launch's error (cudaGetLastError()).
extern "C" int erf_nb1d_block(const void* x, const void* w, const void* bias,
                              void* t1, void* t2, void* out, int B, int H,
                              int W, int C, int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    case 64: return launch<64>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    case 128: return launch<128>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    default: return cudaErrorInvalidValue;
  }
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
