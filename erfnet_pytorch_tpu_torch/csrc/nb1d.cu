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
// four-stage cooperative kernel with f32 maps, the f32 fold of the
// weights, f32 biases and f32 scratch maps (sized per call by the
// wrapper), no rounding but f32's own.  The product is an FFMA micro-tile
// on the CUDA cores (each thread TM pixels x 8 output channels; no TF32).
// An f32 tap stack is 3 C^2 x 4 bytes, 192 KB at C=128, so the C=128
// stages take K in three chunks of one tap each (the tap's weights and
// the tile's shifted rows, restaged per tile); the C=64 and C=16 stacks
// fit whole and are staged once per stage, as in the bf16 form.  A 16-byte
// cp.async carries 4 f32 channels.  Bound at f32: operations at every C
// (12 C^2 MACs per pixel against 67 TFLOP/s).
#include <cooperative_groups.h>

#include "common.cuh"

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
// f32 form
// ---------------------------------------------------------------------------

// NCHUNK K chunks of TPC taps (KC = TPC C columns); the threads form a
// grid of row groups x column groups: thread t owns tile rows rowg, rowg +
// RS, ... (rowg = t / TC) and the output channels 4 colg + g CS + q, q < 4,
// of its TN / 4 groups g (colg = t % TC, CS = 4 TC; see ffma_tile).
template <int C>
struct Cfg32 {
  static constexpr int THREADS = 256, TN = 8, BM = C == 16 ? 256 : 64;
  static constexpr int TC = C / TN, RS = THREADS / TC, TM = BM / RS;
  static constexpr int CS = 4 * TC;
  static constexpr int NCHUNK = C == 128 ? 3 : 1, TPC = 3 / NCHUNK;
  static constexpr int KC = TPC * C, LDA = pitch4(KC), LDB = C;
  static_assert(THREADS % TC == 0 && BM % RS == 0, "f32 nb1d tile");
  static constexpr size_t a_bytes = ((size_t)BM * LDA * 4 + 127) / 128 * 128;
  static constexpr size_t smem = a_bytes + (size_t)KC * LDB * 4;
};

// Start copying taps [t0, t0 + TPC) of the A tile of pixels [m0, m0 + BM):
// row r, column tq C + c = channel c of pixel m0 + r shifted by
// (t0 + tq - 1) dil along the axis, zero where it leaves the map.
template <int C>
__device__ __forceinline__ void gather_f32(float* As, const float* src,
                                           int m0, int M, int H, int W,
                                           int axis, int dil, int t0) {
  using G = Cfg32<C>;
  constexpr int VPT = C / 4;  // 16-byte vectors per (pixel, tap)
  const int step = axis == 0 ? W : 1;
  const int lim = axis == 0 ? H : W;
  for (int v = threadIdx.x; v < G::BM * G::TPC * VPT; v += blockDim.x) {
    const int r = v / (G::TPC * VPT), tq = (v / VPT) % G::TPC, j = v % VPT;
    const int m = m0 + r;
    const int off = (t0 + tq - 1) * dil;
    const int pos = axis == 0 ? (m / W) % H : m % W;
    const bool valid = m < M && pos + off >= 0 && pos + off < lim;
    const long long pix = valid ? (long long)m + (long long)off * step : 0;
    cp_async16(As + r * G::LDA + tq * C + j * 4, src + pix * C + j * 4,
               valid);
  }
}

// One stage over the tiles of this CTA's share, f32:
//   out = relu(conv3tap(src; w, axis, dil) + bias [+ res]).
// src and res are read through L2 (cp.async.cg, __ldcg): within the launch
// an earlier stage wrote them.
template <int C>
__device__ void stage_f32(unsigned char* smem, const float* src,
                          const float* w, const float* bias, const float* res,
                          float* out, int M, int H, int W, int axis,
                          int dil) {
  using G = Cfg32<C>;
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = reinterpret_cast<float*>(smem + G::a_bytes);
  const int tiles = (M + G::BM - 1) / G::BM;
  const int colg = threadIdx.x % G::TC, rowg = threadIdx.x / G::TC;
  float bv[G::TN];
#pragma unroll
  for (int j = 0; j < G::TN; ++j)
    bv[j] = __ldg(bias + 4 * colg + (j / 4) * G::CS + j % 4);

  if constexpr (G::NCHUNK == 1) load_matrix(Ws, G::LDB, w, G::KC, C);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile * G::BM;
    float acc[G::TM][G::TN];
    zero_tile(acc);
    for (int c = 0; c < G::NCHUNK; ++c) {
      gather_f32<C>(As, src, m0, M, H, W, axis, dil, c * G::TPC);
      if constexpr (G::NCHUNK > 1)
        load_matrix(Ws, G::LDB, w + (size_t)c * G::KC * C, G::KC, C);
      cp_async_wait_all();
      __syncthreads();
      ffma_tile<G::TM, G::TN, G::KC, G::CS>(acc, As + rowg * G::LDA,
                                            G::RS * G::LDA, Ws + 4 * colg,
                                            G::LDB);
      __syncthreads();  // every thread is done with the chunk
    }
#pragma unroll
    for (int i = 0; i < G::TM; ++i) {
      const int m = m0 + rowg + i * G::RS;
      if (m >= M) break;  // rows grow with i
      const long long at = (long long)m * C + 4 * colg;
      float o[G::TN];
#pragma unroll
      for (int j = 0; j < G::TN; ++j) o[j] = acc[i][j] + bv[j];
      if (res != nullptr) {
#pragma unroll
        for (int j = 0; j < G::TN; j += 4) {
          const float4 r4 = __ldcg(
              reinterpret_cast<const float4*>(res + at + (j / 4) * G::CS));
          o[j] += r4.x; o[j + 1] += r4.y; o[j + 2] += r4.z; o[j + 3] += r4.w;
        }
      }
#pragma unroll
      for (int j = 0; j < G::TN; j += 4)
        *reinterpret_cast<float4*>(out + at + (j / 4) * G::CS) =
            make_float4(fmaxf(o[j], 0.0f), fmaxf(o[j + 1], 0.0f),
                        fmaxf(o[j + 2], 0.0f), fmaxf(o[j + 3], 0.0f));
    }
  }
  cp_async_wait_all();
}

template <int C>
__global__ void __launch_bounds__(256)
nb1d_block_f32_kernel(const float* x, const float* __restrict__ w,
                      const float* __restrict__ b, float* t1, float* t2,
                      float* out, int M, int H, int W, int dil) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WS = 3 * C * C;
  cg::grid_group grid = cg::this_grid();
  stage_f32<C>(smem, x, w, b, nullptr, t1, M, H, W, 0, 1);
  grid.sync();
  stage_f32<C>(smem, t1, w + WS, b + C, nullptr, t2, M, H, W, 1, 1);
  grid.sync();
  stage_f32<C>(smem, t2, w + 2 * WS, b + 2 * C, nullptr, t1, M, H, W, 0, dil);
  grid.sync();
  stage_f32<C>(smem, t1, w + 3 * WS, b + 3 * C, x, out, M, H, W, 1, dil);
}

template <int C>
int launch_f32(const void* x, const void* w, const void* bias, void* t1,
               void* t2, void* out, int B, int H, int W, int dil,
               cudaStream_t stream) {
  using G = Cfg32<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  cudaError_t e = allow_smem(nb1d_block_f32_kernel<C>, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(nb1d_block_f32_kernel<C>, G::THREADS, G::smem,
                         &grid_max)) != cudaSuccess)
    return e;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  int M = B * H * W;
  const int tiles = (M + G::BM - 1) / G::BM;
  const dim3 grid((unsigned)(tiles < grid_max ? tiles : grid_max));
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  float* t1p = static_cast<float*>(t1);
  float* t2p = static_cast<float*>(t2);
  float* op = static_cast<float*>(out);
  void* args[] = {&xp, &wp, &bp, &t1p, &t2p, &op, &M, &H, &W, &dil};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nb1d_block_f32_kernel<C>), grid,
      dim3(G::THREADS), args, G::smem, stream);
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
// bias (4, C) f32.
extern "C" int erf_nb1d_block_f32(const void* x, const void* w,
                                  const void* bias, void* t1, void* t2,
                                  void* out, int B, int H, int W, int C,
                                  int dil, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_f32<16>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    case 64: return launch_f32<64>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    case 128:
      return launch_f32<128>(x, w, bias, t1, t2, out, B, H, W, dil, s);
    default: return cudaErrorInvalidValue;
  }
}
