// w8a8 int8 non_bottleneck_1d inference: one launch per block.
//
// Replaces erfnet_pytorch_tpu/ops/pallas/nb1d_q8.py:_nb1d_q8_kernel (via
// nb1d_infer_q8 / nb1d_infer_packed_q8) and :_nb1d_q8_stack_kernel (via
// nb1d_stack_infer_q8, as one launch per block with an f32 carry between
// launches).  With BN folded, per-column int8 weight codes w_k, and
// per-tensor activation scales, a block is
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
// rounds half to even with __float2int_rn, as the plain version
// (ops/cuda/nb1d_q8.py) and the TPU kernel do.  So the kernel is bit-
// identical to its plain version.
//
// Design: the shape of csrc/nb1d.cu.  The four convs are four stages of one
// cooperative launch with a grid-wide barrier between them; a persistent
// grid walks BM-pixel tiles, each tile an implicit GEMM with K = 3C (the
// three taps of a pixel side by side), padded to the k32 step of
// mma.sync.m16n8k32.s8 (C = 16: K = 48 -> 64; the padding's weight codes
// are zero, so whatever the A tile holds there adds nothing).  Stage 1
// quantizes x while it gathers the tile (load, scale, round, store); stages
// 2-4 gather int8 codes with cp.async.  t1..t3 pass through two int8
// scratch maps in device memory, a quarter of the bytes of f32 (L2-
// resident at serving sizes).  The tap stacks are stored transposed,
// [cout][tap * C + cin], so that ldmatrix loads both the A and the B
// fragments of the int8 MMA without transposition.
//
// Bound on this card: at serving sizes the blocks move more bytes than
// their int8 products need time (12 C^2 MACs per pixel at 1979 TOP/s
// against 2-8 bytes per channel of input and output at 3.35 TB/s), except
// the C=128 block with bf16 in and out, which is close to even.  This
// version gathers every input pixel three times (once per tap) and
// quantizes stage 1's input once per tap; a band of rows staged once per
// tile, wgmma, and TMA are the next steps.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

using namespace erfk;
namespace cg = cooperative_groups;

namespace {

constexpr int QMAX = 127;

// BM pixels per tile; 8 warps split it into WM-row x WN-column blocks.  K is
// padded to the MMA's k32 step; row pitches are odd multiples of 16 bytes so
// that the 8 rows of an ldmatrix fall on 8 different bank groups.  The
// int32 product tile (pitch C + 4) reuses the A buffer.  NBUF A buffers:
// with two, the next tile's gather is issued before this one's product.
template <int C>
struct QCfg {
  static constexpr int THREADS = 256, BM = C == 16 ? 256 : 64;
  static constexpr int NBUF = C == 128 ? 1 : 2;
  static constexpr int WCOLS = C == 16 ? 1 : 2;  // warps across the columns
  static constexpr int WN = C / WCOLS, WM = BM * WCOLS / (THREADS / 32);
  static constexpr int KP = (3 * C + 31) / 32 * 32;
  static constexpr int LDA = KP + 16, LDB = KP + 16, LDC = C + 4;
  static constexpr size_t a_raw = (size_t)BM * LDA > (size_t)BM * LDC * 4
                                      ? (size_t)BM * LDA
                                      : (size_t)BM * LDC * 4;
  static constexpr size_t a_bytes = (a_raw + 127) / 128 * 128;
  static constexpr size_t smem = NBUF * a_bytes + (size_t)C * LDB;
};

__device__ __forceinline__ void ldsm_x4_b8(unsigned (&r)[4], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x32, row) * b (32x8, col), s8 operands, s32 accumulators.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Cs (rows x N int32, pitch N + 4) = A (rows x KP int8, pitch LDA) *
// B^T, with B stored [n][k] (N x KP int8, pitch LDB).  An A fragment of
// m16n8k32 is four 8x16-byte matrices (rows 0-7 / 8-15, bytes 0-15 /
// 16-31), the B fragments of two n8 tiles likewise four (n 0-7 / 8-15,
// k bytes 0-15 / 16-31): one ldmatrix.x4 each.  The product may alias A:
// the function synchronises the block before it stores.
template <int WM, int WN, int LDA, int LDB, int N, int KP>
__device__ __forceinline__ void block_gemm_s8(const int8_t* A, const int8_t* B,
                                              int* Cs) {
  constexpr int LDC = N + 4, MT = WM / 16, NT = WN / 8, WCOLS = N / WN;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && N % WN == 0 && KP % 32 == 0,
                "tile shape");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WCOLS, wn = warp % WCOLS;
  const int8_t* a_row = A + (wm * WM + lane % 16) * LDA + (lane / 16) * 16;
  const int8_t* b_row =
      B + (wn * WN + (lane / 16) * 8 + lane % 8) * LDB + ((lane / 8) % 2) * 16;
  int acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0;
#pragma unroll 2
  for (int k = 0; k < KP; k += 32) {
    unsigned a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4_b8(a[m], a_row + m * 16 * LDA + k);
#pragma unroll
    for (int n = 0; n < WN / 16; ++n) {
      unsigned b[4];
      ldsm_x4_b8(b, b_row + n * 16 * LDB + k);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_s8_16832(acc[m][2 * n], a[m], b[0], b[1]);
        mma_s8_16832(acc[m][2 * n + 1], a[m], b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with A before Cs overwrites it
  // thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns
  // 2t and 2t + 1 of each m16 x n8 tile
  int* c_row = Cs + (wm * WM + lane / 4) * LDC + wn * WN + 2 * (lane % 4);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      int* c = c_row + m * 16 * LDC + n * 8;
      *reinterpret_cast<int2*>(c) = make_int2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<int2*>(c + 8 * LDC) =
          make_int2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
}

__device__ __forceinline__ int code(float y) {
  return min(max(__float2int_rn(y), 0), QMAX);
}

__device__ __forceinline__ uint2 pack_s8x8(const int (&q)[8]) {
  uint2 r;
  r.x = (q[0] & 0xff) | (q[1] & 0xff) << 8 | (q[2] & 0xff) << 16 |
        (unsigned)(q[3] & 0xff) << 24;
  r.y = (q[4] & 0xff) | (q[5] & 0xff) << 8 | (q[6] & 0xff) << 16 |
        (unsigned)(q[7] & 0xff) << 24;
  return r;
}

// 8 consecutive values of a map that is not written in this launch.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Start filling the A tile of pixels [m0, m0 + BM): row r holds the three
// taps of pixel m0 + r (K = tap * C + cin), zero where a tap leaves the
// map.  An int8 source (t1, t2) is copied with cp.async; a bf16 or f32
// source (the block input x, stage 1) is quantized on the way, 8 channels
// per load.  Either way the call closes one cp.async group, so the caller's
// group count is the same for every stage.
template <int C, typename SrcT>
__device__ __forceinline__ void gather(int8_t* As, const SrcT* src, int m0,
                                       int M, int H, int W, int axis, int dil,
                                       float inv_in) {
  using G = QCfg<C>;
  const int step = axis == 0 ? W : 1;
  const int lim = axis == 0 ? H : W;
  if constexpr (std::is_same_v<SrcT, int8_t>) {
    constexpr int VPT = C / 16;  // 16-byte vectors per (pixel, tap)
    for (int v = threadIdx.x; v < G::BM * 3 * VPT; v += blockDim.x) {
      const int r = v / (3 * VPT), t = (v / VPT) % 3, j = v % VPT;
      const int m = m0 + r, off = (t - 1) * dil;
      const int pos = axis == 0 ? (m / W) % H : m % W;
      const bool valid = m < M && pos + off >= 0 && pos + off < lim;
      const long long pix = valid ? m + (long long)off * step : 0;
      cp_async16(As + r * G::LDA + t * C + j * 16, src + pix * C + j * 16,
                 valid);
    }
  } else {
    constexpr int VPT = C / 8;  // 8-channel units per (pixel, tap)
    for (int v = threadIdx.x; v < G::BM * 3 * VPT; v += blockDim.x) {
      const int r = v / (3 * VPT), t = (v / VPT) % 3, j = v % VPT;
      const int m = m0 + r, off = (t - 1) * dil;
      const int pos = axis == 0 ? (m / W) % H : m % W;
      uint2 packed = make_uint2(0, 0);
      if (m < M && pos + off >= 0 && pos + off < lim) {
        float f[8];
        load8(src + (m + (long long)off * step) * C + j * 8, f);
        int q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = code(__fmul_rn(f[k], inv_in));
        packed = pack_s8x8(q);
      }
      *reinterpret_cast<uint2*>(As + r * G::LDA + t * C + j * 8) = packed;
    }
  }
  cp_async_commit();
}

// One stage over the tiles of this CTA's share.  SrcT: int8_t (a code map)
// or the block input's type (stage 1, quantized in the gather).  DstT:
// int8_t (stages 1-3: the requant epilogue, codes to a scratch map) or the
// output type (stage 4: real units plus the residual x, then ReLU).
// axis 0: taps along H (pixel step W); axis 1: along W (pixel step 1).
// Each thread owns 8 fixed channels of every (THREADS / VPT)-th tile row:
// its m and f are loaded once per stage.  Code maps written earlier in the
// launch are read through L2 only (cp.async.cg).
template <int C, typename SrcT, typename ResT, typename DstT>
__device__ void stage(unsigned char* smem, const SrcT* src,
                      const int8_t* __restrict__ wt,
                      const float* __restrict__ mv,
                      const float* __restrict__ fv, const ResT* res, DstT* out,
                      int M, int H, int W, int axis, int dil, float inv_in) {
  using G = QCfg<C>;
  constexpr int VPT = C / 8, RSTEP = G::THREADS / VPT;
  constexpr int PER = G::BM / RSTEP;  // output vectors per thread per tile
  constexpr bool LAST = !std::is_same_v<DstT, int8_t>;
  static_assert(G::THREADS % VPT == 0 && G::BM % RSTEP == 0, "tile shape");
  int8_t* Ws = reinterpret_cast<int8_t*>(smem + G::NBUF * G::a_bytes);
  const int tiles = (M + G::BM - 1) / G::BM;
  const int j = threadIdx.x % VPT, r0 = threadIdx.x / VPT;
  float mk[8], fk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mk[i] = __ldg(mv + j * 8 + i);
    fk[i] = __ldg(fv + j * 8 + i);
  }
  // the transposed tap stack, C rows of KP bytes; joins the first group
  for (int v = threadIdx.x; v < C * (G::KP / 16); v += blockDim.x) {
    const int r = v / (G::KP / 16), c = v % (G::KP / 16);
    cp_async16(Ws + r * G::LDB + c * 16, wt + (long long)r * G::KP + c * 16,
               true);
  }
  int tile = blockIdx.x;
  auto A = [&](int it) {
    return reinterpret_cast<int8_t*>(smem + (it % G::NBUF) * G::a_bytes);
  };
  gather<C>(A(0), src, tile * G::BM, M, H, W, axis, dil, inv_in);
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + (int)gridDim.x;
    if constexpr (G::NBUF == 2) {
      if (next < tiles)
        gather<C>(A(it + 1), src, next * G::BM, M, H, W, axis, dil, inv_in);
      else
        cp_async_commit();  // an empty group keeps the count uniform
      cp_async_wait_group<1>();  // this tile's A (and the weights) landed
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();

    const int m0 = tile * G::BM;
    int* Cs = reinterpret_cast<int*>(A(it));
    block_gemm_s8<G::WM, G::WN, G::LDA, G::LDB, C, G::KP>(A(it), Ws, Cs);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = r0 + i * RSTEP, m = m0 + r;
      if (m >= M) break;  // rows grow with i
      const int4* c = reinterpret_cast<const int4*>(Cs + r * G::LDC + j * 8);
      const int4 c0 = c[0], c1 = c[1];
      const int a[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float y[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        y[k] = __fadd_rn(__fmul_rn(__int2float_rn(a[k]), mk[k]), fk[k]);
      const long long o = (long long)m * C + j * 8;
      if constexpr (LAST) {
        float x[8];
        load8(res + o, x);
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = fmaxf(__fadd_rn(y[k], x[k]), 0.0f);
        store8(out + o, y);
      } else {
        int q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = code(y[k]);
        *reinterpret_cast<uint2*>(out + o) = pack_s8x8(q);
      }
    }
    __syncthreads();  // this buffer's Cs read before a gather refills it
    if constexpr (G::NBUF == 1) {
      if (next < tiles)
        gather<C>(A(0), src, next * G::BM, M, H, W, axis, dil, inv_in);
    }
  }
  cp_async_wait_all();
}

template <int C, typename InT, typename OutT>
__global__ void __launch_bounds__(256)
nb1d_q8_kernel(const InT* x, const int8_t* __restrict__ wt,
               const float* __restrict__ mv, const float* __restrict__ fv,
               int8_t* t1, int8_t* t2, OutT* out, int M, int H, int W,
               int dil, float inv_in) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int WS = C * QCfg<C>::KP;
  cg::grid_group grid = cg::this_grid();
  stage<C, InT, InT, int8_t>(smem, x, wt, mv, fv, nullptr, t1, M, H, W, 0, 1,
                             inv_in);
  grid.sync();
  stage<C, int8_t, InT, int8_t>(smem, t1, wt + WS, mv + C, fv + C, nullptr,
                                t2, M, H, W, 1, 1, inv_in);
  grid.sync();
  stage<C, int8_t, InT, int8_t>(smem, t2, wt + 2 * WS, mv + 2 * C, fv + 2 * C,
                                nullptr, t1, M, H, W, 0, dil, inv_in);
  grid.sync();
  stage<C, int8_t, InT, OutT>(smem, t1, wt + 3 * WS, mv + 3 * C, fv + 3 * C,
                              x, out, M, H, W, 1, dil, inv_in);
}

template <int C, typename InT, typename OutT>
int launch(const void* x, const void* wt, const void* mv, const void* fv,
           void* t1, void* t2, void* out, int B, int H, int W, int dil,
           float inv_in, cudaStream_t stream) {
  using G = QCfg<C>;
  static bool smem_ok = false;
  static int grid_max = 0;  // resident CTAs: a cooperative grid's limit
  auto kernel = nb1d_q8_kernel<C, InT, OutT>;
  cudaError_t e = allow_smem(kernel, G::smem, &smem_ok);
  if (e != cudaSuccess) return e;
  if (grid_max == 0 &&
      (e = resident_ctas(kernel, G::THREADS, G::smem, &grid_max)) !=
          cudaSuccess)
    return e;
  if ((long long)B * H * W * C >= (1LL << 31)) return cudaErrorInvalidValue;
  int M = B * H * W;
  const int tiles = (M + G::BM - 1) / G::BM;
  const dim3 grid((unsigned)(tiles < grid_max ? tiles : grid_max));
  const InT* xp = static_cast<const InT*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* mp = static_cast<const float*>(mv);
  const float* fp = static_cast<const float*>(fv);
  int8_t* t1p = static_cast<int8_t*>(t1);
  int8_t* t2p = static_cast<int8_t*>(t2);
  OutT* op = static_cast<OutT*>(out);
  void* args[] = {&xp, &wp, &mp, &fp, &t1p, &t2p, &op,
                  &M,  &H,  &W,  &dil, &inv_in};
  // refuses (never hangs) a grid that cannot be resident all at once
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                  dim3(G::THREADS), args, G::smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int C>
int launch_io(const void* x, const void* wt, const void* mv, const void* fv,
              void* t1, void* t2, void* out, int B, int H, int W, int dil,
              int in_f32, int out_f32, float inv_in, cudaStream_t s) {
  if (in_f32)
    return out_f32 ? launch<C, float, float>(x, wt, mv, fv, t1, t2, out, B, H,
                                             W, dil, inv_in, s)
                   : launch<C, float, bf16>(x, wt, mv, fv, t1, t2, out, B, H,
                                            W, dil, inv_in, s);
  return out_f32 ? launch<C, bf16, float>(x, wt, mv, fv, t1, t2, out, B, H, W,
                                          dil, inv_in, s)
                 : launch<C, bf16, bf16>(x, wt, mv, fv, t1, t2, out, B, H, W,
                                         dil, inv_in, s);
}

}  // namespace

// One block: out = nb1d_q8(x).  x: (B, H, W, C) bf16 (in_f32 = 0) or f32;
// out: the same shape, bf16 (out_f32 = 0) or f32; wt: (4, C, KP) int8
// [conv, cout, tap * C + cin], KP = 3C padded to a multiple of 32, zero in
// the padding; mv, fv: (4, C) f32; t1, t2: (B, H, W, C) int8 scratch;
// inv_in: the input's reciprocal scale.  Returns the launch's error
// (cudaGetLastError()).
extern "C" int erf_nb1d_q8_block(const void* x, const void* wt, const void* mv,
                                 const void* fv, void* t1, void* t2, void* out,
                                 int B, int H, int W, int C, int dil,
                                 int in_f32, int out_f32, float inv_in,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch_io<16>(x, wt, mv, fv, t1, t2, out, B, H, W, dil,
                                  in_f32, out_f32, inv_in, s);
    case 64: return launch_io<64>(x, wt, mv, fv, t1, t2, out, B, H, W, dil,
                                  in_f32, out_f32, inv_in, s);
    case 128: return launch_io<128>(x, wt, mv, fv, t1, t2, out, B, H, W, dil,
                                    in_f32, out_f32, inv_in, s);
    default: return cudaErrorInvalidValue;
  }
}
