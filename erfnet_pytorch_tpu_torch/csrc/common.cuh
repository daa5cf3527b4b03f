// Shared pieces of the port's CUDA kernels (sm_90a).
//
// block_gemm: one CTA multiplies a bf16 tile A (BM x K, shared memory) by a
// bf16 tile B (K x N, shared memory) on the tensor cores (mma.sync m16n8k16
// with ldmatrix operand loads, f32 accumulation) and leaves the f32 product
// in shared memory.  Each warp owns one block of a grid of row bands x
// column bands.  The product may alias A: the function synchronises the
// block before it stores.
//
// Every kernel of the port stages its operands this way: gather an implicit-
// GEMM tile of the input into shared memory with cp.async (zero fill at the
// map's edges), multiply, and run its epilogue from the f32 product.  Simple
// and correct first; TMA, wgmma and pipelining are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace erfk {

using bf16 = __nv_bfloat16;

// ldmatrix: four 8x8 b16 matrices; lane l gives the address of row l % 8
// of matrix l / 8.  The .trans form hands each thread a column pair.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Row pitches: A is LDA bf16, B is N + 8 bf16, C is N + 4 f32.  A pitch of
// an odd multiple of 16 bytes puts the 8 rows of an ldmatrix on 8
// different bank groups.  The warps form a grid of (rows / WM) x (N / WN):
// warp w owns rows [WM (w / (N / WN)), + WM) and columns
// [WN (w % (N / WN)), + WN).  KLEN: the K extent multiplied.
template <int WM, int WN, int LDA, int N, int KLEN>
__device__ __forceinline__ void block_gemm(const bf16* A, const bf16* B,
                                           float* C) {
  constexpr int LDB = N + 8, LDC = N + 4, MT = WM / 16, NT = WN / 8;
  constexpr int WCOLS = N / WN;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && N % WN == 0 &&
                    KLEN % 16 == 0 && KLEN <= LDA - 8,
                "tile shape");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WCOLS, wn = warp % WCOLS;
  // ldmatrix addresses: A rows (lane % 16) of each m16 tile, column half
  // lane / 16; B (k-major) rows k + lane % 16, column half lane / 16
  const bf16* a_row = A + (wm * WM + lane % 16) * LDA + (lane / 16) * 8;
  const bf16* b_row = B + (lane % 16) * LDB + wn * WN + (lane / 16) * 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < KLEN; k += 16) {
    unsigned a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm_x4(a[m], a_row + m * 16 * LDA + k);
#pragma unroll
    for (int n = 0; n < WN / 16; ++n) {
      unsigned b[4];
      ldsm_x4_trans(b, b_row + k * LDB + n * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16_16816(acc[m][2 * n], a[m], b[0], b[1]);
        mma_bf16_16816(acc[m][2 * n + 1], a[m], b[2], b[3]);
      }
    }
  }
  __syncthreads();  // every warp is done with A before C overwrites it
  // thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8, columns
  // 2t and 2t + 1 of each m16 x n8 tile
  float* c_row = C + (wm * WM + lane / 4) * LDC + wn * WN + 2 * (lane % 4);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* c = c_row + m * 16 * LDC + n * 8;
      *reinterpret_cast<float2*>(c) = make_float2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<float2*>(c + 8 * LDC) =
          make_float2(acc[m][n][2], acc[m][n][3]);
    }
  __syncthreads();
}

// Asynchronous 16-byte copy global -> shared (cp.async, through L2 only),
// zero fill when !valid.  Many copies stay in flight per thread, where a
// load-then-store loop would wait out one memory latency per vector; the
// L2-only path also keeps data written earlier in the same launch coherent.
// Wait with cp_async_wait_all() and then __syncthreads().
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of copies issued so far; wait until at most N groups
// are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying a dense row-major (rows x cols) bf16 matrix from global
// memory into shared memory with row pitch ld; cols % 8 == 0.  Completes
// at the caller's cp_async_wait_all().
__device__ __forceinline__ void load_matrix(bf16* dst, int ld,
                                            const bf16* src, int rows,
                                            int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, j = v % vpr;
    cp_async16(dst + r * ld + j * 8, src + (int64_t)r * cols + j * 8, true);
  }
}

__device__ __forceinline__ uint4 zero_vec() { return make_uint4(0, 0, 0, 0); }

// 8 f32 -> 8 bf16 packed in 16 bytes (round to nearest even).
__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return out;
}

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// instantiation; the attribute is per function).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}

// How many CTAs of `kernel` the device holds at once (SMs x CTAs per SM):
// the grid of a kernel whose CTAs loop over tiles, staging their weights
// once.  Cached by the caller (per instantiation).
template <typename Kernel>
inline cudaError_t resident_ctas(Kernel kernel, int threads, size_t smem,
                                 int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Training helpers: the stats-cotangent fold, fixed-order reductions of
// per-CTA partial sums, and the weight-gradient product.  Every sum over
// the batch is taken per CTA into its own slot of a partial buffer and then
// reduced in a fixed order, never with f32 atomics, so two runs of a step
// give bit-identical results.
// ---------------------------------------------------------------------------

// out = bf16(g + gs1[b, c] + 2 z gs2[b, c]) in f32: the backward of a
// kernel's per-image (sum, sum of squares) outputs folded into the
// upstream gradient.  g, z, out: (B, HW, C) bf16, C % 8 == 0; gs1, gs2:
// (B, C) f32.  One thread per 8 channels of a pixel.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256)
adjust_grad_kernel(const bf16* __restrict__ g, const bf16* __restrict__ z,
                   const float* __restrict__ gs1,
                   const float* __restrict__ gs2, bf16* __restrict__ out,
                   long long pixels, int HW, int C) {
  const int vpp = C / 8;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= pixels * vpp) return;
  const long long m = v / vpp;
  const int c0 = (int)(v % vpp) * 8;
  const int b = (int)(m / HW);
  float gv[8], zv[8], o[8];
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(g + m * C + c0)), gv);
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(z + m * C + c0)), zv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a1 = __ldg(gs1 + b * C + c0 + k);
    const float a2 = __ldg(gs2 + b * C + c0 + k);
    o[k] = __fadd_rn(__fadd_rn(gv[k], a1), __fmul_rn(__fmul_rn(2.0f, zv[k]), a2));
  }
  *reinterpret_cast<uint4*>(out + m * C + c0) = pack_bf16x8(o);
}

inline cudaError_t adjust_grad(const void* g, const void* z, const void* gs1,
                               const void* gs2, void* out, int B, int HW,
                               int C, cudaStream_t s) {
  if (C % 8) return cudaErrorInvalidValue;
  const long long pixels = (long long)B * HW;
  const long long n = pixels * (C / 8);
  adjust_grad_kernel<><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(z),
      static_cast<const float*>(gs1), static_cast<const float*>(gs2),
      static_cast<bf16*>(out), pixels, HW, C);
  return cudaGetLastError();
}

// out[g][l] = sum_{j < n} part[(g n + j) len + l] in a fixed order: a
// block takes 32 consecutive l (one per lane, coalesced) and splits j over
// its warps, warp w adding j = w, w + WJ, ... in increasing order; lane l
// of warp 0 then adds the WJ warp sums in warp order.
template <int UNUSED = 0>
__global__ void __launch_bounds__(1024)
reduce_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int n, int len) {
  __shared__ float s[32][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int wj = blockDim.x / 32;
  const int l = blockIdx.x * 32 + lane;
  const float* p = part + (long long)blockIdx.y * n * len + l;
  float acc = 0.0f;
  if (l < len) {
#pragma unroll 4
    for (int j = w; j < n; j += wj) acc += __ldg(p + (long long)j * len);
  }
  s[w][lane] = acc;
  __syncthreads();
  if (w == 0 && l < len) {
    float t = 0.0f;
    for (int k = 0; k < wj; ++k) t += s[k][lane];
    out[(long long)blockIdx.y * len + l] = t;
  }
}

inline cudaError_t reduce_parts(const float* part, float* out, int groups,
                                int n, int len, cudaStream_t s) {
  const int wj = n >= 256 ? 32 : n >= 32 ? 8 : 1;
  reduce_parts_kernel<><<<dim3((len + 31) / 32, groups), 32 * wj, 0, s>>>(
      part, out, n, len);
  return cudaGetLastError();
}

// Weight-gradient product of one CTA: D (MB x NP, f32) += A^T G over BP
// pixels, A (BP x MB) and G (BP x NP) bf16 in shared memory, pixel-major
// (row = pixel).  The A fragments are loaded with ldmatrix.trans, so the
// pixel axis is the product's depth.  The 8 warps form a grid of
// (MB / WM) x (NP / WN) x WARPS_K; with WARPS_K > 1 a warp takes every
// WARPS_K-th 16-pixel step and the warps' sums are added in a fixed order
// at the end (wgrad_store).
template <int MB, int NP, int WM, int WN>
struct WgCfg {
  static constexpr int THREADS = 256, BP = 64;
  static constexpr int WARPS_MN = (MB / WM) * (NP / WN);
  static constexpr int WARPS_K = 8 / WARPS_MN;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = MB + 8, LDG = NP + 8;
  static_assert(MB % WM == 0 && NP % WN == 0 && WM % 16 == 0 &&
                    WN % 16 == 0 && 8 % WARPS_MN == 0,
                "wgrad warp grid");
  static constexpr size_t a_bytes = ((size_t)BP * LDA * 2 + 127) / 128 * 128;
  static constexpr size_t g_bytes = ((size_t)BP * LDG * 2 + 127) / 128 * 128;
  static constexpr size_t red_bytes =
      WARPS_K > 1 ? (size_t)WARPS_K * MB * NP * 4 : 0;
  static constexpr size_t smem = a_bytes + g_bytes > red_bytes
                                     ? a_bytes + g_bytes
                                     : red_bytes;
};

template <int MB, int NP, int WM, int WN>
__device__ __forceinline__ void wgrad_step(
    const bf16* As, const bf16* Gs,
    float (&acc)[WgCfg<MB, NP, WM, WN>::MT][WgCfg<MB, NP, WM, WN>::NT][4]) {
  using Q = WgCfg<MB, NP, WM, WN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / Q::WARPS_MN, wmn = warp % Q::WARPS_MN;
  const int wm = wmn / (NP / WN), wn = wmn % (NP / WN);
  const bf16* a_base = As + ((lane % 8) + (lane / 16) * 8) * Q::LDA + wm * WM +
                       ((lane / 8) % 2) * 8;
  const bf16* g_base = Gs + (lane % 16) * Q::LDG + wn * WN + (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < Q::BP / 16; ++ks) {
    if (ks % Q::WARPS_K != wk) continue;
    unsigned a[Q::MT][4];
#pragma unroll
    for (int m = 0; m < Q::MT; ++m)
      ldsm_x4_trans(a[m], a_base + ks * 16 * Q::LDA + m * 16);
#pragma unroll
    for (int n = 0; n < WN / 16; ++n) {
      unsigned b[4];
      ldsm_x4_trans(b, g_base + ks * 16 * Q::LDG + n * 16);
#pragma unroll
      for (int m = 0; m < Q::MT; ++m) {
        mma_bf16_16816(acc[m][2 * n], a[m], b[0], b[1]);
        mma_bf16_16816(acc[m][2 * n + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// Store D's rows [0, mreal) x columns [0, nreal) to dst (row pitch nreal),
// adding the WARPS_K partial sums in a fixed order through shared memory
// (red, >= red_bytes, free for use).  Call with the whole block.
template <int MB, int NP, int WM, int WN>
__device__ __forceinline__ void wgrad_store(
    float (&acc)[WgCfg<MB, NP, WM, WN>::MT][WgCfg<MB, NP, WM, WN>::NT][4],
    float* red, float* dst, int mreal, int nreal) {
  using Q = WgCfg<MB, NP, WM, WN>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / Q::WARPS_MN, wmn = warp % Q::WARPS_MN;
  const int wm = wmn / (NP / WN), wn = wmn % (NP / WN);
  const int g = lane / 4, t = lane % 4;
  if constexpr (Q::WARPS_K == 1) {
#pragma unroll
    for (int m = 0; m < Q::MT; ++m)
#pragma unroll
      for (int n = 0; n < Q::NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * WM + m * 16 + g + 8 * h;
          const int col = wn * WN + n * 8 + 2 * t;
          if (row >= mreal) continue;
          if (col < nreal) dst[row * nreal + col] = acc[m][n][2 * h];
          if (col + 1 < nreal) dst[row * nreal + col + 1] = acc[m][n][2 * h + 1];
        }
  } else {
    __syncthreads();  // the staged tiles are dead: red may alias them
#pragma unroll
    for (int m = 0; m < Q::MT; ++m)
#pragma unroll
      for (int n = 0; n < Q::NT; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * WM + m * 16 + g + 8 * h;
          const int col = wn * WN + n * 8 + 2 * t;
          float* r = red + ((size_t)wk * MB + row) * NP + col;
          r[0] = acc[m][n][2 * h];
          r[1] = acc[m][n][2 * h + 1];
        }
    __syncthreads();
    for (int e = threadIdx.x; e < mreal * nreal; e += blockDim.x) {
      const int row = e / nreal, col = e % nreal;
      float s = 0.0f;
      for (int k = 0; k < Q::WARPS_K; ++k) s += red[((size_t)k * MB + row) * NP + col];
      dst[e] = s;
    }
  }
}

}  // namespace erfk

extern "C" const char* erf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
