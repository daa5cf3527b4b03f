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

}  // namespace erfk

extern "C" const char* erf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
