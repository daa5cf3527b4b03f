// Shared pieces of the port's CUDA kernels (sm_90a): ldmatrix and the
// mma.sync bf16 product, cp.async copies (zero fill at the map's edges),
// bf16 packing, the f32 helpers of the f32 forms, and the launch helpers
// (shared-memory opt-in, resident CTAs, error strings).  The halo-patch
// convs' tiling is in conv32.cuh, their bf16 patch loader and the wgmma
// pieces in conv16.cuh.
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

// The same for one 4-byte word (cp.async.ca: the 4-byte form goes through
// L1), for runs that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// The same for 8 bytes, always valid (cp.async.ca: .cg copies 16 only).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
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

// ---------------------------------------------------------------------------
// f32 helpers.  The f32 forms of the serving kernels multiply on the CUDA
// cores in f32 (FFMA, no TF32 anywhere): the operands are staged in shared
// memory as f32 with the same cp.async gathers as the bf16 forms (4
// channels per 16-byte copy instead of 8), and each thread accumulates a
// TM x TN block of the product in registers.
// ---------------------------------------------------------------------------

// 8 consecutive elements -> 8 f32: one 16-byte load of bf16, two of f32.
// Read-only path: for operands no kernel writes in the same launch.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  unpack_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// f32 -> the element type T (bf16 rounds to nearest even).
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// 8 f32 -> 8 consecutive elements: one 16-byte store of bf16 (rounded),
// two of f32.
__device__ __forceinline__ void store_vec8(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}

__device__ __forceinline__ void store_vec8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// A value as the element type T would hold it: bf16 rounds (nearest even),
// f32 keeps it.
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <>
__device__ __forceinline__ float round_as<float>(float v) { return v; }

// A row pitch (floats) >= k with pitch % 32 == 4: the float4 reads of
// the rows of a quarter warp (ffma_tile's A operand) fall on distinct
// banks.
constexpr int pitch4(int k) { return k + (36 - k % 32) % 32; }

// Thread tile of an f32 product on the CUDA cores:
//   acc[i][4 g + q] += sum_{k < KLEN} A(i, k) B(k, g CS + q)
// A: this thread's row i at a + i * rstride (floats), k along the row;
// B: row k at b + k * ldb, this thread's columns in TN / 4 groups of four,
// group g at column g CS.  Both in shared memory, 16-byte aligned, KLEN
// % 4 == 0.  With b = B + 4 t for thread t of a row of TC threads and CS =
// 4 TC, the threads of a row read each group as one contiguous run (no
// bank conflicts); with row pitches of 4 mod 32 floats (pitch4), the A
// reads of the rows of a quarter warp fall on distinct banks.  Per four k
// a thread loads TM + TN float4 and issues 4 TM TN FMAs; each output is one
// f32 FMA chain in increasing k.
template <int TM, int TN, int KLEN, int CS>
__device__ __forceinline__ void ffma_tile(float (&acc)[TM][TN],
                                          const float* a, int rstride,
                                          const float* b, int ldb) {
  static_assert(KLEN % 4 == 0 && TN % 4 == 0, "ffma_tile shape");
#pragma unroll 2
  for (int k = 0; k < KLEN; k += 4) {
    float av[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(a + i * rstride + k);
      av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[TN];
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(b + (k + kk) * ldb + g * CS);
        bv[4 * g] = v.x; bv[4 * g + 1] = v.y;
        bv[4 * g + 2] = v.z; bv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i][kk], bv[j], acc[i][j]);
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero_tile(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
}

// acc += part: a K chunk's partial sums added to the running total.  The
// chunked f32 products sum each chunk in a chain of its own and add the
// chunks in order: shorter FMA chains (their rounding grows with the
// chain) and the order in which the plain versions add their per-tap
// products.
template <int TM, int TN>
__device__ __forceinline__ void add_tile(float (&acc)[TM][TN],
                                         const float (&part)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
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

// ---------------------------------------------------------------------------
// f32 training helpers: the f32 forms of the train kernels (the JAX
// package's default compute dtype) keep every map in f32, round nothing to
// bf16 and multiply on the CUDA cores (FFMA; no TF32).  Sums over the
// batch stay per CTA and are reduced in a fixed order, as above.
// ---------------------------------------------------------------------------

// out = g + gs1[b, c] + 2 z gs2[b, c] in f32, the order of the bf16 fold
// without its rounding.  g, z, out: (B, HW, C) f32, C % 4 == 0.  One
// thread per 4 channels of a pixel.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256)
adjust_grad_f32_kernel(const float* __restrict__ g,
                       const float* __restrict__ z,
                       const float* __restrict__ gs1,
                       const float* __restrict__ gs2,
                       float* __restrict__ out, long long pixels, int HW,
                       int C) {
  const int vpp = C / 4;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= pixels * vpp) return;
  const long long m = v / vpp;
  const int c0 = (int)(v % vpp) * 4;
  const int b = (int)(m / HW);
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g + m * C + c0));
  const float4 zv = __ldg(reinterpret_cast<const float4*>(z + m * C + c0));
  const float gi[4] = {gv.x, gv.y, gv.z, gv.w};
  const float zi[4] = {zv.x, zv.y, zv.z, zv.w};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float a1 = __ldg(gs1 + b * C + c0 + k);
    const float a2 = __ldg(gs2 + b * C + c0 + k);
    o[k] = __fadd_rn(__fadd_rn(gi[k], a1), __fmul_rn(__fmul_rn(2.0f, zi[k]), a2));
  }
  *reinterpret_cast<float4*>(out + m * C + c0) =
      make_float4(o[0], o[1], o[2], o[3]);
}

inline cudaError_t adjust_grad_f32(const void* g, const void* z,
                                   const void* gs1, const void* gs2,
                                   void* out, int B, int HW, int C,
                                   cudaStream_t s) {
  if (C % 4) return cudaErrorInvalidValue;
  const long long pixels = (long long)B * HW;
  const long long n = pixels * (C / 4);
  adjust_grad_f32_kernel<><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(z),
      static_cast<const float*>(gs1), static_cast<const float*>(gs2),
      static_cast<float*>(out), pixels, HW, C);
  return cudaGetLastError();
}

}  // namespace erfk

extern "C" const char* erf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
