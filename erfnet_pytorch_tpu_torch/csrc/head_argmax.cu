// Two heads + argmax, logits never in device memory.
//
// (1) erf_head_argmax, the decoder head: ConvTranspose2d(16, n, k2 s2) as a parity-plane
// matmul, logits rounded to bf16, first-max argmax over the n classes of
// each parity plane, int32 predictions stored straight into (B, 2H, 2W).
//
// Replaces erfnet_pytorch_tpu/ops/pallas/head_argmax.py:_kernel_grouped and
// :_kernel (via head_argmax, G = 32 packed and G = 4 plain): the same
// function for both, and the TPU's depth_to_space_planes(_packed) reshape is
// folded into the store.  Logits never reach device memory.
//
// Semantics: z[g*n + c] = sum_k f[k] W[k, g*n + c] + bias[g*n + c] in f32
// (bf16 x bf16 products are exact in f32), rounded to bf16; plane
// g = a*2 + b writes pixel (2i + a, 2j + b).  The lowest index among the
// maxima wins; a plane with a NaN logit gives n - 1, as the TPU kernel's
// clamp does.
//
// Bound on this card: one thread per feature pixel does 16 x 4n FMAs on the
// CUDA cores in f32 (1280 for n = 20) against 32 bytes read and 16 written,
// so this version is bound by f32 issue rate, above the byte bound.  Moving
// the product to the tensor cores is the next step.
//
// (2) erf_head_argmax_1x1, the encoder's 1x1 head as the encoder-stage eval
// step and train IoU run it: feats (M, 128) bf16 @ W (128, n) + bias (n,)
// f32, logits rounded to bf16, first-max argmax over n, int32 (M,).
// Replaces erfnet_pytorch_tpu/ops/pallas/head_argmax.py:_kernel at G = 1,
// K = 128 (head_argmax -> _op -> pallas_call, as training/steps.py:374 calls
// it): the same sum in f32 (bf16 x bf16 products are exact), the same
// rounding, the same first-max rule, and a pixel with a NaN logit gives
// n - 1 as that kernel's clamp does.  The TPU kernel computes the logits
// transposed so that the argmax is a sublane reduction; here each thread
// owns one pixel and keeps its n logits in registers.
//
// Bound on this card: bytes, 256 read and 4 written per pixel (12.8 MB at
// the B=6 512x1024 encoder stage, about 3.8 us at 3.35 TB/s); the 128 x n
// FMAs per pixel run on the CUDA cores in f32, so this simple version is
// bound by its f32 FMAs and shared-memory reads of W instead (W and the bias
// stay in shared memory, padded to NP classes, read as broadcasts; the
// feature row comes in as sixteen 16-byte loads).  The tensor cores are
// the next step.
// (3) The f32 forms of both (the JAX package's default compute dtype,
// eval_iou and the other eval CLIs without --bf16): the same kernels as
// templates on the element type T of feats and W.  At f32 the feats and W
// are read as f32 (the 1x1 head's 512-byte feature row as thirty-two
// 16-byte loads), the same f32 FMAs run, and the logits are not rounded:
// the TPU kernel's round_bf16 is false at f32.  The first-max and NaN
// rules are the same.  Bound at f32: the decoder head's 16 x 80 FMAs per
// feature pixel against 67 TFLOP/s (above its 80 bytes); the 1x1 head's
// bytes (512 read, 4 written per pixel).
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int K = 16, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_argmax_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                   const float* __restrict__ bias, int* __restrict__ out,
                   long long M, int H, int W, int n) {
  extern __shared__ float sm[];
  float* Ws = sm;              // (K, 4n)
  float* bs = sm + K * 4 * n;  // (4n,)
  for (int i = threadIdx.x; i < K * 4 * n; i += blockDim.x)
    Ws[i] = to_f32(w[i]);
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float f[K];
  load8(feats + m * K, f);
  load8(feats + m * K + 8, f + 8);
  const long long b = m / ((long long)H * W);
  const int i = (int)((m / W) % H), j = (int)(m % W);

  for (int a = 0; a < 2; ++a) {
    int pred[2];
    for (int pb = 0; pb < 2; ++pb) {
      const int g = a * 2 + pb;
      float best = __int_as_float(0xff800000);  // -inf
      int idx = 0;
      bool nan = false;
      for (int c = 0; c < n; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(f[k], Ws[k * 4 * n + g * n + c], acc);
        const float z = round_as<T>(acc + bs[g * n + c]);
        if (isnan(z)) {
          nan = true;
        } else if (z > best) {
          best = z;
          idx = c;
        }
      }
      pred[pb] = nan ? n - 1 : idx;
    }
    *reinterpret_cast<int2*>(out + (b * 2 * H + 2 * i + a) * 2 * W + 2 * j) =
        make_int2(pred[0], pred[1]);
  }
}

constexpr int K1 = 128, THREADS1 = 128;

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS1)
head_argmax_1x1_kernel(const T* __restrict__ feats,
                       const T* __restrict__ w,
                       const float* __restrict__ bias, int* __restrict__ out,
                       long long M, int n) {
  __shared__ __align__(16) float Ws[K1 * NP];  // (K1, NP), zero past n
  __shared__ float bs[NP];
  for (int i = threadIdx.x; i < K1 * NP; i += blockDim.x) {
    const int k = i / NP, c = i % NP;
    Ws[i] = c < n ? to_f32(w[k * n + c]) : 0.0f;
  }
  for (int i = threadIdx.x; i < NP; i += blockDim.x)
    bs[i] = i < n ? bias[i] : 0.0f;
  __syncthreads();

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float acc[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) acc[c] = 0.0f;
  const T* src = feats + m * K1;
#pragma unroll 2
  for (int k0 = 0; k0 < K1; k0 += 8) {
    float f[8];
    load8(src + k0, f);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* wr = Ws + (k0 + kk) * NP;
#pragma unroll
      for (int c = 0; c < NP; ++c) acc[c] = fmaf(f[kk], wr[c], acc[c]);
    }
  }
  float best = __int_as_float(0xff800000);  // -inf
  int idx = 0;
  bool nan = false;
#pragma unroll
  for (int c = 0; c < NP; ++c) {
    if (c < n) {
      const float z = round_as<T>(acc[c] + bs[c]);
      if (isnan(z)) {
        nan = true;
      } else if (z > best) {
        best = z;
        idx = c;
      }
    }
  }
  out[m] = nan ? n - 1 : idx;
}

template <typename T, int NP>
cudaError_t launch_1x1(const void* feats, const void* w, const void* bias,
                       void* out, long long M, int n, cudaStream_t s) {
  const unsigned grid = (unsigned)((M + THREADS1 - 1) / THREADS1);
  head_argmax_1x1_kernel<T, NP><<<grid, THREADS1, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<int*>(out), M, n);
  return cudaGetLastError();
}

template <typename T>
int head_1x1(const void* feats, const void* w, const void* bias, void* out,
             int M, int n, void* stream) {
  if (M < 1 || n < 1 || n > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8) return launch_1x1<T, 8>(feats, w, bias, out, M, n, s);
  if (n <= 16) return launch_1x1<T, 16>(feats, w, bias, out, M, n, s);
  if (n <= 24) return launch_1x1<T, 24>(feats, w, bias, out, M, n, s);
  return launch_1x1<T, 32>(feats, w, bias, out, M, n, s);
}

template <typename T>
int head(const void* feats, const void* w, const void* bias, void* out,
         int B, int H, int W, int n, void* stream) {
  if (n < 1 || n > 256) return cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const size_t smem = (size_t)(K + 1) * 4 * n * sizeof(float);
  const unsigned grid = (unsigned)((M + THREADS - 1) / THREADS);
  head_argmax_kernel<T><<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<int*>(out), M, H, W, n);
  return cudaGetLastError();
}

}  // namespace

// feats: (M, 128) bf16; w: (128, n) bf16; bias: (n,) f32; out: (M,) int32.
// n <= 32 (the class count padded to NP = 8, 16, 24 or 32).
extern "C" int erf_head_argmax_1x1(const void* feats, const void* w,
                                   const void* bias, void* out, int M, int n,
                                   void* stream) {
  return head_1x1<bf16>(feats, w, bias, out, M, n, stream);
}

// The f32 form: feats (M, 128) f32, w (128, n) f32, logits not rounded.
extern "C" int erf_head_argmax_1x1_f32(const void* feats, const void* w,
                                       const void* bias, void* out, int M,
                                       int n, void* stream) {
  return head_1x1<float>(feats, w, bias, out, M, n, stream);
}

// feats: (B, H, W, 16) bf16; w: (16, 4n) bf16 (column block g = plane a*2+b);
// bias: (4n,) f32; out: (B, 2H, 2W) int32.
extern "C" int erf_head_argmax(const void* feats, const void* w,
                               const void* bias, void* out, int B, int H,
                               int W, int n, void* stream) {
  return head<bf16>(feats, w, bias, out, B, H, W, n, stream);
}

// The f32 form: feats (B, H, W, 16) f32, w (16, 4n) f32, logits not
// rounded.
extern "C" int erf_head_argmax_f32(const void* feats, const void* w,
                                   const void* bias, void* out, int B, int H,
                                   int W, int n, void* stream) {
  return head<float>(feats, w, bias, out, B, H, W, n, stream);
}
