// Decoder head + argmax: ConvTranspose2d(16, n, k2 s2) as a parity-plane
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
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int K = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
head_argmax_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                   const float* __restrict__ bias, int* __restrict__ out,
                   long long M, int H, int W, int n) {
  extern __shared__ float sm[];
  float* Ws = sm;              // (K, 4n)
  float* bs = sm + K * 4 * n;  // (4n,)
  for (int i = threadIdx.x; i < K * 4 * n; i += blockDim.x)
    Ws[i] = __bfloat162float(w[i]);
  for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();

  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  float f[K];
  const uint4* src = reinterpret_cast<const uint4*>(feats + m * K);
  unpack_bf16x8(__ldg(src), f);
  unpack_bf16x8(__ldg(src + 1), f + 8);
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
        const float z = __bfloat162float(__float2bfloat16(acc + bs[g * n + c]));
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

}  // namespace

// feats: (B, H, W, 16) bf16; w: (16, 4n) bf16 (column block g = plane a*2+b);
// bias: (4n,) f32; out: (B, 2H, 2W) int32.
extern "C" int erf_head_argmax(const void* feats, const void* w,
                               const void* bias, void* out, int B, int H,
                               int W, int n, void* stream) {
  if (n < 1 || n > 256) return cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const size_t smem = (size_t)(K + 1) * 4 * n * sizeof(float);
  const unsigned grid = (unsigned)((M + THREADS - 1) / THREADS);
  head_argmax_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<int*>(out), M, H, W, n);
  return cudaGetLastError();
}
