// Prediction head fused with the class-weighted NLL loss, forward and
// backward, for the encoder stage's 1x1 head (G = 1).
//
// Replaces erfnet_pytorch_tpu/ops/pallas/head_loss.py:make_head_loss
// (_fwd_kernel / _bwd_kernel) at G = 1.  Per feature row m (a pixel):
//
//   z = f_m . bf16(W) + b                    (K = 128 -> n classes, f32)
//   nll = logsumexp(z) - z[t_m];  w = cw[t_m]  (0 outside [0, n))
//   num = sum_m w nll,  den = sum_m w         (the caller takes num / den)
//
// Backward (cotangent gnum of num; den has no gradient):
//
//   dz = bf16(gnum w (softmax(z) - onehot(t)))
//   dfeats = bf16(dz . bf16(W)^T);  dW = f^T dz;  db = sum_m dz   (f32)
//
// The logits never reach device memory.  One thread per row computes its
// n logits on the CUDA cores in f32 (a row's products are exact in f32, as
// on the TPU's MXU); sums over rows go to per-CTA partials reduced in a
// fixed order.  The weight gradient is a separate launch over chunks of
// rows that reads the feats and the stored dz.
//
// Bound on this card: bytes (128 bf16 features per row against 2 x 128 x n
// operations).  This version runs the product on the CUDA cores, which at
// n = 20 is about at the byte bound's level; the tensor cores are the next
// step if it is not.
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int K = 128, NMAX = 32, THREADS = 256;

__device__ __forceinline__ void logits(const bf16* f, const float* Ws,
                                       const float* bs, int n, float* z) {
#pragma unroll
  for (int c = 0; c < NMAX; ++c) z[c] = 0.0f;
  const uint4* src = reinterpret_cast<const uint4*>(f);
#pragma unroll 1
  for (int kv = 0; kv < K / 8; ++kv) {
    float fv[8];
    unpack_bf16x8(__ldg(src + kv), fv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* wr = Ws + (kv * 8 + i) * NMAX;
#pragma unroll
      for (int c = 0; c < NMAX; ++c) z[c] = fmaf(fv[i], wr[c], z[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < NMAX; ++c)  // -inf past the n classes
    z[c] = c < n ? z[c] + bs[c] : -__int_as_float(0x7f800000);
}

// stage bf16(W) as f32 (K, NMAX) zero padded, the bias and the weights
__device__ __forceinline__ void stage(const bf16* w, const float* bias,
                                      const float* cw, int n, float* Ws,
                                      float* bs, float* cws) {
  for (int i = threadIdx.x; i < K * NMAX; i += blockDim.x) {
    const int k = i / NMAX, c = i % NMAX;
    Ws[i] = c < n ? __bfloat162float(w[k * n + c]) : 0.0f;
  }
  for (int c = threadIdx.x; c < NMAX; c += blockDim.x) {
    bs[c] = c < n ? bias[c] : 0.0f;
    cws[c] = c < n ? cw[c] : 0.0f;
  }
  __syncthreads();
}

// fixed-order sum of one value per thread; result valid in thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s /= 2) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
           const float* __restrict__ bias, const int* __restrict__ labels,
           const float* __restrict__ cw, float* __restrict__ part, int M,
           int n) {
  __shared__ float Ws[K * NMAX], bs[NMAX], cws[NMAX], red[THREADS];
  stage(w, bias, cw, n, Ws, bs, cws);
  const long long m = (long long)blockIdx.x * THREADS + threadIdx.x;
  float num = 0.0f, den = 0.0f;
  if (m < M) {
    float z[NMAX];
    logits(feats + m * K, Ws, bs, n, z);
    float mx = z[0];
#pragma unroll
    for (int c = 1; c < NMAX; ++c) mx = fmaxf(mx, z[c]);
    float s = 0.0f, zt = 0.0f;
    const int t = __ldg(labels + m);
#pragma unroll
    for (int c = 0; c < NMAX; ++c) {
      if (c < n) s += expf(z[c] - mx);
      if (c == t) zt = z[c];
    }
    const float wt = t >= 0 && t < n ? cws[t] : 0.0f;
    num = wt * (mx + logf(s) - zt);
    den = wt;
  }
  num = block_sum(num, red);
  den = block_sum(den, red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ w,
                const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ cw,
                const float* __restrict__ gnum, bf16* __restrict__ dz_out,
                bf16* __restrict__ dfeats, int M, int n) {
  __shared__ float Ws[K * NMAX], bs[NMAX], cws[NMAX];
  stage(w, bias, cw, n, Ws, bs, cws);
  const long long m = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  float z[NMAX];
  logits(feats + m * K, Ws, bs, n, z);
  float mx = z[0];
#pragma unroll
  for (int c = 1; c < NMAX; ++c) mx = fmaxf(mx, z[c]);
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < NMAX; ++c) {
    z[c] = c < n ? expf(z[c] - mx) : 0.0f;
    s += z[c];
  }
  const int t = __ldg(labels + m);
  const float gw = __ldg(gnum) * (t >= 0 && t < n ? cws[t] : 0.0f);
  const float inv = 1.0f / s;
#pragma unroll
  for (int c = 0; c < NMAX; ++c) {
    const float p = z[c] * inv;
    z[c] = __bfloat162float(
        __float2bfloat16(gw * (p - (c == t ? 1.0f : 0.0f))));
    if (c < n) dz_out[m * n + c] = __float2bfloat16(z[c]);
  }
  // dfeats[k] = sum_c dz[c] W[k, c], 8 features per 16-byte store
  uint4* dst = reinterpret_cast<uint4*>(dfeats + m * K);
#pragma unroll 1
  for (int kv = 0; kv < K / 8; ++kv) {
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* wr = Ws + (kv * 8 + i) * NMAX;
      float a = 0.0f;
#pragma unroll
      for (int c = 0; c < NMAX; ++c) a = fmaf(z[c], wr[c], a);
      o[i] = a;
    }
    dst[kv] = pack_bf16x8(o);
  }
}

// dW (K, n) and db (n,) partials over a chunk of CHUNK rows: thread
// (k = tid / 2, half = tid % 2) owns dW[k, half * 16 .. + 16); threads
// < n also sum db.  part[chunk] = [dW (K n), db (n)].
constexpr int CHUNK = 1024, SUB = 64;

__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const bf16* __restrict__ feats, const bf16* __restrict__ dz,
             float* __restrict__ part, int M, int n) {
  __shared__ float fs[SUB][K + 1];
  __shared__ float ds[SUB][NMAX];
  const int k = threadIdx.x / 2, half = threadIdx.x % 2;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  float dbs = 0.0f;
  const long long r_begin = (long long)blockIdx.x * CHUNK;
  const long long r_stop = r_begin + CHUNK < M ? r_begin + CHUNK : M;
  for (long long r0 = r_begin; r0 < r_stop; r0 += SUB) {
    for (int e = threadIdx.x; e < SUB * K; e += THREADS) {
      const int r = e / K, kk = e % K;
      fs[r][kk] = r0 + r < r_stop ? __bfloat162float(feats[(r0 + r) * K + kk])
                                  : 0.0f;
    }
    for (int e = threadIdx.x; e < SUB * NMAX; e += THREADS) {
      const int r = e / NMAX, c = e % NMAX;
      ds[r][c] = r0 + r < r_stop && c < n
                     ? __bfloat162float(dz[(r0 + r) * n + c])
                     : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < SUB; ++r) {
      const float f = fs[r][k];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(f, ds[r][half * 16 + i], acc[i]);
    }
    if (threadIdx.x < n)
      for (int r = 0; r < SUB; ++r) dbs += ds[r][threadIdx.x];
    __syncthreads();
  }
  float* dst = part + (long long)blockIdx.x * (K * n + n);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = half * 16 + i;
    if (c < n) dst[k * n + c] = acc[i];
  }
  if (threadIdx.x < n) dst[K * n + threadIdx.x] = dbs;
}

}  // namespace

// feats: (M, 128) bf16; w: (128, n) bf16; bias, cw: (n,) f32; labels: (M,)
// int32; n <= 32.  Forward: part (ceil(M / 256), 2) f32 scratch; out (2,)
// f32 = [num, den].
extern "C" int erf_head_loss_fwd(const void* feats, const void* w,
                                 const void* bias, const void* labels,
                                 const void* cw, void* part, void* out,
                                 int M, int n, void* stream) {
  if (n < 1 || n > NMAX || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + THREADS - 1) / THREADS;
  fwd_kernel<<<blocks, THREADS, 0, s>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<float*>(part), M, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(out), 1, blocks, 2, s);
}

// Backward.  gnum: (1,) f32 on the device; dz: (M, n) bf16 scratch;
// dfeats: (M, 128) bf16; part: (ceil(M / 1024), 128 n + n) f32 scratch;
// grads: (128 n + n) f32 = [dW (128, n), db].
extern "C" int erf_head_loss_bwd(const void* feats, const void* w,
                                 const void* bias, const void* labels,
                                 const void* cw, const void* gnum, void* dz,
                                 void* dfeats, void* part, void* grads, int M,
                                 int n, void* stream) {
  if (n < 1 || n > NMAX || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_rows_kernel<<<(M + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<const float*>(gnum),
      static_cast<bf16*>(dz), static_cast<bf16*>(dfeats), M, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int chunks = (M + CHUNK - 1) / CHUNK;
  wgrad_kernel<<<chunks, THREADS, 0, s>>>(static_cast<const bf16*>(feats),
                                          static_cast<const bf16*>(dz),
                                          static_cast<float*>(part), M, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks, K * n + n, s);
}
