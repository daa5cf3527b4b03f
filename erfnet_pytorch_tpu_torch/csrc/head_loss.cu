// Prediction head fused with the class-weighted NLL loss, forward and
// backward: G = 1, the encoder stage's 1x1 head (K = 128 features per
// row), and G = 4, the decoder's ConvTranspose2d(16, n, 2, s2) head as a
// (16 x 4n) product over the four parity planes (K = 16).
//
// Replaces erfnet_pytorch_tpu/ops/pallas/head_loss.py:make_head_loss
// (_fwd_kernel / _bwd_kernel) at G = 1 and G = 4; its W-packed G = 4p form
// is the same function on a reshaped view.  Per feature row m (a pixel,
// or the 2x2 output block of a pre-head pixel) and group p < G:
//
//   z = f_m . bf16(W) + b                    (K -> G n logits, f32)
//   mx = max over the row's G n logits
//   nll_p = mx + log(sum_c exp(z_p,c - mx)) - z_p,t;  w_p = cw[t]
//                                            (t = t_m,p; 0 outside [0, n))
//   num = sum w_p nll_p,  den = sum w_p       (the caller takes num / den)
//
// Backward (cotangent gnum of num; den has no gradient):
//
//   dz = bf16(gnum w_p (softmax_p(z) - onehot(t)))
//   dfeats = bf16(dz . bf16(W)^T);  dW = f^T dz;  db = sum_m dz   (f32)
//
// The logits never reach device memory.  One thread per row computes its
// G n logits on the CUDA cores in f32 (a row's products are exact in f32,
// as on the TPU's MXU); sums over rows go to per-CTA partials reduced in
// a fixed order.  At G = 1 the weight gradient is a separate launch over
// chunks of rows that reads the feats and the stored dz; at G = 4, where
// dz (M x 80) would be five times the features, each CTA keeps its rows'
// dz in shared memory and adds its share of dW and db there.
//
// Bound on this card: bytes (K bf16 features per row against 2 K G n
// operations).  This version runs the product on the CUDA cores, which at
// n = 20 is about at the byte bound's level; the tensor cores are the next
// step if it is not.
//
// The f32 forms (erf_head_loss*_f32, the JAX package's default compute
// dtype): the same kernels as templates on the element type T of feats,
// W, dz and dfeats.  At f32 the feature rows are read as f32, W is staged
// unrounded, and dz and dfeats are not rounded: f32 logits, f32 products,
// f32 sums, nothing rounded to bf16.  The G = 4 backward keeps its rows'
// f32 dz in (dynamic) shared memory, 41 KB per CTA.  Bound at f32: bytes
// (512 bytes per G = 1 row, 64 per G = 4 row, against 40 and 160 FMAs).
#include "common.cuh"

using namespace erfk;

namespace {

constexpr int K = 128, NMAX = 32, THREADS = 256;

template <typename T>
__device__ __forceinline__ void logits(const T* f, const float* Ws,
                                       const float* bs, int n, float* z) {
#pragma unroll
  for (int c = 0; c < NMAX; ++c) z[c] = 0.0f;
#pragma unroll 1
  for (int kv = 0; kv < K / 8; ++kv) {
    float fv[8];
    load8(f + kv * 8, fv);
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

// stage W (bf16 or f32) as f32 (K, NMAX) zero padded, the bias and the
// weights
template <typename T>
__device__ __forceinline__ void stage(const T* w, const float* bias,
                                      const float* cw, int n, float* Ws,
                                      float* bs, float* cws) {
  for (int i = threadIdx.x; i < K * NMAX; i += blockDim.x) {
    const int k = i / NMAX, c = i % NMAX;
    Ws[i] = c < n ? to_f32(w[k * n + c]) : 0.0f;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ feats, const T* __restrict__ w,
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_rows_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                const float* __restrict__ bias,
                const int* __restrict__ labels, const float* __restrict__ cw,
                const float* __restrict__ gnum, T* __restrict__ dz_out,
                T* __restrict__ dfeats, int M, int n) {
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
    z[c] = round_as<T>(gw * (p - (c == t ? 1.0f : 0.0f)));
    if (c < n) dz_out[m * n + c] = from_f32<T>(z[c]);
  }
  // dfeats[k] = sum_c dz[c] W[k, c], 8 features per store
  T* dst = dfeats + m * K;
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
    store_vec8(dst + kv * 8, o);
  }
}

// dW (K, n) and db (n,) partials over a chunk of CHUNK rows: thread
// (k = tid / 2, half = tid % 2) owns dW[k, half * 16 .. + 16); threads
// < n also sum db.  part[chunk] = [dW (K n), db (n)].
constexpr int CHUNK = 1024, SUB = 64;

template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ feats, const T* __restrict__ dz,
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
      fs[r][kk] = r0 + r < r_stop ? to_f32(feats[(r0 + r) * K + kk]) : 0.0f;
    }
    for (int e = threadIdx.x; e < SUB * NMAX; e += THREADS) {
      const int r = e / NMAX, c = e % NMAX;
      ds[r][c] = r0 + r < r_stop && c < n ? to_f32(dz[(r0 + r) * n + c])
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

// ---------------------------------------------------------------------------
// G = 4: the decoder head, K = 16, n <= 20 classes per plane
// ---------------------------------------------------------------------------

constexpr int K4 = 16, G4 = 4, NC4 = 20, GN4 = G4 * NC4, THREADS4 = 128;
constexpr int CHUNK4 = 1024;  // rows per CTA in the backward

// stage W (K4, G4 n) as f32 (K4, G4 NC4), column g NC4 + c, zero past n;
// the bias likewise; the class weights
template <typename T>
__device__ __forceinline__ void stage4(const T* w, const float* bias,
                                       const float* cw, int n, float* Ws,
                                       float* bs, float* cws) {
  for (int i = threadIdx.x; i < K4 * GN4; i += blockDim.x) {
    const int k = i / GN4, g = (i % GN4) / NC4, c = i % NC4;
    Ws[i] = c < n ? to_f32(w[k * G4 * n + g * n + c]) : 0.0f;
  }
  for (int i = threadIdx.x; i < GN4; i += blockDim.x) {
    const int g = i / NC4, c = i % NC4;
    bs[i] = c < n ? bias[g * n + c] : 0.0f;
  }
  for (int c = threadIdx.x; c < NC4; c += blockDim.x)
    cws[c] = c < n ? cw[c] : 0.0f;
  __syncthreads();
}

// z[g NC4 + c] for row m; returns the row max over the valid logits
template <typename T>
__device__ __forceinline__ float logits4(const T* f, const float* Ws,
                                         const float* bs, int n, float* fv,
                                         float* z) {
  load8(f, fv);
  load8(f + 8, fv + 8);
#pragma unroll
  for (int i = 0; i < GN4; ++i) z[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < K4; ++k)
#pragma unroll
    for (int i = 0; i < GN4; ++i) z[i] = fmaf(fv[k], Ws[k * GN4 + i], z[i]);
#pragma unroll
  for (int i = 0; i < GN4; ++i) z[i] += bs[i];
  float mx = -__int_as_float(0x7f800000);
#pragma unroll
  for (int i = 0; i < GN4; ++i)
    if (i % NC4 < n) mx = fmaxf(mx, z[i]);
  return mx;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fwd4_kernel(const T* __restrict__ feats, const T* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ labels,
            const float* __restrict__ cw, float* __restrict__ part, int M,
            int n) {
  __shared__ float Ws[K4 * GN4], bs[GN4], cws[NC4], red[THREADS];
  stage4(w, bias, cw, n, Ws, bs, cws);
  const long long m = (long long)blockIdx.x * THREADS + threadIdx.x;
  float num = 0.0f, den = 0.0f;
  if (m < M) {
    float fv[K4], z[GN4];
    const float mx = logits4(feats + m * K4, Ws, bs, n, fv, z);
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      float s = 0.0f, zt = 0.0f;
      const int t = __ldg(labels + m * G4 + g);
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        if (c < n) s += expf(z[g * NC4 + c] - mx);
        if (c == t) zt = z[g * NC4 + c];
      }
      const float wt = t >= 0 && t < n ? cws[t] : 0.0f;
      num += wt * (mx + logf(s) - zt);
      den += wt;
    }
  }
  num = block_sum(num, red);
  den = block_sum(den, red);
  if (threadIdx.x == 0) {
    part[2 * blockIdx.x] = num;
    part[2 * blockIdx.x + 1] = den;
  }
}

// Backward: each CTA takes CHUNK4 rows, THREADS4 at a time, one thread per
// row: dz (rounded to T) and dfeats; the block's dz and feats go to shared
// memory and thread t adds outputs o = t, t + THREADS4, ... of [dW (K4 x
// G4 n), db (G4 n)] over those rows.  part[cta] = the CTA's [dW, db].
constexpr int OUT4 = (K4 + 1) * GN4, PER4 = (OUT4 + THREADS4 - 1) / THREADS4;

// The rows' dz in shared memory, exact: bf16 bits, or f32.
template <typename T>
struct Dz4 {
  using S = float;
  static constexpr int LD = GN4 + 1;
  __device__ static S put(float v) { return v; }
  __device__ static float get(S v) { return v; }
};
template <>
struct Dz4<bf16> {
  using S = unsigned short;
  static constexpr int LD = GN4 + 2;
  __device__ static S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __device__ static float get(S v) {
    return __bfloat162float(__ushort_as_bfloat16(v));
  }
};

template <typename T>
constexpr size_t bwd4_smem() {
  return (size_t)THREADS4 * (K4 + 1) * 4 +
         (size_t)THREADS4 * Dz4<T>::LD * sizeof(typename Dz4<T>::S);
}

template <typename T>
__global__ void __launch_bounds__(THREADS4)
bwd4_kernel(const T* __restrict__ feats, const T* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ labels,
            const float* __restrict__ cw, const float* __restrict__ gnum,
            T* __restrict__ dfeats, float* __restrict__ part, int M,
            int n) {
  using D = Dz4<T>;
  __shared__ float Ws[K4 * GN4], bs[GN4], cws[NC4];
  extern __shared__ __align__(16) unsigned char dyn[];
  float (*fs)[K4 + 1] = reinterpret_cast<float (*)[K4 + 1]>(dyn);
  typename D::S (*ds)[D::LD] = reinterpret_cast<typename D::S (*)[D::LD]>(
      dyn + (size_t)THREADS4 * (K4 + 1) * 4);
  stage4(w, bias, cw, n, Ws, bs, cws);
  const int gn = G4 * n, len = (K4 + 1) * gn;
  float acc[PER4];
#pragma unroll
  for (int i = 0; i < PER4; ++i) acc[i] = 0.0f;
  const float gs = __ldg(gnum);
  const long long r_begin = (long long)blockIdx.x * CHUNK4;
  const long long r_stop = r_begin + CHUNK4 < M ? r_begin + CHUNK4 : M;
  for (long long r0 = r_begin; r0 < r_stop; r0 += THREADS4) {
    const long long m = r0 + threadIdx.x;
    float fv[K4], z[GN4];
    if (m < r_stop) {
      const float mx = logits4(feats + m * K4, Ws, bs, n, fv, z);
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const int i = g * NC4 + c;
          z[i] = c < n ? expf(z[i] - mx) : 0.0f;
          s += z[i];
        }
        const int t = __ldg(labels + m * G4 + g);
        const float gw = gs * (t >= 0 && t < n ? cws[t] : 0.0f);
        const float inv = 1.0f / s;
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const int i = g * NC4 + c;
          const float p = z[i] * inv;
          z[i] = c < n ? round_as<T>(gw * (p - (c == t ? 1.0f : 0.0f)))
                       : 0.0f;
        }
      }
      float o[K4];
#pragma unroll
      for (int k = 0; k < K4; ++k) {
        float a = 0.0f;
#pragma unroll
        for (int i = 0; i < GN4; ++i) a = fmaf(z[i], Ws[k * GN4 + i], a);
        o[k] = a;
      }
      store_vec8(dfeats + m * K4, o);
      store_vec8(dfeats + m * K4 + 8, o + 8);
    } else {
#pragma unroll
      for (int k = 0; k < K4; ++k) fv[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < GN4; ++i) z[i] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < K4; ++k) fs[threadIdx.x][k] = fv[k];
    // dz in the caller's column order g n + c
#pragma unroll
    for (int i = 0; i < GN4; ++i)
      if (i % NC4 < n)
        ds[threadIdx.x][(i / NC4) * n + i % NC4] = D::put(z[i]);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER4; ++e) {
      const int o = threadIdx.x + e * THREADS4;
      if (o < K4 * gn) {
        const int k = o / gn, col = o % gn;
        float a = acc[e];
        for (int r = 0; r < THREADS4; ++r)
          a = fmaf(fs[r][k], D::get(ds[r][col]), a);
        acc[e] = a;
      } else if (o < len) {
        const int col = o - K4 * gn;
        float a = acc[e];
        for (int r = 0; r < THREADS4; ++r)
          a += D::get(ds[r][col]);
        acc[e] = a;
      }
    }
    __syncthreads();
  }
  float* dst = part + (long long)blockIdx.x * len;
#pragma unroll
  for (int e = 0; e < PER4; ++e) {
    const int o = threadIdx.x + e * THREADS4;
    if (o < len) dst[o] = acc[e];
  }
}

// ------------------------------- launchers --------------------------------

template <typename T>
int fwd1(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, void* part, void* out, int M,
         int n, void* stream) {
  if (n < 1 || n > NMAX || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + THREADS - 1) / THREADS;
  fwd_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<float*>(part), M, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(out), 1, blocks, 2, s);
}

template <typename T>
int bwd1(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, const void* gnum, void* dz,
         void* dfeats, void* part, void* grads, int M, int n, void* stream) {
  if (n < 1 || n > NMAX || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bwd_rows_kernel<T><<<(M + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<const float*>(gnum),
      static_cast<T*>(dz), static_cast<T*>(dfeats), M, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int chunks = (M + CHUNK - 1) / CHUNK;
  wgrad_kernel<T><<<chunks, THREADS, 0, s>>>(static_cast<const T*>(feats),
                                             static_cast<const T*>(dz),
                                             static_cast<float*>(part), M, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks, K * n + n, s);
}

template <typename T>
int fwd4(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, void* part, void* out, int M,
         int n, void* stream) {
  if (n < 1 || n > NC4 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + THREADS - 1) / THREADS;
  fwd4_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<float*>(part), M, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(out), 1, blocks, 2, s);
}

template <typename T>
int bwd4(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, const void* gnum, void* dfeats,
         void* part, void* grads, int M, int n, void* stream) {
  if (n < 1 || n > NC4 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool ok = false;
  constexpr size_t smem = bwd4_smem<T>();
  cudaError_t e = allow_smem(bwd4_kernel<T>, smem, &ok);
  if (e != cudaSuccess) return e;
  const int chunks = (M + CHUNK4 - 1) / CHUNK4;
  bwd4_kernel<T><<<chunks, THREADS4, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<const float*>(gnum),
      static_cast<T*>(dfeats), static_cast<float*>(part), M, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, chunks,
                      (K4 + 1) * G4 * n, s);
}

}  // namespace

// ------------------------------ C interface -------------------------------
//
// The bf16 forms take feats, W, dz and dfeats in bf16; the _f32 forms the
// same operands in f32.  bias, cw, gnum, part, out and grads are f32 in
// both.

// feats: (M, 128); w: (128, n); bias, cw: (n,) f32; labels: (M,) int32;
// n <= 32.  Forward: part (ceil(M / 256), 2) f32 scratch; out (2,) f32 =
// [num, den].
extern "C" int erf_head_loss_fwd(const void* feats, const void* w,
                                 const void* bias, const void* labels,
                                 const void* cw, void* part, void* out,
                                 int M, int n, void* stream) {
  return fwd1<bf16>(feats, w, bias, labels, cw, part, out, M, n, stream);
}

extern "C" int erf_head_loss_fwd_f32(const void* feats, const void* w,
                                     const void* bias, const void* labels,
                                     const void* cw, void* part, void* out,
                                     int M, int n, void* stream) {
  return fwd1<float>(feats, w, bias, labels, cw, part, out, M, n, stream);
}

// Backward.  gnum: (1,) f32 on the device; dz: (M, n) scratch; dfeats:
// (M, 128); part: (ceil(M / 1024), 128 n + n) f32 scratch; grads:
// (128 n + n) f32 = [dW (128, n), db].
extern "C" int erf_head_loss_bwd(const void* feats, const void* w,
                                 const void* bias, const void* labels,
                                 const void* cw, const void* gnum, void* dz,
                                 void* dfeats, void* part, void* grads, int M,
                                 int n, void* stream) {
  return bwd1<bf16>(feats, w, bias, labels, cw, gnum, dz, dfeats, part,
                    grads, M, n, stream);
}

extern "C" int erf_head_loss_bwd_f32(const void* feats, const void* w,
                                     const void* bias, const void* labels,
                                     const void* cw, const void* gnum,
                                     void* dz, void* dfeats, void* part,
                                     void* grads, int M, int n,
                                     void* stream) {
  return bwd1<float>(feats, w, bias, labels, cw, gnum, dz, dfeats, part,
                     grads, M, n, stream);
}

// G = 4.  feats: (M, 16); w: (16, 4n), column g n + c for plane g =
// a*2+b; bias: (4n,) f32; labels: (M, 4) int32 in plane order; cw: (n,)
// f32; n <= 20.  Forward: part (ceil(M / 256), 2) f32 scratch; out (2,)
// f32 = [num, den].
extern "C" int erf_head_loss4_fwd(const void* feats, const void* w,
                                  const void* bias, const void* labels,
                                  const void* cw, void* part, void* out,
                                  int M, int n, void* stream) {
  return fwd4<bf16>(feats, w, bias, labels, cw, part, out, M, n, stream);
}

extern "C" int erf_head_loss4_fwd_f32(const void* feats, const void* w,
                                      const void* bias, const void* labels,
                                      const void* cw, void* part, void* out,
                                      int M, int n, void* stream) {
  return fwd4<float>(feats, w, bias, labels, cw, part, out, M, n, stream);
}

// G = 4 backward.  gnum: (1,) f32 on the device; dfeats: (M, 16); part:
// (ceil(M / 1024), 17 * 4n) f32 scratch; grads (17 * 4n) f32 = [dW (16,
// 4n), db (4n)].
extern "C" int erf_head_loss4_bwd(const void* feats, const void* w,
                                  const void* bias, const void* labels,
                                  const void* cw, const void* gnum,
                                  void* dfeats, void* part, void* grads,
                                  int M, int n, void* stream) {
  return bwd4<bf16>(feats, w, bias, labels, cw, gnum, dfeats, part, grads,
                    M, n, stream);
}

extern "C" int erf_head_loss4_bwd_f32(const void* feats, const void* w,
                                      const void* bias, const void* labels,
                                      const void* cw, const void* gnum,
                                      void* dfeats, void* part, void* grads,
                                      int M, int n, void* stream) {
  return bwd4<float>(feats, w, bias, labels, cw, gnum, dfeats, part, grads,
                     M, n, stream);
}
