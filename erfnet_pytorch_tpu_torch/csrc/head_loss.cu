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
// The logits and dz never reach device memory; sums over rows go to
// per-CTA partials reduced in a fixed order, so a step is bit-
// reproducible.  The forward (fwd_kernel, fwd4_kernel): one thread a row
// computes its G n logits on the CUDA cores in f32 (a row's products are
// exact in f32, as on the TPU's MXU), at G = 1 over NMAX = 32 zero-padded
// classes (0.036 ms at B=6 against the library's 0.045: left as it is).
// The G = 1 backward is one pass (bwd1_kernel): persistent CTAs, one wave,
// each over a chunk of rows in blocks of 128 staged with 16-byte cp.async
// (the next block in flight); per block the logits, softmax and dz over
// 20 columns of W at n = 20, else 32 (two threads a row), [dW | db] +=
// F^T [dz | 1] on an FFMA micro-tile with the rows as its depth, then
// dfeats = dz . W^T staged in the block's feats buffer and written 16
// bytes a thread.
// The two launches it replaced (a thread a row over 32 classes writing dz
// (M x n) to device memory, then a weight gradient over 48 CTAs of 1024
// rows that read it back) took 0.27 ms at B=6 (PERF.md §6).  At G = 4,
// where dz (M x 80) would be five times the features, each CTA keeps its
// rows' dz in shared memory and adds its share of dW and db there.
//
// Bound on this card at G = 1, B=6 (M = 49152, n = 20): bytes, 2 M K
// bf16 values read and written against 3 M K n FMAs (0.0114 ms; at f32
// 0.0227 ms, and the products on the CUDA cores at 67 TFLOP/s take 0.011
// ms).  What is left: the logits and dfeats loops read W from shared
// memory at about one 16-byte load per 4 FMAs (two threads a row); the
// tensor cores are the next step if the pass stays above its bound.
//
// The f32 forms (erf_head_loss*_f32, the JAX package's default compute
// dtype): the same kernels as templates on the element type T of feats,
// W, dz and dfeats.  At f32 the feature rows are read as f32, W is staged
// unrounded, and dz and dfeats are not rounded: f32 logits, f32 products,
// f32 sums, nothing rounded to bf16.  The G = 4 backward keeps its rows'
// f32 dz in (dynamic) shared memory, 41 KB per CTA; the G = 1 backward
// stages its blocks of feats in f32 (64 KB each).  Bound at f32: bytes
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
      if (c == t && c < n) zt = z[c];  // a label in [n, NMAX) weighs 0
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

// ---------------------------------------------------------------------------
// G = 1 backward: one pass (bwd1_kernel)
// ---------------------------------------------------------------------------
//
// Persistent CTAs, one wave: CTA c owns rows [c rows, (c + 1) rows) of the
// M feature rows (rows = head_loss_rows(M): at least R1, and enough that
// the CTAs fit the SMs once) and takes them in blocks of R1 rows, the next
// block's feats in flight (16-byte cp.async, coalesced) while this one
// computes.  A staged row keeps its K values in T, its 16-byte chunk e at
// chunk e ^ swz1(r).  Per block:
//  1. Stage one, two threads a row: thread (r, h) sums the logits of row r
//     over its half of K, chunks j = 2 i + h (one FMA chain per class in
//     increasing k), for NP columns of W (staged once as f32, zero past
//     n; NP = 20 for the encoder's 17-20 classes, else 32); the two
//     halves are added (a shuffle), then the bias.  Both
//     threads take the softmax and dz = round_T(gnum w[t] (p - onehot))
//     and write their half of the row's dz to Ds (f32: a bf16 dz is
//     exact there).
//  2. Stage two: [dW | db] += F^T [dz | 1] over the block's rows, an FFMA
//     micro-tile with the rows as its depth: warp w takes rows [w KL1,
//     (w + 1) KL1) of every block, lane l owns dW rows k = 4 l .. 4 l + 3
//     and all NP columns (one FMA chain per output over the warp's rows in
//     order); lane c < n of warp w sums db[c] over the same rows.
//  3. dfeats = round_T(dz . W^T), two threads a row (thread (r, h) its
//     chunks j = 2 i + h, one FMA chain per output over c), staged in
//     the block's own feats buffer (read by then) and written 16 bytes a
//     thread.
// At the end the eight warps' sums are added in warp order: the CTA's
// partial part[c] = [dW (K n) | db (n)], reduced over the CTAs in a fixed
// order by a second launch.  dz never leaves the CTA.
constexpr int R1 = 128, THREADS1 = 256, WK1 = THREADS1 / 32, KL1 = R1 / WK1;
constexpr int CTAS1 = 1;  // CTAs an SM (registers: 4 NP dW sums a thread)

// staged feature rows of T: 16-byte chunks, 8 bf16 or 4 f32 a chunk;
// chunk e of row r at chunk e ^ swz1(r), so that the 8 lanes of a quarter
// warp (rows r .. r + 3, halves h = 0, 1, chunks 2 i + h) fall on 8 bank
// groups
template <typename T>
struct Rows1 {
  static constexpr int VPC = 16 / (int)sizeof(T), CPR = K / VPC;
  static constexpr size_t bytes = (size_t)R1 * K * sizeof(T);
};
__device__ __forceinline__ int swz1(int r) { return 2 * (r & 3); }

// W (K, n) staged as f32 (K, NP), zero past n: row k at chunk k PC + (k >>
// 3), PC odd, so that the rows the two halves of a row read at once (4
// apart at f32, 8 apart at bf16) fall on distinct bank groups
template <int NP>
struct W1 {
  static constexpr int PC = (NP / 4) % 2 ? NP / 4 : NP / 4 + 1;
  static constexpr size_t bytes = ((size_t)K * PC + K / 8) * 16;
  __device__ static float* row(float* Ws, int k) {
    return Ws + 4 * (k * PC + (k >> 3));
  }
};

template <typename T, int NP>
struct Bwd1 {
  using F = Rows1<T>;
  static constexpr size_t w_off = 2 * F::bytes;  // two feats buffers
  static constexpr size_t d_off = w_off + (W1<NP>::bytes + 127) / 128 * 128;
  static constexpr size_t work = d_off + (size_t)R1 * NP * 4;
  // the warps' [dW | db] sums at the end, over the dead buffers
  static constexpr size_t red = (size_t)WK1 * (K + 1) * NP * 4;
  static constexpr size_t smem = work > red ? work : red;
  static_assert(NP % 4 == 0 && NP <= NMAX && F::CPR % 2 == 0 &&
                    THREADS1 == 2 * R1 && smem <= 232448,
                "G = 1 backward tile");
};

// this thread's 16-byte chunk of a staged row -> VPC f32 values
__device__ __forceinline__ void chunk_f32(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void chunk_f32(const bf16* p, float* v) {
  unpack_bf16x8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void chunk_store(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void chunk_store(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack_bf16x8(v);
}
// values 4 l .. 4 l + 3 of a staged row (lane l of stage two)
__device__ __forceinline__ void quad_f32(const float* row, int r, int l,
                                         float* v) {
  chunk_f32(row + 4 * (l ^ swz1(r)), v);
}
__device__ __forceinline__ void quad_f32(const bf16* row, int r, int l,
                                         float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(
      row + 8 * ((l >> 1) ^ swz1(r)) + 4 * (l & 1));
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int NP>
__global__ void __launch_bounds__(THREADS1, CTAS1)
bwd1_kernel(const T* __restrict__ feats, const T* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ labels,
            const float* __restrict__ cw, const float* __restrict__ gnum,
            T* __restrict__ dfeats, float* __restrict__ part, int M, int n,
            int rows) {
  using G = Bwd1<T, NP>;
  using F = Rows1<T>;
  constexpr int VPC = F::VPC, CPR = F::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem + G::w_off);
  float* Ds = reinterpret_cast<float*>(smem + G::d_off);
  __shared__ float bs[NP], cws[NP];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = tid >> 1, h = tid & 1;  // stage one and three: row, half
  const long long c_begin = (long long)blockIdx.x * rows;
  const long long c_end = c_begin + rows < M ? c_begin + rows : M;
  const int blocks = (int)((c_end - c_begin + R1 - 1) / R1);
  auto buf = [&](int kb) {
    return reinterpret_cast<T*>(smem + (kb & 1) * F::bytes);
  };
  // block kb's rows into buf(kb), zero past the chunk
  auto issue = [&](int kb) {
    if (kb < blocks) {
      const long long r0 = c_begin + (long long)kb * R1;
      T* dst = buf(kb);
      for (int v = tid; v < R1 * CPR; v += THREADS1) {
        const int rr = v / CPR, e = v % CPR;
        const bool valid = r0 + rr < c_end;
        cp_async16(dst + rr * K + VPC * (e ^ swz1(rr)),
                   feats + (valid ? (r0 + rr) * K + VPC * e : 0), valid);
      }
    }
    cp_async_commit();
  };
  issue(0);
  for (int i = tid; i < K * NP; i += THREADS1) {
    const int k = i / NP, c = i % NP;
    W1<NP>::row(Ws, k)[c] = c < n ? to_f32(w[k * n + c]) : 0.0f;
  }
  if (tid < NP) {
    bs[tid] = tid < n ? bias[tid] : 0.0f;
    cws[tid] = tid < n ? cw[tid] : 0.0f;
  }
  const float gs = __ldg(gnum);
  float acc[4][NP], dbs = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[i][c] = 0.0f;

  for (int kb = 0; kb < blocks; ++kb) {
    const long long r0 = c_begin + (long long)kb * R1;
    const int nvalid = (int)(c_end - r0 < R1 ? c_end - r0 : R1);
    T* Fb = buf(kb);
    cp_async_wait_group<0>();  // block kb, the only group in flight
    __syncthreads();
    // block kb + 1 into the buffer block kb - 1 left: the barrier above
    // ends its dfeats copy-out
    issue(kb + 1);

    // 1. logits, softmax, dz of row r
    {
      const T* frow = Fb + r * K;
      float z[NP];
#pragma unroll
      for (int c = 0; c < NP; ++c) z[c] = 0.0f;
#pragma unroll 2
      for (int i = 0; i < CPR / 2; ++i) {
        const int j = 2 * i + h;
        float fv[VPC];
        chunk_f32(frow + VPC * (j ^ swz1(r)), fv);
#pragma unroll
        for (int kk = 0; kk < VPC; ++kk) {
          const float* wr = W1<NP>::row(Ws, j * VPC + kk);
#pragma unroll
          for (int c4 = 0; c4 < NP / 4; ++c4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * c4);
            z[4 * c4] = fmaf(fv[kk], wv.x, z[4 * c4]);
            z[4 * c4 + 1] = fmaf(fv[kk], wv.y, z[4 * c4 + 1]);
            z[4 * c4 + 2] = fmaf(fv[kk], wv.z, z[4 * c4 + 2]);
            z[4 * c4 + 3] = fmaf(fv[kk], wv.w, z[4 * c4 + 3]);
          }
        }
      }
      // the halves added (h = 0's + h = 1's, the same in both lanes), the
      // bias; -inf past the n classes
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        z[c] += __shfl_xor_sync(0xffffffffu, z[c], 1);
        z[c] = c < n ? z[c] + bs[c] : -__int_as_float(0x7f800000);
      }
      float mx = z[0];
#pragma unroll
      for (int c = 1; c < NP; ++c) mx = fmaxf(mx, z[c]);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        z[c] = c < n ? expf(z[c] - mx) : 0.0f;
        s += z[c];
      }
      const int t = r < nvalid ? __ldg(labels + r0 + r) : -1;
      const float gw = gs * (t >= 0 && t < n ? cws[t] : 0.0f);
      const float inv = 1.0f / s;
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        const float p = z[c] * inv;
        z[c] = r < nvalid && c < n
                   ? round_as<T>(gw * (p - (c == t ? 1.0f : 0.0f)))
                   : 0.0f;
      }
#pragma unroll
      for (int c4 = 0; c4 < NP / 4; ++c4)
        if ((c4 & 1) == h)
          *reinterpret_cast<float4*>(Ds + r * NP + 4 * c4) =
              make_float4(z[4 * c4], z[4 * c4 + 1], z[4 * c4 + 2],
                          z[4 * c4 + 3]);
    }
    __syncthreads();

    // 2. [dW | db] over this warp's rows of the block
    {
      const int stop = min((warp + 1) * KL1, nvalid);
      for (int rr = warp * KL1; rr < stop; ++rr) {
        float f[4], d[NP];
        quad_f32(Fb + rr * K, rr, lane, f);
#pragma unroll
        for (int c4 = 0; c4 < NP / 4; ++c4) {
          const float4 v = *reinterpret_cast<const float4*>(Ds + rr * NP +
                                                            4 * c4);
          d[4 * c4] = v.x; d[4 * c4 + 1] = v.y;
          d[4 * c4 + 2] = v.z; d[4 * c4 + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NP; ++c) acc[i][c] = fmaf(f[i], d[c], acc[i][c]);
        if (lane < NP) dbs += Ds[rr * NP + lane];
      }
    }
    __syncthreads();  // F is read: its buffer stages dfeats

    // 3. dfeats of row r, this thread's chunks, into the buffer
    {
      float d[NP];
#pragma unroll
      for (int c4 = 0; c4 < NP / 4; ++c4) {
        const float4 v = *reinterpret_cast<const float4*>(Ds + r * NP + 4 * c4);
        d[4 * c4] = v.x; d[4 * c4 + 1] = v.y;
        d[4 * c4 + 2] = v.z; d[4 * c4 + 3] = v.w;
      }
      T* frow = Fb + r * K;
#pragma unroll 2
      for (int i = 0; i < CPR / 2; ++i) {
        const int j = 2 * i + h;
        float o[VPC];
#pragma unroll
        for (int kk = 0; kk < VPC; ++kk) {
          const float* wr = W1<NP>::row(Ws, j * VPC + kk);
          float a = 0.0f;
#pragma unroll
          for (int c4 = 0; c4 < NP / 4; ++c4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * c4);
            a = fmaf(d[4 * c4], wv.x, a);
            a = fmaf(d[4 * c4 + 1], wv.y, a);
            a = fmaf(d[4 * c4 + 2], wv.z, a);
            a = fmaf(d[4 * c4 + 3], wv.w, a);
          }
          o[kk] = a;
        }
        chunk_store(frow + VPC * (j ^ swz1(r)), o);
      }
    }
    __syncthreads();
    // whole rows, 16 bytes a thread: the block's rows are consecutive
    for (int v = tid; v < nvalid * CPR; v += THREADS1) {
      const int rr = v / CPR, e = v % CPR;
      *reinterpret_cast<uint4*>(dfeats + (r0 + rr) * K + VPC * e) =
          *reinterpret_cast<const uint4*>(Fb + rr * K + VPC * (e ^ swz1(rr)));
    }
    // buf(kb) is refilled only by block kb + 2, issued after the next
    // iteration's barrier
  }
  cp_async_wait_all();
  __syncthreads();  // every buffer is dead: red may alias them
  float* red = reinterpret_cast<float*>(smem);
  const int len = (K + 1) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NP; ++c)
      if (c < n) red[warp * len + (4 * lane + i) * n + c] = acc[i][c];
  if (lane < n) red[warp * len + K * n + lane] = dbs;
  __syncthreads();
  float* dst = part + (long long)blockIdx.x * len;
  for (int e = tid; e < len; e += THREADS1) {
    float a = 0.0f;
    for (int wi = 0; wi < WK1; ++wi) a += red[wi * len + e];
    dst[e] = a;
  }
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

// Rows a G = 1 backward CTA owns: at least R1, and enough that the
// CTAs (CTAS1 an SM) fit the device's SMs once; 0 on a CUDA error.
int head_loss_rows(int M) {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 &&
      (cudaGetDevice(&dev) != cudaSuccess ||
       cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
           cudaSuccess))
    return 0;
  if (sms < 1 || M < 1) return 0;
  const long long per = ((long long)M + sms * CTAS1 - 1) / (sms * CTAS1);
  return (int)(per > R1 ? per : R1);
}

template <typename T, int NP>
cudaError_t bwd1_launch(const void* feats, const void* w, const void* bias,
                        const void* labels, const void* cw, const void* gnum,
                        void* dfeats, void* part, int M, int n, int rows,
                        int ctas, cudaStream_t s) {
  using G = Bwd1<T, NP>;
  static bool ok = false;
  cudaError_t e = allow_smem(bwd1_kernel<T, NP>, G::smem, &ok);
  if (e != cudaSuccess) return e;
  bwd1_kernel<T, NP><<<ctas, THREADS1, G::smem, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<const float*>(gnum),
      static_cast<T*>(dfeats), static_cast<float*>(part), M, n, rows);
  return cudaGetLastError();
}

// Launches: the one-pass kernel (20 or 32 columns of W), then the
// reduction of its per-CTA partials.
template <typename T>
int bwd1(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, const void* gnum, void* dfeats,
         void* part, void* grads, int M, int n, void* stream) {
  if (n < 1 || n > NMAX || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = head_loss_rows(M);
  if (rows < 1) return cudaErrorInvalidValue;
  const int ctas = (M + rows - 1) / rows;
#define ERF_BWD1(NP)                                                      \
  bwd1_launch<T, NP>(feats, w, bias, labels, cw, gnum, dfeats, part, M, n, \
                     rows, ctas, s)
  // the encoder's 20 classes, else 32 columns, zero past n
  cudaError_t e = n > 16 && n <= 20 ? ERF_BWD1(20) : ERF_BWD1(32);
#undef ERF_BWD1
  if (e != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, ctas, K * n + n, s);
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
// The bf16 forms take feats, W and dfeats in bf16; the _f32 forms the
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

// Backward.  gnum: (1,) f32 on the device; dfeats: (M, 128); part:
// (ceil(M / erf_head_loss_rows(M)), 128 n + n) f32 scratch, one partial a
// CTA; grads: (128 n + n) f32 = [dW (128, n), db].
extern "C" int erf_head_loss_bwd(const void* feats, const void* w,
                                 const void* bias, const void* labels,
                                 const void* cw, const void* gnum,
                                 void* dfeats, void* part, void* grads, int M,
                                 int n, void* stream) {
  return bwd1<bf16>(feats, w, bias, labels, cw, gnum, dfeats, part, grads, M,
                    n, stream);
}

extern "C" int erf_head_loss_bwd_f32(const void* feats, const void* w,
                                     const void* bias, const void* labels,
                                     const void* cw, const void* gnum,
                                     void* dfeats, void* part, void* grads,
                                     int M, int n, void* stream) {
  return bwd1<float>(feats, w, bias, labels, cw, gnum, dfeats, part, grads,
                     M, n, stream);
}

// Rows per CTA of the G = 1 backward for M rows (its partials: ceil(M /
// rows)); 0 on a CUDA error.
extern "C" int erf_head_loss_rows(int M) { return head_loss_rows(M); }

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
