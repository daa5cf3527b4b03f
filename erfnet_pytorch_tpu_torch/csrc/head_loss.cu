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
// reproducible.  The G = 1 forward (fwd_kernel): one thread a row computes
// its n logits on the CUDA cores in f32 (a row's products are exact in
// f32, as on the TPU's MXU) over NMAX = 32 zero-padded classes (0.036 ms
// at B=6 against the library's 0.045: left as it is).  The G = 1 backward
// is one pass (bwd1_kernel): persistent CTAs, one wave, each over a chunk
// of rows in blocks of 128 staged with 16-byte cp.async (the next block
// in flight); per block the logits, softmax and dz over 20 columns of W
// at n = 20, else 32 (two threads a row), [dW | db] += F^T [dz | 1] on an
// FFMA micro-tile with the rows as its depth, then dfeats = dz . W^T
// staged in the block's feats buffer and written 16 bytes a thread.  The
// two launches it replaced (a thread a row over 32 classes writing dz (M x
// n) to device memory, then a weight gradient over 48 CTAs of 1024 rows
// that read it back) took 0.27 ms at B=6 (PERF.md §6).
//
// Both G = 4 passes (fwd4_kernel, bwd4_kernel) take the same shape: one
// wave of persistent CTAs (two an SM, 256 threads), each over a chunk of
// rows in blocks of 128, a block's feature rows and labels staged with
// 16-byte cp.async, three blocks in flight while the CTA computes; a
// thread computes one plane's 20 logits for 2 rows, a register tile that
// reads each W float4 (staged once as f32) once for its 2 rows, and the
// row max is taken across the row's four threads by shuffles.  The
// forward adds w nll over each thread's rows and writes one [num, den]
// partial a CTA.  The backward keeps the block's dz in shared memory (dz
// (M x 80) would be five times the features), forms dfeats from the four
// planes' partial sums (a thread's, for its rows, added across the row's
// threads) and adds [dW | db] += F^T [dz | 1] on an FFMA micro-tile (a
// lane 4 x 10 outputs over its warp's 16 rows of each block), one partial
// of 1360 floats a CTA.  So reduce_parts adds 264 rows on an H100 each
// way, where one partial a 1024 rows (768 CTAs of 128 threads, dW summed
// straight from shared memory) and one a 256 rows of the forward (3072)
// took it before.  Latency, not the FMA rate, sets the passes' pace
// (scripts/cuda_head4_variants.py times their parts and the other tiles;
// PERF.md §6).
//
// Bound on this card (chip_smoke.py _flops_bytes_head: 2 M K G n flops
// forward and 4 M K G n backward, the feature rows read once a pass, the
// labels, dfeats written): at G = 1, B=6 (M = 49152, n = 20) bytes, 0.0114
// ms (at f32 0.0227 ms; its 15360 flops a row on the CUDA cores at 67
// TFLOP/s take 0.011 ms); at G = 4 in the stage-2 step (M = 786432, 7680
// flops a row forward and backward against 80 bytes in bf16, 224 in f32)
// bytes in bf16 (0.0300 ms), operations in f32 (0.0901 ms, its bytes
// 0.0526).  What is left: the products run on the CUDA cores (bf16
// mma.sync could carry the G = 4 three products, whose bf16 x bf16 terms
// are exact in f32), and the G = 1 logits and dfeats loops read W at about
// one 16-byte load per 4 FMAs.
//
// The f32 forms (erf_head_loss*_f32, the JAX package's default compute
// dtype): the same kernels as templates on the element type T of feats,
// W, dz and dfeats.  At f32 the feature rows are read as f32, W is staged
// unrounded, and dz and dfeats are not rounded: f32 logits, f32 products,
// f32 sums, nothing rounded to bf16.  The G = 1 backward stages its blocks
// of feats in f32 (64 KB each), the G = 4 passes theirs (8 KB).
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
// M feature rows (rows = rows_per_cta(M, R1, CTAS1): at least R1, and
// enough that the CTAs fit the SMs once) and takes them in blocks of R1
// rows, the next block's feats in flight (16-byte cp.async, coalesced)
// while this one computes.  A staged row keeps its K values in T, its
// 16-byte chunk e at chunk e ^ swz1(r).  Per block:
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
//
// Both passes run one wave of persistent CTAs (CTAS4 an SM): CTA c owns
// rows [c rows, (c + 1) rows) of the M feature rows (rows =
// rows_per_cta(M, R4, CTAS4): at least R4, and enough that the CTAs fit
// the SMs once) and takes them in blocks of R4 rows, each block's feature
// rows and labels staged with 16-byte cp.async into a ring of NB4
// buffers, NB4 - 1 blocks in flight while the CTA computes.  Thread (g, q)
// = (tid / 4, tid % 4) computes the n logits of plane q (columns [q NC4,
// q NC4 + n) of W, staged once as f32 and zero past n) for the block's
// rows g + RG4 i, i < TM4: a register tile of TM4 rows x NC4 logits, each
// W float4 read once for its TM4 rows (one FMA chain over k a logit, then
// the bias); a row's max over its 4 n logits is taken across its four
// threads by shuffles.  Shared loads, not FMAs, set the pass's pace: the
// tile takes them from 84 a row and plane (one row a thread) to 24.
//   Forward: num += w_t nll, den += w_t over the thread's rows; at the end
//   the CTA's sums in a fixed order (an xor tree over the lanes, then the
//   warps in order): part[c] = [num, den].
//   Backward, per block:
//   1. dz = round_T(gnum w_t (softmax_q - onehot)) of plane q into Ds
//      (f32: a bf16 dz is exact there); dfeats = round_T(dz . W^T): each
//      thread its plane's partial sums for its rows (a chain over its
//      columns in order; W^T staged as f32, row i's 16-byte chunk j at j ^
//      (i / NC4)), in two halves of k, the four planes added by an xor
//      tree across the row's threads (the same sums in each), thread q
//      writing k = 4 q .. 4 q + 3.
//   2. [dW | db] += F^T [dz | 1] on an FFMA micro-tile with the rows as its
//      depth: warp w takes rows [w RW4, (w + 1) RW4) of every block, lane
//      (kg, cg) = (lane / 8, lane % 8) owns dW rows k = 4 kg .. 4 kg + 3 x
//      the padded columns CG4 cg .. CG4 cg + CG4 - 1 (one FMA chain an
//      output over the warp's rows in order) and db of the same columns.
//   At the end the warps' sums are added in warp order: part[c] = [dW (K4
//   x 4n) | db (4n)], reduced over the CTAs by reduce_parts.  dz never
//   leaves the CTA.
constexpr int K4 = 16, G4 = 4, NC4 = 20, GN4 = G4 * NC4;
constexpr int THREADS4 = 256, WARPS4 = THREADS4 / 32;
constexpr int TM4 = 2;                  // rows a thread (of one plane)
constexpr int RG4 = THREADS4 / G4;      // a thread's rows: g + RG4 i
constexpr int R4 = RG4 * TM4;           // rows a block
constexpr int RW4 = R4 / WARPS4;        // rows a warp a block in the dW tile
constexpr int CTAS4 = 2;                // CTAs an SM (128 registers)
constexpr int NB4 = 4;                  // block buffers
constexpr int CG4 = 10;                 // padded dW columns a lane
constexpr int DWB4 = (K4 + 1) * GN4;    // [dW | db], padded columns

// The G = 4 passes' shared memory (byte offsets).  NB4 buffers of a
// block's feature rows (T) and labels; W and W^T as f32; dz.
template <typename T>
struct Pass4 {
  static constexpr int VPC = 16 / (int)sizeof(T), CPR = K4 / VPC;
  static constexpr size_t f_bytes = (size_t)R4 * K4 * sizeof(T);
  static constexpr size_t buf_bytes = f_bytes + (size_t)R4 * G4 * 4;
  static constexpr size_t w_off = NB4 * buf_bytes;
  static constexpr size_t wt_off = w_off + (size_t)K4 * GN4 * 4;
  static constexpr size_t fwd_smem = wt_off;  // the forward stops at W
  static constexpr size_t d_off = wt_off + (size_t)GN4 * K4 * 4;
  static constexpr size_t work = d_off + (size_t)R4 * GN4 * 4;
  // the warps' [dW | db] sums at the end, over the dead buffers
  static constexpr size_t red = (size_t)WARPS4 * DWB4 * 4;
  static constexpr size_t smem = work > red ? work : red;
  static_assert(R4 % WARPS4 == 0 && 8 * CG4 == GN4 && 4 * 4 == K4 &&
                    smem <= 232448,
                "G = 4 pass");
  __device__ static T* feats(unsigned char* s, int kb) {
    return reinterpret_cast<T*>(s + (kb % NB4) * buf_bytes);
  }
  __device__ static int* labels(unsigned char* s, int kb) {
    return reinterpret_cast<int*>(s + (kb % NB4) * buf_bytes + f_bytes);
  }
};

// Stage W (K4, G4 n) as f32 Ws (K4, GN4), column g NC4 + c, zero past n;
// with Wt, W^T (GN4, K4), row i's 16-byte chunk j at j ^ (i / NC4); the
// bias (GN4) and the class weights (NC4) likewise.  The caller's barrier
// follows.
template <typename T>
__device__ __forceinline__ void stage4(const T* w, const float* bias,
                                       const float* cw, int n, float* Ws,
                                       float* Wt, float* bs, float* cws) {
  for (int i = threadIdx.x; i < K4 * GN4; i += blockDim.x) {
    const int k = i / GN4, col = i % GN4, g = col / NC4, c = col % NC4;
    const float v = c < n ? to_f32(w[k * G4 * n + g * n + c]) : 0.0f;
    Ws[i] = v;
    if (Wt != nullptr) Wt[col * K4 + 4 * ((k / 4) ^ g) + k % 4] = v;
  }
  for (int i = threadIdx.x; i < GN4; i += blockDim.x) {
    const int g = i / NC4, c = i % NC4;
    bs[i] = c < n ? bias[g * n + c] : 0.0f;
  }
  for (int c = threadIdx.x; c < NC4; c += blockDim.x)
    cws[c] = c < n ? cw[c] : 0.0f;
}

// Start copying block kb (rows [r0, r0 + R4) of the CTA's [.., c_end)) of
// the feature rows and labels into its buffers, zero past c_end; one
// cp.async group either way.
template <typename T>
__device__ __forceinline__ void issue4(unsigned char* smem, int kb,
                                       int blocks, const T* feats,
                                       const int* labels, long long c_begin,
                                       long long c_end) {
  using P = Pass4<T>;
  if (kb < blocks) {
    const long long r0 = c_begin + (long long)kb * R4;
    T* Fd = P::feats(smem, kb);
    int* Ld = P::labels(smem, kb);
    for (int v = threadIdx.x; v < R4 * (P::CPR + 1); v += THREADS4) {
      const int rr = v / (P::CPR + 1), e = v % (P::CPR + 1);
      const bool valid = r0 + rr < c_end;
      if (e < P::CPR)
        cp_async16(Fd + rr * K4 + P::VPC * e,
                   feats + (valid ? (r0 + rr) * K4 + P::VPC * e : 0), valid);
      else
        cp_async16(Ld + rr * G4, labels + (valid ? (r0 + rr) * G4 : 0),
                   valid);
    }
  }
  cp_async_commit();
}

// Values 4 kq .. 4 kq + 3 of a staged feature row, as f32.
__device__ __forceinline__ void quad4(const float* p, int kq, float (&f)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[kq];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void quad4(const bf16* p, int kq, float (&f)[4]) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[kq];
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// 4 f32 -> 4 consecutive elements of T (bf16 rounds to nearest even).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// z[i]: the logits of plane q of the thread's rows g + RG4 i of the block
// F, the bias added, -inf past n; mx[i]: row i's max over its G4 n logits
// (the four threads of a row, lanes 4 g' .. 4 g' + 3, each give their
// plane).
template <typename T>
__device__ __forceinline__ void logits4(const T* F, int g, const float* Ws,
                                        const float* bs, int q, int n,
                                        float (&z)[TM4][NC4],
                                        float (&mx)[TM4]) {
#pragma unroll
  for (int i = 0; i < TM4; ++i)
#pragma unroll
    for (int c = 0; c < NC4; ++c) z[i][c] = 0.0f;
#pragma unroll
  for (int kq = 0; kq < K4 / 4; ++kq) {
    float f[TM4][4];
#pragma unroll
    for (int i = 0; i < TM4; ++i) quad4(F + (g + RG4 * i) * K4, kq, f[i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = Ws + (4 * kq + kk) * GN4 + q * NC4;
#pragma unroll
      for (int c4 = 0; c4 < NC4 / 4; ++c4) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + 4 * c4);
#pragma unroll
        for (int i = 0; i < TM4; ++i) {
          z[i][4 * c4] = fmaf(f[i][kk], wv.x, z[i][4 * c4]);
          z[i][4 * c4 + 1] = fmaf(f[i][kk], wv.y, z[i][4 * c4 + 1]);
          z[i][4 * c4 + 2] = fmaf(f[i][kk], wv.z, z[i][4 * c4 + 2]);
          z[i][4 * c4 + 3] = fmaf(f[i][kk], wv.w, z[i][4 * c4 + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM4; ++i) {
    float m = -__int_as_float(0x7f800000);
#pragma unroll
    for (int c = 0; c < NC4; ++c) {
      z[i][c] = c < n ? z[i][c] + bs[q * NC4 + c]
                      : -__int_as_float(0x7f800000);
      m = fmaxf(m, z[i][c]);
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    mx[i] = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS4, CTAS4)
fwd4_kernel(const T* __restrict__ feats, const T* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ labels,
            const float* __restrict__ cw, float* __restrict__ part, int M,
            int n, int rows) {
  using P = Pass4<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem + P::w_off);
  __shared__ float bs[GN4], cws[NC4], red[2 * WARPS4];
  const int tid = threadIdx.x, g = tid >> 2, q = tid & 3;
  const long long c_begin = (long long)blockIdx.x * rows;
  const long long c_end = c_begin + rows < M ? c_begin + rows : M;
  const int blocks = (int)((c_end - c_begin + R4 - 1) / R4);
  for (int kb = 0; kb < NB4 - 1; ++kb)
    issue4<T>(smem, kb, blocks, feats, labels, c_begin, c_end);
  stage4(w, bias, cw, n, Ws, nullptr, bs, cws);
  float num = 0.0f, den = 0.0f;
  for (int kb = 0; kb < blocks; ++kb) {
    const long long r0 = c_begin + (long long)kb * R4;
    const int nvalid = (int)(c_end - r0 < R4 ? c_end - r0 : R4);
    cp_async_wait_group<NB4 - 2>();  // block kb landed
    __syncthreads();
    // block kb + NB4 - 1 into the buffers block kb - 1 left
    issue4<T>(smem, kb + NB4 - 1, blocks, feats, labels, c_begin, c_end);
    float z[TM4][NC4], mx[TM4];
    logits4(P::feats(smem, kb), g, Ws, bs, q, n, z, mx);
    const int* L = P::labels(smem, kb);
#pragma unroll
    for (int i = 0; i < TM4; ++i) {
      const int r = g + RG4 * i;
      const int t = r < nvalid ? L[r * G4 + q] : -1;
      float s = 0.0f, zt = 0.0f;
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        if (c < n) s += expf(z[i][c] - mx[i]);
        if (c == t && c < n) zt = z[i][c];  // a label in [n, NC4) weighs 0
      }
      const float wt = t >= 0 && t < n ? cws[t] : 0.0f;
      num += wt * (mx[i] + logf(s) - zt);
      den += wt;
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    den += __shfl_xor_sync(0xffffffffu, den, o);
  }
  if (tid % 32 == 0) {
    red[tid / 32] = num;
    red[WARPS4 + tid / 32] = den;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f, b = 0.0f;
    for (int wi = 0; wi < WARPS4; ++wi) {
      a += red[wi];
      b += red[WARPS4 + wi];
    }
    part[2 * blockIdx.x] = a;
    part[2 * blockIdx.x + 1] = b;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS4, CTAS4)
bwd4_kernel(const T* __restrict__ feats, const T* __restrict__ w,
            const float* __restrict__ bias, const int* __restrict__ labels,
            const float* __restrict__ cw, const float* __restrict__ gnum,
            T* __restrict__ dfeats, float* __restrict__ part, int M, int n,
            int rows) {
  using P = Pass4<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ws = reinterpret_cast<float*>(smem + P::w_off);
  float* Wt = reinterpret_cast<float*>(smem + P::wt_off);
  float* Ds = reinterpret_cast<float*>(smem + P::d_off);
  __shared__ float bs[GN4], cws[NC4];
  const int tid = threadIdx.x, g = tid >> 2, q = tid & 3;
  const int warp = tid / 32, lane = tid % 32, kg = lane >> 3, cg = lane & 7;
  const long long c_begin = (long long)blockIdx.x * rows;
  const long long c_end = c_begin + rows < M ? c_begin + rows : M;
  const int blocks = (int)((c_end - c_begin + R4 - 1) / R4);
  for (int kb = 0; kb < NB4 - 1; ++kb)
    issue4<T>(smem, kb, blocks, feats, labels, c_begin, c_end);
  stage4(w, bias, cw, n, Ws, Wt, bs, cws);
  const float gs = __ldg(gnum);
  float acc[4][CG4], dbs[CG4];
#pragma unroll
  for (int j = 0; j < CG4; ++j) {
    dbs[j] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][j] = 0.0f;
  }

  for (int kb = 0; kb < blocks; ++kb) {
    const long long r0 = c_begin + (long long)kb * R4;
    const int nvalid = (int)(c_end - r0 < R4 ? c_end - r0 : R4);
    const T* Fb = P::feats(smem, kb);
    cp_async_wait_group<NB4 - 2>();  // block kb landed
    __syncthreads();
    // block kb + NB4 - 1 into the buffers block kb - 1 left (its step 2
    // ended before the barrier above)
    issue4<T>(smem, kb + NB4 - 1, blocks, feats, labels, c_begin, c_end);

    // 1. logits, softmax, dz of plane q of the thread's rows; dfeats
    {
      float z[TM4][NC4], mx[TM4];
      logits4(Fb, g, Ws, bs, q, n, z, mx);
      const int* L = P::labels(smem, kb);
#pragma unroll
      for (int i = 0; i < TM4; ++i) {
        const int r = g + RG4 * i;
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          z[i][c] = c < n ? expf(z[i][c] - mx[i]) : 0.0f;
          s += z[i][c];
        }
        const int t = r < nvalid ? L[r * G4 + q] : -1;
        const float gw = gs * (t >= 0 && t < n ? cws[t] : 0.0f);
        const float inv = 1.0f / s;
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const float p = z[i][c] * inv;
          z[i][c] = r < nvalid && c < n
                        ? round_as<T>(gw * (p - (c == t ? 1.0f : 0.0f)))
                        : 0.0f;
        }
#pragma unroll
        for (int c4 = 0; c4 < NC4 / 4; ++c4)
          *reinterpret_cast<float4*>(Ds + r * GN4 + q * NC4 + 4 * c4) =
              make_float4(z[i][4 * c4], z[i][4 * c4 + 1], z[i][4 * c4 + 2],
                          z[i][4 * c4 + 3]);
      }
      // dfeats, k in two halves of 8: plane q's partial sums, then the
      // four planes' (q0 + q1) + (q2 + q3) in every lane of the row
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        float o[TM4][8];
#pragma unroll
        for (int i = 0; i < TM4; ++i)
#pragma unroll
          for (int k = 0; k < 8; ++k) o[i][k] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC4; ++c) {
          const float* wr = Wt + (q * NC4 + c) * K4;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int j = 2 * hk + jj;
            const float4 v =
                *reinterpret_cast<const float4*>(wr + 4 * (j ^ q));
#pragma unroll
            for (int i = 0; i < TM4; ++i) {
              o[i][4 * jj] = fmaf(z[i][c], v.x, o[i][4 * jj]);
              o[i][4 * jj + 1] = fmaf(z[i][c], v.y, o[i][4 * jj + 1]);
              o[i][4 * jj + 2] = fmaf(z[i][c], v.z, o[i][4 * jj + 2]);
              o[i][4 * jj + 3] = fmaf(z[i][c], v.w, o[i][4 * jj + 3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TM4; ++i) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            o[i][k] += __shfl_xor_sync(0xffffffffu, o[i][k], 1);
            o[i][k] += __shfl_xor_sync(0xffffffffu, o[i][k], 2);
          }
          const int r = g + RG4 * i;
          if ((q >> 1) == hk && r < nvalid) {
            float mine[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mine[j] = q & 1 ? o[i][4 + j] : o[i][j];
            store4(dfeats + (r0 + r) * K4 + 4 * q, mine);
          }
        }
      }
    }
    __syncthreads();  // Ds is complete

    // 2. [dW | db] over this warp's rows of the block
    {
      const int stop = min((warp + 1) * RW4, nvalid);
      for (int rr = warp * RW4; rr < stop; ++rr) {
        float f[4], d[CG4];
        quad4(Fb + rr * K4, kg, f);
#pragma unroll
        for (int j = 0; j < CG4 / 2; ++j) {
          const float2 v = *reinterpret_cast<const float2*>(
              Ds + rr * GN4 + CG4 * cg + 2 * j);
          d[2 * j] = v.x;
          d[2 * j + 1] = v.y;
        }
#pragma unroll
        for (int j = 0; j < CG4; ++j) {
          dbs[j] += d[j];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][j] = fmaf(f[a], d[j], acc[a][j]);
        }
      }
    }
    // Ds and buffer kb are next written after the next iteration's barrier
  }
  cp_async_wait_all();
  __syncthreads();  // every buffer is dead: red may alias them
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < CG4; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
      red[warp * DWB4 + (4 * kg + a) * GN4 + CG4 * cg + j] = acc[a][j];
    if (kg == 0) red[warp * DWB4 + K4 * GN4 + CG4 * cg + j] = dbs[j];
  }
  __syncthreads();
  const int gn = G4 * n;
  float* dst = part + (long long)blockIdx.x * (K4 + 1) * gn;
  for (int e = tid; e < DWB4; e += THREADS4) {
    const int row = e / GN4, pg = (e % GN4) / NC4, c = e % NC4;
    if (c >= n) continue;
    float a = 0.0f;
    for (int wi = 0; wi < WARPS4; ++wi) a += red[wi * DWB4 + e];
    dst[row * gn + pg * n + c] = a;
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

// Rows a persistent CTA owns: at least least, and enough that the CTAs
// (per_sm an SM) fit the device's SMs once; 0 on a CUDA error.
int rows_per_cta(int M, int least, int per_sm) {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 &&
      (cudaGetDevice(&dev) != cudaSuccess ||
       cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
           cudaSuccess))
    return 0;
  if (sms < 1 || M < 1) return 0;
  const long long per = ((long long)M + sms * per_sm - 1) / (sms * per_sm);
  return (int)(per > least ? per : least);
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
  const int rows = rows_per_cta(M, R1, CTAS1);
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

// G = 4: the one-wave pass, then the reduction of its per-CTA partials.
template <typename T>
int fwd4(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, void* part, void* out, int M,
         int n, void* stream) {
  if (n < 1 || n > NC4 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = rows_per_cta(M, R4, CTAS4);
  if (rows < 1) return cudaErrorInvalidValue;
  const int ctas = (M + rows - 1) / rows;
  static bool ok = false;
  constexpr size_t smem = Pass4<T>::fwd_smem;
  cudaError_t e = allow_smem(fwd4_kernel<T>, smem, &ok);
  if (e != cudaSuccess) return e;
  fwd4_kernel<T><<<ctas, THREADS4, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<float*>(part), M, n, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(out), 1, ctas, 2, s);
}

template <typename T>
int bwd4(const void* feats, const void* w, const void* bias,
         const void* labels, const void* cw, const void* gnum, void* dfeats,
         void* part, void* grads, int M, int n, void* stream) {
  if (n < 1 || n > NC4 || M < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = rows_per_cta(M, R4, CTAS4);
  if (rows < 1) return cudaErrorInvalidValue;
  const int ctas = (M + rows - 1) / rows;
  static bool ok = false;
  constexpr size_t smem = Pass4<T>::smem;
  cudaError_t e = allow_smem(bwd4_kernel<T>, smem, &ok);
  if (e != cudaSuccess) return e;
  bwd4_kernel<T><<<ctas, THREADS4, smem, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const int*>(labels),
      static_cast<const float*>(cw), static_cast<const float*>(gnum),
      static_cast<T*>(dfeats), static_cast<float*>(part), M, n, rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce_parts(static_cast<const float*>(part),
                      static_cast<float*>(grads), 1, ctas,
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
extern "C" int erf_head_loss_rows(int M) {
  return rows_per_cta(M, R1, CTAS1);
}

// G = 4.  feats: (M, 16); w: (16, 4n), column g n + c for plane g =
// a*2+b; bias: (4n,) f32; labels: (M, 4) int32 in plane order; cw: (n,)
// f32; n <= 20.  Forward: part (ceil(M / erf_head_loss4_rows(M)), 2) f32
// scratch, one partial a CTA; out (2,) f32 = [num, den].
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
// (ceil(M / erf_head_loss4_rows(M)), 17 * 4n) f32 scratch, one partial a
// CTA; grads (17 * 4n) f32 = [dW (16, 4n), db (4n)].
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

// Rows per CTA of both G = 4 passes for M rows (their partials: ceil(M /
// rows)); 0 on a CUDA error.
extern "C" int erf_head_loss4_rows(int M) {
  return rows_per_cta(M, R4, CTAS4);
}
