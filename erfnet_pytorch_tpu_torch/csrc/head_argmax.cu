// Two heads + argmax, logits never in device memory.
//
// (1) erf_head_argmax, the decoder head: ConvTranspose2d(16, n, k2 s2) as
// a parity-plane matmul, logits rounded to bf16, first-max argmax over the
// n classes of each parity plane, int32 predictions stored straight into
// (B, 2H, 2W).
//
// Replaces erfnet_pytorch_tpu/ops/pallas/head_argmax.py:_kernel_grouped and
// :_kernel (via head_argmax, G = 32 packed and G = 4 plain): the same
// function for both, and the TPU's depth_to_space_planes(_packed) reshape is
// folded into the store.  Logits never reach device memory.
//
// Semantics: z[g*n + c] = sum_k f[k] W[k, g*n + c] + bias[g*n + c] in f32
// (bf16 x bf16 products are exact in f32; the bias added after the sum, as
// the plain version adds it), rounded to bf16; plane g = a*2 + b writes
// pixel (2i + a, 2j + b).  The lowest index among the maxima wins; a plane
// with a NaN logit gives n - 1, as the TPU kernel's clamp does.
//
// On the tensor cores: a warp takes feature pixels 32 at a time, two
// m16 blocks, its A fragments the pixels' 16-channel rows, 8 bytes a lane
// a row (bf16; 16 at f32): the K order is permuted so that lane (g, t)
// holds channels 4t .. 4t + 3 of rows g and g + 8, the B fragments of W
// permuted the same way.  W (16 x 4n) is laid out once per CTA in shared
// memory as each lane's B fragments, each plane's n classes padded to a
// multiple of 8 (24 at n = 20: 12 n8 tiles for the four planes), and the
// bias beside it.  bf16: one mma.sync m16n8k16 per (m16 block, n8 tile),
// f32 accumulators.  f32: 3xTF32 over the two k8 steps (W split into TF32
// hi and lo once per CTA, the feature rows split in registers; the cross
// products chained, the high parts' apart, added on the CUDA cores), the
// logits not rounded (the TPU kernel's round_bf16 is false there).
// mma.sync and not wgmma: N is 24 columns a plane and K one k-step, too
// small for a warpgroup's m64 tiles to pay for their staging; CUDA C++
// and not Triton, as every kernel of the port.
// Argmax in registers: each lane takes the first maximum over its own
// columns of a plane (increasing column order, a strict >, head_fold:
// three instructions a logit; padded columns excluded by their index; a
// NaN marks the lane's result (+inf, -1), which wins every comparison);
// the four lanes of a quad then combine by two
// xor-shuffles (the larger value, on equal values the lower class index),
// each exchange halving the (plane, block, row) results a lane carries, so
// that lane t ends with the four planes of one pixel (block t / 2, row g +
// 8 (t % 2)) and stores its 2 x 2 predictions as two int2, a warp's stores
// two runs of 256 contiguous bytes.  n up to 256: n <= 32 unrolls the
// tiles of a plane, larger n loops over them.
//
// Bound on this card: bytes, 32 read and 16 written per feature pixel in
// bf16 (0.0075 ms at B=4 512x1024); f32: the 16 x 80 MACs per feature
// pixel against 67 TFLOP/s, 0.0200 ms, or under 3xTF32 the bytes (64 read,
// 16 written), 0.0125 ms.  What bounds this version: the argmax's
// per-logit work on the CUDA cores, the bias add, the rounding and
// head_fold for 96 logits a lane per 32 pixels, and the quad exchange
// (folding the NaN test into the max, rounding two logits a cvt, testing
// the padding in a plane's last tile only and decoding the pixel in 32
// bits took the bf16 form from 0.0403 to 0.0349 ms and f32 from 0.0587 to
// 0.0436, B=4 512x1024, NVIDIA H100 80GB HBM3, 700.00 W: PERF.md §6).
//
// (2) erf_head_argmax_1x1, the encoder's 1x1 head as the encoder-stage eval
// step and train IoU run it: feats (M, 128) bf16 @ W (128, n) + bias (n,)
// f32, logits rounded to bf16, first-max argmax over n, int32 (M,).
// Replaces erfnet_pytorch_tpu/ops/pallas/head_argmax.py:_kernel at G = 1,
// K = 128 (head_argmax -> _op -> pallas_call, as training/steps.py:374 calls
// it): the same sum in f32 (bf16 x bf16 products are exact), the same
// rounding, the same first-max rule, and a pixel with a NaN logit gives
// n - 1 as that kernel's clamp does.  The TPU kernel computes the logits
// transposed so that the argmax is a sublane reduction; here the product
// runs on the tensor cores and the argmax in registers, as in (1).
//
// A warp takes the pixels an m16 block (16 rows) at a time, from a grid
// of one wave of persistent CTAs (resident_ctas), and loads the next
// block's rows before the products of this one.  The K order is permuted
// so that the A fragments are plain 16-byte loads: lane (g, t)'s load q
// is the 16 bytes at 64 q + 16 t of rows g and g + 8, so each load of the
// warp reads 64 contiguous bytes of each of its 16 rows and a quad reads
// a row whole; each load makes two k steps (bf16: four loads, eight
// m16n8k16 steps; f32: eight loads, sixteen m16n8k8 steps).  W (128 x n)
// is laid out once a CTA in shared memory as the lanes' B fragments,
// permuted the same way, the classes padded to n8 tiles (NT = 1 .. 4, 3
// at n = 20); the lane's bias columns stay in registers.  f32: 3xTF32 as
// in (1), W split into TF32 hi and lo once a CTA, the rows split in
// registers.  Epilogue: the bias added after the sum, the logits rounded
// to bf16 in the bf16 form, head_fold over the lane's columns of its two
// rows (padded columns excluded by their index), then two xor exchanges
// in the quad, the first halving the rows a lane carries; lanes t = 0, 1
// store a block's 16 predictions, 64 contiguous bytes.  mma.sync and not
// wgmma: N is at most 32 columns, and an m64 warpgroup tile would need
// the pixels staged in shared memory to feed a product that does not
// bound the kernel.
//
// Bound on this card: bytes, 256 read and 4 written per pixel (12.8 MB at
// the B=6 512x1024 encoder stage, about 3.8 us at 3.35 TB/s), which fit in
// the 50 MB L2 when the encoder has just written them; f32 512 read (7.6
// us), the 128 x n MACs a pixel far below that on the tensor cores.
// Measured: PERF.md §6 rows 16 G1, 16 G1 f32.
// (3) The f32 forms of both (the JAX package's default compute dtype,
// eval_iou and the other eval CLIs without --bf16): the same kernels as
// templates on the element type T of feats and W.  At f32 the feats and W
// are read as f32 and the logits are not rounded: the TPU kernel's
// round_bf16 is false at f32.  The first-max and NaN rules are the same.
#include <type_traits>

#include "common.cuh"
#include "conv32.cuh"

using namespace erfk;

namespace {

constexpr int K = 16, THREADS = 256, WARPS = THREADS / 32;
constexpr int MB = 2, PX = 16 * MB;   // m16 blocks, pixels a warp step
constexpr int SENT = 0x7fffffff;   // a lane's index with no finite maximum

// per form: the 32-bit words of a lane's B fragments of an n8 tile (bf16:
// b0, b1; f32: the hi parts of steps 0 and 1, then the lo parts) and a
// lane's raw A row (4 channels)
template <typename T>
struct HeadForm;
template <>
struct HeadForm<bf16> {
  static constexpr int FW = 2;
  using Raw = uint2;
};
template <>
struct HeadForm<float> {
  static constexpr int FW = 8;
  using Raw = float4;
};

// d += a (16x8, row, TF32) b (8x8, col, TF32), f32 accumulators
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max that returns NaN when either input is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ uint32_t bf16_bits(bf16 v) {
  return __bfloat16_as_ushort(v);
}

// One logit z of column col into a lane's (best, idx): the index moves
// where z > best or either is NaN, best becomes max.NaN (a NaN sticks),
// so a strict > keeps the first maximum and a lane that met a NaN ends
// with best NaN (its index then means nothing).
__device__ __forceinline__ void head_fold(float z, int col, float& best,
                                          int& idx) {
  idx = !(z <= best) ? col : idx;
  best = max_nan(best, z);
}

// (bo, io) wins over (bm, im): the larger value, on equal values the lower
// index (a NaN's (+inf, -1) wins every comparison)
__device__ __forceinline__ bool head_better(float bo, int io, float bm,
                                            int im) {
  return bo > bm || (bo == bm && io < im);
}

// NTP: n8 tiles a plane (ceil(n / 8)) as a constant, or 0: ntp_rt
template <typename T, int NTP>
__global__ void __launch_bounds__(THREADS)
head_argmax_kernel(const T* __restrict__ feats, const T* __restrict__ w,
                   const float* __restrict__ bias, int* __restrict__ out,
                   long long M, int H, int W, int n, int ntp_rt) {
  using F = HeadForm<T>;
  using Raw = typename F::Raw;
  constexpr bool F32 = std::is_same<T, float>::value;
  const int ntp = NTP ? NTP : ntp_rt, np = 8 * ntp;
  extern __shared__ __align__(16) unsigned char sm[];
  // B fragments: tile tt = p ntp + j (plane p, columns 8 j ..), lane l at
  // Bf + (tt 32 + l) FW; the bias, plane p's padded columns at bs + p np
  uint32_t* Bf = reinterpret_cast<uint32_t*>(sm);
  float* bs = reinterpret_cast<float*>(sm + (size_t)4 * ntp * 32 * F::FW * 4);
  for (int v = threadIdx.x; v < 4 * ntp * 32; v += THREADS) {
    const int tt = v / 32, l = v % 32, p = tt / ntp;
    const int col = 8 * (tt % ntp) + (l >> 2), r0 = 4 * (l & 3);
    // lane (g, t): column g of the tile, W rows 4t .. 4t + 3 (the
    // permuted K: bf16 logical k 2t, 2t + 1, 2t + 8, 2t + 9; f32 t, t + 4
    // of step 0, then of step 1)
    const T* src = w + (size_t)r0 * 4 * n + p * n + col;
    uint32_t* dst = Bf + (size_t)v * F::FW;
    if constexpr (F32) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_tf32(col < n ? __ldg(src + (size_t)k * 4 * n) : 0.0f, dst[k],
                   dst[4 + k]);
    } else {
      uint32_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = col < n ? bf16_bits(src[(size_t)k * 4 * n]) : 0u;
      dst[0] = q[0] | q[1] << 16;
      dst[1] = q[2] | q[3] << 16;
    }
  }
  for (int v = threadIdx.x; v < 4 * np; v += THREADS)
    bs[v] = v % np < n ? __ldg(bias + (v / np) * n + v % np) : 0.0f;
  __syncthreads();

  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int hb = t & 1, bb = t >> 1;   // the pixel this lane stores
  static_assert(MB == 2, "a lane stores one pixel of the two blocks");
  const long long steps = (M + PX - 1) / PX;
  const long long stride = (long long)gridDim.x * WARPS;
  const int HW = H * W;   // M < 2^31: the pixel decode in 32 bits
  // rows g and g + 8 (h) of block bk: channels 4t .. 4t + 3, zero past M
  auto load = [&](long long s, Raw (&r)[MB][2]) {
#pragma unroll
    for (int bk = 0; bk < MB; ++bk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = s * PX + bk * 16 + h * 8 + g;
        r[bk][h] = m < M ? __ldg(reinterpret_cast<const Raw*>(
                               feats + m * K + 4 * t))
                         : Raw{};
      }
  };
  long long s = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  Raw cur[MB][2];
  if (s < steps) load(s, cur);
  for (; s < steps; s += stride) {
    Raw nxt[MB][2];
    if (s + stride < steps) load(s + stride, nxt);
    // A: bf16 a[bk] = (row g: ch 4t, 4t+1), (row g+8: same), (row g: ch
    // 4t+2, 4t+3), (row g+8: same); f32 step 0 the rows' .x and .y, step
    // 1 their .z and .w, each split into TF32 hi and lo
    uint32_t a[MB][2][4], al[MB][2][4];
#pragma unroll
    for (int bk = 0; bk < MB; ++bk) {
      if constexpr (F32) {
        const float v[2][4] = {{cur[bk][0].x, cur[bk][1].x, cur[bk][0].y,
                                cur[bk][1].y},
                               {cur[bk][0].z, cur[bk][1].z, cur[bk][0].w,
                                cur[bk][1].w}};
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(v[st][i], a[bk][st][i], al[bk][st][i]);
      } else {
        a[bk][0][0] = cur[bk][0].x;
        a[bk][0][1] = cur[bk][1].x;
        a[bk][0][2] = cur[bk][0].y;
        a[bk][0][3] = cur[bk][1].y;
      }
    }
    // each lane's first maximum over its columns, per (plane, block, row)
    float best[4][MB][2];
    int idx[4][MB][2];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int bk = 0; bk < MB; ++bk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          best[p][bk][h] = __int_as_float(0xff800000);  // -inf
          idx[p][bk][h] = SENT;
        }
#pragma unroll(NTP ? NTP : 1)
      for (int j = 0; j < ntp; ++j) {
        const uint32_t* f = Bf + ((size_t)(p * ntp + j) * 32 + lane) * F::FW;
        const float2 bv =
            *reinterpret_cast<const float2*>(bs + p * np + 8 * j + 2 * t);
        uint32_t b[F::FW];
        if constexpr (F32) {
          const uint4 hi = *reinterpret_cast<const uint4*>(f);
          const uint4 lo = *reinterpret_cast<const uint4*>(f + 4);
          b[0] = hi.x; b[1] = hi.y; b[2] = hi.z; b[3] = hi.w;
          b[4] = lo.x; b[5] = lo.y; b[6] = lo.z; b[7] = lo.w;
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(f);
          b[0] = q.x;
          b[1] = q.y;
        }
        // only the last tile of a plane holds padded columns
        const bool last = NTP ? j == NTP - 1 : j == ntp - 1;
        const int col = 8 * j + 2 * t;
#pragma unroll
        for (int bk = 0; bk < MB; ++bk) {
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if constexpr (F32) {
            float big[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32_1688(c, al[bk][0], b[0], b[1]);
            mma_tf32_1688(c, a[bk][0], b[4], b[5]);
            mma_tf32_1688(c, al[bk][1], b[2], b[3]);
            mma_tf32_1688(c, a[bk][1], b[6], b[7]);
            mma_tf32_1688(big, a[bk][0], b[0], b[1]);
            mma_tf32_1688(big, a[bk][1], b[2], b[3]);
#pragma unroll
            for (int i = 0; i < 4; ++i) c[i] = big[i] + c[i];
          } else {
            mma_bf16_16816(c, a[bk][0], b[0], b[1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float z0 = c[2 * h] + bv.x, z1 = c[2 * h + 1] + bv.y;
            if constexpr (!F32) {   // both rounded to bf16 by one cvt
              const __nv_bfloat162 r = __floats2bfloat162_rn(z0, z1);
              z0 = __low2float(r);
              z1 = __high2float(r);
            }
            if (!last || col < n)
              head_fold(z0, col, best[p][bk][h], idx[p][bk][h]);
            if (!last || col + 1 < n)
              head_fold(z1, col + 1, best[p][bk][h], idx[p][bk][h]);
          }
        }
      }
#pragma unroll
      for (int bk = 0; bk < MB; ++bk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (isnan(best[p][bk][h])) {
            best[p][bk][h] = __int_as_float(0x7f800000);  // +inf
            idx[p][bk][h] = -1;
          }
    }
    // the quad: xor 1 pairs the rows (h), xor 2 the blocks; each lane
    // keeps its own pixel's half and sends the other
    float rb[4][MB];
    int ri[4][MB];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int bk = 0; bk < MB; ++bk) {
        float kb = hb ? best[p][bk][1] : best[p][bk][0];
        int ki = hb ? idx[p][bk][1] : idx[p][bk][0];
        const float ob = __shfl_xor_sync(
            0xffffffffu, hb ? best[p][bk][0] : best[p][bk][1], 1);
        const int oi = __shfl_xor_sync(
            0xffffffffu, hb ? idx[p][bk][0] : idx[p][bk][1], 1);
        if (head_better(ob, oi, kb, ki)) {
          kb = ob;
          ki = oi;
        }
        rb[p][bk] = kb;
        ri[p][bk] = ki;
      }
    int pred[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float kb = bb ? rb[p][1] : rb[p][0];
      int ki = bb ? ri[p][1] : ri[p][0];
      const float ob =
          __shfl_xor_sync(0xffffffffu, bb ? rb[p][0] : rb[p][1], 2);
      const int oi =
          __shfl_xor_sync(0xffffffffu, bb ? ri[p][0] : ri[p][1], 2);
      if (head_better(ob, oi, kb, ki)) ki = oi;
      pred[p] = ki < 0 ? n - 1 : ki == SENT ? 0 : ki;
    }
    // pixel m's planes (a, 0), (a, 1) at output row 2 i + a, columns 2 j,
    // 2 j + 1
    const long long m = s * PX + bb * 16 + hb * 8 + g;
    if (m < M) {
      const int b = (int)m / HW, rem = (int)m % HW, i = rem / W, j = rem % W;
      int* o = out + (((long long)b * 2 * H + 2 * i) * 2 * W + 2 * j);
      *reinterpret_cast<int2*>(o) = make_int2(pred[0], pred[1]);
      *reinterpret_cast<int2*>(o + 2 * W) = make_int2(pred[2], pred[3]);
    }
#pragma unroll
    for (int bk = 0; bk < MB; ++bk) {
      cur[bk][0] = nxt[bk][0];
      cur[bk][1] = nxt[bk][1];
    }
  }
}

constexpr int K1 = 128, WARPS1 = 8, CTA1 = 32 * WARPS1;

// per form: Q 16-byte loads of a row a lane (its 32 of the row's 128
// channels), each E channels; BW: the uint4 words of a lane's B fragments
// for one load's channels of an n8 tile (bf16 the bf16 pairs; f32 the
// TF32 hi parts, then the lo parts)
template <typename T>
struct Head1Form;
template <>
struct Head1Form<bf16> {
  static constexpr int Q = 4, E = 8, BW = 1, MIN_CTAS = 2;
};
template <>
struct Head1Form<float> {
  static constexpr int Q = 8, E = 4, BW = 2, MIN_CTAS = 1;
};

// NT: the n8 tiles of the classes (ceil(n / 8), 1 .. 4)
template <typename T, int NT>
__global__ void __launch_bounds__(CTA1, Head1Form<T>::MIN_CTAS)
head_argmax_1x1_kernel(const T* __restrict__ feats,
                       const T* __restrict__ w,
                       const float* __restrict__ bias, int* __restrict__ out,
                       long long M, int n) {
  using F = Head1Form<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int Q = F::Q, E = F::E, BW = F::BW;
  // B fragments of load q, tile j, word b, lane l at Bf[((q NT + j) BW +
  // b) 32 + l]: a warp's read of one word is 512 contiguous bytes
  __shared__ uint4 Bf[Q * NT * BW * 32];
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const long long blocks = (M + 15) / 16;
  const long long stride = (long long)gridDim.x * WARPS1;
  // rows g and g + 8 (h) of m16 block sb: load q of lane t is the row's
  // 16 bytes at 64 q + 16 t (channels E (4 q + t) ..), so that each load
  // of the warp reads 64 contiguous bytes of each of its rows; zero past M
  auto load = [&](long long sb, uint4 (&r)[2][Q]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = sb * 16 + h * 8 + g;
      const uint4* src =
          reinterpret_cast<const uint4*>(feats + m * K1) + t;
#pragma unroll
      for (int q = 0; q < Q; ++q)
        r[h][q] = m < M ? __ldg(src + 4 * q) : make_uint4(0, 0, 0, 0);
    }
  };
  long long s = (long long)blockIdx.x * WARPS1 + threadIdx.x / 32;
  uint4 cur[2][Q];
  if (s < blocks) load(s, cur);   // in flight while W is laid out

  // lane l = (g', t') of tile j, load q: column 8 j + g', W rows k0 ..
  // k0 + E - 1 (k0 = E (4 q + t')), the channels lane t' holds of load q
#pragma unroll
  for (int v0 = 0; v0 < Q * NT * 32; v0 += CTA1) {
    const int v = v0 + threadIdx.x;
    if (v >= Q * NT * 32) break;
    const int l = v % 32, j = (v / 32) % NT, q = v / (32 * NT);
    const int col = 8 * j + (l >> 2), k0 = E * (4 * q + (l & 3));
    const T* src = w + (size_t)k0 * n + col;
    uint4* dst = Bf + (size_t)(q * NT + j) * BW * 32 + l;
    if constexpr (F32) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_tf32(col < n ? __ldg(src + (size_t)k * n) : 0.0f, hi[k], lo[k]);
      dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dst[32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      uint32_t p[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        p[k] = col < n ? bf16_bits(src[(size_t)2 * k * n]) |
                             bf16_bits(src[(size_t)(2 * k + 1) * n]) << 16
                       : 0u;
      dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    }
  }
  // this lane's columns 8 j + 2 t, + 1 of the bias, zero past n
  float2 bv[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    bv[j] = make_float2(c < n ? __ldg(bias + c) : 0.0f,
                        c + 1 < n ? __ldg(bias + c + 1) : 0.0f);
  }
  __syncthreads();

  for (; s < blocks; s += stride) {
    uint4 nxt[2][Q];
    if (s + stride < blocks) load(s + stride, nxt);
    float c[NT][4], big[F32 ? NT : 1][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[j][i] = 0.0f;
        if constexpr (F32) big[j][i] = 0.0f;
      }
    // load q's words x, y, z, w of rows g (r0) and g + 8 (r1) make two k
    // steps: bf16 m16n8k16 a = (r0.x, r1.x, r0.y, r1.y), then (.z, .w)
    // (logical k 2t, 2t + 1 the word's pair, 2t + 8, 2t + 9 the next);
    // f32 m16n8k8 the same words as TF32 (logical k t, t + 4), each split
    // into hi and lo
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const uint4 r0 = cur[0][q], r1 = cur[1][q];
      const uint32_t a[2][4] = {{r0.x, r1.x, r0.y, r1.y},
                                {r0.z, r1.z, r0.w, r1.w}};
      const uint4* f = Bf + (size_t)q * NT * BW * 32 + lane;
      if constexpr (F32) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int st = 0; st < 2; ++st)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(a[st][i]), ah[st][i], al[st][i]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4 hi = f[j * 64], lo = f[j * 64 + 32];
          mma_tf32_1688(c[j], al[0], hi.x, hi.y);
          mma_tf32_1688(c[j], ah[0], lo.x, lo.y);
          mma_tf32_1688(c[j], al[1], hi.z, hi.w);
          mma_tf32_1688(c[j], ah[1], lo.z, lo.w);
          mma_tf32_1688(big[j], ah[0], hi.x, hi.y);
          mma_tf32_1688(big[j], ah[1], hi.z, hi.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint4 b = f[j * 32];
          mma_bf16_16816(c[j], a[0], b.x, b.y);
          mma_bf16_16816(c[j], a[1], b.z, b.w);
        }
      }
    }
    // each lane's first maximum over its columns of rows g, g + 8 (h)
    float best[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
    int idx[2] = {SENT, SENT};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z0 = c[j][2 * h], z1 = c[j][2 * h + 1];
        if constexpr (F32) {
          z0 = big[j][2 * h] + z0;
          z1 = big[j][2 * h + 1] + z1;
        }
        z0 += bv[j].x;
        z1 += bv[j].y;
        if constexpr (!F32) {   // both rounded to bf16 by one cvt
          const __nv_bfloat162 r = __floats2bfloat162_rn(z0, z1);
          z0 = __low2float(r);
          z1 = __high2float(r);
        }
        // only the last tile holds padded columns
        if (j < NT - 1 || col < n) head_fold(z0, col, best[h], idx[h]);
        if (j < NT - 1 || col + 1 < n)
          head_fold(z1, col + 1, best[h], idx[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (isnan(best[h])) {
        best[h] = __int_as_float(0x7f800000);  // +inf
        idx[h] = -1;
      }
    // the quad: xor 1 pairs lanes, each keeping row h = t & 1 and sending
    // the other; xor 2 then joins the pairs, so lanes t = 0, 1 end with
    // rows g and g + 8
    const int hb = t & 1;
    float kb = hb ? best[1] : best[0];
    int ki = hb ? idx[1] : idx[0];
    float ob = __shfl_xor_sync(0xffffffffu, hb ? best[0] : best[1], 1);
    int oi = __shfl_xor_sync(0xffffffffu, hb ? idx[0] : idx[1], 1);
    if (head_better(ob, oi, kb, ki)) {
      kb = ob;
      ki = oi;
    }
    ob = __shfl_xor_sync(0xffffffffu, kb, 2);
    oi = __shfl_xor_sync(0xffffffffu, ki, 2);
    if (head_better(ob, oi, kb, ki)) ki = oi;
    // lanes t = 0 and 1 store the block's 16 predictions, 64 contiguous
    // bytes
    const long long m = s * 16 + hb * 8 + g;
    if (t < 2 && m < M) out[m] = ki < 0 ? n - 1 : ki == SENT ? 0 : ki;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < Q; ++q) cur[h][q] = nxt[h][q];
  }
}

// One wave of persistent CTAs (W laid out once a CTA), at most one per 8
// m16 blocks.
template <typename T, int NT>
cudaError_t launch_1x1(const void* feats, const void* w, const void* bias,
                       void* out, long long M, int n, cudaStream_t s) {
  const auto kernel = head_argmax_1x1_kernel<T, NT>;
  static int gm = 0;
  if (gm == 0) {
    const cudaError_t e = resident_ctas(kernel, CTA1, 0, &gm);
    if (e != cudaSuccess) return e;
  }
  const long long ctas = ((M + 15) / 16 + WARPS1 - 1) / WARPS1;
  kernel<<<(unsigned)(ctas < gm ? ctas : gm), CTA1, 0, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<int*>(out), M, n);
  return cudaGetLastError();
}

template <typename T>
int head_1x1(const void* feats, const void* w, const void* bias, void* out,
             int M, int n, void* stream) {
  if (M < 1 || n < 1 || n > 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 7) / 8) {
    case 1: return launch_1x1<T, 1>(feats, w, bias, out, M, n, s);
    case 2: return launch_1x1<T, 2>(feats, w, bias, out, M, n, s);
    case 3: return launch_1x1<T, 3>(feats, w, bias, out, M, n, s);
    default: return launch_1x1<T, 4>(feats, w, bias, out, M, n, s);
  }
}

template <typename T, int NTP>
int launch_head(const void* feats, const void* w, const void* bias,
                void* out, int B, int H, int W, int n, cudaStream_t s) {
  const auto kernel = head_argmax_kernel<T, NTP>;
  const int ntp = (n + 7) / 8;
  // the smem of this n; the attribute is set once for the most a form
  // takes (n = 256 where NTP = 0)
  const auto bytes = [](int tiles) {
    return (size_t)4 * tiles * 32 * HeadForm<T>::FW * 4 +
           (size_t)32 * tiles * 4;
  };
  static bool ok = false;
  static int gm = 0;
  cudaError_t e = allow_smem(kernel, bytes(NTP ? NTP : 32), &ok);
  if (e != cudaSuccess) return e;
  int grid_max = gm;
  if (grid_max == 0) {
    if ((e = resident_ctas(kernel, THREADS, bytes(ntp), &grid_max)) !=
        cudaSuccess)
      return e;
    if (NTP) gm = grid_max;   // NTP = 0: the smem varies with n
  }
  const long long M = (long long)B * H * W;
  const long long ctas = ((M + PX - 1) / PX + WARPS - 1) / WARPS;
  head_argmax_kernel<T, NTP>
      <<<(unsigned)(ctas < grid_max ? ctas : grid_max), THREADS, bytes(ntp),
         s>>>(static_cast<const T*>(feats), static_cast<const T*>(w),
              static_cast<const float*>(bias), static_cast<int*>(out), M, H,
              W, n, ntp);
  return cudaGetLastError();
}

template <typename T>
int head(const void* feats, const void* w, const void* bias, void* out,
         int B, int H, int W, int n, void* stream) {
  if (n < 1 || n > 256 || B < 1 || H < 1 || W < 1 ||
      (long long)B * H * W >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 7) / 8) {
    case 1: return launch_head<T, 1>(feats, w, bias, out, B, H, W, n, s);
    case 2: return launch_head<T, 2>(feats, w, bias, out, B, H, W, n, s);
    case 3: return launch_head<T, 3>(feats, w, bias, out, B, H, W, n, s);
    case 4: return launch_head<T, 4>(feats, w, bias, out, B, H, W, n, s);
    default: return launch_head<T, 0>(feats, w, bias, out, B, H, W, n, s);
  }
}

}  // namespace

// feats: (M, 128) bf16, 16-byte aligned; w: (128, n) bf16; bias: (n,)
// f32; out: (M,) int32.  n <= 32 (NT = ceil(n / 8) n8 tiles).
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
