// The halo-patch pieces shared by the train NB1d conv pair (nb1d_pair.cu:
// its four convs and the weight gradient) and the eval NB1d blocks (nb1d.cu:
// the bf16 whole-map block's stages; nb1d_halo.cu: the wgmma pieces;
// nb1d_q8.cu: the int8 blocks' patches, tiling and s8 wgmma).  The tiling
// (Geo, make_geo, tile_at, Taps) is conv32.cuh's; patch_geo / patch_tile
// are the eval blocks' form of it (each tap a constant shift of a patch).
//
// stage_patch copies a tile's halo patch of a bf16 (or int8) map into
// shared memory with 16-byte cp.async (cp.async.cg: through L2, so a map
// written earlier in the same launch is read correctly), zero where a
// position is off the map, in either layout: pixel-major (a pixel's C
// channels in one row of pitch LDP, for ldmatrix) or chunk-major (16 bytes
// of every pixel in a plane: chunk e of every pixel in plane e, pixel after
// pixel 16 bytes apart, for wgmma's core matrices).
//
// wgmma pieces (bf16 in, f32 sums; s8 in, s32 sums): the descriptor of an
// operand without swizzle, the m64nNk16 bf16 and m64nNk32 s8 products with
// both operands in shared memory (wgmma_bf16, wgmma_s8), the fences and
// waits, and reg_fence (pins registers that an in-flight wgmma reads or
// writes).  A K-major operand without swizzle is read as 8-row x 16-byte
// core matrices of 128 contiguous bytes: a chunk-major patch is one
// wherever an m64 block starts (8 consecutive pixels of a plane), so a tap
// of a halo patch, a constant shift of its pixels, is an A operand as it
// stands.  In bytes the layout is one for both types: a chunk is 8 bf16
// channels or 16 int8 codes, a bf16 k16 step or half an s8 k32 step.
#pragma once

#include "common.cuh"
#include "conv32.cuh"

namespace erfk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix x4 (and .trans) from a shared-memory byte address: each lane
// gives the row address of its own matrix row, so a row of a tap's view is
// any patch pixel.
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Start copying tile tl's patch of the (B, H, W, C) map src (bf16, or
// int8 codes with T = int8_t) into dst, 16-byte chunk e (8 bf16 or 16 int8
// channels) of patch pixel px at dst + px LDP + e LDE (in elements of T),
// zero where a position is off the map (nothing is read there).  Patch
// pixel px = j TA + a at along position tl.lo + j (band 0; tl.lo may be
// negative, a patch that keeps its halo off the map) or band j / L's (band
// 1): consecutive threads copy consecutive 16 bytes of a map row on the
// paths' tiles.
template <int C, int THREADS, int LDP, int LDE, typename T = bf16>
__device__ __forceinline__ void stage_patch(T* dst, const T* src,
                                            const Geo& g, const Tile& tl) {
  constexpr int EL = 16 / (int)sizeof(T), VK = C / EL;
  const int npx = tl.ext << g.lg;
  for (int v = threadIdx.x; v < npx * VK; v += THREADS) {
    const int e = v % VK, px = v / VK;
    const int j = px >> g.lg, c = tl.a0 + (px & (g.TA - 1));
    const int p = g.band ? tl.s0 + j % g.L + (j / g.L - 1) * g.d : tl.lo + j;
    const bool valid = p >= 0 && p < g.n && c < g.m;
    const long long off = valid ? geo_pixel(g, tl.b, p, c) * C + e * EL : 0;
    cp_async16(dst + px * LDP + e * LDE, src + off, valid);
  }
}

// A stage's tiling for the eval blocks' halo patches: tiles of at most bm
// pixels whose patch, the tile's L positions along and d on each side of
// them (off the map too, where the copy leaves zeros), holds at most cap
// pixels, at least ta_min across (a power of two); of those the one with
// the fewest tiles (then the smallest patch), else three bands of L
// positions (a dilation too large for one patch).  Either way each tap is
// the patch shifted by a constant: tap t of tile pixel q reads patch pixel
// q + t d TA (bands: q + t L TA).
inline Geo patch_geo(int H, int W, int axis, int d, int bm, int cap,
                     int ta_min) {
  Geo g;
  g.axis = axis;
  g.n = axis ? W : H;
  g.m = axis ? H : W;
  g.d = d < g.n ? d : g.n;
  g.band = 1;
  long long best = 0;
  int best_px = 0;
  for (int ta = ta_min; ta <= bm; ta *= 2) {
    const int L = g.n < bm / ta ? g.n : bm / ta;
    const int px = (L + 2 * g.d) * ta;
    if (px > cap) continue;
    const long long tiles =
        (long long)((g.n + L - 1) / L) * ((g.m + ta - 1) / ta);
    if (g.band || tiles < best || (tiles == best && px < best_px)) {
      best = tiles;
      best_px = px;
      g.L = L;
      g.TA = ta;
      g.band = 0;
    }
  }
  if (g.band) {
    g.TA = ta_min;
    g.L = cap / (3 * ta_min) < bm / ta_min ? cap / (3 * ta_min)
                                           : bm / ta_min;
  }
  for (g.lg = 0; (1 << g.lg) < g.TA;) ++g.lg;
  g.segs = (g.n + g.L - 1) / g.L;
  g.ablk = (g.m + g.TA - 1) / g.TA;
  return g;
}

// Tile t of a patch_geo tiling with its patch: band 0 keeps the whole
// halo, from s0 - d (conv32.cuh tile_at clamps it to the map).
__device__ __forceinline__ Tile patch_tile(const Geo& g, int t) {
  Tile tl = tile_at(g, t);
  if (!g.band) {
    tl.lo = tl.s0 - g.d;
    tl.ext = g.L + 2 * g.d;
  }
  return tl;
}

__device__ __forceinline__ float pick4(float a, float b, float c, float d,
                                       int i) {
  return i & 2 ? (i & 1 ? d : c) : (i & 1 ? b : a);
}

// p[s] = this lane's pair (columns 2 (lane % 4), + 1) of n8 tile s of four;
// v = the 8 columns of tile lane % 4, the pair of lane l at v[2 l]: a 4 x 4
// transpose of pairs across the quad (three xor shuffles; every lane of
// the warp calls it).
__device__ __forceinline__ void quad_gather(const float (&p)[4][2],
                                            float (&v)[8], int lane) {
  const int tq = lane % 4;
  float r[4][2];  // r[k]: the pair of lane tq ^ k
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    r[0][c] = pick4(p[0][c], p[1][c], p[2][c], p[3][c], tq);
#pragma unroll
    for (int k = 1; k < 4; ++k)
      r[k][c] = __shfl_xor_sync(
          0xffffffffu, pick4(p[0][c], p[1][c], p[2][c], p[3][c], tq ^ k), k);
  }
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      v[2 * l + c] = pick4(r[0][c], r[1][c], r[2][c], r[3][c], l ^ tq);
}

// r[l] = word lane % 4 of lane l's w (l = 0..3, the lanes of this quad):
// a 4 x 4 transpose of 32-bit words across the quad (three xor shuffles;
// every lane of the warp calls it).
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4],
                                               uint32_t (&r)[4], int lane) {
  const int tq = lane % 4;
  uint32_t got[4];  // got[k]: the word of lane tq ^ k
  got[0] = w[tq];
#pragma unroll
  for (int k = 1; k < 4; ++k)
    got[k] = __shfl_xor_sync(0xffffffffu, w[tq ^ k], k);
#pragma unroll
  for (int l = 0; l < 4; ++l) r[l] = got[l ^ tq];
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins registers that an in-flight wgmma reads or writes: the compiler
// neither moves nor reuses them across this point (placed after the wait
// that ends the wgmma).
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int M>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[M][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[m][i])::"memory");
}
// shared memory written by this thread (cp.async or stores) made visible
// to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma descriptor of a K-major operand without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes from p, lbo bytes between two
// adjacent in K, sbo between two adjacent in M (or N).
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}

// d (64 x N f32, the warpgroup's accumulator fragments: n8 tile j of the
// warp's 16 rows at d[4 j ..], rows lane / 4 and + 8, columns 2 (lane % 4)
// and + 1) = a (64 x 16 bf16, descriptor da) b (16 x N bf16, descriptor db)
// + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[8], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The byte offset of k16 step ks of tap t in a tap stack laid out for
// wgmma_bf16's B (ops/cuda/nb1d.py wg_taps): per tap a (C x C) image of
// core matrices (k8 chunk kc, n8) at (kc C / 8 + n8) 128 bytes, row n of
// one its 8 consecutive k; C 32 bytes a k16 step.  Its descriptor: lbo C
// 16 (the next k8 chunk), sbo 128 (the next 8 columns).
template <int C>
__device__ __forceinline__ uint32_t wg_tap_offset(int t, int ks) {
  return (uint32_t)(t * C * C * 2 + ks * C * 32);
}


// d (64 x N s32, the warpgroup's accumulator fragments, laid out as
// wgmma_bf16's) = a (64 x 32 s8, descriptor da) b (32 x N s8, descriptor
// db, K-major) + (scale_d ? d : 0).  The int32 sums are exact.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The byte offset of k32 step ks of tap t in a tap stack of int8 codes laid
// out for wgmma_s8's B (ops/cuda/nb1d_q8.py wg_taps_q8): per tap a (C x C)
// image of core matrices (k16 chunk kc, n8) at (kc C / 8 + n8) 128 bytes,
// row n of one its 16 consecutive k; C 32 bytes a k32 step.  Its
// descriptor: lbo C 16 (the next k16 chunk), sbo 128 (the next 8 columns).
// The bf16 layout in bytes (wg_tap_offset), a tap C C bytes.
template <int C>
__device__ __forceinline__ uint32_t wg_tap_offset_q8(int t, int ks) {
  return (uint32_t)(t * C * C + ks * C * 32);
}

}  // namespace erfk
