// Backward of the clipped-offset shift DCN (csrc/dcn_shift.cu computes the
// forward): the column build, the input gradient and the offset/mask
// gradients, the three parts of the transpose that are not matrix products.
//
// Replaces: m3dssd_tpu/ops/dcn.py:_dcn_shift_core_bwd, the reference
// package's hand-written transpose of the shifted-MAC forward (XLA on the
// TPU; its forward is the TPU kernel m3dssd_tpu/ops/dcn_pallas.py).
//
// What it computes. With R = ceil(clamp), knots d in [-R, R], the clipped
// offset (oy, ox) of tap k at output pixel p, tri(u) = max(0, 1 - |u|) and
// s(k, dy, dx) = (ky + dy - K/2, kx + dx - K/2), the forward is
//     col[p, k, c] = m[p,k] * sum_{dy,dx} tri(oy-dy) tri(ox-dx) x[p + s, c]
//     out[p, :]    = sum_{k,c} col[p,k,c] * w[k,c,:]
// Given the output cotangent g and gk = g . W^T ([B*H*W, K*K*C], a matrix
// product the wrapper leaves to cuBLAS, as is dW = col^T . g):
//   * dcn_shift_bwd_cols_kernel writes col itself ([B*H*W, K*K*C], the
//     forward's column build standing alone) for the dW product;
//   * dcn_shift_bwd_data_kernel writes dx in gather form: each input pixel
//     q sums m tri tri (evaluated at p = q - s) * gk[p, k, :] over its
//     taps and knots. No atomics, so dx is the same on every run;
//   * dcn_shift_bwd_coord_kernel forms, per (p, k), the C-dot table
//     t[dy][dx] = sum_c gk[p,k,c] x[p + s, c] and from it
//         dmask = sum tri(oy-dy) tri(ox-dx) t
//         doy   = m sum tri'(oy-dy) tri(ox-dx) t,  dox likewise,
//     times the clip's derivative, with the reference package's subgradient
//     conventions: d|u|/du = +1 at 0, d max(t, 0)/dt = 0.5 at 0, and the
//     clip passes 0.5 at |o| = clamp (m3dssd_tpu/ops/dcn.py:343-365). At
//     init every offset is exactly 0, on those kinks, where tri' is non-zero
//     at three knots per axis: the whole table is needed, not 4 corners.
// Sums are taken in float32 whatever the feature type; dx and col are
// written in x's type, doffset and dmask in float32.
//
// What bounds it on an H100. cols writes, and data and coord read, a
// [B*H*W, K^2*C] tensor, K^2 = 9 times the bytes of x; their operations
// (4 corners per column element, (2R+1)^2 dot products per (p, k, c)) come
// to less than half of that time on the float32 CUDA cores at R = 1. So
// both are bound by memory, and what keeps a simple kernel from the bound
// is re-reading x: 81 shifted rows per pixel through the caches.
//
// Design of cols and coord. One block owns an 8 x 16 pixel tile of one
// image (the forward's tile) and walks the channels in chunks. The chunk's
// x slab, the tile plus a halo of P = K/2 + R pixels, zero outside the
// image, is staged in shared memory and double-buffered, so the next chunk
// lands while this one is used. Every output is written once, with no
// atomics, so the results are the same from run to run.
//   * cols (256 threads, two blocks per SM, 128-byte chunks: 64 bf16 or 32
//     float32 channels; slab by 16-byte cp.async). Per tile the block
//     computes each (pixel, tap)'s 4 bilinear corner weights (mask folded
//     in) and the slab index of its upper-left corner once, into shared
//     memory, with the forward's edge rule (floor(o) capped at R - 1, so an
//     offset at +R stays in the slab). Then 8 lanes cover one (pixel, tap)
//     row of the chunk: each sums its 4 corners, 8 bf16 channels at a time
//     from 16-byte slab reads, in float32, rounds once and writes 16 bytes,
//     so a warp writes 4 whole 128-byte rows.
//   * coord (576 threads = 18 warps, one block per SM, 64-byte chunks: 32
//     bf16 or 16 float32 channels). Each stage holds the chunk's x slab and
//     the tile's gk rows ([8 x 16 px x 9 taps] x 64 bytes), each one 4-D
//     box copied by the TMA (thread 0 issues, an mbarrier counts the bytes;
//     the TMA zero-fills the halo outside the image) with its 64-byte
//     swizzle. Two warps own each tap; a lane owns a column of 2 vertically
//     adjacent pixels of it and keeps their 2 (2R+1)^2 tables in registers
//     across all chunks. A lane reads its pixels' gk once and each slab
//     vector of their joint window once: (2 + 2R) x (2R + 1) loads instead
//     of 2 (2R+1)^2, each used for up to 2 dot products. The 8 lanes of a
//     quarter-warp take 8 neighbouring pixels, whose rows the swizzle puts
//     in 8 distinct bank groups; each lane's swizzled row offsets are
//     computed once, so a load costs one XOR. No table is split across
//     lanes, so no shuffle reduction is needed; each lane applies the
//     subgradient rules to its own pairs.
//     Staging both by 16-byte cp.async measured slower on an H100: those
//     requests moved the bytes more slowly than the TMA's boxes.
//   * Both take rows of 16-byte multiples, 16-byte aligned: the wrapper
//     copies x (and gk) with C padded by zero channels where they are not.
//   * Where the tiles cannot fill the card (the first neck layer, 12 x 40,
//     gives 48 tiles), the wrapper splits the chunks over blockIdx.y: cols
//     needs no reduction; coord writes float32 partial tables and
//     dcn_shift_bwd_coord_reduce_kernel sums them in a fixed order before
//     the subgradient rules.
// The launch geometry (tiles, chunk split, shared memory) is planned in
// Python (ops/dcn_cuda.py:bwd_plan) and checked here.
//
// Design of data (the transpose of cols: it reads the 9C-wide gk and
// writes the C-wide dx). One block of 256 threads owns an 8 x 16 tile of
// input pixels q of one image and walks the channels in 128-byte chunks
// (64 bf16 or 32 float32 channels), and within a chunk the K^2 taps. For
// tap k the rows q needs are p = q - s(k, knot): the tile shifted by
// (K/2 - ky, K/2 - kx) and widened by R, a (TH+2R) x (TW+2R) box of gk
// seen as the 5-D tensor {C, K^2, W, H, B}, which the TMA copies (thread 0
// issues, an mbarrier counts the bytes; 128-byte swizzle) and zero-fills
// outside the image, never from the neighbouring image. Per-tap boxes read
// 1.41 x the tile's gk rows through L2 at R = 1; one box over the union
// window would read 1.875 x. The boxes go through a ring of DATA_STAGES
// stages (a full and an empty mbarrier each): thread 0 refills a stage as
// soon as every warp has released it. Nine boxes of a chunk would take
// 207,360 bytes at R = 1; the ring of single taps keeps a block at 74,048
// bytes, two blocks per SM.
//   Per tile, the block first stores for every (tap, box pixel) its
// clipped offset and mask, read from the window of the tile plus a halo
// of K/2 + R with coalesced loads (zero mask outside the image). In any
// tap's box, knot (dy, dx) of the tile's pixel (qy, qx) is box pixel
// (qy + R - dy, qx + R - dx), so a lane computes its rows' addresses once.
// Two lanes own a pixel, four 16-byte vectors of the chunk each (one lane
// per pixel and all eight vectors measured slower: half the warps; 64-byte
// chunks too: twice the boxes). Per knot a lane reads p's entry, forms
// m tri(oy - dy) tri(ox - dx) and, only where that is non-zero (one knot
// of nine when every offset is 0), reads its 4 vectors by 16-byte loads,
// widens bf16 by one shift or mask per value and sums in float32. The
// swizzle puts the rows of 8 neighbouring pixels in 8 distinct bank
// groups. After the K^2 taps the lane writes its 64 bytes of dx, rounded
// once. Taps and knots are summed in a fixed order, with no atomics; the
// first neck layer's chunks are split over blockIdx.y as in cols
// (disjoint channels, no reduce).
//
// Interface: plain C, loaded with ctypes (ops/dcn_cuda.py). Layouts: x
// [B,H,W,C], offset [B,H,W,K*K,2] float32 (dy, dx), mask [B,H,W,K*K]
// float32, gk and col [B*H*W, K*K*C] in x's type, dx [B,H,W,C] in x's type,
// doffset [B,H,W,K*K,2] and dmask [B,H,W,K*K] float32; all contiguous.
// dtype 0 is float32, 1 bfloat16. Each entry point launches on the given
// stream and returns the cudaError_t of its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_shift_common.cuh"

namespace {

using namespace dcn_common;

constexpr int MAX_SMEM = 232448;
constexpr int MAX_SPLIT = 64;
constexpr int TH = 8, TW = 16;   // pixel tile of every kernel here
constexpr int TP = TH * TW;
constexpr int COLS_NT = 256;
constexpr int COLS_RV = 8;       // 16-byte vectors per slab row of cols
constexpr int COORD_K = 3;       // coord takes a 3 x 3 kernel
constexpr int COORD_N = 2;       // pixels per coord lane (a column of N)
constexpr int COORD_LANES = TP / COORD_N;  // lanes per tap
constexpr int COORD_NT = COORD_K * COORD_K * COORD_LANES;  // 576
constexpr int COORD_ROW = 64;    // bytes of a pixel's (or a gk row's) chunk
constexpr int RED_NT = 256;
constexpr int DATA_ROW = 128;    // bytes of a gk row's chunk in data (the
                                 // 128-byte swizzle's span)
constexpr int DATA_LPP = 2;      // data's lanes per pixel of the tile
constexpr int DATA_NT = TP * DATA_LPP;
constexpr int DATA_RV = DATA_ROW / 16 / DATA_LPP;  // 16-byte vectors a lane
constexpr int DATA_STAGES = 2;   // tap boxes in data's ring

__device__ __forceinline__ float clip(float o, float clamp) {
  return fminf(fmaxf(o, -clamp), clamp);
}

// triangle weight max(0, 1 - |o - d|)
__device__ __forceinline__ float tri(float o, int d) {
  return fmaxf(0.f, 1.f - fabsf(o - (float)d));
}

// d tri(o - d) / do: -dmax0(1 - |u|) * dabs(u), u = o - d, with
// dabs(u) = +1 for u >= 0 and dmax0(t) = 1, 0.5, 0 for t >, ==, < 0
__device__ __forceinline__ float dtri(float o, int d) {
  const float u = o - (float)d;
  const float t = 1.f - fabsf(u);
  const float dmax0 = t > 0.f ? 1.f : (t == 0.f ? 0.5f : 0.f);
  return -dmax0 * (u >= 0.f ? 1.f : -1.f);
}

// d clip(o, -clamp, clamp) / do: 1 inside, 0.5 on the edge, 0 outside
__device__ __forceinline__ float dclip(float o, float clamp) {
  const float a = fabsf(o);
  return a < clamp ? 1.f : (a == clamp ? 0.5f : 0.f);
}

// 16 bytes of shared memory as float32 values
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

// the same from a shared-memory address: one 16-byte load, and each bf16
// widened by one shift or mask
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void lds_vec(uint32_t addr, float (&f)[4]) {
  const uint4 v = lds128(addr);
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void lds_vec(uint32_t addr, float (&f)[8]) {
  const uint4 v = lds128(addr);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16/sizeof(T) float32 values rounded to T, one 16-byte store
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst,
                                          const float (&v)[8]) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                 pack2(v[6], v[7]));
}

// Geometry shared with ops/dcn_cuda.py:bwd_plan.
__host__ __device__ constexpr int slab_pixels(int K, int R) {
  return (TH + 2 * (K / 2 + R)) * (TW + 2 * (K / 2 + R));
}
__host__ __device__ constexpr int cols_slab_bytes(int K, int R) {
  return slab_pixels(K, R) * COLS_RV * 16;
}
// two slabs, then per (pixel, tap) a float4 of weights and an int2 of
// (slab index, output row)
__host__ __device__ constexpr int cols_smem_bytes(int K, int R) {
  return 2 * cols_slab_bytes(K, R) + TP * K * K * (16 + 8);
}
// one stage of coord: the x slab box, padded to 1024 bytes, and the gk box
// (a multiple of 1024 bytes), each at a 1024-byte boundary so that the
// TMA's 64-byte swizzle follows the offsets
__host__ __device__ constexpr int coord_slab_bytes(int R) {
  return (slab_pixels(COORD_K, R) * COORD_ROW + 1023) & ~1023;
}
__host__ __device__ constexpr int coord_gk_bytes() {
  return TP * COORD_K * COORD_K * COORD_ROW;
}
__host__ __device__ constexpr int coord_stage_bytes(int R) {
  return coord_slab_bytes(R) + coord_gk_bytes();
}
// two stages and 1024 bytes of alignment slack
__host__ __device__ constexpr int coord_smem_bytes(int R) {
  return 1024 + 2 * coord_stage_bytes(R);
}
// data's gk box of one tap: the tile widened by R
__host__ __device__ constexpr int data_box_pixels(int R) {
  return (TH + 2 * R) * (TW + 2 * R);
}
// one stage of data's ring: a box at a 1024-byte boundary (the swizzle)
__host__ __device__ constexpr int data_stage_bytes(int R) {
  return (data_box_pixels(R) * DATA_ROW + 1023) & ~1023;
}
// 1024 bytes of alignment slack, the ring, then per (tap, box pixel) a
// float4 (clipped oy, ox, mask, 0)
__host__ __device__ constexpr int data_smem_bytes(int K, int R) {
  return 1024 + DATA_STAGES * data_stage_bytes(R) +
         K * K * data_box_pixels(R) * 16;
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int block, int tiles_y, int tiles_x) {
  Tile t;
  const int per_img = tiles_y * tiles_x;
  t.b = block / per_img;
  const int i = block - t.b * per_img;
  t.y0 = (i / tiles_x) * TH;
  t.x0 = (i % tiles_x) * TW;
  return t;
}

// ---------------------------------------------------------------------------
// cols
// ---------------------------------------------------------------------------

struct ColsArgs {
  const void* x;
  const float* offset;
  const float* mask;
  void* col;
  int B, H, W, C, K;
  float clamp;
  int tiles_y, tiles_x, chunks_per_split;
};

// slab of cols: pixel p of the (TH+2P) x (TW+2P) window at p * 128 bytes
template <typename T>
__device__ __forceinline__ void cols_load_slab(const ColsArgs& a,
                                               uint8_t* slab, const Tile& t,
                                               int P, int SW, int npix,
                                               int c0) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  for (int e = threadIdx.x; e < npix * COLS_RV; e += COLS_NT) {
    const int p = e / COLS_RV, v = e % COLS_RV;
    const int sy = p / SW, sx = p - sy * SW;
    const int gy = t.y0 - P + sy, gx = t.x0 - P + sx;
    const int c = c0 + v * VEC;
    const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W && c < a.C;
    cp_async16(smem_u32(slab + e * 16),
               ok ? x + (((long long)t.b * a.H + gy) * a.W + gx) * a.C + c
                  : x,
               ok ? 16 : 0);
  }
}

// col[p, k*C + c] = m tri tri-weighted 4 corners of x around p + s(k)
template <typename T, int R>
__global__ void __launch_bounds__(COLS_NT, 2)
dcn_shift_bwd_cols_kernel(const __grid_constant__ ColsArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = COLS_RV * VEC;  // channels per chunk
  extern __shared__ __align__(16) uint8_t tile_smem[];
  uint8_t* smem = tile_smem;
  const int K = a.K, KK = K * K, P = K / 2 + R;
  const int SW = TW + 2 * P, npix = (TH + 2 * P) * SW;
  const int slab_bytes = npix * COLS_RV * 16;
  float4* wt = reinterpret_cast<float4*>(smem + 2 * slab_bytes);
  int2* idx = reinterpret_cast<int2*>(wt + TP * KK);
  const int tid = threadIdx.x;
  const Tile t = tile_of(blockIdx.x, a.tiles_y, a.tiles_x);
  const int nchunks = (a.C + CH - 1) / CH;
  const int j0 = blockIdx.y * a.chunks_per_split;
  const int j1 = min(nchunks, j0 + a.chunks_per_split);

  cols_load_slab<T>(a, smem, t, P, SW, npix, j0 * CH);
  cp_async_commit();
  // per (pixel m, tap k): 4 corner weights and (upper-left slab index,
  // output row (y*W + x)*KK + k); index -1 for a pixel outside the image
  for (int r = tid; r < TP * KK; r += COLS_NT) {
    const int m = r / KK, k = r - m * KK;
    const int py = m / TW, px = m % TW;
    const int gy = t.y0 + py, gx = t.x0 + px;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    int2 id = make_int2(-1, 0);
    if (gy < a.H && gx < a.W) {
      const long long pk = (((long long)t.b * a.H + gy) * a.W + gx) * KK + k;
      const float oy = clip(a.offset[2 * pk], a.clamp);
      const float ox = clip(a.offset[2 * pk + 1], a.clamp);
      const float mk = a.mask[pk];
      // floor(o) = R only at o = R, where the upper corner weighs 0:
      // take the corners R-1, R so both stay inside the slab
      const float fy = fminf(floorf(oy), (float)(R - 1));
      const float fx = fminf(floorf(ox), (float)(R - 1));
      const float ly = oy - fy, lx = ox - fx;
      const float wy0 = (1.f - ly) * mk, wy1 = ly * mk;
      w = make_float4(wy0 * (1.f - lx), wy0 * lx, wy1 * (1.f - lx), wy1 * lx);
      id.x = (py + k / K + (int)fy + R) * SW + px + k % K + (int)fx + R;
      id.y = (gy * a.W + gx) * KK + k;
    }
    wt[r] = w;
    idx[r] = id;
  }

  T* colb = static_cast<T*>(a.col) + (long long)t.b * a.H * a.W * KK * a.C;
  const int g = tid % COLS_RV;
  for (int j = j0; j < j1; ++j) {
    const uint8_t* slab = smem + ((j - j0) & 1) * slab_bytes;
    cp_async_wait<0>();
    __syncthreads();  // slab j (and the weights) ready; slab j-1 released
    if (j + 1 < j1) {
      cols_load_slab<T>(a, smem + ((j + 1 - j0) & 1) * slab_bytes, t, P, SW,
                        npix, (j + 1) * CH);
      cp_async_commit();
    }
    const int c = j * CH + g * VEC;
    if (c >= a.C) continue;
#pragma unroll 4
    for (int r = tid / COLS_RV; r < TP * KK; r += COLS_NT / COLS_RV) {
      const int2 id = idx[r];
      if (id.x < 0) continue;
      const float4 w = wt[r];
      float f[VEC], v[VEC];
      load_vec(slab + (id.x * COLS_RV + g) * 16, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = w.x * f[i];
      load_vec(slab + ((id.x + 1) * COLS_RV + g) * 16, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = fmaf(w.y, f[i], v[i]);
      load_vec(slab + ((id.x + SW) * COLS_RV + g) * 16, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = fmaf(w.z, f[i], v[i]);
      load_vec(slab + ((id.x + SW + 1) * COLS_RV + g) * 16, f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = fmaf(w.w, f[i], v[i]);
      store_vec(colb + (long long)id.y * a.C + c, v);
    }
  }
}

// ---------------------------------------------------------------------------
// coord
// ---------------------------------------------------------------------------

struct CoordArgs {
  const float* offset;
  const float* mask;
  float* doffset;
  float* dmask;
  float* partial;  // [split, B*H*W*9, (2R+1)^2] when the chunks are split
  int B, H, W, C;
  float clamp;
  int tiles_y, tiles_x, chunks_per_split;
};

// dmask and doffset of pair pk (pixel * 9 + tap) from its C-dot table
template <int R>
__device__ __forceinline__ void coord_epilogue(
    const float (&t)[2 * R + 1][2 * R + 1], const float* offset,
    const float* mask, float clamp, long long pk, float* doffset,
    float* dmask) {
  constexpr int S = 2 * R + 1;
  const float ry = offset[2 * pk], rx = offset[2 * pk + 1];
  const float oy = clip(ry, clamp), ox = clip(rx, clamp);
  float wy[S], wx[S], gy[S], gx[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    wy[i] = tri(oy, i - R);
    wx[i] = tri(ox, i - R);
    gy[i] = dtri(oy, i - R);
    gx[i] = dtri(ox, i - R);
  }
  float dm = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
  for (int iy = 0; iy < S; ++iy)
#pragma unroll
    for (int ix = 0; ix < S; ++ix) {
      dm += wy[iy] * wx[ix] * t[iy][ix];
      sy += gy[iy] * wx[ix] * t[iy][ix];
      sx += wy[iy] * gx[ix] * t[iy][ix];
    }
  const float mk = mask[pk];
  dmask[pk] = dm;
  doffset[2 * pk] = mk * sy * dclip(ry, clamp);
  doffset[2 * pk + 1] = mk * sx * dclip(rx, clamp);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(phase)
      : "memory");
}
// a 4-D TMA box of map at coordinates (c0, c1, c2, c3) into dst, counted
// on bar
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the 5-D form of tma_load4
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// byte offset of 16-byte vector 0 of 64-byte row r of a box the TMA wrote
// with its 64-byte swizzle (address bits 4-5 XOR bits 7-8); vector v is at
// the offset ^ (v << 4)
__device__ __forceinline__ int swz64_offset(int r) {
  return r * COORD_ROW + (((r >> 1) & 3) << 4);
}
// the same for 128-byte rows and the 128-byte swizzle (address bits 4-6
// XOR bits 7-9)
__device__ __forceinline__ int swz128_offset(int r) {
  return r * 128 + ((r & 7) << 4);
}

// thread 0: chunk j's x slab and gk box into stage st, counted on bar (the
// fence orders the block's earlier reads of st before the TMA's writes)
template <int CH, int SLAB, int BYTES>
__device__ __forceinline__ void coord_issue(uint8_t* st, uint64_t* bar,
                                            const CUtensorMap* xm,
                                            const CUtensorMap* gm,
                                            const Tile& t, int H, int P,
                                            int j) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, BYTES);
  tma_load4(st, xm, bar, j * CH, t.x0 - P, t.y0 - P, t.b);
  tma_load4(st + SLAB, gm, bar, j * CH, 0, t.x0, t.b * H + t.y0);
}

// per (p, k): the C-dot table t against the shifted x, then dmask and
// doffset with the subgradient rules above (or, when split, the partial
// table of this block's chunks). Stage s holds chunk j's x slab, the box
// [TH+2P rows][TW+2P px][64 bytes] of x, and its gk box [TH][TW][9 taps]
// [64 bytes], both loaded by the TMA, issued by thread 0.
template <typename T, int R>
__global__ void __launch_bounds__(COORD_NT, 1)
dcn_shift_bwd_coord_kernel(const __grid_constant__ CoordArgs a,
                           const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap gk_map) {
  constexpr int S = 2 * R + 1;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RV = COORD_ROW / 16;
  constexpr int CH = RV * VEC;  // channels per chunk
  constexpr int KK = COORD_K * COORD_K;
  constexpr int P = COORD_K / 2 + R, SW = TW + 2 * P;
  constexpr int SLAB = coord_slab_bytes(R), STAGE = coord_stage_bytes(R);
  constexpr int BYTES = slab_pixels(COORD_K, R) * COORD_ROW +
                        coord_gk_bytes();  // what the TMA writes per stage
  extern __shared__ uint8_t coord_smem[];
  __shared__ __align__(8) uint64_t full[2];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(coord_smem) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  // the threads of tap k own lanes (h, x): the pixels (N h + i, x), i < N
  const int k = tid / COORD_LANES, lane = tid % COORD_LANES;
  const int ky = k / COORD_K, kx = k % COORD_K;
  const int h = lane / TW, px = lane % TW;
  const Tile t = tile_of(blockIdx.x, a.tiles_y, a.tiles_x);
  const int nchunks = (a.C + CH - 1) / CH;
  const int j0 = blockIdx.y * a.chunks_per_split;
  const int j1 = min(nchunks, j0 + a.chunks_per_split);
  // gk row of pixel i is row0 + i * TW * KK; slab pixel of pixel 0's knot
  // (-R, -R) of tap k is sp0; pixel i's knot (dy, dx) lies at
  // sp0 + (i + dy + R) * SW + dx + R
  const int row0 = (COORD_N * h * TW + px) * KK + k;
  const int sp0 = (COORD_N * h + ky) * SW + px + kx;
  // their byte offsets in a stage with the 64-byte swizzle of vector 0;
  // vector v of the same row lies at offset ^ (v << 4)
  int g_off[COORD_N], s_off[COORD_N + S - 1][S];
#pragma unroll
  for (int i = 0; i < COORD_N; ++i)
    g_off[i] = SLAB + swz64_offset(row0 + i * TW * KK);
#pragma unroll
  for (int jj = 0; jj < COORD_N + S - 1; ++jj)
#pragma unroll
    for (int bb = 0; bb < S; ++bb)
      s_off[jj][bb] = swz64_offset(sp0 + jj * SW + bb);

  const CUtensorMap* xm = &x_map;
  const CUtensorMap* gm = &gk_map;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    coord_issue<CH, SLAB, BYTES>(smem, full, xm, gm, t, a.H, P, j0);
  }
  __syncthreads();

  float acc[COORD_N][S][S];
#pragma unroll
  for (int i = 0; i < COORD_N; ++i)
#pragma unroll
    for (int aa = 0; aa < S; ++aa)
#pragma unroll
      for (int bb = 0; bb < S; ++bb) acc[i][aa][bb] = 0.f;

  for (int j = j0; j < j1; ++j) {
    // the stage of chunk j + 1 was released by the barrier that ended
    // iteration j - 1
    if (tid == 0 && j + 1 < j1)
      coord_issue<CH, SLAB, BYTES>(smem + ((j + 1 - j0) & 1) * STAGE,
                                   &full[(j + 1 - j0) & 1], xm, gm, t, a.H, P,
                                   j + 1);
    mbar_wait(&full[(j - j0) & 1], ((j - j0) >> 1) & 1);
    const uint8_t* slab = smem + ((j - j0) & 1) * STAGE;
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      float g[COORD_N][VEC];
#pragma unroll
      for (int i = 0; i < COORD_N; ++i)
        load_vec(slab + (g_off[i] ^ (v << 4)), g[i]);
#pragma unroll
      for (int bb = 0; bb < S; ++bb) {
#pragma unroll
        for (int jj = 0; jj < COORD_N + S - 1; ++jj) {
          float sv[VEC];
          load_vec(slab + (s_off[jj][bb] ^ (v << 4)), sv);
#pragma unroll
          for (int i = 0; i < COORD_N; ++i) {
            const int aa = jj - i;
            if (aa >= 0 && aa < S) {
              float d = acc[i][aa][bb];
#pragma unroll
              for (int e = 0; e < VEC; ++e) d = fmaf(g[i][e], sv[e], d);
              acc[i][aa][bb] = d;
            }
          }
        }
      }
    }
    __syncthreads();  // stage (j - j0) & 1 is free for chunk j + 2
  }

  const long long npairs = (long long)a.B * a.H * a.W * KK;
#pragma unroll
  for (int i = 0; i < COORD_N; ++i) {
    const int gy = t.y0 + COORD_N * h + i, gx = t.x0 + px;
    if (gy >= a.H || gx >= a.W) continue;
    const long long pk = (((long long)t.b * a.H + gy) * a.W + gx) * KK + k;
    if (a.partial != nullptr) {
      float* dst = a.partial + (blockIdx.y * npairs + pk) * S * S;
#pragma unroll
      for (int aa = 0; aa < S; ++aa)
#pragma unroll
        for (int bb = 0; bb < S; ++bb) dst[aa * S + bb] = acc[i][aa][bb];
    } else {
      coord_epilogue<R>(acc[i], a.offset, a.mask, a.clamp, pk, a.doffset,
                        a.dmask);
    }
  }
}

// the split's partial tables summed in order, then the subgradient rules
template <int R>
__global__ void __launch_bounds__(RED_NT)
dcn_shift_bwd_coord_reduce_kernel(const __grid_constant__ CoordArgs a,
                                  int split) {
  constexpr int S = 2 * R + 1;
  const long long npairs = (long long)a.B * a.H * a.W * COORD_K * COORD_K;
  for (long long pk = (long long)blockIdx.x * RED_NT + threadIdx.x;
       pk < npairs; pk += (long long)gridDim.x * RED_NT) {
    float t[S][S];
#pragma unroll
    for (int aa = 0; aa < S; ++aa)
#pragma unroll
      for (int bb = 0; bb < S; ++bb) t[aa][bb] = 0.f;
    for (int s = 0; s < split; ++s) {
      const float* src = a.partial + (s * npairs + pk) * S * S;
#pragma unroll
      for (int aa = 0; aa < S; ++aa)
#pragma unroll
        for (int bb = 0; bb < S; ++bb) t[aa][bb] += src[aa * S + bb];
    }
    coord_epilogue<R>(t, a.offset, a.mask, a.clamp, pk, a.doffset, a.dmask);
  }
}

// ---------------------------------------------------------------------------
// data
// ---------------------------------------------------------------------------

struct DataArgs {
  const float* offset;
  const float* mask;
  void* dx;
  int B, H, W, C, K;
  float clamp;
  int tiles_y, tiles_x, chunks_per_split;
};

// thread 0: the gk box of chunk j, tap k into stage st, counted on bar
// (the fence orders the block's earlier reads of st before the TMA's
// writes). The box starts at the tile's corner shifted by
// (K/2 - ky - R, K/2 - kx - R).
template <int R, int CH, int BYTES>
__device__ __forceinline__ void data_issue(uint8_t* st, uint64_t* bar,
                                           const CUtensorMap* gm,
                                           const Tile& t, int K, int j,
                                           int k) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect_tx(bar, BYTES);
  const int pad = K / 2;
  tma_load5(st, gm, bar, j * CH, k, t.x0 + pad - k % K - R,
            t.y0 + pad - k / K - R, t.b);
}

// dx[q, c] = sum over taps k and knots (dy, dx) of
// (m tri(oy - dy) tri(ox - dx))(p, k) gk[p, k, c], p = q - s(k, dy, dx)
// inside the image. The block's items are (chunk, tap) pairs in order;
// item i sits in stage i % DATA_STAGES.
template <typename T, int R>
__global__ void __launch_bounds__(DATA_NT, 2)
dcn_shift_bwd_data_kernel(const __grid_constant__ DataArgs a,
                          const __grid_constant__ CUtensorMap gk_map) {
  constexpr int S = 2 * R + 1;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = DATA_ROW / sizeof(T);  // channels per chunk
  constexpr int BW = TW + 2 * R, BOX = data_box_pixels(R);
  constexpr int STAGE = data_stage_bytes(R);
  constexpr int BYTES = BOX * DATA_ROW;  // what the TMA writes per item
  extern __shared__ uint8_t data_smem[];
  __shared__ __align__(8) uint64_t full[DATA_STAGES], empty[DATA_STAGES];
  // 1024-byte aligned, as an offset from data_smem so that the compiler
  // keeps shared-memory loads
  uint8_t* ring = data_smem + ((1024 - (smem_u32(data_smem) & 1023)) & 1023);
  float4* tab = reinterpret_cast<float4*>(ring + DATA_STAGES * STAGE);
  const int tid = threadIdx.x;
  const int K = a.K, KK = K * K, pad = K / 2, P = pad + R;
  const Tile t = tile_of(blockIdx.x, a.tiles_y, a.tiles_x);
  const int nchunks = (a.C + CH - 1) / CH;
  const int j0 = blockIdx.y * a.chunks_per_split;
  const int j1 = min(nchunks, j0 + a.chunks_per_split);
  const int items = (j1 - j0) * KK;
  const CUtensorMap* gm = &gk_map;
  if (tid == 0) {
    for (int st = 0; st < DATA_STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], DATA_NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < DATA_STAGES && i < items; ++i)
      data_issue<R, CH, BYTES>(ring + i * STAGE, &full[i], gm, t, K,
                               j0 + i / KK, i % KK);
  }
  // tab[k * BOX + box pixel] = (clipped oy, ox, mask) of the pixel p the
  // box of tap k holds there, mask 0 outside the image. A thread takes a
  // pixel of the window (tile plus a halo of P) and its K^2 taps, so its
  // loads of offset and mask are contiguous and a warp's are coalesced;
  // window pixel (wy, wx) lies at box pixel (wy - 2 pad + ky,
  // wx - 2 pad + kx) of tap k, if inside that box.
  const int WW = TW + 2 * P, WN = (TH + 2 * P) * WW;
  for (int wp = tid; wp < WN; wp += DATA_NT) {
    const int wy = wp / WW, wx = wp - wy * WW;
    const int gy = t.y0 - P + wy, gx = t.x0 - P + wx;
    const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const long long p0 =
        in ? (((long long)t.b * a.H + gy) * a.W + gx) * KK : 0;
    for (int ky = 0; ky < K; ++ky) {
      const int ry = wy - 2 * pad + ky;
      if (ry < 0 || ry >= TH + 2 * R) continue;
#pragma unroll 3
      for (int kx = 0; kx < K; ++kx) {
        const int rx = wx - 2 * pad + kx, k = ky * K + kx;
        if (rx < 0 || rx >= BW) continue;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (in) {
          const float2 o = __ldg(
              reinterpret_cast<const float2*>(a.offset + 2 * (p0 + k)));
          v = make_float4(clip(o.x, a.clamp), clip(o.y, a.clamp),
                          __ldg(a.mask + p0 + k), 0.f);
        }
        tab[k * BOX + ry * BW + rx] = v;
      }
    }
  }
  __syncthreads();  // the table and the barriers are ready

  // the lane's pixel (qy, qx) and vectors v0 + v, v < DATA_RV, of the
  // chunk: its knot (dy, dx) is box pixel rq + (R - dy) * BW + R - dx in
  // every tap's box; the swizzled byte offsets of those rows' vector v0
  // are computed once (vector v0 + v lies at the offset ^ (v << 4))
  const int q = tid % TP, v0 = tid / TP * DATA_RV;
  const int qy = q / TW, qx = q % TW;
  const int rq = qy * BW + qx;
  int row_off[S][S];
#pragma unroll
  for (int iy = 0; iy < S; ++iy)
#pragma unroll
    for (int ix = 0; ix < S; ++ix)
      row_off[iy][ix] =
          swz128_offset(rq + (S - 1 - iy) * BW + S - 1 - ix) ^ (v0 << 4);
  const bool inside = t.y0 + qy < a.H && t.x0 + qx < a.W;
  T* dxq = static_cast<T*>(a.dx) +
           (((long long)t.b * a.H + t.y0 + qy) * a.W + t.x0 + qx) * a.C;
  float acc[DATA_RV][VEC];
#pragma unroll
  for (int v = 0; v < DATA_RV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;

  int j = j0, k = 0;
  for (int i = 0; i < items; ++i) {
    const int st = i % DATA_STAGES;
    // refill the stage of item i - 1 with item i - 1 + DATA_STAGES once
    // every warp has released it
    if (tid == 0 && i > 0 && i - 1 + DATA_STAGES < items) {
      const int prev = (i - 1) % DATA_STAGES, next = i - 1 + DATA_STAGES;
      mbar_wait(&empty[prev], ((i - 1) / DATA_STAGES) & 1);
      data_issue<R, CH, BYTES>(ring + prev * STAGE, &full[prev], gm, t, K,
                               j0 + next / KK, next % KK);
    }
    mbar_wait(&full[st], (i / DATA_STAGES) & 1);
    const uint32_t box = smem_u32(ring) + st * STAGE;
    const float4* tk = tab + k * BOX + rq;
#pragma unroll
    for (int iy = 0; iy < S; ++iy) {
#pragma unroll
      for (int ix = 0; ix < S; ++ix) {
        const float4 o = tk[(S - 1 - iy) * BW + S - 1 - ix];
        const float w = o.z * tri(o.x, iy - R) * tri(o.y, ix - R);
        if (w != 0.f) {
#pragma unroll
          for (int v = 0; v < DATA_RV; ++v) {
            float f[VEC];
            lds_vec((box + row_off[iy][ix]) ^ (v << 4), f);
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[v][e] = fmaf(w, f[e], acc[v][e]);
          }
        }
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&empty[st]);
    if (++k == KK) {
      // chunk j is summed over every tap: write the lane's part of dx
#pragma unroll
      for (int v = 0; v < DATA_RV; ++v) {
        const int c = j * CH + (v0 + v) * VEC;
        if (inside && c < a.C) store_vec(dxq + c, acc[v]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;
      }
      k = 0;
      ++j;
    }
  }
}

// cuTensorMapEncodeTiled, found through the runtime (no link to libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// an N-D tensor map of a contiguous tensor with the given dims (innermost
// first, in elements) and box, swizzled (64 bytes unless said), zero
// outside the tensor
template <int N>
bool tensor_map(CUtensorMap* map, const void* base, int dtype,
                const cuuint64_t (&dims)[N], const cuuint32_t (&box)[N],
                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_64B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t strides[N - 1];
  cuuint32_t ones[N];
  cuuint64_t stride = dtype == 0 ? 4 : 2;
  for (int i = 0; i < N; ++i) {
    if (i < N - 1) strides[i] = stride *= dims[i];
    ones[i] = 1;
  }
  return fn(map,
            dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            N, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool valid_problem(int B, int H, int W, int C, int K, float clamp, int R) {
  return B > 0 && H > 0 && W > 0 && C > 0 && K > 0 && K % 2 == 1 &&
         clamp > 0.f && (R == 1 || R == 2);
}

// rows of C channels of p start 16-byte aligned (the 16-byte copies and
// stores; the wrapper pads C where they would not)
bool rows16(int C, int dtype, const void* p) {
  return (C * (dtype == 0 ? 4 : 2)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the plan's tiles and chunk split agree with this file's geometry
bool valid_plan(int H, int W, int C, int chunk, int tiles_y, int tiles_x,
                int split, int chunks_per_split, int smem, int need) {
  const int nchunks = (C + chunk - 1) / chunk;
  return tiles_y == (H + TH - 1) / TH && tiles_x == (W + TW - 1) / TW &&
         chunks_per_split >= 1 && split >= 1 && split <= MAX_SPLIT &&
         split == (nchunks + chunks_per_split - 1) / chunks_per_split &&
         smem >= need && smem <= MAX_SMEM;
}

template <typename T, int R>
cudaError_t launch_cols(const ColsArgs& a, int split, int smem,
                        cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      dcn_shift_bwd_cols_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(a.B * a.tiles_y * a.tiles_x), (unsigned)split);
  dcn_shift_bwd_cols_kernel<T, R><<<grid, COLS_NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_data(const DataArgs& a, const CUtensorMap& gk_map,
                        int split, int smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      dcn_shift_bwd_data_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(a.B * a.tiles_y * a.tiles_x), (unsigned)split);
  dcn_shift_bwd_data_kernel<T, R><<<grid, DATA_NT, smem, s>>>(a, gk_map);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_coord(const CoordArgs& a, const CUtensorMap& x_map,
                         const CUtensorMap& gk_map, int split, int smem,
                         cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      dcn_shift_bwd_coord_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(a.B * a.tiles_y * a.tiles_x), (unsigned)split);
  dcn_shift_bwd_coord_kernel<T, R><<<grid, COORD_NT, smem, s>>>(a, x_map,
                                                                 gk_map);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const long long npairs = (long long)a.B * a.H * a.W * COORD_K * COORD_K;
  const long long blocks = (npairs + RED_NT - 1) / RED_NT;
  dcn_shift_bwd_coord_reduce_kernel<R>
      <<<(unsigned)(blocks < 4096 ? blocks : 4096), RED_NT, 0, s>>>(a, split);
  return cudaGetLastError();
}

}  // namespace

// col [B*H*W, K*K*C] in x's type, on the launch plan of
// ops/dcn_cuda.py:bwd_plan("cols", ...)
extern "C" int dcn_shift_bwd_cols(const void* x, const void* offset,
                                  const void* mask, void* col, int dtype,
                                  int B, int H, int W, int C, int K,
                                  float clamp, int R, int tiles_y,
                                  int tiles_x, int split,
                                  int chunks_per_split, int smem,
                                  void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int chunk = COLS_RV * (dtype == 0 ? 4 : 8);
  if (!valid_plan(H, W, C, chunk, tiles_y, tiles_x, split, chunks_per_split,
                  smem, cols_smem_bytes(K, R)) ||
      !rows16(C, dtype, x) || !rows16(C, dtype, col))
    return (int)cudaErrorInvalidValue;
  ColsArgs a;
  a.x = x, a.offset = static_cast<const float*>(offset);
  a.mask = static_cast<const float*>(mask), a.col = col;
  a.B = B, a.H = H, a.W = W, a.C = C, a.K = K, a.clamp = clamp;
  a.tiles_y = tiles_y, a.tiles_x = tiles_x;
  a.chunks_per_split = chunks_per_split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_cols<float, 1>(a, split, smem, s)
               : launch_cols<float, 2>(a, split, smem, s);
  else
    e = R == 1 ? launch_cols<__nv_bfloat16, 1>(a, split, smem, s)
               : launch_cols<__nv_bfloat16, 2>(a, split, smem, s);
  return (int)e;
}

// dx [B,H,W,C] in gk's type from gk [B*H*W, K*K*C], on the launch plan
// of ops/dcn_cuda.py:bwd_plan("data", ...). gk and dx must start 16-byte
// aligned and C * sizeof(T) be a multiple of 16 (the TMA's strides, the
// 16-byte stores): the wrapper pads C where it is not.
extern "C" int dcn_shift_bwd_data(const void* gk, const void* offset,
                                  const void* mask, void* dx, int dtype,
                                  int B, int H, int W, int C, int K,
                                  float clamp, int R, int tiles_y,
                                  int tiles_x, int split,
                                  int chunks_per_split, int smem,
                                  void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int chunk = DATA_ROW / (dtype == 0 ? 4 : 2);
  if (!valid_plan(H, W, C, chunk, tiles_y, tiles_x, split, chunks_per_split,
                  smem, data_smem_bytes(K, R)) ||
      !rows16(C, dtype, gk) || !rows16(C, dtype, dx))
    return (int)cudaErrorInvalidValue;
  CUtensorMap gk_map;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)(K * K),
                              (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t box[5] = {(cuuint32_t)chunk, 1, (cuuint32_t)(TW + 2 * R),
                             (cuuint32_t)(TH + 2 * R), 1};
  if (!tensor_map(&gk_map, gk, dtype, dims, box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  DataArgs a;
  a.offset = static_cast<const float*>(offset);
  a.mask = static_cast<const float*>(mask);
  a.dx = dx;
  a.B = B, a.H = H, a.W = W, a.C = C, a.K = K, a.clamp = clamp;
  a.tiles_y = tiles_y, a.tiles_x = tiles_x;
  a.chunks_per_split = chunks_per_split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_data<float, 1>(a, gk_map, split, smem, s)
               : launch_data<float, 2>(a, gk_map, split, smem, s);
  else
    e = R == 1 ? launch_data<__nv_bfloat16, 1>(a, gk_map, split, smem, s)
               : launch_data<__nv_bfloat16, 2>(a, gk_map, split, smem, s);
  return (int)e;
}

// doffset [B,H,W,9,2] and dmask [B,H,W,9] float32 (K = 3), on the launch
// plan of ops/dcn_cuda.py:bwd_plan("coord", ...); partial: float32
// workspace [split, B*H*W*9, (2R+1)^2], used when split > 1. x and gk must
// start 16-byte aligned and C * sizeof(T) be a multiple of 16 (the TMA's
// strides): the wrapper pads C where it is not.
extern "C" int dcn_shift_bwd_coord(const void* x, const void* gk,
                                   const void* offset, const void* mask,
                                   void* doffset, void* dmask, void* partial,
                                   int dtype, int B, int H, int W, int C,
                                   int K, float clamp, int R, int tiles_y,
                                   int tiles_x, int split,
                                   int chunks_per_split, int smem,
                                   void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || K != COORD_K || dtype < 0 ||
      dtype > 1 || (split > 1) != (partial != nullptr))
    return (int)cudaErrorInvalidValue;
  const int es = dtype == 0 ? 4 : 2;
  const int chunk = COORD_ROW / es;
  if (!valid_plan(H, W, C, chunk, tiles_y, tiles_x, split, chunks_per_split,
                  smem, coord_smem_bytes(R)) ||
      !rows16(C, dtype, x) || !rows16(C, dtype, gk))
    return (int)cudaErrorInvalidValue;
  const int P = COORD_K / 2 + R;
  CUtensorMap x_map, gk_map;
  const cuuint64_t x_dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
  const cuuint32_t x_box[4] = {(cuuint32_t)chunk,
                               (cuuint32_t)(TW + 2 * P),
                               (cuuint32_t)(TH + 2 * P), 1};
  const cuuint64_t gk_dims[4] = {(cuuint64_t)C, (cuuint64_t)(COORD_K * COORD_K),
                                 (cuuint64_t)W, (cuuint64_t)B * H};
  const cuuint32_t gk_box[4] = {(cuuint32_t)chunk,
                                (cuuint32_t)(COORD_K * COORD_K),
                                (cuuint32_t)TW, (cuuint32_t)TH};
  if (!tensor_map(&x_map, x, dtype, x_dims, x_box) ||
      !tensor_map(&gk_map, gk, dtype, gk_dims, gk_box))
    return (int)cudaErrorInvalidValue;
  CoordArgs a;
  a.offset = static_cast<const float*>(offset);
  a.mask = static_cast<const float*>(mask);
  a.doffset = static_cast<float*>(doffset);
  a.dmask = static_cast<float*>(dmask);
  a.partial = static_cast<float*>(partial);
  a.B = B, a.H = H, a.W = W, a.C = C, a.clamp = clamp;
  a.tiles_y = tiles_y, a.tiles_x = tiles_x;
  a.chunks_per_split = chunks_per_split;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_coord<float, 1>(a, x_map, gk_map, split, smem, s)
               : launch_coord<float, 2>(a, x_map, gk_map, split, smem, s);
  else
    e = R == 1 ? launch_coord<__nv_bfloat16, 1>(a, x_map, gk_map, split, smem,
                                                s)
               : launch_coord<__nv_bfloat16, 2>(a, x_map, gk_map, split, smem,
                                                s);
  return (int)e;
}

extern "C" const char* dcn_shift_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
