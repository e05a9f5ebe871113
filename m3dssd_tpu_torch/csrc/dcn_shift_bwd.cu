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
// What bounds it on an H100. cols writes, and coord reads, a
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
// data: one block of NT threads per pixel. The block first computes the
// K^2 (2R+1)^2 triangle weights of its pixel and their source rows into
// shared memory, then each thread walks its channels (thread t owns c = t,
// t + NT, ...), so the reads and writes of a row are coalesced.
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

constexpr int NT = 128;          // threads per block of data
constexpr int MAX_SMEM = 232448;
constexpr int MAX_SPLIT = 64;
constexpr int TH = 8, TW = 16;   // pixel tile of cols and coord
constexpr int TP = TH * TW;
constexpr int COLS_NT = 256;
constexpr int COLS_RV = 8;       // 16-byte vectors per slab row of cols
constexpr int COORD_K = 3;       // coord takes a 3 x 3 kernel
constexpr int COORD_N = 2;       // pixels per coord lane (a column of N)
constexpr int COORD_LANES = TP / COORD_N;  // lanes per tap
constexpr int COORD_NT = COORD_K * COORD_K * COORD_LANES;  // 576
constexpr int COORD_ROW = 64;    // bytes of a pixel's (or a gk row's) chunk
constexpr int RED_NT = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

struct Pixel {
  int b, y, x;
};

__device__ __forceinline__ Pixel pixel_of(long long p, int H, int W) {
  Pixel q;
  q.x = (int)(p % W);
  const long long bh = p / W;
  q.y = (int)(bh % H);
  q.b = (int)(bh / H);
  return q;
}

// 16 bytes of shared memory as float32 values
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load_vec(const uint8_t* p, float (&f)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
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
// data (one block per input pixel)
// ---------------------------------------------------------------------------

// dx[q, c] = sum over taps k and knots of (m tri tri)(p, k) gk[p, k, c],
// p = q - s(k, knot) inside the image
template <typename T, int R>
__global__ void __launch_bounds__(NT)
dcn_shift_bwd_data_kernel(const T* __restrict__ gk,
                          const float* __restrict__ offset,
                          const float* __restrict__ mask, T* __restrict__ dx,
                          int H, int W, int C, int K, float clamp) {
  constexpr int S = 2 * R + 1;
  extern __shared__ float smem[];
  const int KK = K * K, NTERM = KK * S * S, pad = K / 2;
  float* wts = smem;
  long long* src = reinterpret_cast<long long*>(smem + 2 * ((NTERM + 1) / 2));
  const long long qi = blockIdx.x;
  const Pixel q = pixel_of(qi, H, W);
  for (int t = threadIdx.x; t < NTERM; t += NT) {
    const int k = t / (S * S), iy = (t / S) % S, ix = t % S;
    const int py = q.y - (k / K - pad + iy - R);
    const int px = q.x - (k % K - pad + ix - R);
    float wt = 0.f;
    long long row = -1;
    if (py >= 0 && py < H && px >= 0 && px < W) {
      const long long pp = ((long long)q.b * H + py) * W + px;
      const float oy = clip(offset[(pp * KK + k) * 2], clamp);
      const float ox = clip(offset[(pp * KK + k) * 2 + 1], clamp);
      wt = mask[pp * KK + k] * tri(oy, iy - R) * tri(ox, ix - R);
      if (wt != 0.f) row = pp * KK + k;
    }
    wts[t] = wt;
    src[t] = row;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float acc = 0.f;
    for (int t = 0; t < NTERM; ++t) {
      const long long row = src[t];
      if (row >= 0) acc += wts[t] * to_f(gk[row * C + c]);
    }
    dx[qi * C + c] = from_f<T>(acc);
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

// byte offset of 16-byte vector 0 of 64-byte row r of a box the TMA wrote
// with its 64-byte swizzle (address bits 4-5 XOR bits 7-8); vector v is at
// the offset ^ (v << 4)
__device__ __forceinline__ int swz64_offset(int r) {
  return r * COORD_ROW + (((r >> 1) & 3) << 4);
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

// a 4-D tensor map of a contiguous tensor with the given dims (innermost
// first, in elements) and box, 64-byte swizzle, zero outside the tensor
bool tensor_map4(CUtensorMap* map, const void* base, int dtype,
                 const cuuint64_t (&dims)[4], const cuuint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = dtype == 0 ? 4 : 2;
  const cuuint64_t strides[3] = {dims[0] * es, dims[0] * dims[1] * es,
                                 dims[0] * dims[1] * dims[2] * es};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map,
            dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
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

// shared memory of data (float weight + 64-bit row) for K*K*(2R+1)^2 terms
int terms(int K, int R) { return K * K * (2 * R + 1) * (2 * R + 1); }

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
cudaError_t launch_data(const void* gk, const void* offset, const void* mask,
                        void* dx, int B, int H, int W, int C, int K,
                        float clamp, cudaStream_t s) {
  const int n = terms(K, R);
  const int smem = (int)(2 * ((n + 1) / 2) * sizeof(float) +
                         n * sizeof(long long));
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dcn_shift_bwd_data_kernel<T, R><<<(unsigned)((long long)B * H * W), NT,
                                    smem, s>>>(
      static_cast<const T*>(gk), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(dx), H, W, C, K,
      clamp);
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

// dx [B,H,W,C] in gk's type from gk [B*H*W, K*K*C]
extern "C" int dcn_shift_bwd_data(const void* gk, const void* offset,
                                  const void* mask, void* dx, int dtype,
                                  int B, int H, int W, int C, int K,
                                  float clamp, int R, void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_data<float, 1>(gk, offset, mask, dx, B, H, W, C, K,
                                       clamp, s)
               : launch_data<float, 2>(gk, offset, mask, dx, B, H, W, C, K,
                                       clamp, s);
  else
    e = R == 1 ? launch_data<__nv_bfloat16, 1>(gk, offset, mask, dx, B, H, W,
                                               C, K, clamp, s)
               : launch_data<__nv_bfloat16, 2>(gk, offset, mask, dx, B, H, W,
                                               C, K, clamp, s);
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
  if (!tensor_map4(&x_map, x, dtype, x_dims, x_box) ||
      !tensor_map4(&gk_map, gk, dtype, gk_dims, gk_box))
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
