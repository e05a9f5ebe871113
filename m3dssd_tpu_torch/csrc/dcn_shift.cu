// Forward of the modulated deformable convolution (DCNv2) with offsets
// clipped to +-clamp, stride 1, dilation 1, padding K/2: the neck DCN of the
// flagship detector.
//
// Replaces: m3dssd_tpu/ops/dcn_pallas.py:dcn_v2_shift_pallas, the TPU
// kernel of the same function (and the XLA op ops/dcn.py:dcn_v2_shift that
// the JAX model runs in its place).
//
// What it computes. With R = ceil(clamp), tap k of output pixel p samples
//     col[p, k, c] = m[p,k] * sum_{dy,dx} tri(oy-dy) * tri(ox-dx)
//                             * x[y + ky - K/2 + dy, x + kx - K/2 + dx, c]
// over the knots dy, dx in [-R, R], with tri(u) = max(0, 1 - |u|), (oy, ox)
// the clipped offset, and zero outside the image. For |o| <= R only the
// knots floor(o) and floor(o) + 1 carry weight, so this is 4-corner
// bilinear sampling. Then out[p, :] = sum_{k,c} col[p,k,c] * w[k,c,:] + bias.
//
// What bounds it on an H100. 2 * HW * K^2 * C * Cout operations against
// (HW * (C + Cout) + K^2 * C * Cout) elements moved: at the flagship's neck
// shapes (K = 3, C and Cout 256..1024) that is hundreds of operations per
// byte, so the function is bound by the tensor cores' rate, not by memory.
// What keeps a kernel from that rate is the column build that feeds them:
// read from device memory per tap, x would be read 9 times per (pixel,
// channel) and the product would wait on it.
//
// bfloat16 design (dcn_shift_bf16_wgmma_kernel). One block owns a 2-D tile
// of TH x TW = 8 x 16 = 128 output pixels of one image by BN = 128 output
// channels, and walks the reduction in chunks of BK = 64 input channels:
//   * the chunk's x slab, the tile plus a halo of P = K/2 + R pixels, is
//     copied once into shared memory by cp.async, zero outside the image
//     (the TPU kernel's padded VMEM slab); all K^2 taps read it from there;
//   * per tap, each thread clips its pixel's offset in float32 and sums the
//     4 bilinear corners, 8 channels (16 bytes) at a time from the slab, in
//     float32, and writes the column tile A [128 px, 64 ch] in bfloat16 in
//     the K-major 128-byte-swizzled layout that wgmma reads;
//   * the weight chunk W[k, c0:c0+64, n0:n0+128] is copied by cp.async,
//     straight from the [K*K*C, Cout] layout, into a 2-stage ring as an
//     N-major 128-byte-swizzled tile;
//   * two warpgroups each multiply 64 rows of A by W with
//     wgmma.m64n128k16 (bf16 in, float32 accumulators in registers). The
//     product of one tap runs asynchronously while the block builds the
//     next tap's columns into the other A buffer and loads the next weight
//     chunk, so the CUDA cores and the tensor cores overlap;
//   * where the output tiles cannot fill the card, the wrapper splits the
//     channel chunks S ways (blockIdx.z): each split writes float32 partial
//     sums to a workspace and dcn_shift_splitk_reduce_kernel sums the S
//     partials in a fixed order, adds the bias and casts (no atomics, so
//     the result does not change from run to run);
//   * the epilogue adds the float32 bias, rounds to bfloat16, stages the
//     tile in shared memory and writes it in 16-byte rows.
// The columns are rounded to bfloat16 before the product, as the reference
// forms its columns in x's type; the product accumulates in float32.
// The [B*H*W, K^2*C] columns never reach device memory. The launch
// geometry (tiles, split, shared memory) is planned in Python
// (ops/dcn_cuda.py:plan) and checked here.
//
// What bounds this design. Per step (one tap of one 64-channel chunk, 1M
// multiply-adds on the tensor cores, 512 cycles at their peak) a block
// moves about 144 KB through shared memory: 64 KB of corner reads from
// the slab, 16 KB of A written, 16 KB of weights landing, and 48 KB of
// wgmma operand reads. At 128 bytes per cycle per SM that is about 1100
// cycles, so shared-memory traffic of the column build, not the tensor
// cores, sets the pace; two blocks per SM (127 registers, ~95 KB of
// shared memory each) hide each other's latency. On an H100 a 3-stage
// weight ring and reading the next tap's offsets a step ahead measured no
// faster. A wider BN (256, one block per SM) would halve the build's
// traffic per multiply-add.
//
// float32 (dcn_shift_fwd_kernel): the first version, kept as the exact
// float32 form. One block owns BM = 64 output pixels (flattened over B*H*W)
// by BN = 128 channels, builds 16-channel column chunks from x with the
// (2R+1)^2 triangle weights, and multiplies on the CUDA cores in float32.
//
// Interface: plain C, loaded with ctypes (ops/dcn_cuda.py). Layouts:
// x [B,H,W,C], offset [B,H,W,K*K,2] float32 (dy, dx), mask [B,H,W,K*K]
// float32, weight [K*K*C, Cout] in x's type, bias [Cout] float32, out
// [B,H,W,Cout] in x's type; all contiguous. Each entry point launches on
// the given stream and returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_shift_common.cuh"

namespace {

__device__ __forceinline__ float tri(float u) {
  return fmaxf(0.f, 1.f - fabsf(u));
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 16;   // input channels per chunk
constexpr int TM = 4;    // output pixels per thread
constexpr int TN = 8;    // output channels per thread
constexpr int GX = BN / TN;        // 16 thread columns (output channels)
constexpr int NT = (BM / TM) * GX; // 256 threads

template <int R>
__global__ void __launch_bounds__(NT)
dcn_shift_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const float* __restrict__ weight,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int B, int H, int W, int C, int Cout, int K,
                     float clamp) {
  constexpr int D = 2 * R + 1;
  constexpr int DD = D * D;
  __shared__ __align__(16) float As[BK][BM + 4];  // column tile, k-major
  __shared__ __align__(16) float Bs[BK][BN];      // weight tile
  __shared__ float Wt[BM][DD];                    // per-pixel tap weights
  __shared__ int Pb[BM], Py[BM], Px[BM];          // pixel (b, y, x); b<0: none

  const int tid = threadIdx.x;
  const int tx = tid % GX;
  const int ty = tid / GX;
  const long long HW = (long long)H * W;
  const long long npix = (long long)B * HW;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KK = K * K;
  const int pad = K / 2;

  if (tid < BM) {
    const long long p = p0 + tid;
    if (p < npix) {
      const int b = (int)(p / HW);
      const int rem = (int)(p - (long long)b * HW);
      Pb[tid] = b;
      Py[tid] = rem / W;
      Px[tid] = rem % W;
    } else {
      Pb[tid] = -1;
      Py[tid] = 0;
      Px[tid] = 0;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < KK; ++k) {
    const int ky = k / K, kx = k % K;
    __syncthreads();  // pixel table ready; previous tap done reading Wt
    if (tid < BM) {
      if (Pb[tid] >= 0) {
        const long long pk = (p0 + tid) * KK + k;
        const float oy = fminf(fmaxf(offset[2 * pk], -clamp), clamp);
        const float ox = fminf(fmaxf(offset[2 * pk + 1], -clamp), clamp);
        const float m = mask[pk];
#pragma unroll
        for (int iy = 0; iy < D; ++iy) {
          const float wy = tri(oy - (float)(iy - R)) * m;
#pragma unroll
          for (int ix = 0; ix < D; ++ix)
            Wt[tid][iy * D + ix] = wy * tri(ox - (float)(ix - R));
        }
      } else {
#pragma unroll
        for (int t = 0; t < DD; ++t) Wt[tid][t] = 0.f;
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += BK) {
      // column tile: neighbouring threads take neighbouring channels
      for (int e = tid; e < BK * BM; e += NT) {
        const int c = e % BK;
        const int i = e / BK;
        const int b = Pb[i];
        float v = 0.f;
        if (b >= 0 && c0 + c < C) {
          const int yb = Py[i] + ky - pad - R;
          const int xb = Px[i] + kx - pad - R;
#pragma unroll
          for (int iy = 0; iy < D; ++iy) {
            const int sy = yb + iy;
            if (sy < 0 || sy >= H) continue;
            const float* row = x + ((long long)b * H + sy) * W * C + c0 + c;
#pragma unroll
            for (int ix = 0; ix < D; ++ix) {
              const int sx = xb + ix;
              if (sx < 0 || sx >= W) continue;
              v = fmaf(Wt[i][iy * D + ix], row[(long long)sx * C], v);
            }
          }
        }
        As[c][i] = v;
      }
      // weight tile: rows k*C + c0 .. k*C + c0 + BK of [K*K*C, Cout]
      for (int e = tid; e < BK * BN; e += NT) {
        const int j = e % BN;
        const int c = e / BN;
        float v = 0.f;
        if (c0 + c < C && n0 + j < Cout)
          v = weight[((long long)k * C + c0 + c) * Cout + n0 + j];
        Bs[c][j] = v;
      }
      __syncthreads();

#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float a[TM] = {a4.x, a4.y, a4.z, a4.w};
        float bv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + GX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long p = p0 + ty * TM + i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + GX * j;
      if (n < Cout) out[p * Cout + n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: wgmma kernel
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int TH = 8, TW = 16;        // output tile: 8 x 16 pixels of one image
constexpr int BM = TH * TW;           // 128 rows of the product
constexpr int BN = 128;               // output channels per block
constexpr int BK = 64;                // input channels per chunk (128 bytes)
constexpr int NT = 256;               // two warpgroups
constexpr int TILE_BYTES = BM * BK * 2;  // one A or W tile: 16 KB
constexpr int W_STAGES = 2;  // weight ring; loads run W_STAGES - 1 steps ahead
constexpr int MAX_SMEM = 232448;
// split-K reduce kernel
constexpr int RED_NT = 256;

// Shared memory: 1024 bytes of alignment slack, 2 A tiles, 2 W stages and
// one x slab of (TH + 2P) x (TW + 2P) pixels x 64 channels. Must agree
// with ops/dcn_cuda.py:plan.
__host__ __device__ constexpr int slab_bytes(int K, int R) {
  return (TH + 2 * (K / 2 + R)) * (TW + 2 * (K / 2 + R)) * BK * 2;
}
__host__ __device__ constexpr int smem_bytes(int K, int R) {
  return 1024 + (2 + W_STAGES) * TILE_BYTES + slab_bytes(K, R);
}

using namespace dcn_common;

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] * B[16 x 128]; A K-major, B N-major (transposed)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

struct Args {
  const __nv_bfloat16* x;
  const float* offset;
  const float* mask;
  const __nv_bfloat16* weight;
  const float* bias;
  __nv_bfloat16* out;
  float* partial;  // [S, B*H*W, Cout] when the reduction is split
  int B, H, W, C, Cout, K;
  float clamp;
  int tiles_x, tiles_y, chunks_per_split;
  int x_vec, w_vec;  // rows of x / weight allow 16-byte copies
};

// x slab of chunk j: pixel p of the (TH+2P) x (TW+2P) window at p * 128
// bytes, its 16-byte channel group g at position g ^ (p & 7)
__device__ __forceinline__ void load_slab(const Args& a, uint8_t* slab,
                                          int b, int y0, int x0, int P,
                                          int SW, int npix, int c0) {
  for (int e = threadIdx.x; e < npix * 8; e += NT) {
    const int p = e >> 3, g = e & 7;
    const int sy = p / SW, sx = p - (p / SW) * SW;
    const int gy = y0 - P + sy, gx = x0 - P + sx;
    const int c = c0 + g * 8;
    uint8_t* dst = slab + p * 128 + ((g ^ (p & 7)) << 4);
    const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    const long long base = (((long long)b * a.H + gy) * a.W + gx) * a.C;
    if (a.x_vec) {
      const bool ok = in && c < a.C;
      cp_async16(smem_u32(dst), ok ? (const void*)(a.x + base + c)
                                   : (const void*)a.x, ok ? 16 : 0);
    } else {
      __nv_bfloat16 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (in && c + i < a.C) ? a.x[base + c + i]
                                   : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// weight chunk of step (tap k, channels c0..c0+63): row r (input channel)
// of N-half h at h * 8192 + r * 128, 16-byte group g at g ^ (r & 7)
__device__ __forceinline__ void load_w(const Args& a, uint8_t* ws, int k,
                                       int c0, int n0) {
  for (int e = threadIdx.x; e < BK * (BN / 8); e += NT) {
    const int r = e >> 4, q = e & 15;
    const int h = q >> 3, g = q & 7;
    const int c = c0 + r, n = n0 + q * 8;
    uint8_t* dst = ws + h * 8192 + r * 128 + ((g ^ (r & 7)) << 4);
    const long long row = ((long long)k * a.C + c) * a.Cout;
    if (a.w_vec) {
      const bool ok = c < a.C && n < a.Cout;
      cp_async16(smem_u32(dst), ok ? (const void*)(a.weight + row + n)
                                   : (const void*)a.weight, ok ? 16 : 0);
    } else {
      __nv_bfloat16 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = (c < a.C && n + i < a.Cout) ? a.weight[row + n + i]
                                           : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 2)
dcn_shift_bf16_wgmma_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = smem;                   // 2 column tiles
  uint8_t* Ws = smem + 2 * TILE_BYTES;  // W_STAGES weight stages
  uint8_t* slab = smem + (2 + W_STAGES) * TILE_BYTES;

  const int tid = threadIdx.x;
  const int K = a.K, KK = K * K;
  const int P = K / 2 + R;
  const int SW = TW + 2 * P;
  const int npix = (TH + 2 * P) * SW;
  const int per_img = a.tiles_y * a.tiles_x;
  const int b = blockIdx.x / per_img;
  const int tile = blockIdx.x - b * per_img;
  const int y0 = (tile / a.tiles_x) * TH;
  const int x0 = (tile % a.tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int nchunks = (a.C + BK - 1) / BK;
  const int j0 = blockIdx.z * a.chunks_per_split;
  const int j1 = min(nchunks, j0 + a.chunks_per_split);
  const int t0 = j0 * KK, t1 = j1 * KK;

  // this thread's column-build row and channel groups
  const int m = tid >> 1, ghalf = (tid & 1) * 4;
  const int py = m / TW, px = m % TW;
  const int gy = y0 + py, gx = x0 + px;
  const bool pix_ok = gy < a.H && gx < a.W;
  const long long pix = ((long long)b * a.H + gy) * a.W + gx;

  const int wg = tid >> 7;  // warpgroup: rows 64*wg .. 64*wg + 63
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  load_slab(a, slab, b, y0, x0, P, SW, npix, j0 * BK);
  for (int i = 0; i < W_STAGES - 1 && t0 + i < t1; ++i)
    load_w(a, Ws + i * TILE_BYTES, (t0 + i) % KK, (t0 + i) / KK * BK, n0);
  cp_async_commit();

  for (int t = t0; t < t1; ++t) {
    const int j = t / KK, k = t - j * KK;
    const int s = (t - t0) & 1;
    const int ws = (t - t0) % W_STAGES;
    if (k == 0) {  // the chunk's slab (and this step's weights) in place
      cp_async_wait<0>();
      __syncthreads();
    }
    // build the column tile A(t): 4 bilinear corners from the slab
    {
      float w00 = 0.f, w01 = 0.f, w10 = 0.f, w11 = 0.f;
      int base = 0;
      if (pix_ok) {
        const long long pk = pix * KK + k;
        const float oy = fminf(fmaxf(__ldg(a.offset + 2 * pk), -a.clamp),
                               a.clamp);
        const float ox = fminf(fmaxf(__ldg(a.offset + 2 * pk + 1), -a.clamp),
                               a.clamp);
        const float mk = __ldg(a.mask + pk);
        // floor(o) = R only at o = R, where the upper corner weighs 0:
        // take the corners R-1, R so both stay inside the slab
        const float fy = fminf(floorf(oy), (float)(R - 1));
        const float fx = fminf(floorf(ox), (float)(R - 1));
        const float ly = oy - fy, lx = ox - fx;
        const float wy0 = (1.f - ly) * mk, wy1 = ly * mk;
        w00 = wy0 * (1.f - lx);
        w01 = wy0 * lx;
        w10 = wy1 * (1.f - lx);
        w11 = wy1 * lx;
        base = (py + k / K + (int)fy + R) * SW + px + k % K + (int)fx + R;
      }
      const int p00 = base, p01 = base + 1, p10 = base + SW,
                p11 = base + SW + 1;
      uint8_t* arow = As + s * TILE_BYTES + m * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int g = ghalf + q;
        float f[8], v[8];
        unpack8(*reinterpret_cast<const uint4*>(slab + p00 * 128 +
                                                ((g ^ (p00 & 7)) << 4)), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = w00 * f[i];
        unpack8(*reinterpret_cast<const uint4*>(slab + p01 * 128 +
                                                ((g ^ (p01 & 7)) << 4)), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fmaf(w01, f[i], v[i]);
        unpack8(*reinterpret_cast<const uint4*>(slab + p10 * 128 +
                                                ((g ^ (p10 & 7)) << 4)), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fmaf(w10, f[i], v[i]);
        unpack8(*reinterpret_cast<const uint4*>(slab + p11 * 128 +
                                                ((g ^ (p11 & 7)) << 4)), f);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fmaf(w11, f[i], v[i]);
        *reinterpret_cast<uint4*>(arow + ((g ^ (m & 7)) << 4)) =
            make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                       pack2(v[4], v[5]), pack2(v[6], v[7]));
      }
    }
    // the previous product is done with its A tile and W stage; the weights
    // of this step have landed
    fence_acc(acc);
    wgmma_wait_all();
    fence_acc(acc);
    cp_async_wait<W_STAGES - 2>();
    fence_async_shared();
    __syncthreads();
    if (t + 1 < t1 && (t + 1) / KK != j)
      load_slab(a, slab, b, y0, x0, P, SW, npix, (j + 1) * BK);
    const int tw = t + W_STAGES - 1;  // its stage was read by product t-1
    if (tw < t1)
      load_w(a, Ws + (tw - t0) % W_STAGES * TILE_BYTES, tw % KK,
             tw / KK * BK, n0);
    cp_async_commit();
    // A(t) [128 x 64] x W(t) [64 x 128], 4 steps of k = 16, left running
    {
      const uint32_t a_base = smem_u32(As + s * TILE_BYTES + wg * 64 * 128);
      const uint32_t w_base = smem_u32(Ws + ws * TILE_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(acc, wgmma_desc(a_base + kk * 32, 16, 1024),
                         wgmma_desc(w_base + kk * 2048, 8192, 1024));
      wgmma_commit();
    }
  }
  fence_acc(acc);
  wgmma_wait_all();
  fence_acc(acc);

  // accumulator layout of m64nNk16: acc[4j + 2h + e] is row
  // 16 * warp + lane / 4 + 8h, column 8j + 2 * (lane % 4) + e
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  const int col0 = 2 * (lane & 3);
  if (a.partial != nullptr) {
    // split reduction: float32 partial sums, no bias
    float* part = a.partial + (long long)blockIdx.z * a.B * a.H * a.W * a.Cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const int oy = y0 + r / TW, ox = x0 + r % TW;
      if (oy >= a.H || ox >= a.W) continue;
      float* dst = part + (((long long)b * a.H + oy) * a.W + ox) * a.Cout;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + col0;
        if ((a.Cout & 1) == 0 && n < a.Cout) {
          *reinterpret_cast<float2*>(dst + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          if (n < a.Cout) dst[n] = acc[4 * j + 2 * h];
          if (n + 1 < a.Cout) dst[n + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
    return;
  }
  // bias, round to bf16, stage the [128 px, 128 ch] tile in the two A
  // buffers (row r at r * 256 bytes, 16-byte group g at g ^ (r & 7)), then
  // write it out in 16-byte pieces
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + 8 * j + col0;
    const float b0 = n < a.Cout ? __ldg(a.bias + n) : 0.f;
    const float b1 = n + 1 < a.Cout ? __ldg(a.bias + n + 1) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      *reinterpret_cast<uint32_t*>(As + r * 256 + ((j ^ (r & 7)) << 4) +
                                   col0 * 2) =
          pack2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * (BN / 8); e += NT) {
    const int r = e >> 4, g = e & 15;
    const int oy = y0 + r / TW, ox = x0 + r % TW;
    const int n = n0 + g * 8;
    if (oy >= a.H || ox >= a.W || n >= a.Cout) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(As + r * 256 + ((g ^ (r & 7)) << 4));
    __nv_bfloat16* dst =
        a.out + (((long long)b * a.H + oy) * a.W + ox) * a.Cout + n;
    if ((a.Cout & 7) == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&v);
      for (int i = 0; i < 8 && n + i < a.Cout; ++i) dst[i] = e8[i];
    }
  }
}

// out[i] = bf16(sum_s partial[s, i] + bias[i % Cout]), s in order
__global__ void __launch_bounds__(RED_NT)
dcn_shift_splitk_reduce_kernel(const float* __restrict__ partial,
                               const float* __restrict__ bias,
                               __nv_bfloat16* __restrict__ out,
                               long long total, int Cout, int S) {
  for (long long i = (long long)blockIdx.x * RED_NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * RED_NT) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += partial[s * total + i];
    out[i] = __float2bfloat16(v + bias[i % Cout]);
  }
}

template <int R>
cudaError_t launch(const Args& a, int split, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dcn_shift_bf16_wgmma_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.B * a.tiles_y * a.tiles_x),
                  (unsigned)((a.Cout + BN - 1) / BN), (unsigned)split);
  dcn_shift_bf16_wgmma_kernel<R><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const long long total = (long long)a.B * a.H * a.W * a.Cout;
  const long long blocks = (total + RED_NT - 1) / RED_NT;
  dcn_shift_splitk_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                                   RED_NT, 0, stream>>>(
      a.partial, a.bias, a.out, total, a.Cout, split);
  return cudaGetLastError();
}

}  // namespace bf16

bool valid_problem(int B, int H, int W, int C, int Cout, int K, float clamp,
                   int R) {
  return B > 0 && H > 0 && W > 0 && C > 0 && Cout > 0 && K > 0 &&
         K % 2 == 1 && clamp > 0.f && (R == 1 || R == 2);
}

}  // namespace

// float32 inputs: the CUDA-core kernel. R = ceil(clamp), 1 or 2.
extern "C" int dcn_shift_forward_f32(const void* x, const void* offset,
                                     const void* mask, const void* weight,
                                     const void* bias, void* out, int B,
                                     int H, int W, int C, int Cout, int K,
                                     float clamp, int R, void* stream) {
  if (!valid_problem(B, H, W, C, Cout, K, clamp, R))
    return (int)cudaErrorInvalidValue;
  using namespace f32;
  const long long npix = (long long)B * H * W;
  const dim3 grid((unsigned)((npix + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* of = static_cast<const float*>(offset);
  const float* mk = static_cast<const float*>(mask);
  const float* wt = static_cast<const float*>(weight);
  const float* bs = static_cast<const float*>(bias);
  float* ot = static_cast<float*>(out);
  if (R == 1)
    dcn_shift_fwd_kernel<1><<<grid, NT, 0, s>>>(xf, of, mk, wt, bs, ot, B, H,
                                                W, C, Cout, K, clamp);
  else
    dcn_shift_fwd_kernel<2><<<grid, NT, 0, s>>>(xf, of, mk, wt, bs, ot, B, H,
                                                W, C, Cout, K, clamp);
  return (int)cudaGetLastError();
}

// bfloat16 inputs: the wgmma kernel, with the launch plan of
// ops/dcn_cuda.py:plan (tiles, split, chunks per split, shared memory),
// which is checked against this file's geometry. partial: float32
// workspace [split, B*H*W, Cout], used when split > 1.
extern "C" int dcn_shift_forward_bf16(
    const void* x, const void* offset, const void* mask, const void* weight,
    const void* bias, void* out, void* partial, int B, int H, int W, int C,
    int Cout, int K, float clamp, int R, int tiles_y, int tiles_x, int split,
    int chunks_per_split, int smem, int x_vec, int w_vec, void* stream) {
  using namespace bf16;
  if (!valid_problem(B, H, W, C, Cout, K, clamp, R))
    return (int)cudaErrorInvalidValue;
  const int nchunks = (C + BK - 1) / BK;
  if (tiles_y != (H + TH - 1) / TH || tiles_x != (W + TW - 1) / TW ||
      chunks_per_split < 1 || split < 1 || split > 64 ||
      split != (nchunks + chunks_per_split - 1) / chunks_per_split ||
      (split > 1) != (partial != nullptr) || smem < smem_bytes(K, R) ||
      smem > MAX_SMEM || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.offset = static_cast<const float*>(offset);
  a.mask = static_cast<const float*>(mask);
  a.weight = static_cast<const __nv_bfloat16*>(weight);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.partial = static_cast<float*>(partial);
  a.B = B, a.H = H, a.W = W, a.C = C, a.Cout = Cout, a.K = K;
  a.clamp = clamp;
  a.tiles_x = tiles_x, a.tiles_y = tiles_y;
  a.chunks_per_split = chunks_per_split;
  a.x_vec = x_vec, a.w_vec = w_vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(R == 1 ? launch<1>(a, split, smem, s)
                      : launch<2>(a, split, smem, s));
}

extern "C" const char* dcn_shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
