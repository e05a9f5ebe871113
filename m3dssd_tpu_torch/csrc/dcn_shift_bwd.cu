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
//     init every offset is exactly 0, on those kinks.
// Sums are taken in float32 whatever the feature type; dx and col are
// written in x's type, doffset and dmask in float32.
//
// What bounds it on an H100. Each kernel does 2 * B*H*W * K^2 * (2R+1)^2 * C
// operations on the CUDA cores (the knots that carry no weight are skipped
// by the first two) and moves a [B*H*W, K^2*C] tensor (col written, or gk
// read) plus x or dx: at 1.6..2 bytes per operation in bf16 it is bound by
// memory, not by the 67 TFLOP/s of the float32 CUDA cores.
//
// Design (simple and right first; tensor cores and TMA are later work).
// cols and data: one block of NT threads per pixel. The block first
// computes the K^2 (2R+1)^2 triangle weights of its pixel and their source
// rows into shared memory, then each thread walks its channels (thread t
// owns c = t, t + NT, ...), so the reads and writes of a row are coalesced.
// coord: one warp per output pixel; lanes walk the channels, each keeps the
// (2R+1)^2 partial dot products of one tap in registers, a butterfly of
// shuffles sums them and lane 0 applies the subgradient rules.
//
// Interface: plain C, loaded with ctypes (ops/dcn_cuda.py). Layouts: x
// [B,H,W,C], offset [B,H,W,K*K,2] float32 (dy, dx), mask [B,H,W,K*K]
// float32, gk and col [B*H*W, K*K*C] in x's type, dx [B,H,W,C] in x's type,
// doffset [B,H,W,K*K,2] and dmask [B,H,W,K*K] float32; all contiguous.
// dtype 0 is float32, 1 bfloat16. Each entry point launches on the given
// stream and returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;          // threads per block of cols and data
constexpr int COORD_WARPS = 4;   // pixels (one warp each) per coord block
constexpr int MAX_SMEM = 48 * 1024;

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

// col[p, k*C + c] = sum over knots of m tri tri x[p + s(k, knot), c]
template <typename T, int R>
__global__ void __launch_bounds__(NT)
dcn_shift_bwd_cols_kernel(const T* __restrict__ x,
                          const float* __restrict__ offset,
                          const float* __restrict__ mask, T* __restrict__ col,
                          int H, int W, int C, int K, float clamp) {
  constexpr int S = 2 * R + 1;
  extern __shared__ float smem[];
  const int KK = K * K, NTERM = KK * S * S, pad = K / 2;
  float* wts = smem;
  int* src = reinterpret_cast<int*>(smem + NTERM);
  const long long p = blockIdx.x;
  const Pixel q = pixel_of(p, H, W);
  for (int t = threadIdx.x; t < NTERM; t += NT) {
    const int k = t / (S * S), iy = (t / S) % S, ix = t % S;
    const float oy = clip(offset[(p * KK + k) * 2], clamp);
    const float ox = clip(offset[(p * KK + k) * 2 + 1], clamp);
    const float wt = mask[p * KK + k] * tri(oy, iy - R) * tri(ox, ix - R);
    const int yy = q.y + k / K - pad + iy - R;
    const int xx = q.x + k % K - pad + ix - R;
    const bool use = wt != 0.f && yy >= 0 && yy < H && xx >= 0 && xx < W;
    wts[t] = wt;
    src[t] = use ? yy * W + xx : -1;
  }
  __syncthreads();
  const T* xb = x + (long long)q.b * H * W * C;
  T* out = col + p * KK * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    for (int k = 0; k < KK; ++k) {
      float acc = 0.f;
      for (int j = 0; j < S * S; ++j) {
        const int s = src[k * S * S + j];
        if (s >= 0) acc += wts[k * S * S + j] * to_f(xb[(long long)s * C + c]);
      }
      out[k * C + c] = from_f<T>(acc);
    }
  }
}

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

// per (p, k): the C-dot table t against the shifted x, then dmask and
// doffset with the subgradient rules above
template <typename T, int R>
__global__ void __launch_bounds__(32 * COORD_WARPS)
dcn_shift_bwd_coord_kernel(const T* __restrict__ x, const T* __restrict__ gk,
                           const float* __restrict__ offset,
                           const float* __restrict__ mask,
                           float* __restrict__ doffset,
                           float* __restrict__ dmask, int B, int H, int W,
                           int C, int K, float clamp) {
  constexpr int S = 2 * R + 1;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * COORD_WARPS + threadIdx.x / 32;
  if (p >= (long long)B * H * W) return;
  const int KK = K * K, pad = K / 2;
  const Pixel q = pixel_of(p, H, W);
  const T* xb = x + (long long)q.b * H * W * C;
  for (int k = 0; k < KK; ++k) {
    const T* g = gk + (p * KK + k) * C;
    const int y0 = q.y + k / K - pad - R, x0 = q.x + k % K - pad - R;
    float t[S][S];
#pragma unroll
    for (int iy = 0; iy < S; ++iy)
#pragma unroll
      for (int ix = 0; ix < S; ++ix) t[iy][ix] = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = to_f(g[c]);
#pragma unroll
      for (int iy = 0; iy < S; ++iy) {
        const int yy = y0 + iy;
        if (yy < 0 || yy >= H) continue;
#pragma unroll
        for (int ix = 0; ix < S; ++ix) {
          const int xx = x0 + ix;
          if (xx < 0 || xx >= W) continue;
          t[iy][ix] += gv * to_f(xb[((long long)yy * W + xx) * C + c]);
        }
      }
    }
#pragma unroll
    for (int iy = 0; iy < S; ++iy)
#pragma unroll
      for (int ix = 0; ix < S; ++ix)
#pragma unroll
        for (int m = 16; m > 0; m >>= 1)
          t[iy][ix] += __shfl_xor_sync(0xffffffffu, t[iy][ix], m);
    if (lane == 0) {
      const float ry = offset[(p * KK + k) * 2];
      const float rx = offset[(p * KK + k) * 2 + 1];
      const float oy = clip(ry, clamp), ox = clip(rx, clamp);
      const float mk = mask[p * KK + k];
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
      dmask[p * KK + k] = dm;
      doffset[(p * KK + k) * 2] = mk * sy * dclip(ry, clamp);
      doffset[(p * KK + k) * 2 + 1] = mk * sx * dclip(rx, clamp);
    }
  }
}

bool valid_problem(int B, int H, int W, int C, int K, float clamp, int R) {
  return B > 0 && H > 0 && W > 0 && C > 0 && K > 0 && K % 2 == 1 &&
         clamp > 0.f && (R == 1 || R == 2);
}

// shared memory of cols (float weight + int row) and data (float weight +
// 64-bit row) for K*K*(2R+1)^2 terms
int terms(int K, int R) { return K * K * (2 * R + 1) * (2 * R + 1); }

template <typename T, int R>
cudaError_t launch_cols(const void* x, const void* offset, const void* mask,
                        void* col, int B, int H, int W, int C, int K,
                        float clamp, cudaStream_t s) {
  const int smem = terms(K, R) * (int)(sizeof(float) + sizeof(int));
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  dcn_shift_bwd_cols_kernel<T, R><<<(unsigned)((long long)B * H * W), NT,
                                    smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(col), H, W, C, K,
      clamp);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_data(const void* gk, const void* offset, const void* mask,
                        void* dx, int B, int H, int W, int C, int K,
                        float clamp, cudaStream_t s) {
  const int n = terms(K, R);
  const int smem = (int)(2 * ((n + 1) / 2) * sizeof(float) +
                         n * sizeof(long long));
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  dcn_shift_bwd_data_kernel<T, R><<<(unsigned)((long long)B * H * W), NT,
                                    smem, s>>>(
      static_cast<const T*>(gk), static_cast<const float*>(offset),
      static_cast<const float*>(mask), static_cast<T*>(dx), H, W, C, K,
      clamp);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_coord(const void* x, const void* gk, const void* offset,
                         const void* mask, void* doffset, void* dmask, int B,
                         int H, int W, int C, int K, float clamp,
                         cudaStream_t s) {
  const long long npix = (long long)B * H * W;
  const unsigned blocks = (unsigned)((npix + COORD_WARPS - 1) / COORD_WARPS);
  dcn_shift_bwd_coord_kernel<T, R><<<blocks, 32 * COORD_WARPS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gk),
      static_cast<const float*>(offset), static_cast<const float*>(mask),
      static_cast<float*>(doffset), static_cast<float*>(dmask), B, H, W, C, K,
      clamp);
  return cudaGetLastError();
}

}  // namespace

// col [B*H*W, K*K*C] in x's type
extern "C" int dcn_shift_bwd_cols(const void* x, const void* offset,
                                  const void* mask, void* col, int dtype,
                                  int B, int H, int W, int C, int K,
                                  float clamp, int R, void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_cols<float, 1>(x, offset, mask, col, B, H, W, C, K,
                                       clamp, s)
               : launch_cols<float, 2>(x, offset, mask, col, B, H, W, C, K,
                                       clamp, s);
  else
    e = R == 1 ? launch_cols<__nv_bfloat16, 1>(x, offset, mask, col, B, H, W,
                                               C, K, clamp, s)
               : launch_cols<__nv_bfloat16, 2>(x, offset, mask, col, B, H, W,
                                               C, K, clamp, s);
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

// doffset [B,H,W,K*K,2] and dmask [B,H,W,K*K] float32
extern "C" int dcn_shift_bwd_coord(const void* x, const void* gk,
                                   const void* offset, const void* mask,
                                   void* doffset, void* dmask, int dtype,
                                   int B, int H, int W, int C, int K,
                                   float clamp, int R, void* stream) {
  if (!valid_problem(B, H, W, C, K, clamp, R) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = R == 1 ? launch_coord<float, 1>(x, gk, offset, mask, doffset, dmask,
                                        B, H, W, C, K, clamp, s)
               : launch_coord<float, 2>(x, gk, offset, mask, doffset, dmask,
                                        B, H, W, C, K, clamp, s);
  else
    e = R == 1 ? launch_coord<__nv_bfloat16, 1>(x, gk, offset, mask, doffset,
                                                dmask, B, H, W, C, K, clamp,
                                                s)
               : launch_coord<__nv_bfloat16, 2>(x, gk, offset, mask, doffset,
                                                dmask, B, H, W, C, K, clamp,
                                                s);
  return (int)e;
}

extern "C" const char* dcn_shift_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
