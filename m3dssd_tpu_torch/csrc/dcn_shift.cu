// Forward of the modulated deformable convolution (DCNv2) with offsets
// clipped to +-clamp, stride 1, dilation 1, padding K/2: the neck DCN of the
// flagship detector.
//
// Replaces: m3dssd_tpu/ops/dcn_pallas.py:dcn_v2_shift_pallas, the TPU
// kernel of the same function (and the XLA op ops/dcn.py:dcn_v2_shift that
// the JAX model runs in its place).
//
// What it computes. With R = ceil(clamp) and knots d in [-R, R], tap k of
// output pixel p samples
//     col[p, k, c] = m[p,k] * sum_{dy,dx} tri(oy-dy) * tri(ox-dx)
//                             * x[y + ky - K/2 + dy, x + kx - K/2 + dx, c]
// with tri(u) = max(0, 1 - |u|), (oy, ox) the clipped offset, and zero
// outside the image. This is bilinear sampling, exact for |offset| <= R.
// Then out[p, :] = sum_{k,c} col[p, k, c] * w[k, c, :] + bias.
//
// What bounds it on an H100. 2 * HW * K^2 * C * Cout operations against
// (HW * (C + Cout) + K^2 * C * Cout) elements moved: at the flagship's neck
// shapes (K = 3, C and Cout 256..1024) that is hundreds of operations per
// byte, so the function is bound by arithmetic, not by memory. The
// (2R+1)^2-term gather that builds the columns reads x nine times per tap,
// but from cache: each x element is reused by neighbouring pixels of the
// same block.
//
// Design. One block owns a tile of BM output pixels (flattened over B*H*W,
// so a ragged W needs no special case) by BN output channels. For each tap
// it computes the BM x (2R+1)^2 triangle weights, mask folded in, into
// shared memory. For each chunk of BK input channels it builds the
// column tile [BK, BM] in shared memory straight from x -- the
// [B*H*W, K^2*C] columns never reach device memory -- loads the matching
// [BK, BN] weight chunk, and accumulates the product in float32 registers
// (TM x TN outputs per thread). The epilogue adds the float32 bias and
// casts to x's type. This first version multiplies on the CUDA cores in
// float32; tensor-core products (mma.sync / wgmma), TMA loads and
// pipelining are later work. Accumulation is float32 throughout, where the
// reference accumulates the shifted MACs in the feature type: in bfloat16
// the two differ by bf16 rounding.
//
// Interface: plain C, loaded with ctypes (ops/dcn_cuda.py). Layouts:
// x [B,H,W,C] (float32 or bfloat16), offset [B,H,W,K*K,2] float32 (dy, dx),
// mask [B,H,W,K*K] float32, weight [K*K*C, Cout] in x's type, bias [Cout]
// float32, out [B,H,W,Cout] in x's type; all contiguous. Launches on the
// given stream and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 128;  // output channels per block
constexpr int BK = 16;   // input channels per chunk
constexpr int TM = 4;    // output pixels per thread
constexpr int TN = 8;    // output channels per thread
constexpr int GX = BN / TN;        // 16 thread columns (output channels)
constexpr int NT = (BM / TM) * GX; // 256 threads

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float tri(float u) {
  return fmaxf(0.f, 1.f - fabsf(u));
}

template <typename T, int R>
__global__ void __launch_bounds__(NT)
dcn_shift_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                     const float* __restrict__ mask,
                     const T* __restrict__ weight,
                     const float* __restrict__ bias, T* __restrict__ out,
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
            const T* row = x + ((long long)b * H + sy) * W * C + c0 + c;
#pragma unroll
            for (int ix = 0; ix < D; ++ix) {
              const int sx = xb + ix;
              if (sx < 0 || sx >= W) continue;
              v = fmaf(Wt[i][iy * D + ix], to_f32(row[(long long)sx * C]), v);
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
          v = to_f32(weight[((long long)k * C + c0 + c) * Cout + n0 + j]);
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
      if (n < Cout) out[p * Cout + n] = from_f32<T>(acc[i][j] + bias[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* offset, const void* mask,
                   const void* weight, const void* bias, void* out, int B,
                   int H, int W, int C, int Cout, int K, float clamp, int R,
                   cudaStream_t stream) {
  const long long npix = (long long)B * H * W;
  const dim3 grid((unsigned)((npix + BM - 1) / BM),
                  (unsigned)((Cout + BN - 1) / BN));
  const dim3 block(NT);
  const T* xt = static_cast<const T*>(x);
  const float* of = static_cast<const float*>(offset);
  const float* mk = static_cast<const float*>(mask);
  const T* wt = static_cast<const T*>(weight);
  const float* bs = static_cast<const float*>(bias);
  T* ot = static_cast<T*>(out);
  if (R == 1)
    dcn_shift_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
        xt, of, mk, wt, bs, ot, B, H, W, C, Cout, K, clamp);
  else
    dcn_shift_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(
        xt, of, mk, wt, bs, ot, B, H, W, C, Cout, K, clamp);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. R = ceil(clamp), 1 or 2.
extern "C" int dcn_shift_forward(const void* x, const void* offset,
                                 const void* mask, const void* weight,
                                 const void* bias, void* out, int B, int H,
                                 int W, int C, int Cout, int K, float clamp,
                                 int R, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cout <= 0 || K <= 0 ||
      K % 2 == 0 || !(clamp > 0.f) || (R != 1 && R != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, offset, mask, weight, bias, out, B, H, W, C,
                              Cout, K, clamp, R, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, offset, mask, weight, bias, out, B,
                                      H, W, C, Cout, K, clamp, R, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dcn_shift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
