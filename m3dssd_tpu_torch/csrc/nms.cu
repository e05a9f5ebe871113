// Greedy first-K 2D NMS of a batch of images, on the card: the detect
// path's NMS behind the custom op m3dssd::nms_first_k (ops/nms_op.py).
//
// Replaces: no TPU kernel. The JAX package runs this NMS as XLA ops
// (m3dssd_tpu/ops/nms.py:nms_select_t), and the port ran the same K rounds
// as PyTorch ops (ops/nms.py:nms_select_t): each round an argmax, gathers
// and an IoU pass over every anchor of every image, launched from the host,
// about 15 passes over [B, N] float32 a round. This kernel gives exactly
// that function's (indices, valid) and reads the scores once.
//
// What it computes, per image: greedy NMS in order of score, highest
// first and the lower index first among equal scores (as torch.argmax
// breaks ties), suppressing where IoU > iou_thresh with the +1-pixel
// areas, and keeps the first K survivors. With a stop (has_stop) a row is
// valid while its score is >= floor; without one while it is > -inf.
// Unused slots are valid = 0 with index 0. A NaN score wins every argmax
// of the plain version and passes no test, so an image holding one gets K
// invalid rows at index 0 (with a stop) or at its first NaN (without).
//
// The IoU rounds as PyTorch's separate elementwise ops do: every add,
// subtract, multiply and divide is an __f*_rn intrinsic, so no FMA is
// contracted and every suppression decision equals the plain version's
// bit for bit.
//
// What bounds it on an H100. The decisions touch only the candidates,
// the anchors whose score passes the floor (a few to a few hundred an
// image at the detect cells' score_thres), so the work is one read of the
// scores, B * N * 4 bytes (70.8 MB at bs=64 and 276,480 anchors: 21 us
// at 3.35 TB/s), plus the candidates' boxes. It is bound by bytes and by
// latency, not by operations.
//
// Design.
//   * nms_compact_kernel: a grid of many blocks per image streams the
//     scores once, four loads in flight a thread, and appends each
//     candidate (score > -inf and >= floor) to its image's buffer of kCap
//     keys through a warp-aggregated atomic counter. A key is
//     (~ordered(score) << 32 | index), so ascending keys are descending
//     scores, ascending indices among equal ones. The count goes on past
//     kCap. NaN scores mark their image (atomicMax of N - index).
//   * nms_select_kernel: one block of 1024 threads an image. When the
//     count is at most kCap it sorts the keys in shared memory (bitonic,
//     the count rounded up to a power of two), stages the candidates'
//     boxes there, and one warp scans them in order, 32 at a time: each
//     lane tests its candidate against the kept boxes (at most K, in
//     shared memory), then the chunk's survivors are taken in order, each
//     unless one taken before it overlaps it (the taken lanes test it at
//     once, a vote decides), and the scan stops at K kept.
//     When the count exceeds kCap the block runs the plain version's
//     rounds over its image exactly: a block-wide argmax, then one pass
//     that suppresses and finds the next round's argmax, over a copy of
//     the scores in device scratch. That path is slower but needs no
//     read-back on the host; it adds one to a device tally, which only a
//     caller that asks reads back.
//
// Interface: plain C, loaded with ctypes (ops/nms_op.py). boxes [B,4,N]
// and scores [B,N] float32; keys [B,kCap] 64-bit, counters [2,B] int32 and
// scratch [B,N] float32 as workspace; idx [B,K] int64 and valid [B,K]
// uint8 out; tally one int32. All contiguous. nms_first_k launches on
// the given stream and returns the cudaError_t of its launches.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCap = 4096;            // candidates an image the sort takes
constexpr int kCompactThreads = 256;
constexpr int kPer = 4;               // scores a compact thread loads at once
constexpr int kSelectThreads = 1024;
constexpr int kSmemLimit = 232448;    // dynamic shared memory of one block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool passes(float v, int has_stop, float floor) {
  return has_stop ? v >= floor : v > -INFINITY;
}

__device__ __forceinline__ unsigned long long sort_key(float v, int j) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);      // -0 sorts as +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);        // ascending order
  return ((unsigned long long)(~u) << 32) | (unsigned)j;
}

__device__ __forceinline__ float4 load_box(const float* bx, int N, int j) {
  const size_t n = N;
  return make_float4(bx[j], bx[n + j], bx[2 * n + j], bx[3 * n + j]);
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// IoU(a, b) > thr, as ops/nms.py:nms_select_t rounds it
__device__ __forceinline__ bool overlaps(float4 a, float aa, float4 b,
                                         float ab, float thr) {
  float w = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.f);
  float h = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.f);
  w = w < 0.f ? 0.f : w;                 // clamp(min=0), NaN stays NaN
  h = h < 0.f ? 0.f : h;
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(aa, ab), inter)) > thr;
}

// (v, i) wins over (bv, bi) in torch.argmax: NaN above all, then the
// larger value, then the lower index
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// block-wide argmax; every thread returns with the block's (v, i)
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(kFull, v, o);
    const int oi = __shfl_down_sync(kFull, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                       // the last call's readers are done
  if (lane == 0) { sv[w] = v; si[w] = i; }
  __syncthreads();
  if (w == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    v = in ? sv[lane] : -INFINITY;
    i = in ? si[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(kFull, v, o);
      const int oi = __shfl_down_sync(kFull, i, o);
      if (beats(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
}

__global__ void __launch_bounds__(kCompactThreads)
nms_compact_kernel(const float* __restrict__ scores, int N, float floor,
                   unsigned long long* __restrict__ keys,
                   int* __restrict__ count, int* __restrict__ nan_mark) {
  const int b = blockIdx.y;
  const float* s = scores + (size_t)b * N;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long long step = (long long)gridDim.x * kCompactThreads * kPer;
  for (long long base = (long long)blockIdx.x * kCompactThreads * kPer;
       base < N; base += step) {
    float v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const long long j = base + e * kCompactThreads + threadIdx.x;
      v[e] = j < N ? __ldg(s + j) : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int j = (int)(base + e * kCompactThreads + threadIdx.x);
      if (v[e] != v[e]) atomicMax(nan_mark + b, N - j);
      const bool cand = v[e] > -INFINITY && v[e] >= floor;
      const unsigned m = __ballot_sync(kFull, cand);
      if (m == 0) continue;
      const int leader = __ffs(m) - 1;
      int first = 0;
      if (lane == leader) first = atomicAdd(count + b, __popc(m));
      first = __shfl_sync(kFull, first, leader);
      const int pos = first + __popc(m & below);
      if (cand && pos < kCap) keys[(size_t)b * kCap + pos] = sort_key(v[e], j);
    }
  }
}

// bitonic sort of keys[0, P) ascending, P a power of two
__device__ void sort_keys(unsigned long long* keys, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int o = i ^ j;
        if (o > i) {
          const unsigned long long a = keys[i], c = keys[o];
          if ((a > c) == ((i & k) == 0)) { keys[i] = c; keys[o] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// the plain version's rounds over one image, exactly (count > kCap)
__device__ void select_rounds(const float* bx, const float* s, float* act,
                              int N, int K, float thr, int has_stop,
                              float floor, long long* idx,
                              unsigned char* valid, float* sv, int* si) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float v = s[j];
    act[j] = v;
    if (beats(v, j, bv, bi)) { bv = v; bi = j; }
  }
  block_argmax(bv, bi, sv, si);
  for (int k = 0; k < K; ++k) {
    if (!passes(bv, has_stop, floor)) {  // nothing changes any more
      for (int r = k + threadIdx.x; r < K; r += blockDim.x) {
        idx[r] = has_stop ? 0 : bi;
        valid[r] = 0;
      }
      return;
    }
    if (threadIdx.x == 0) { idx[k] = bi; valid[k] = 1; }
    if (k + 1 == K) return;
    const float4 pick = load_box(bx, N, bi);
    const float pa = area_of(pick);
    float nv = -INFINITY;
    int ni = INT_MAX;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      float v = act[j];
      if (v != -INFINITY) {
        const float4 o = load_box(bx, N, j);
        if (j == bi || overlaps(pick, pa, o, area_of(o), thr)) {
          act[j] = -INFINITY;
          v = -INFINITY;
        }
      }
      if (beats(v, j, nv, ni)) { nv = v; ni = j; }
    }
    block_argmax(nv, ni, sv, si);
    bv = nv;
    bi = ni;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
nms_select_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores, int N, int K, float thr,
                  int has_stop, float floor,
                  const unsigned long long* __restrict__ keys_g,
                  const int* __restrict__ count,
                  const int* __restrict__ nan_mark, float* __restrict__ scratch,
                  long long* __restrict__ idx_out,
                  unsigned char* __restrict__ valid_out,
                  int* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float4* cand = reinterpret_cast<float4*>(keys + kCap);
  float4* kept_box = cand + kCap;
  float* kept_area = reinterpret_cast<float*>(kept_box + K);
  __shared__ float sv[32];
  __shared__ int si[32];

  const int b = blockIdx.x;
  const float* bx = boxes + (size_t)b * 4 * N;
  long long* idx = idx_out + (size_t)b * K;
  unsigned char* valid = valid_out + (size_t)b * K;
  const int tid = threadIdx.x;

  if (nan_mark[b] > 0) {          // the plain version picks a NaN each round
    const long long at = has_stop ? 0 : (long long)(N - nan_mark[b]);
    for (int k = tid; k < K; k += blockDim.x) { idx[k] = at; valid[k] = 0; }
    return;
  }
  const int c = count[b];
  if (c > kCap) {
    if (tid == 0) atomicAdd(tally, 1);
    select_rounds(bx, scores + (size_t)b * N, scratch + (size_t)b * N, N, K,
                  thr, has_stop, floor, idx, valid, sv, si);
    return;
  }

  int P = 1;
  while (P < c) P <<= 1;
  for (int r = tid; r < P; r += blockDim.x)
    keys[r] = r < c ? keys_g[(size_t)b * kCap + r] : ~0ull;
  __syncthreads();
  sort_keys(keys, P);
  for (int r = tid; r < c; r += blockDim.x)
    cand[r] = load_box(bx, N, (int)(keys[r] & 0xffffffffu));
  __syncthreads();
  if (tid >= 32) return;

  // one warp scans the candidates in order, 32 at a time
  const int lane = tid;
  int kept = 0;
  for (int base = 0; base < c && kept < K; base += 32) {
    const int r = base + lane;
    const bool in = r < c;
    const float4 mine = in ? cand[r] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float ma = area_of(mine);
    bool live = in;
    for (int t = 0; t < kept && live; ++t)
      live = !overlaps(kept_box[t], kept_area[t], mine, ma, thr);
    // the chunk's survivors in order: each is taken unless a lane taken
    // before it overlaps it (those lanes test it at once)
    unsigned take = 0;
    int room = K - kept;
    for (unsigned m = __ballot_sync(kFull, live); m && room > 0;
         m &= m - 1) {
      const int i = __ffs(m) - 1;
      float4 o;
      o.x = __shfl_sync(kFull, mine.x, i);
      o.y = __shfl_sync(kFull, mine.y, i);
      o.z = __shfl_sync(kFull, mine.z, i);
      o.w = __shfl_sync(kFull, mine.w, i);
      const float oa = __shfl_sync(kFull, ma, i);
      const bool hit = ((take >> lane) & 1u) && overlaps(mine, ma, o, oa, thr);
      if (!__any_sync(kFull, hit)) { take |= 1u << i; --room; }
    }
    if ((take >> lane) & 1u) {
      const int slot = kept + __popc(take & ((1u << lane) - 1u));
      kept_box[slot] = mine;
      kept_area[slot] = ma;
      idx[slot] = (long long)(keys[r] & 0xffffffffu);
      valid[slot] = 1;
    }
    kept += __popc(take);
    __syncwarp();
  }
  // every active score is -inf now: the plain version's argmax is index 0
  const unsigned char rest = passes(-INFINITY, has_stop, floor) ? 1 : 0;
  for (int k = kept + lane; k < K; k += 32) { idx[k] = 0; valid[k] = rest; }
}

size_t select_smem_bytes(int K) {
  return (size_t)kCap * (sizeof(unsigned long long) + sizeof(float4)) +
         (size_t)K * (sizeof(float4) + sizeof(float));
}

}  // namespace

extern "C" int nms_capacity() { return kCap; }

extern "C" int nms_max_out() {
  return (int)((kSmemLimit - 1024 - select_smem_bytes(0)) /
               (sizeof(float4) + sizeof(float)));
}

extern "C" int nms_first_k(const void* boxes, const void* scores, int B,
                           int N, int K, float iou_thresh, int has_stop,
                           float floor, void* keys, void* counters,
                           void* scratch, void* idx, void* valid, void* tally,
                           void* stream) {
  if (B < 1 || B > 65535 || N < 1 || K < 1 || K > nms_max_out())
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* count = static_cast<int*>(counters);
  int* nan_mark = count + B;
  cudaError_t e = cudaMemsetAsync(counters, 0, 2 * (size_t)B * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  const long long per_block = (long long)kCompactThreads * kPer * 4;
  const long long blocks = (N + per_block - 1) / per_block;
  const dim3 cgrid((unsigned)(blocks < 65535 ? blocks : 65535), (unsigned)B);
  nms_compact_kernel<<<cgrid, kCompactThreads, 0, s>>>(
      static_cast<const float*>(scores), N, has_stop ? floor : -INFINITY,
      static_cast<unsigned long long*>(keys), count, nan_mark);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = select_smem_bytes(K);
  e = cudaFuncSetAttribute(nms_select_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  nms_select_kernel<<<B, kSelectThreads, smem, s>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores), N,
      K, iou_thresh, has_stop, floor,
      static_cast<const unsigned long long*>(keys), count, nan_mark,
      static_cast<float*>(scratch), static_cast<long long*>(idx),
      static_cast<unsigned char*>(valid), static_cast<int*>(tally));
  return (int)cudaGetLastError();
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
