// Error-feedback white-data filter for Hopper, sm_90a.
//
//   acc = float(g) + float(r);  keep = |acc| >= tau
//   send = keep ? acc : 0 (g's dtype);  new_r = keep ? 0 : acc (r's dtype)
//   kept += sum(keep)
//
// Replaces the TPU kernel src/repro/kernels/whitedata_filter/whitedata_filter.py:24
// (_filter_kernel, launched by whitedata_filter_pallas).  The Pallas kernel
// walks (256, 256) tiles of an array that its wrapper pads to a multiple of
// 256 elements and writes one partial count per tile, which the wrapper
// sums; the padding counts as kept when tau <= 0.  Here the kernel runs over
// the flat n elements with no padding, and each block adds its count into one
// int32 with a single atomicAdd (integer sums, so the result does not depend
// on the order).
//
// Design:
//   * g and r are each float32 or bfloat16, independently (4 instances);
//     the sum is one f32 add (no product, so no FMA can form) and the
//     outputs round with __float2bfloat16_rn, round-to-nearest-even as
//     torch's .to(torch.bfloat16): every output is bit-exact with the
//     plain version;  |acc| >= tau is false for a NaN, which goes to new_r;
//   * the elements go in units of 4 (one 16-byte load of f32, one 8-byte
//     load of bf16); a block's tile is 8 x 256 units, unit u of it on
//     thread u % 256, so every load and store of a warp is contiguous, and
//     each thread has 8 units of g and r in flight before it stores;
//   * the launcher finds the head (0-3 elements) that puts all four
//     pointers on a unit boundary; the head and the tail run as scalars.
//     Pointers that no head aligns (views at offsets that differ between
//     g and r) run all scalar;
//   * a grid-stride loop over tiles, 64-bit indices; each thread keeps its
//     count, a warp shuffle and a block reduction in shared memory sum them.
//   Inputs are contiguous; the wrapper checks that and zeroes `kept`.
//   A first version gave each thread 8 consecutive elements (two 16-byte
//   loads 32 bytes apart, so each load instruction of a warp used half of
//   every sector it touched) and one group in flight; it was slower
//   (PERF.md).
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Per element it reads g and r
// and writes send and new_r: 16 bytes in f32, 12 with bf16 g and f32 r.
// One f32 add, one compare and two selects per element are far below the
// f32 rate.  A block of the rwkv6-7b tree, (4096, 14336) f32, moves 939.5 MB:
// 0.2805 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 4;   // elements per unit: 16 bytes of f32, 8 of bf16
constexpr int kUnroll = 8;   // units per thread in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// one unit of 4 elements at p (aligned to the unit's bytes) into f32
// registers, and back
__device__ __forceinline__ void load4(const float* __restrict__ p, float (&x)[kVec]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p, float (&x)[kVec]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void store4(float* __restrict__ p, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* __restrict__ p, const float (&x)[kVec]) {
  uint2 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
  h[0] = __halves2bfloat162(__float2bfloat16_rn(x[0]), __float2bfloat16_rn(x[1]));
  h[1] = __halves2bfloat162(__float2bfloat16_rn(x[2]), __float2bfloat16_rn(x[3]));
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename G, typename R>
__global__ void __launch_bounds__(kThreads) whitedata_filter_kernel(
    const G* __restrict__ g, const R* __restrict__ r,
    const float* __restrict__ tau_ptr, float tau_value,
    G* __restrict__ send, R* __restrict__ new_r, int* __restrict__ kept,
    int64_t n, int64_t head, int64_t units) {
  const float tau = tau_ptr != nullptr ? *tau_ptr : tau_value;
  int count = 0;

  // a block's tile is kUnroll x kThreads units; unit u of the tile goes to
  // thread u % kThreads, so every load and store of a warp is contiguous
  constexpr int64_t kTile = (int64_t)kUnroll * kThreads;
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < units; t0 += (int64_t)gridDim.x * kTile) {
    float gx[kUnroll][kVec], rx[kUnroll][kVec];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = t0 + u * kThreads + threadIdx.x;
      if (q < units) {
        load4(g + head + q * kVec, gx[u]);
        load4(r + head + q * kVec, rx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = t0 + u * kThreads + threadIdx.x;
      if (q < units) {
        float sx[kVec], nx[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float acc = gx[u][i] + rx[u][i];
          const bool keep = fabsf(acc) >= tau;
          sx[i] = keep ? acc : 0.0f;
          nx[i] = keep ? 0.0f : acc;
          count += keep;
        }
        store4(send + head + q * kVec, sx);
        store4(new_r + head + q * kVec, nx);
      }
    }
  }

  // the head [0, head) and the tail [head + units * kVec, n), one element each
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tail0 = head + units * kVec;
  const int64_t scalars = head + (n - tail0);
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < scalars; t += stride) {
    const int64_t i = t < head ? t : tail0 + (t - head);
    const float acc = to_f32(g[i]) + to_f32(r[i]);
    const bool keep = fabsf(acc) >= tau;
    send[i] = from_f32<G>(keep ? acc : 0.0f);
    new_r[i] = from_f32<R>(keep ? 0.0f : acc);
    count += keep;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
  __shared__ int warp_counts[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < kThreads / 32 ? warp_counts[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0 && count != 0) atomicAdd(kept, count);
  }
}

// whether p + elems elements lies on a boundary of one unit's bytes
bool unit_aligned(const void* p, int64_t elems, int elem_size) {
  return (reinterpret_cast<uintptr_t>(p) + elems * elem_size) % (kVec * elem_size) == 0;
}

template <typename G, typename R>
int launch(const void* g, const void* r, const float* tau_ptr, float tau, void* send,
           void* new_r, int* kept, int64_t n, cudaStream_t stream) {
  // the head that puts all four pointers on a unit boundary, if one does
  int64_t head = n;
  for (int64_t h = 0; h < kVec && h < n; ++h) {
    if (unit_aligned(g, h, sizeof(G)) && unit_aligned(send, h, sizeof(G)) &&
        unit_aligned(r, h, sizeof(R)) && unit_aligned(new_r, h, sizeof(R))) {
      head = h;
      break;
    }
  }
  const int64_t units = (n - head) / kVec;
  const int64_t scalars = n - units * kVec;
  const int64_t tiles = (units + (int64_t)kUnroll * kThreads - 1) / ((int64_t)kUnroll * kThreads);
  const int64_t scalar_blocks = (scalars + kThreads - 1) / kThreads;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = tiles > scalar_blocks ? tiles : scalar_blocks;
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  whitedata_filter_kernel<G, R><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const G*>(g), static_cast<const R*>(r), tau_ptr, tau,
      static_cast<G*>(send), static_cast<R*>(new_r), kept, n, head, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g, send: float32 (g_bf16 = 0) or bfloat16 (1); r, new_r likewise by
// r_bf16.  tau is read from tau_ptr on the device where that is not null,
// else taken by value.  Adds the count of kept elements to *kept.  Launches
// on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for n < 1.
int whitedata_filter_forward(const void* g, const void* r, int g_bf16, int r_bf16,
                             const void* tau_ptr, float tau, void* send, void* new_r,
                             void* kept, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* tp = static_cast<const float*>(tau_ptr);
  int* kp = static_cast<int*>(kept);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16 && r_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(g, r, tp, tau, send, new_r, kp, n, s);
  if (g_bf16) return launch<__nv_bfloat16, float>(g, r, tp, tau, send, new_r, kp, n, s);
  if (r_bf16) return launch<float, __nv_bfloat16>(g, r, tp, tau, send, new_r, kp, n, s);
  return launch<float, float>(g, r, tp, tau, send, new_r, kp, n, s);
}

const char* whitedata_filter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
