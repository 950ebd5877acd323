// RG-LRU scan backward (Griffin / RecurrentGemma gated linear recurrence)
// for Hopper, sm_90a.
//
// Forward (rglru_scan.cu): h_t = a_t * h_{t-1} + b_t per channel, h_0 = h0.
// Backward, given dh (B, T, D) and dh_last (B, D), the reverse scan
//   g_T = dh_T + dh_last,   g_t = dh_t + a_{t+1} g_{t+1}
//   db_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_1 g_1.
//
// New work: the TPU kernel src/repro/kernels/rglru_scan/rglru_scan.py:27
// (_rglru_kernel) has no backward; the JAX package differentiates
// jax.lax.associative_scan (src/repro/models/rglru.py:66) with autodiff.
//
// Design, the forward kernel's run backwards: one thread per (b, d) channel,
// threads along d so that each step's loads and stores coalesce across a
// warp; the carry a_{t+1} g_{t+1} lives in a register; the loads of a, dh
// and h_{t-1} do not depend on it, so the thread keeps the next P steps in
// flight in registers while it runs the current P (P = 16, no shared
// memory, no barrier).  It reads the forward's f32 output h for h_{t-1}, so
// nothing is recomputed.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the training shape B=1,
// T=4096, D=4096 it reads a, h and dh (3 x 67.1 MB) and writes da and db
// (2 x 67.1 MB): 335.6 MB, 0.100 ms; its arithmetic (an add and two
// multiplies per element) is far below the f32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPrefetch = 16;

// steps t0, t0 - 1, ..., t0 - P + 1 (those >= 0): a_t, dh_t and h_{t-1}
template <int P>
__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ h,
                                           const float* __restrict__ dh, float h0v,
                                           size_t base, int t0, int D,
                                           float (&ra)[P], float (&rg)[P], float (&rh)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = t0 - p;
    if (t >= 0) {
      const size_t off = base + (size_t)t * D;
      ra[p] = __ldg(a + off);
      rg[p] = __ldg(dh + off);
      rh[p] = t > 0 ? __ldg(h + off - D) : h0v;
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) rglru_scan_backward_kernel(
    const float* __restrict__ a,        // (B, T, D)
    const float* __restrict__ h,        // (B, T, D): the forward's output
    const float* __restrict__ h0,       // (B, D)
    const float* __restrict__ dh,       // (B, T, D)
    const float* __restrict__ dh_last,  // (B, D)
    float* __restrict__ da,             // (B, T, D)
    float* __restrict__ db,             // (B, T, D)
    float* __restrict__ dh0,            // (B, D)
    int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)bi * T * D + d;   // element (bi, 0, d)
  const float h0v = h0[(size_t)bi * D + d];

  float carry = dh_last[(size_t)bi * D + d];    // a_{t+1} g_{t+1}
  float na[P], ng[P], nh[P];
  load_steps<P>(a, h, dh, h0v, base, T - 1, D, na, ng, nh);
  for (int t0 = T - 1; t0 >= 0; t0 -= P) {
    float ca[P], cg[P], ch[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ca[p] = na[p];
      cg[p] = ng[p];
      ch[p] = nh[p];
    }
    load_steps<P>(a, h, dh, h0v, base, t0 - P, D, na, ng, nh);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (t0 - p >= 0) {
        const size_t off = base + (size_t)(t0 - p) * D;
        const float g = cg[p] + carry;
        db[off] = g;
        da[off] = g * ch[p];
        carry = ca[p] * g;
      }
    }
  }
  dh0[(size_t)bi * D + d] = carry;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the grid cannot hold.
int rglru_scan_backward(const void* a, const void* h, const void* h0, const void* dh,
                        const void* dh_last, void* da, void* db, void* dh0,
                        int B, int T, int D, void* stream) {
  if (B < 1 || T < 1 || D < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_backward_kernel<kPrefetch><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dh),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), T, D);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
