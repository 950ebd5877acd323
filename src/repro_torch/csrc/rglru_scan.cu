// RG-LRU scan (Griffin / RecurrentGemma gated linear recurrence) for Hopper,
// sm_90a.
//
//   h_t = a_t * h_{t-1} + b_t        (per channel), returns (h_1..T, h_T)
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/rglru_scan.py:27
// (_rglru_kernel, launched by rglru_scan_pallas).  The Pallas kernel keeps a
// (1, bd) state row in VMEM scratch and carries it across the time chunks of
// a sequential grid axis; blocks here run in no order, so the whole T loop
// stays inside one thread and the state never leaves a register.
//
// Design (simple and right first):
//   * one thread per (b, d) channel; threads run along d, so each step's
//     loads of a and b and its store of h coalesce across a warp;
//   * h lives in a register; each step is one FMA;
//   * the loads do not depend on h, so the thread keeps the next P steps of
//     a and b in flight in registers while it runs the current P steps
//     (P = 16: 64 floats of registers, no shared memory, no barrier);
//   * any B, T and D; the ragged edge of D is masked.
//   Inputs are contiguous f32 (B, T, D) and (B, D); the wrapper checks that.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the serving prefill shape
// B=8, T=512, D=4096 it reads 2 x 67.1 MB of a and b and writes 67.1 MB of h,
// plus 2 x 131 kB of states: about 201.6 MB, 0.060 ms.  Its arithmetic, one
// FMA per element, is 0.034 GFLOP, far below the f32 rate.  At the decode
// shape (T=1) the data is 0.66 MB (0.2 us): the launch sets the pace.
//
// What this design does not yet do: B*D = 32,768 threads fill only ~8 warps
// of each of the 132 SMs, and a thread walks its T steps alone, so the
// bytes in flight are capped by P.  A chunked two-pass scan across T (more
// threads per channel) and fusing the gate math of the RG-LRU block
// (sigmoid, exp, sqrt) into the kernel, so a and b never reach device
// memory, are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPrefetch = 16;

template <int P>
__device__ __forceinline__ void load_steps(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           size_t base, int t0, int T, int D,
                                           float (&ra)[P], float (&rb)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (t0 + p < T) {
      const size_t off = base + (size_t)(t0 + p) * D;
      ra[p] = __ldg(a + off);
      rb[p] = __ldg(b + off);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ a,    // (B, T, D)
    const float* __restrict__ b,    // (B, T, D)
    const float* __restrict__ h0,   // (B, D)
    float* __restrict__ h,          // (B, T, D)
    float* __restrict__ h_last,     // (B, D)
    int T, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)bi * T * D + d;   // element (bi, 0, d)

  float hv = h0[(size_t)bi * D + d];
  float na[P], nb[P];
  load_steps<P>(a, b, base, 0, T, D, na, nb);
  for (int t0 = 0; t0 < T; t0 += P) {
    float ca[P], cb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ca[p] = na[p];
      cb[p] = nb[p];
    }
    load_steps<P>(a, b, base, t0 + P, T, D, na, nb);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (t0 + p < T) {
        hv = fmaf(ca[p], hv, cb[p]);
        h[base + (size_t)(t0 + p) * D] = hv;
      }
    }
  }
  h_last[(size_t)bi * D + d] = hv;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the grid cannot hold.
int rglru_scan_forward(const void* a, const void* b, const void* h0, void* h,
                       void* h_last, int B, int T, int D, void* stream) {
  if (B < 1 || T < 1 || D < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<kPrefetch><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), T, D);
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
