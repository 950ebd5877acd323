// WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper, sm_90a.
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28
// (_wkv6_kernel, launched by wkv6_pallas).  The Pallas kernel sweeps time in
// chunks over a sequential grid and keeps the (N, N) state in VMEM scratch
// between them; blocks here run in no order, so the whole T loop stays inside
// one block and the state never leaves registers.
//
// Design (simple and right first):
//   * one thread block per (b, h), N threads; thread j holds column j of the
//     state, S[i][j] for all i, in N registers;
//   * each step stages r_t, k_t, w_t in shared memory (double-buffered, so
//     one __syncthreads per step) and each thread computes
//       y_j = sum_i r_i (S_ij + u_i k_i v_j),  S_ij <- w_i S_ij + k_i v_j;
//   * the next step's r/k/v/w are loaded into registers before the current
//     step's arithmetic, hiding part of the load latency;
//   * it reads the model's (B, T, H, N) layout directly, so the two
//     transposes of the TPU wrapper (ops.py) disappear.  Inputs are
//     contiguous f32; the wrapper checks that.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// memory.  At the serving prefill shape B=8, T=512, H=64, N=64 it reads
// 4 x 67.1 MB of r/k/v/w and writes 67.1 MB of y plus the two 8.4 MB states:
// about 352 MB, 0.105 ms per layer.  Its arithmetic, 5 N^2 per step and head
// in the factored form (y = r.S + (r.(u*k)) v, then the rank-1 update), is
// 5.4 GFLOP, 0.080 ms.
//
// What this design does not yet do: the per-step __syncthreads and the
// dependent chain of N FMAs into y_j make it latency-bound, worst at small
// B*H (decode, or few heads): 512 blocks of 64 threads leave most warp slots
// of the 132 SMs empty.  cp.async/TMA staging of chunks of r/k/w, several
// heads per block and the chunked form on tensor cores are later work.

#include <cuda_runtime.h>

template <int N>
__global__ void __launch_bounds__(N) wkv6_forward_kernel(
    const float* __restrict__ r,    // (B, T, H, N)
    const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ w,
    const float* __restrict__ u,    // (H, N)
    const float* __restrict__ s0,   // (B, H, N, N), S[i][j] at i * N + j
    float* __restrict__ y,          // (B, T, H, N)
    float* __restrict__ s_fin,      // (B, H, N, N)
    int T, int H) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;

  __shared__ float sr[2][N];
  __shared__ float sk[2][N];
  __shared__ float sw[2][N];
  __shared__ float su[N];

  float S[N];
  const float* s0p = s0 + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0p[i * N + j];
  su[j] = u[h * N + j];

  const size_t stride_t = (size_t)H * N;
  const size_t base = ((size_t)b * T * H + h) * N + j;  // element (b, 0, h, j)

  float rn = r[base], kn = k[base], vn = v[base], wn = w[base];
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < T) {
      const size_t off = base + (size_t)(t + 1) * stride_t;
      rn = r[off];
      kn = k[off];
      vn = v[off];
      wn = w[off];
    }
    float yj = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = sk[buf][i] * vj;
      yj = fmaf(sr[buf][i], fmaf(su[i], kv, S[i]), yj);
      S[i] = fmaf(sw[buf][i], S[i], kv);
    }
    y[base + (size_t)t * stride_t] = yj;
  }

  float* sfp = s_fin + (size_t)bh * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) sfp[i * N + j] = S[i];
}

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim the kernel is not built for.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_fin,
                 int B, int T, int H, int N, void* stream) {
  const dim3 grid(B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(s0);
  float* yp = static_cast<float*>(y);
  float* fp = static_cast<float*>(s_fin);
  switch (N) {
    case 16:
      wkv6_forward_kernel<16><<<grid, 16, 0, st>>>(rp, kp, vp, wp, up, sp, yp, fp, T, H);
      break;
    case 64:
      wkv6_forward_kernel<64><<<grid, 64, 0, st>>>(rp, kp, vp, wp, up, sp, yp, fp, T, H);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
