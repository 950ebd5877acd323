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
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
// memory.  At the serving prefill shape B=8, T=512, H=64, N=64 it reads
// 4 x 67.1 MB of r/k/v/w and writes 67.1 MB of y plus the two 8.4 MB states:
// about 352 MB, 0.1052 ms per layer.  Its arithmetic, 5 N^2 operations per
// step and head, is 5.4 GFLOP, 0.080 ms; executed as 3 f32 instructions per
// state element and step (below) it is 3.2e9 lane instructions, 0.096 ms at
// 128 lanes x 132 SMs x 1.98 GHz.  So the serial loop has to stay within a
// few percent of 3 instructions per element, with its latency hidden.
//
// Design, one block of 2N threads per (b, h):
//   * the factored update.  y_j = sum_i r_i S_ij + a_t v_j with
//     a_t = sum_i r_i u_i k_i, and S_ij <- w_i S_ij + k_i v_j: three f32
//     instructions per element and step (FMA into y, MUL k v, FMA into S),
//     where r_i (S_ij + u_i k_i v_j) takes four.  a_t is computed once per
//     step by the block, off the serial loop.  No decay products, no
//     division: w = 0 and subnormal w go through the FMA as in the plain
//     version.
//   * register tiles.  Thread (rg, cg), rg in [0, 8), cg in [0, N/4), holds
//     rows rg*N/8 .. +N/8 and columns 4cg .. 4cg+3 of S (32 registers at
//     N = 64).  Each 16-byte shared load of r, k or w feeds four columns, and
//     each thread's chain into y is N/8 long.  The 8 row groups' partial y
//     go to shared memory and are summed once per chunk.
//   * chunks, not steps.  r, k, w, v for TC = 8 steps of the head are copied
//     into shared memory with 16-byte cp.async, 3 stages deep, so two chunks'
//     copies are in flight behind the current chunk's arithmetic.  Two
//     barriers per chunk (chunk landed; partial y written), not one per step.
//     A ragged last chunk (T = 1 in decode) copies and runs only its rows.
//   * fitting the SM.  128 threads, at most 128 registers each
//     (__launch_bounds__(128, 4)) and 40 KB of shared memory per block let 4
//     heads share an SM: the 512 heads of the prefill shape run in one wave
//     on 132 SMs, 16 warps per SM where the first version had 8.
//   * the reduction pass.  Per chunk, thread (s, cg) sums the 8 partials of
//     step s, columns 4cg..4cg+3, computes a_s from its four lanes of r, u, k
//     and a shuffle over the N/4 threads of the step, adds a_s v, and writes
//     y: each step's row of N floats as one coalesced 256-byte store.
// It reads the model's (B, T, H, N) layout directly; the wrapper checks that
// inputs are contiguous f32 on 16-byte boundaries.
//
// What holds it now (PERF.md): on an H100 SXM at 700 W it reaches ~60% of
// the byte bound at the prefill shape.  Its time grows linearly with the
// heads per SM, the depth of the cp.async ring does not move it, and the
// card runs at its power limit with the SM clock below its 1.98 GHz peak:
// the loop is bound by the f32 instruction rate.  Fewer instructions per
// element (a chunked form on the CUDA cores) is what is left.

#include <cuda_runtime.h>

namespace {

constexpr int kRowGroups = 8;   // threads along the rows of S
constexpr int kChunk = 8;       // time steps staged per chunk
constexpr int kStages = 3;      // chunks in shared memory at once
static_assert(kChunk == kRowGroups, "thread (rg, cg) stages row rg of a chunk");

// threads per block: kRowGroups x N/4
template <int N>
constexpr int kThreads = kRowGroups * N / 4;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// n consecutive floats of shared memory, 16 bytes (or 8) at a time
template <int n>
__device__ __forceinline__ void ld_row(float (&dst)[n], const float* p) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < n; q += 4) {
      const float4 x = ld4(p + q);
      dst[q] = x.x; dst[q + 1] = x.y; dst[q + 2] = x.z; dst[q + 3] = x.w;
    }
  } else {
    static_assert(n == 2, "rows per thread: 2 or a multiple of 4");
    const float2 x = *reinterpret_cast<const float2*>(p);
    dst[0] = x.x; dst[1] = x.y;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads<N>, 4) wkv6_forward_kernel(
    const float* __restrict__ r,    // (B, T, H, N)
    const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ w,
    const float* __restrict__ u,    // (H, N)
    const float* __restrict__ s0,   // (B, H, N, N), S[i][j] at i * N + j
    float* __restrict__ y,          // (B, T, H, N)
    float* __restrict__ s_fin,      // (B, H, N, N)
    int T, int H) {
  constexpr int RT = N / kRowGroups;   // rows of S per thread
  constexpr int CG = N / 4;            // column groups of 4
  // staged inputs: [stage][r, k, w, v][step][N]; partial y: [step][row group][N]
  __shared__ __align__(16) float xs[kStages][4][kChunk][N];
  __shared__ __align__(16) float yp[kChunk][kRowGroups][N];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int cg = threadIdx.x % CG;
  const int rg = threadIdx.x / CG;
  const size_t stride_t = (size_t)H * N;
  const size_t base = ((size_t)b * T * H + h) * N;   // element (b, 0, h, 0)
  const int n_chunks = (T + kChunk - 1) / kChunk;

  // chunk c into stage c % kStages: thread (rg, cg) copies 16 bytes of row
  // rg of each tensor.  One commit per call, empty past the end, so that
  // wait_group counts chunks.
  auto load_chunk = [&](int c) {
    const int t = c * kChunk + rg;
    if (c < n_chunks && t < T) {
      const size_t off = base + (size_t)t * stride_t + cg * 4;
      float (*dst)[kChunk][N] = xs[c % kStages];
      cp_async16(&dst[0][rg][cg * 4], r + off);
      cp_async16(&dst[1][rg][cg * 4], k + off);
      cp_async16(&dst[2][rg][cg * 4], w + off);
      cp_async16(&dst[3][rg][cg * 4], v + off);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) load_chunk(c);

  float S[RT][4];
  const float* s0p = s0 + (size_t)bh * N * N + (size_t)rg * RT * N + cg * 4;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float4 x = ld4(s0p + i * N);
    S[i][0] = x.x; S[i][1] = x.y; S[i][2] = x.z; S[i][3] = x.w;
  }
  const float4 uq = ld4(u + (size_t)h * N + cg * 4);

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // chunk c landed; chunk c - 1 fully read
    load_chunk(c + kStages - 1);
    const float (*x)[kChunk][N] = xs[c % kStages];
    const int tc = min(kChunk, T - c * kChunk);

    // the serial part: partial y over this thread's rows, then the update
    auto step = [&](int s) {
      float rr[RT], kk[RT], ww[RT];
      ld_row<RT>(rr, &x[0][s][rg * RT]);
      ld_row<RT>(kk, &x[1][s][rg * RT]);
      ld_row<RT>(ww, &x[2][s][rg * RT]);
      const float4 vq = ld4(&x[3][s][cg * 4]);
      const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
      float yy[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          yy[q] = fmaf(rr[i], S[i][q], yy[q]);
          S[i][q] = fmaf(ww[i], S[i][q], kk[i] * vv[q]);
        }
      }
      st4(&yp[s][rg][cg * 4], make_float4(yy[0], yy[1], yy[2], yy[3]));
    };
    if (tc == kChunk) {
#pragma unroll
      for (int s = 0; s < kChunk; ++s) step(s);
    } else {
#pragma unroll 1
      for (int s = 0; s < tc; ++s) step(s);
    }
    __syncthreads();                  // partial y of the chunk written

    // the reduction: thread (rg, cg) finishes step s = rg, columns 4cg..4cg+3
    const int s = rg;
    const float4 rq = ld4(&x[0][s][cg * 4]);
    const float4 kq = ld4(&x[1][s][cg * 4]);
    const float4 vq = ld4(&x[3][s][cg * 4]);
    float a = rq.x * (uq.x * kq.x);
    a = fmaf(rq.y, uq.y * kq.y, a);
    a = fmaf(rq.z, uq.z * kq.z, a);
    a = fmaf(rq.w, uq.w * kq.w, a);
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    float4 acc = ld4(&yp[s][0][cg * 4]);
#pragma unroll
    for (int g = 1; g < kRowGroups; ++g) {
      const float4 p = ld4(&yp[s][g][cg * 4]);
      acc.x += p.x; acc.y += p.y; acc.z += p.z; acc.w += p.w;
    }
    acc.x = fmaf(a, vq.x, acc.x);
    acc.y = fmaf(a, vq.y, acc.y);
    acc.z = fmaf(a, vq.z, acc.z);
    acc.w = fmaf(a, vq.w, acc.w);
    if (s < tc) st4(y + base + (size_t)(c * kChunk + s) * stride_t + cg * 4, acc);
  }
  cp_async_wait<0>();                 // the empty groups past the end

  float* sfp = s_fin + (size_t)bh * N * N + (size_t)rg * RT * N + cg * 4;
#pragma unroll
  for (int i = 0; i < RT; ++i) st4(sfp + i * N, make_float4(S[i][0], S[i][1], S[i][2], S[i][3]));
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* y, float* s_fin, int B, int T, int H, cudaStream_t st) {
  // 4 blocks of 40 KB want the SM's largest shared-memory carveout
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_forward_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv6_forward_kernel<N><<<B * H, kThreads<N>, 0, st>>>(r, k, v, w, u, s0, y, s_fin, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim the kernel is not built for.
int wkv6_forward(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_fin,
                 int B, int T, int H, int N, void* stream) {
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
      return launch<16>(rp, kp, vp, wp, up, sp, yp, fp, B, T, H, st);
    case 64:
      return launch<64>(rp, kp, vp, wp, up, sp, yp, fp, B, T, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
