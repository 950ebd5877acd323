// WKV6 backward (RWKV-6 "Finch" time mix) for Hopper, sm_90a.
//
// Forward (wkv6.cu), per (b, h), with S_0 = s0:
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// Backward, given dy and dS_T = ds_fin, for t = T..1:
//   dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//   dk_t = u * r_t (v_t . dy_t) + dS_t v_t
//   dv_t = (r_t . (u * k_t)) dy_t + dS_t^T k_t
//   dw_t = rowsum(dS_t * S_{t-1})
//   du  += r_t * k_t (v_t . dy_t)
//   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T,   ds0 = dS_0
//
// New work: the TPU kernel src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:28
// (_wkv6_kernel) has no backward; the JAX package differentiates the plain
// chunked form (src/repro/models/rwkv6.py:96, wkv6_chunked) with autodiff.
//
// The reverse sweep needs S_{t-1} while it walks t downwards.  Nothing here
// recovers it by dividing by w: w underflows to exactly 0 in f32.  Instead,
// one block of (N/4)^2 threads per (b, h):
//   1. sweeps forward from s0 and writes S before every kChunk-th step to a
//      scratch buffer of checkpoints in device memory (the wrapper's
//      allocation, (B H, ceil(T / kChunk), N, N) f32);
//   2. walks the chunks in reverse: stages the chunk's r, k, v, w and dy in
//      shared memory, recomputes the chunk's states from its checkpoint into
//      shared memory, then runs the chunk's steps backwards.
// Each element of S and dS is an independent scalar recurrence; only the
// outputs couple them.  Thread (rg, cg) holds the 4 x 4 tile of rows
// 4rg..4rg+3 and columns 4cg..4cg+3 of dS in registers, and of the states
// in a thread-private slice of shared memory (written and read by that
// thread alone, so it needs no barrier).  Per step each thread reduces its
// tile to row partials (S dy, dS v, dS * S) and column partials (dS^T k),
// writes them to shared memory, and after one barrier the first 2N threads
// sum the N/4 partials of one row or one column and write that row's dr,
// dk, dw or that column's dv as coalesced rows of N floats.  The partial
// buffers alternate between two copies by the parity of t, so one barrier
// per step suffices.  du is summed per (b, h) in a register of the thread
// that finishes each row and written once, to (B, H, N); the wrapper sums
// it over the batch (no atomics, no race between blocks).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at the training shape B=2, T=4096, H=64, N=64 it reads r, k, v,
// w, dy (5 x 134 MB) and writes dr, dk, dv, dw (4 x 134 MB): 1.21 GB,
// 0.36 ms; its arithmetic, 14 N^2 operations per step and head (the state,
// 3; dS, 3; the four contractions, 2 each), is 30.1 GFLOP, 0.45 ms.  This
// first design is simple and right, not fast: it recomputes the forward
// twice (the checkpoint sweep and the chunk), pays a barrier per step, and
// at one block of 180 KB of shared memory per SM (N = 64) runs 8 warps on
// each SM.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;     // rows and columns of S per thread
constexpr int kChunk = 8;    // steps between checkpoints

template <int N>
constexpr int kGroups = N / kTile;                 // row groups = column groups

template <int N>
constexpr int kThreads = kGroups<N> * kGroups<N>;

// dynamic shared memory, in floats
template <int N>
constexpr int kHistFloats = kChunk * N * N;        // the chunk's states
template <int N>
constexpr int kStageFloats = 2 * 5 * kChunk * N;   // r, k, v, w, dy; two chunks
template <int N>
constexpr int kRowPitch = N + 4;                   // padded: conflict-free in both passes
template <int N>
constexpr int kRowFloats = 2 * 3 * kGroups<N> * kRowPitch<N>;  // two steps' row partials
template <int N>
constexpr int kColFloats = 2 * N * kGroups<N>;     // two steps' column partials
template <int N>
constexpr int kDotFloats = 2 * 2 * kGroups<N>;     // v.dy and r.(u*k) partials
template <int N>
constexpr size_t kSmemBytes = sizeof(float) * (kHistFloats<N> + kStageFloats<N> +
                                               kRowFloats<N> + kColFloats<N> + kDotFloats<N>);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void unpack(float (&dst)[kTile], float4 x) {
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

// rows i0..i0+3, columns j0..j0+3 of an N x N matrix at p
template <int N>
__device__ __forceinline__ void load_tile(float (&s)[kTile][kTile], const float* p) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) unpack(s[a], ld4(p + a * N));
}

template <int N>
__device__ __forceinline__ void store_tile(float* p, const float (&s)[kTile][kTile]) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) st4(p + a * N, make_float4(s[a][0], s[a][1], s[a][2], s[a][3]));
}

// S <- diag(w) S + k v^T on the tile: w, k at its rows, v at its columns
__device__ __forceinline__ void step_state(float (&s)[kTile][kTile], const float (&w)[kTile],
                                           const float (&k)[kTile], const float (&v)[kTile]) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) s[a][b] = fmaf(w[a], s[a][b], k[a] * v[b]);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads<N>, 1) wkv6_backward_kernel(
    const float* __restrict__ r,       // (B, T, H, N)
    const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ w,
    const float* __restrict__ u,       // (H, N)
    const float* __restrict__ s0,      // (B, H, N, N), S[i][j] at i * N + j
    const float* __restrict__ dy,      // (B, T, H, N)
    const float* __restrict__ ds_fin,  // (B, H, N, N)
    float* __restrict__ ckpt,          // (B H, n_chunks, N, N) scratch
    float* __restrict__ dr,            // (B, T, H, N)
    float* __restrict__ dk,
    float* __restrict__ dv,
    float* __restrict__ dw,
    float* __restrict__ du_part,       // (B, H, N): du of this (b, h)
    float* __restrict__ ds0,           // (B, H, N, N)
    int T, int H) {
  constexpr int G = kGroups<N>;
  constexpr int NT = kThreads<N>;
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                          // [kChunk][kTile][NT][kTile], thread-private
  float* stage = hist + kHistFloats<N>;        // [2][5][kChunk][N]: r, k, v, w, dy
  float* rowp = stage + kStageFloats<N>;       // [2][3][G][N + 4]: S dy, dS v, dS * S
  float* colp = rowp + kRowFloats<N>;          // [2][G][N]: dS^T k
  float* dotp = colp + kColFloats<N>;          // [2][2][G]: v . dy, r . (u * k)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int rg = tid / G;
  const int cg = tid - rg * G;
  const int i0 = rg * kTile;
  const int j0 = cg * kTile;
  const size_t stride_t = (size_t)H * N;
  const size_t base = ((size_t)b * T * H + h) * N;   // element (b, 0, h, 0)
  const int n_chunks = (T + kChunk - 1) / kChunk;
  const size_t tile = (size_t)i0 * N + j0;           // this thread's tile in an N x N matrix
  float* ck = ckpt + (size_t)bh * n_chunks * N * N + tile;

  float uu[kTile];
  unpack(uu, ld4(u + (size_t)h * N + i0));

  // ---- 1. the forward sweep: S before steps 0, kChunk, 2 kChunk, ...
  float S[kTile][kTile];
  load_tile<N>(S, s0 + (size_t)bh * N * N + tile);
  for (int c = 0; c < n_chunks; ++c) {
    store_tile<N>(ck + (size_t)c * N * N, S);
    if (c + 1 == n_chunks) break;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const size_t off = base + (size_t)(c * kChunk + s) * stride_t;
      float kk[kTile], ww[kTile], vv[kTile];
      unpack(kk, __ldg(reinterpret_cast<const float4*>(k + off + i0)));
      unpack(ww, __ldg(reinterpret_cast<const float4*>(w + off + i0)));
      unpack(vv, __ldg(reinterpret_cast<const float4*>(v + off + j0)));
      step_state(S, ww, kk, vv);
    }
  }

  // ---- 2. the chunks in reverse
  float dS[kTile][kTile];
  load_tile<N>(dS, ds_fin + (size_t)bh * N * N + tile);
  float du_acc = 0.f;                          // row tid's du, for tid < N
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int tc = min(kChunk, T - t0);
    float* xs = stage + (c & 1) * 5 * kChunk * N;   // [5][kChunk][N]
    for (int q = tid; q < 5 * kChunk * (N / 4); q += NT) {
      const int x = q / (kChunk * (N / 4));
      const int s = (q / (N / 4)) % kChunk;
      const int n4 = (q % (N / 4)) * 4;
      const float* src = x == 0 ? r : x == 1 ? k : x == 2 ? v : x == 3 ? w : dy;
      if (s < tc) {
        st4(xs + (x * kChunk + s) * N + n4, ld4(src + base + (size_t)(t0 + s) * stride_t + n4));
      }
    }
    __syncthreads();                           // the chunk's inputs staged
    const float* xr = xs;
    const float* xk = xs + kChunk * N;
    const float* xv = xs + 2 * kChunk * N;
    const float* xw = xs + 3 * kChunk * N;
    const float* xdy = xs + 4 * kChunk * N;

    // the chunk's states S before each step, from its checkpoint
    load_tile<N>(S, ck + (size_t)c * N * N);
    for (int s = 0; s < tc; ++s) {
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        st4(hist + ((s * kTile + a) * NT + tid) * kTile,
            make_float4(S[a][0], S[a][1], S[a][2], S[a][3]));
      }
      float kk[kTile], ww[kTile], vv[kTile];
      unpack(kk, ld4(xk + s * N + i0));
      unpack(ww, ld4(xw + s * N + i0));
      unpack(vv, ld4(xv + s * N + j0));
      step_state(S, ww, kk, vv);
    }

    for (int s = tc - 1; s >= 0; --s) {
      const int t = t0 + s;
      const int par = t & 1;
      float Sp[kTile][kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) unpack(Sp[a], ld4(hist + ((s * kTile + a) * NT + tid) * kTile));
      float rr[kTile], kk[kTile], ww[kTile], vv[kTile], gy[kTile];
      unpack(rr, ld4(xr + s * N + i0));
      unpack(kk, ld4(xk + s * N + i0));
      unpack(ww, ld4(xw + s * N + i0));
      unpack(vv, ld4(xv + s * N + j0));
      unpack(gy, ld4(xdy + s * N + j0));

      // the tile's partials, from S_{t-1} (Sp) and dS_t (dS)
      float pr[kTile], pk[kTile], pw[kTile], pv[kTile] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        pr[a] = 0.f; pk[a] = 0.f; pw[a] = 0.f;
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          pr[a] = fmaf(Sp[a][q], gy[q], pr[a]);
          pk[a] = fmaf(dS[a][q], vv[q], pk[a]);
          pw[a] = fmaf(dS[a][q], Sp[a][q], pw[a]);
          pv[q] = fmaf(dS[a][q], kk[a], pv[q]);
        }
      }
      // row partials at [quantity][cg][row]: the pitch of N + 4 floats puts
      // the 16-byte stores of 8 neighbouring cg on distinct banks, and the
      // finish pass reads consecutive rows
      constexpr int RP = kRowPitch<N>;
      float* rp = rowp + par * 3 * G * RP;
      st4(rp + cg * RP + i0, make_float4(pr[0], pr[1], pr[2], pr[3]));
      st4(rp + (G + cg) * RP + i0, make_float4(pk[0], pk[1], pk[2], pk[3]));
      st4(rp + (2 * G + cg) * RP + i0, make_float4(pw[0], pw[1], pw[2], pw[3]));
      st4(colp + (par * G + rg) * N + j0, make_float4(pv[0], pv[1], pv[2], pv[3]));
      float* dp = dotp + par * 2 * G;
      if (rg == 0) {
        float x = vv[0] * gy[0];
#pragma unroll
        for (int q = 1; q < kTile; ++q) x = fmaf(vv[q], gy[q], x);
        dp[cg] = x;
      }
      if (cg == 0) {
        float x = rr[0] * (uu[0] * kk[0]);
#pragma unroll
        for (int a = 1; a < kTile; ++a) x = fmaf(rr[a], uu[a] * kk[a], x);
        dp[G + rg] = x;
      }

      // dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) dS[a][q] = fmaf(ww[a], dS[a][q], rr[a] * gy[q]);
      }
      __syncthreads();                         // step t's partials written

      // finish: thread n < N sums row n, thread N + n column n
      const size_t off = base + (size_t)t * stride_t;
      for (int q = tid; q < 2 * N; q += NT) {
        float vdy = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) vdy += dp[g];
        if (q < N) {
          float sdy = 0.f, dsv = 0.f, dsw = 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            sdy += rp[g * RP + q];
            dsv += rp[(G + g) * RP + q];
            dsw += rp[(2 * G + g) * RP + q];
          }
          const float ri = xr[s * N + q];
          const float ki = xk[s * N + q];
          const float ui = __ldg(u + (size_t)h * N + q);
          dr[off + q] = fmaf(ui * ki, vdy, sdy);
          dk[off + q] = fmaf(ui * ri, vdy, dsv);
          dw[off + q] = dsw;
          du_acc = fmaf(ri * ki, vdy, du_acc);
        } else {
          const int j = q - N;
          float ruk = 0.f, dsk = 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            ruk += dp[G + g];
            dsk += colp[(par * G + g) * N + j];
          }
          dv[off + j] = fmaf(ruk, xdy[s * N + j], dsk);
        }
      }
    }
  }

  store_tile<N>(ds0 + (size_t)bh * N * N + tile, dS);
  if (tid < N) du_part[(size_t)bh * N + tid] = du_acc;
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* s0, const float* dy, const float* ds_fin, float* ckpt, float* dr,
           float* dk, float* dv, float* dw, float* du_part, float* ds0, int B, int T, int H,
           cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_backward_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes<N>));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv6_backward_kernel<N><<<B * H, kThreads<N>, kSmemBytes<N>, st>>>(
      r, k, v, w, u, s0, dy, ds_fin, ckpt, dr, dk, dv, dw, du_part, ds0, T, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Steps between two checkpoints: the wrapper allocates ckpt as
// (B H, ceil(T / wkv6_backward_chunk()), N, N) floats.
int wkv6_backward_chunk() { return kChunk; }

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim the kernel is not built for.
int wkv6_backward(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, const void* dy, const void* ds_fin,
                  void* ckpt, void* dr, void* dk, void* dv, void* dw, void* du_part,
                  void* ds0, int B, int T, int H, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* in[8] = {static_cast<const float*>(r), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(w),
                        static_cast<const float*>(u), static_cast<const float*>(s0),
                        static_cast<const float*>(dy), static_cast<const float*>(ds_fin)};
  float* out[7] = {static_cast<float*>(ckpt), static_cast<float*>(dr),
                   static_cast<float*>(dk), static_cast<float*>(dv),
                   static_cast<float*>(dw), static_cast<float*>(du_part),
                   static_cast<float*>(ds0)};
  switch (N) {
    case 16:
      return launch<16>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1],
                        out[2], out[3], out[4], out[5], out[6], B, T, H, st);
    case 64:
      return launch<64>(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1],
                        out[2], out[3], out[4], out[5], out[6], B, T, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* wkv6_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
