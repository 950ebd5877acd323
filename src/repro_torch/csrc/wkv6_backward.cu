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
//      shared memory (all but the last, which stays in registers), then runs
//      the chunk's steps backwards.
// Each element of S and dS is an independent scalar recurrence; only the
// outputs couple them.  Thread (rg, cg), tid = rg G + cg with G = N/4, holds
// the 4 x 4 tile of rows 4rg..4rg+3 and columns 4cg..4cg+3 of dS in
// registers, and of the states in a thread-private slice of shared memory
// (written and read by that thread alone, so it needs no barrier).
//
// The reduction, with no barrier inside the steps.  The G threads that share
// a row group are G neighbouring lanes of one warp, so three of the four
// contractions (S dy, dS v, dS * S: sums over columns) finish in registers.
// Per step a thread's 12 row partials (3 quantities x 4 rows) are
// reduce-scattered over those G lanes by __shfl_xor_sync: at lane distance
// G/2 each lane keeps the 6 values of two rows, at G/4 the 3 of one row;
// for N = 64 the 4 lanes left with one row pad its 3 sums to 4 and go on
// to one quantity each at distances 2 and 1 (6 + 3 + 2 + 1 = 12 shuffles;
// 6 + 3 for N = 16; a full butterfly would take 48).  Each lane then
// holding a finished sum writes it to the chunk's row buffer in shared
// memory.  The fourth contraction, dS^T k,
// sums over rows across the warps: each warp folds its row groups' column
// partials by shuffles (lane distance 16 for N = 64; 8 and 4 for N = 16)
// and stores one row of N floats for the step to the chunk's column buffer.
// dS never depends on the outputs, so a thread runs all its chunk's steps
// without waiting for anyone.  Once per chunk every warp finishes some of
// the previous chunk's steps (warp w step w for N = 64): v . dy and
// r . (u * k) as warp sums over the staged inputs, dv as the sum of the
// warps' column partials, the terms in v . dy added to dr and dk, and dr,
// dk, dw, dv written as whole rows of N floats (coalesced).  du is summed
// per (b, h) in registers of the finishing lanes, over the warps once at
// the end, and written to (B, H, N); the wrapper sums it over the batch.
// No atomics: the order of every sum is fixed, so two launches give the
// same bits.
//
// Buffers and barriers.  The staging is a ring of three chunks (chunk c in
// slot c % 3); the row and column buffers alternate by chunk parity.  One
// __syncthreads() per chunk: iteration c loads chunk c - 1's inputs and
// checkpoint into registers, meets the barrier (chunk c is staged, chunk
// c + 1's partials are written), recomputes and runs chunk c, finishes
// chunk c + 1, and only then stores chunk c - 1's inputs to slot
// (c + 2) % 3, so the loads fly over a whole chunk.  While a thread runs
// chunk c, others may be finishing chunk c + 1 (slot (c + 1) % 3, the other
// parity) or storing chunk c - 1; none can reach chunk c - 1's steps before
// every thread has finished chunk c + 1.  Two more barriers at the end
// finish chunk 0 and sum du.  Shared memory for N = 64: the states 131,072
// B, the staging 30,720 B, the row buffers 12,288 B, the column buffers
// 32,768 B, du 2,048 B: 208,896 B, one block per SM (8 warps); 161
// registers, no spills.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores): at the training shape B=2, T=4096, H=64, N=64 it reads r, k, v,
// w, dy (5 x 134 MB) and writes dr, dk, dv, dw (4 x 134 MB): 1.21 GB,
// 0.36 ms; its arithmetic, 14 N^2 operations per step and head (the state,
// 3; dS, 3; the four contractions, 2 each), is 30.1 GFLOP, 0.45 ms.
// Measured by tools/wkv6_backward_parts.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W: 2.6952 ms at the training shape, 16.6% of the bound (the
// design before it, a barrier per step, 4.5834 ms in the same run).  What
// each part costs, timed with that part cut out: the forward sweep, which
// writes and later reads 1.07 GB of checkpoints, 0.81 ms; the steps 0.90
// ms, of which their shuffles and selects 0.67 (the card does one warp
// shuffle a clock per SM: 14 a step in each of 8 warps); the recompute
// 0.22 ms; the finish passes 0.18 ms.  What would move it further: sparser
// checkpoints, more warps per SM, fewer lanes per row.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;     // rows and columns of S per thread
constexpr int kChunk = 8;    // steps between checkpoints

template <int N>
constexpr int kGroups = N / kTile;                 // row groups = column groups

template <int N>
constexpr int kThreads = kGroups<N> * kGroups<N>;

template <int N>
constexpr int kLanes = kThreads<N> < 32 ? kThreads<N> : 32;   // threads of a warp

template <int N>
constexpr int kWarps = kThreads<N> / kLanes<N>;

template <int N>
constexpr unsigned kMask = kLanes<N> == 32 ? 0xffffffffu : (1u << kLanes<N>) - 1;

// dynamic shared memory, in floats
template <int N>
constexpr int kHistFloats = kChunk * N * N;           // the chunk's states
template <int N>
constexpr int kStageFloats = 3 * 5 * kChunk * N;      // r, k, v, w, dy; a ring of three chunks
template <int N>
constexpr int kOutFloats = 2 * 3 * kChunk * N;        // S dy, dS v, dS * S per step; two chunks
template <int N>
constexpr int kColFloats = 2 * kChunk * kWarps<N> * N;  // dS^T k per step and warp; two chunks
template <int N>
constexpr int kDuFloats = kWarps<N> * N;              // du per warp
template <int N>
constexpr size_t kSmemBytes = sizeof(float) * (kHistFloats<N> + kStageFloats<N> +
                                               kOutFloats<N> + kColFloats<N> + kDuFloats<N>);

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

// x[0, n) <- the half of x[0, 2n) this lane keeps (the upper one if `upper`)
// plus the partner's copy of it, the partner at lane distance `dist`
template <int n, int cap>
__device__ __forceinline__ void fold(float (&x)[cap], bool upper, int dist, unsigned mask) {
#pragma unroll
  for (int m = 0; m < n; ++m) {
    const float give = upper ? x[m] : x[m + n];
    const float keep = upper ? x[m + n] : x[m];
    x[m] = keep + __shfl_xor_sync(mask, give, dist);
  }
}

// the sum of x over the warp's `lanes` lanes, in every lane (the same bits:
// each level adds the same two values in either lane)
template <int lanes>
__device__ __forceinline__ float warp_sum(float x, unsigned mask) {
#pragma unroll
  for (int d = lanes / 2; d > 0; d /= 2) x += __shfl_xor_sync(mask, x, d);
  return x;
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
  constexpr int L = kLanes<N>;
  constexpr int NW = kWarps<N>;
  constexpr unsigned M = kMask<N>;
  constexpr int R = G / kTile;                 // lanes left holding one row's sums
  constexpr int E = N / L;                     // columns per lane in the finish pass
  constexpr int kX = 5 * kChunk * N;           // floats of one chunk's staged inputs
  constexpr int kItems = kX / 4;               // ... in float4s
  constexpr int kPer = (kItems + NT - 1) / NT;
  static_assert(L % G == 0 && (L / G == 2 || L / G == 4), "a warp holds 2 or 4 row groups");
  static_assert(N % L == 0, "the finish pass gives each lane whole columns");

  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                          // [kChunk][kTile][NT][kTile], thread-private
  float* stage = hist + kHistFloats<N>;        // [3][5][kChunk][N]: r, k, v, w, dy
  float* rowb = stage + kStageFloats<N>;       // [2][3][kChunk][N]: S dy, dS v, dS * S
  float* colb = rowb + kOutFloats<N>;          // [2][kChunk][NW][N]: dS^T k
  float* dup = colb + kColFloats<N>;           // [NW][N]: du

  const int tid = threadIdx.x;
  const int lane = tid % L;
  const int warp = tid / L;
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
  // a chunk's inputs, [5][kChunk][N] in slot c % 3, pass through registers:
  // loaded before the barrier, stored after it
  float4 held[kPer];
  auto load_chunk = [&](int c) {
    const int t0 = c * kChunk;
    const int tc = min(kChunk, T - t0);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int q = tid + p * NT;              // float4 q of [5][kChunk][N / 4]
      const int x = q / (kChunk * (N / 4));
      const int s = (q / (N / 4)) % kChunk;
      const float* src = x == 0 ? r : x == 1 ? k : x == 2 ? v : x == 3 ? w : dy;
      if (q < kItems && s < tc) {
        held[p] = ld4(src + base + (size_t)(t0 + s) * stride_t + (q % (N / 4)) * 4);
      }
    }
  };
  auto store_chunk = [&](int c) {
    const int tc = min(kChunk, T - c * kChunk);
    float* xs = stage + (c % 3) * kX;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int q = tid + p * NT;
      if (q < kItems && (q / (N / 4)) % kChunk < tc) st4(xs + 4 * q, held[p]);
    }
  };

  float uf[E], du_acc[E];                      // at columns lane + e L
#pragma unroll
  for (int e = 0; e < E; ++e) {
    uf[e] = __ldg(u + (size_t)h * N + lane + e * L);
    du_acc[e] = 0.f;
  }
  // chunk c's outputs from its partials: warp `warp` finishes steps warp,
  // warp + NW, ...; lane `lane` columns lane + e L
  auto finish = [&](int c) {
    const int t0 = c * kChunk;
    const int tc = min(kChunk, T - t0);
    const float* xs = stage + (c % 3) * kX;
    const float* ro = rowb + (c & 1) * 3 * kChunk * N;
    const float* co = colb + (c & 1) * kChunk * NW * N;
#pragma unroll
    for (int p = 0; p < (kChunk + NW - 1) / NW; ++p) {
      const int s = warp + p * NW;
      if (s >= tc) break;
      float rr[E], kk[E], gy[E], vdy = 0.f, ruk = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = s * N + lane + e * L;
        rr[e] = xs[i];
        kk[e] = xs[kChunk * N + i];
        gy[e] = xs[4 * kChunk * N + i];
        vdy = fmaf(xs[2 * kChunk * N + i], gy[e], vdy);
        ruk = fmaf(rr[e], uf[e] * kk[e], ruk);
      }
      vdy = warp_sum<L>(vdy, M);
      ruk = warp_sum<L>(ruk, M);
      const size_t off = base + (size_t)(t0 + s) * stride_t;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = lane + e * L;
        float dsk = 0.f;
#pragma unroll
        for (int g = 0; g < NW; ++g) dsk += co[(s * NW + g) * N + i];
        dr[off + i] = fmaf(uf[e] * kk[e], vdy, ro[s * N + i]);
        dk[off + i] = fmaf(uf[e] * rr[e], vdy, ro[(kChunk + s) * N + i]);
        dw[off + i] = ro[(2 * kChunk + s) * N + i];
        dv[off + i] = fmaf(ruk, gy[e], dsk);
        du_acc[e] = fmaf(rr[e] * kk[e], vdy, du_acc[e]);
      }
    }
  };

  float dS[kTile][kTile];
  load_tile<N>(dS, ds_fin + (size_t)bh * N * N + tile);
  load_chunk(n_chunks - 1);
  store_chunk(n_chunks - 1);
  float Sc[kTile][kTile];                      // chunk c's checkpoint, loaded a chunk ahead
  load_tile<N>(Sc, ck + (size_t)(n_chunks - 1) * N * N);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int tc = min(kChunk, T - t0);
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
#pragma unroll
      for (int q = 0; q < kTile; ++q) S[a][q] = Sc[a][q];
    }
    if (c > 0) {
      load_chunk(c - 1);
      load_tile<N>(Sc, ck + (size_t)(c - 1) * N * N);
    }
    __syncthreads();                           // chunk c staged, chunk c + 1's partials written
    const float* xr = stage + (c % 3) * kX;
    const float* xk = xr + kChunk * N;
    const float* xv = xr + 2 * kChunk * N;
    const float* xw = xr + 3 * kChunk * N;
    const float* xdy = xr + 4 * kChunk * N;
    float* ro = rowb + (c & 1) * 3 * kChunk * N;
    float* co = colb + (c & 1) * kChunk * NW * N;

    // the chunk's states S before each step, from its checkpoint, but for
    // the last, which stays in registers
    auto recompute = [&](int s) {
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
    };
    // step t0 + s from S_{t-1} = Sp: its partials reduced to the chunk's
    // buffers, dS moved back
    auto step = [&](int s, const float (&Sp)[kTile][kTile]) {
      float rr[kTile], kk[kTile], ww[kTile], vv[kTile], gy[kTile];
      unpack(rr, ld4(xr + s * N + i0));
      unpack(kk, ld4(xk + s * N + i0));
      unpack(ww, ld4(xw + s * N + i0));
      unpack(vv, ld4(xv + s * N + j0));
      unpack(gy, ld4(xdy + s * N + j0));

      // the tile's partials, from S_{t-1} (Sp) and dS_t (dS): x holds row
      // a's S dy, dS v, dS * S at 3a, 3a + 1, 3a + 2
      float x[3 * kTile], pv[kTile] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
        for (int q = 0; q < kTile; ++q) {
          pr = fmaf(Sp[a][q], gy[q], pr);
          pk = fmaf(dS[a][q], vv[q], pk);
          pw = fmaf(dS[a][q], Sp[a][q], pw);
          pv[q] = fmaf(dS[a][q], kk[a], pv[q]);
        }
        x[3 * a] = pr; x[3 * a + 1] = pk; x[3 * a + 2] = pw;
      }
      // dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
#pragma unroll
        for (int q = 0; q < kTile; ++q) dS[a][q] = fmaf(ww[a], dS[a][q], rr[a] * gy[q]);
      }

      // rows, over the G lanes of the row group: keep rows {0,1} or {2,3},
      // then one row; for N = 64 the 4 lanes left with the same row then
      // keep one quantity each (padded to 4 with a zero), lane 3 none
      fold<6>(x, cg & (G / 2), G / 2, M);
      fold<3>(x, cg & (G / 4), G / 4, M);
      const int i = i0 + cg / R;
      if constexpr (R == 4) {
        x[3] = 0.f;
        fold<2>(x, cg & 2, 2, M);
        fold<1>(x, cg & 1, 1, M);
        if (cg % R < 3) ro[((cg % R) * kChunk + s) * N + i] = x[0];
      } else {
        static_assert(R == 1, "one lane per row holds its three sums");
#pragma unroll
        for (int m = 0; m < 3; ++m) ro[(m * kChunk + s) * N + i] = x[m];
      }

      // columns, over the warp's L / G row groups: keep columns {0,1} or
      // {2,3} of the tile (and, for 4 row groups, one column)
      int j = j0;
      fold<2>(pv, lane & (L / 2), L / 2, M);
      j += lane & (L / 2) ? 2 : 0;
      float* cs = co + (s * NW + warp) * N;
      if constexpr (L / G == 2) {
        *reinterpret_cast<float2*>(cs + j) = make_float2(pv[0], pv[1]);
      } else {
        fold<1>(pv, lane & (L / 4), L / 4, M);
        cs[j + (lane & (L / 4) ? 1 : 0)] = pv[0];
      }
    };

    auto step_from_hist = [&](int s) {
      float Sp[kTile][kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) unpack(Sp[a], ld4(hist + ((s * kTile + a) * NT + tid) * kTile));
      step(s, Sp);
    };

    if (tc == kChunk) {
#pragma unroll
      for (int s = 0; s < kChunk - 1; ++s) recompute(s);
      step(kChunk - 1, S);
#pragma unroll
      for (int s = kChunk - 2; s >= 0; --s) step_from_hist(s);
    } else {
      for (int s = 0; s < tc - 1; ++s) recompute(s);
      step(tc - 1, S);
      for (int s = tc - 2; s >= 0; --s) step_from_hist(s);
    }
    if (c + 1 < n_chunks) finish(c + 1);
    // chunk c - 1's inputs, loaded before the barrier, land after the steps
    if (c > 0) store_chunk(c - 1);
  }
  __syncthreads();                             // chunk 0's partials written
  finish(0);

#pragma unroll
  for (int e = 0; e < E; ++e) dup[warp * N + lane + e * L] = du_acc[e];
  __syncthreads();
  if (tid < N) {
    float acc = 0.f;
#pragma unroll
    for (int g = 0; g < NW; ++g) acc += dup[g * N + tid];
    du_part[(size_t)bh * N + tid] = acc;
  }
  store_tile<N>(ds0 + (size_t)bh * N * N + tile, dS);
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
