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
// Bound on an H100 SXM (3.35 TB/s): memory.  At the training shape B=1,
// T=4096, D=4096 it reads a, h and dh (3 x 67.1 MB) and writes da and db
// (2 x 67.1 MB): 335.6 MB, 0.100 ms; its arithmetic (an add and two
// multiplies per element) is far below the f32 rate.
//
// What held the first design back: one thread per (b, d) channel in
// blocks of 128, each keeping the next 16 steps of a, dh and h_{t-1} in
// flight in registers.  At B=1, D=4096 that is 32 blocks on 132 SMs and
// 0.8 MB in flight over the card, where HBM's latency asks for 2-3 MB:
// 0.38 ms, 26% of the bound.
//
// Design, that of rglru_scan.cu run backwards in time:
//   * one warp per block, one batch row and a tile of 32 consecutive
//     channels (lane = channel); the grid is (ceil(D/32), B);
//   * the warp walks t = T-1 .. 0 with the carry a_{t+1} g_{t+1} in a
//     register, the same operations per step in the same order as the
//     first design;
//   * a_t, dh_t and h_{t-1} (the forward's f32 output, so nothing is
//     recomputed; h0 at t = 0) come through a ring of kStages stages of
//     kSteps steps x 32 channels in shared memory, filled by 16-byte
//     cp.async that the walking warp starts kStages-1 stages ahead; one
//     cp.async.wait_group and one __syncwarp per stage, none per step: 42 KB
//     in flight per block, 5.4 MB over the card at B=1; a stage's inputs go
//     to registers before its first step;
//   * the walk writes da and db to a shared-memory slot; once per stage
//     each lane stores 16-byte pieces of the stage's rows (a 4-byte global
//     store per step and lane took 0.248 ms at B=1; PERF.md);
//   * every input is read once and every output written once; no scratch;
//   * any B, T and D; the ragged edge of D and of the first stage in time
//     is masked.  Where D is no multiple of 4 or a pointer is not 16-byte
//     aligned (odd shapes, off the main paths), the copies move 4 bytes and
//     da and db go out by global stores per step.
//
// ptxas -v (sm_90a, -O3): 66 registers (16-byte copies) and 48 (4-byte), no
// spills, no static shared memory; dynamic shared memory 53,248 bytes (the
// 4 KB output slot and 8 ring slots of 6 KB; 49,152 with 4-byte copies,
// one slot per stage where T has fewer than 8 stages).

#include <cuda_runtime.h>

#include <algorithm>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 32;    // channels per block, one warp
constexpr int kSteps = 16;    // steps per stage of the ring
constexpr int kStages = 8;    // stages of the ring

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// VEC floats from gmem to smem, or VEC zeros where !valid (then gmem is not
// read): a predicate, not a branch, per copy
template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem, bool valid) {
  const int n = valid ? 4 * VEC : 0;
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_addr(smem)), "l"(gmem), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_addr(smem)), "l"(gmem), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

template <int VEC>
struct Layout {
  static constexpr int kPerRow = kLanes / VEC;            // copies per 128-byte row
  static constexpr int kRowsPerPass = kLanes / kPerRow;   // rows one warp-wide copy covers
  static constexpr int kSlot = 3 * kSteps * kLanes;       // a ring slot: a, dh, h_{t-1}
  static constexpr bool kStaged = VEC == 4;               // da, db out through shared memory
  static constexpr int kOut = kStaged ? 2 * kSteps * kLanes : 0;   // floats of the output slot
  // shared memory for the output slot and `slots` ring slots
  static constexpr int bytes(int slots) {
    return static_cast<int>(sizeof(float)) * (kOut + slots * kSlot);
  }
  static_assert(kSteps % kRowsPerPass == 0, "a stage is whole warp-wide copies");
};

template <int VEC>
__global__ void __launch_bounds__(kLanes) rglru_scan_backward_kernel(
    const float* __restrict__ a,        // (B, T, D)
    const float* __restrict__ h,        // (B, T, D): the forward's output
    const float* __restrict__ h0,       // (B, D)
    const float* __restrict__ dh,       // (B, T, D)
    const float* __restrict__ dh_last,  // (B, D)
    float* __restrict__ da,             // (B, T, D)
    float* __restrict__ db,             // (B, T, D)
    float* __restrict__ dh0,            // (B, D)
    int T, int D) {
  using L = Layout<VEC>;
  constexpr int K = kSteps, S = kStages;
  // the output slot, then the ring's slots: S, or one per stage where T
  // has fewer stages
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * kLanes;
  const int nd = min(kLanes, D - d0);
  const size_t row0 = (size_t)blockIdx.y * T;     // row (bi, t=0) of (B*T, D)
  const int n_stages = (T + K - 1) / K;
  const bool live = lane < nd;
  const size_t state = (size_t)blockIdx.y * D + d0 + lane;

  // Stage st holds the steps [t0, t0 + K), t0 = T - (st+1) K, counted from
  // the end; those below 0 are not copied.  This lane's copies, and its
  // stores of staged da and db: channels [c, c + VEC) of the stage's rows
  // r, r + kRowsPerPass, ...
  const int r = lane / L::kPerRow;
  const int c = (lane % L::kPerRow) * VEC;
  const bool c_ok = c < nd;
  const ptrdiff_t pass = static_cast<ptrdiff_t>(L::kRowsPerPass) * D;
  const ptrdiff_t top = (static_cast<ptrdiff_t>(row0) + T - K + r) * D + d0 + c;
  auto fill = [&](int st) {
    float* slot = smem + L::kOut + (st % S) * L::kSlot + r * kLanes + c;
    const ptrdiff_t off = top - static_cast<ptrdiff_t>(st) * K * D;
    const float* pa = a + off;
    const float* pg = dh + off;
    const float* ph = h + off - D;
    const int t = T - (st + 1) * K + r;
#pragma unroll
    for (int p = 0; p < K / L::kRowsPerPass; ++p) {
      const int tp = t + p * L::kRowsPerPass;
      const int row = p * L::kRowsPerPass * kLanes;
      cp_async<VEC>(slot + row, pa, c_ok && tp >= 0);
      cp_async<VEC>(slot + K * kLanes + row, pg, c_ok && tp >= 0);
      cp_async<VEC>(slot + 2 * K * kLanes + row, ph, c_ok && tp >= 1);
      pa += pass;
      pg += pass;
      ph += pass;
    }
  };

  const float h0v = live ? h0[state] : 0.0f;
  float carry = live ? dh_last[state] : 0.0f;    // a_{t+1} g_{t+1}
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_stages) fill(st);
    cp_async_commit();
  }
  float* const so = smem;                          // the output slot: da, then db
  for (int st = 0; st < n_stages; ++st) {
    // refill the slot walked in the previous stage (the __syncwarp at the
    // end of that stage ordered its reads before these writes)
    if (st + S - 1 < n_stages) fill(st + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();      // this thread's copies of stage st have landed
    __syncwarp();                // and every lane's are visible; the last
                                 // stage's stores have read the output slot
    const float* sa = smem + L::kOut + (st % S) * L::kSlot + lane;
    const float* sg = sa + K * kLanes;
    const float* sh = sg + K * kLanes;
    const int t0 = T - (st + 1) * K;
    // step k of the stage goes to oa[k * step], ob[k * step]
    const ptrdiff_t stage_row = (static_cast<ptrdiff_t>(row0) + t0) * D + d0 + lane;
    float* oa = L::kStaged ? so + lane : da + stage_row;
    float* ob = L::kStaged ? so + K * kLanes + lane : db + stage_row;
    const ptrdiff_t step = L::kStaged ? kLanes : D;
    if (live && t0 > 0) {
      // a whole stage above t = 0: its K steps' inputs to registers first
      float ra[K], rg[K], rh[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ra[k] = sa[k * kLanes];
        rg[k] = sg[k * kLanes];
        rh[k] = sh[k * kLanes];
      }
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        const float g = rg[k] + carry;
        ob[k * step] = g;
        oa[k * step] = g * rh[k];
        carry = ra[k] * g;
      }
    } else if (live) {
      // the last stage: it holds t = 0, and below it, for a T that is no
      // multiple of K, steps that do not exist (t0 < 0)
      for (int k = K - 1; k >= 0 && t0 + k >= 0; --k) {
        const float g = sg[k * kLanes] + carry;
        ob[k * step] = g;
        oa[k * step] = g * (t0 + k > 0 ? sh[k * kLanes] : h0v);
        carry = sa[k * kLanes] * g;
      }
    }
    __syncwarp();
    if constexpr (L::kStaged) {
      const ptrdiff_t off = top - static_cast<ptrdiff_t>(st) * K * D;
      float* ga = da + off;
      float* gb = db + off;
      const int t = t0 + r;
#pragma unroll
      for (int p = 0; p < K / L::kRowsPerPass; ++p) {
        const int k = r + p * L::kRowsPerPass;
        if (c_ok && t + p * L::kRowsPerPass >= 0) {
          *reinterpret_cast<float4*>(ga) = *reinterpret_cast<const float4*>(so + k * kLanes + c);
          *reinterpret_cast<float4*>(gb) =
              *reinterpret_cast<const float4*>(so + (K + k) * kLanes + c);
        }
        ga += pass;
        gb += pass;
      }
    }
  }
  if (live) dh0[state] = carry;
}

struct Args {
  const float *a, *h, *h0, *dh, *dh_last;
  float *da, *db, *dh0;
  int T, D;
};

template <int VEC>
cudaError_t launch(dim3 grid, cudaStream_t stream, const Args& x) {
  // more than the default 48 KB of dynamic shared memory needs the attribute
  static const cudaError_t ready = cudaFuncSetAttribute(
      rglru_scan_backward_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<VEC>::bytes(kStages));
  if (ready != cudaSuccess) return ready;
  const int slots = std::min(kStages, (x.T + kSteps - 1) / kSteps);
  rglru_scan_backward_kernel<VEC><<<grid, kLanes, Layout<VEC>::bytes(slots), stream>>>(
      x.a, x.h, x.h0, x.dh, x.dh_last, x.da, x.db, x.dh0, x.T, x.D);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 on success or the CUDA error code, and
// cudaErrorInvalidValue for a shape the grid cannot hold.
int rglru_scan_backward(const void* a, const void* h, const void* h0, const void* dh,
                        const void* dh_last, void* da, void* db, void* dh0,
                        int B, int T, int D, void* stream) {
  if (B < 1 || T < 1 || D < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((D + kLanes - 1) / kLanes, B);
  const Args x{static_cast<const float*>(a), static_cast<const float*>(h),
               static_cast<const float*>(h0), static_cast<const float*>(dh),
               static_cast<const float*>(dh_last), static_cast<float*>(da),
               static_cast<float*>(db), static_cast<float*>(dh0), T, D};
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && aligned16(a) && aligned16(h) && aligned16(dh) &&
                    aligned16(da) && aligned16(db);
  return static_cast<int>(vec4 ? launch<4>(grid, s, x) : launch<1>(grid, s, x));
}

const char* rglru_scan_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
