// RG-LRU scan (Griffin / RecurrentGemma gated linear recurrence) for Hopper,
// sm_90a.
//
//   h_t = a_t * h_{t-1} + b_t        (per channel), returns (h_1..T, h_T)
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/rglru_scan.py:27
// (_rglru_kernel, launched by rglru_scan_pallas).  The Pallas kernel stages
// (time x channel) tiles of a and b in VMEM, double-buffered by DMA, walks
// each tile serially and carries the state row across the time chunks of a
// sequential grid axis.  Blocks here run in no order, so the whole T loop
// stays inside one block and the state never leaves a register; the staging
// comes back as a ring in shared memory filled by cp.async.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  At the training shape B=1,
// T=4096, D=4096 it reads 2 x 67.1 MB of a and b and writes 67.1 MB of h,
// plus the two (B, D) states: 201.4 MB, 0.060 ms; at the serving prefill
// shape B=8, T=512 the same bytes.  Its arithmetic, one FMA per element, is
// far below the f32 rate.  At the decode shape (T=1) the data is 0.66 MB
// (0.2 us): the launch sets the pace.
//
// What held the first design back: one thread per (b, d) channel in blocks
// of 128, each keeping the next 16 steps of a and b in flight in registers.
// At B=1, D=4096 that is 32 blocks on 132 SMs and 0.5 MB in flight over the
// card, where HBM's latency asks for 2-3 MB: 0.25 ms, 24% of the bound.
// Registers cannot hold more steps ahead.
//
// Design: one pass over narrow channel tiles, fed by a ring in shared memory.
//   * One warp per block, one batch row and a tile of 32 consecutive
//     channels (lane = channel: one 128-byte row per step); the grid is
//     (ceil(D/32), B), 128 blocks at B=1, D=4096 and 1024 at B=8.
//   * The warp walks the recurrence, h in a register, one FMA per step in
//     time order, as the first design did.
//   * a and b come through a ring of kStages stages of kSteps steps x 32
//     channels, filled by 16-byte cp.async that the walking warp itself
//     starts kStages-1 stages ahead: cp.async does not block, so a separate
//     producer warp would only add a barrier pair per stage.  Each lane's
//     copy addresses advance by a fixed stride.  One cp.async.wait_group
//     and one __syncwarp per stage, none per step: 56 KB in flight per
//     block, 7.2 MB over the card at B=1.
//   * A stage's steps of a and b go to registers before its first step, so
//     no shared-memory load waits behind the walk.
//   * The walk writes h to a shared-memory slot; once per stage each lane
//     stores 16-byte pieces of the stage's rows.  One 4-byte global store
//     per step and lane held one warp per SM to half the card's rate at
//     B=1 (0.119 ms), and 128-byte bulk copies (TMA) of each row were slower
//     still (0.189 ms; tools/rglru_scan_versions.py, PERF.md).
//   * Every input is read once and every output written once; no scratch.
//   * Any B, T and D: the ragged edge of D and of the last stage is masked.
//     Where D is no multiple of 4 or a pointer is not 16-byte aligned (odd
//     shapes, off the main paths), the copies move 4 bytes and h goes out by
//     a global store per step.
//   Inputs are contiguous f32 (B, T, D) and (B, D); the wrapper checks that.
//
// ptxas -v (sm_90a, -O3): 63 registers (16-byte copies) and 57 (4-byte), no
// spills, no static shared memory; dynamic shared memory 69,632 bytes (the
// 4 KB output slot and 8 ring slots of 8 KB; 65,536 with 4-byte copies,
// one slot per stage where T has fewer than 8 stages).

#include <cuda_runtime.h>

#include <algorithm>

#include <cstdint>

namespace {

constexpr int kLanes = 32;    // channels per block, one warp
constexpr int kSteps = 32;    // steps per stage of the ring
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
  static constexpr int kSlot = 2 * kSteps * kLanes;       // floats of a ring slot: a, then b
  static constexpr bool kStaged = VEC == 4;               // h out through shared memory
  static constexpr int kOut = kStaged ? kSteps * kLanes : 0;   // floats of the output slot
  // shared memory for the output slot and `slots` ring slots
  static constexpr int bytes(int slots) {
    return static_cast<int>(sizeof(float)) * (kOut + slots * kSlot);
  }
  static_assert(kSteps % kRowsPerPass == 0, "a stage is whole warp-wide copies");
};

template <int VEC>
__global__ void __launch_bounds__(kLanes) rglru_scan_kernel(
    const float* __restrict__ a,    // (B, T, D)
    const float* __restrict__ b,    // (B, T, D)
    const float* __restrict__ h0,   // (B, D)
    float* __restrict__ h,          // (B, T, D)
    float* __restrict__ h_last,     // (B, D)
    int T, int D) {
  using L = Layout<VEC>;
  constexpr int K = kSteps, S = kStages;
  // the output slot, then the ring's slots: S, or one per stage where T
  // has fewer stages (a decode step's T = 1 needs one)
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * kLanes;
  const int nd = min(kLanes, D - d0);
  const size_t row0 = (size_t)blockIdx.y * T;     // row (bi, t=0) of (B*T, D)
  const int n_stages = (T + K - 1) / K;
  const bool live = lane < nd;

  // This lane's copies, and its stores of a staged h: channels [c, c + VEC)
  // of the stage's rows r, r + kRowsPerPass, ...
  const int r = lane / L::kPerRow;
  const int c = (lane % L::kPerRow) * VEC;
  const bool c_ok = c < nd;
  const size_t pass = (size_t)L::kRowsPerPass * D;
  const size_t first = (row0 + r) * D + d0 + c;
  auto fill = [&](int st) {
    float* slot = smem + L::kOut + (st % S) * L::kSlot + r * kLanes + c;
    const float* pa = a + first + (size_t)st * K * D;
    const float* pb = b + first + (size_t)st * K * D;
    const int t = st * K + r;
#pragma unroll
    for (int p = 0; p < K / L::kRowsPerPass; ++p) {
      const bool ok = c_ok && t + p * L::kRowsPerPass < T;
      cp_async<VEC>(slot + p * L::kRowsPerPass * kLanes, pa, ok);
      cp_async<VEC>(slot + (K + p * L::kRowsPerPass) * kLanes, pb, ok);
      pa += pass;
      pb += pass;
    }
  };

  float hv = live ? h0[(size_t)blockIdx.y * D + d0 + lane] : 0.0f;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < n_stages) fill(st);
    cp_async_commit();
  }
  float* const so = smem;                          // the output slot
  for (int st = 0; st < n_stages; ++st) {
    // refill the slot walked in the previous stage (the __syncwarp at the
    // end of that stage ordered its reads before these writes)
    if (st + S - 1 < n_stages) fill(st + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();      // this thread's copies of stage st have landed
    __syncwarp();                // and every lane's are visible; the last
                                 // stage's stores have read the output slot
    const float* sa = smem + L::kOut + (st % S) * L::kSlot + lane;
    const float* sb = sa + K * kLanes;
    const int t0 = st * K;
    const int nk = min(K, T - t0);
    // step k of the stage goes to out[k * step]
    float* out = L::kStaged ? so + lane : h + (row0 + t0) * D + d0 + lane;
    const size_t step = L::kStaged ? kLanes : D;
    if (live && nk == K) {
      // a whole stage: its K steps' inputs to registers first
      float ra[K], rb[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ra[k] = sa[k * kLanes];
        rb[k] = sb[k * kLanes];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        hv = fmaf(ra[k], hv, rb[k]);
        out[k * step] = hv;
      }
    } else if (live) {           // the last stage of a ragged T
      for (int k = 0; k < nk; ++k) {
        hv = fmaf(sa[k * kLanes], hv, sb[k * kLanes]);
        out[k * step] = hv;
      }
    }
    __syncwarp();
    if constexpr (L::kStaged) {
      float* g = h + first + (size_t)t0 * D;
#pragma unroll
      for (int p = 0; p < K / L::kRowsPerPass; ++p) {
        const int k = r + p * L::kRowsPerPass;
        if (c_ok && k < nk) {
          *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(so + k * kLanes + c);
        }
        g += pass;
      }
    }
  }
  if (live) h_last[(size_t)blockIdx.y * D + d0 + lane] = hv;
}

template <int VEC>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* a, const float* b,
                   const float* h0, float* h, float* h_last, int T, int D) {
  // more than the default 48 KB of dynamic shared memory needs the attribute
  static const cudaError_t ready = cudaFuncSetAttribute(
      rglru_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<VEC>::bytes(kStages));
  if (ready != cudaSuccess) return ready;
  const int slots = std::min(kStages, (T + kSteps - 1) / kSteps);
  rglru_scan_kernel<VEC><<<grid, kLanes, Layout<VEC>::bytes(slots), stream>>>(
      a, b, h0, h, h_last, T, D);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches on `stream`; returns 0 on success or the CUDA error code, and
// cudaErrorInvalidValue for a shape the grid cannot hold.
int rglru_scan_forward(const void* a, const void* b, const void* h0, void* h,
                       void* h_last, int B, int T, int D, void* stream) {
  if (B < 1 || T < 1 || D < 1 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((D + kLanes - 1) / kLanes, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(b);
  const auto* fh0 = static_cast<const float*>(h0);
  auto* fh = static_cast<float*>(h);
  auto* flast = static_cast<float*>(h_last);
  const cudaError_t e = D % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(h)
      ? launch<4>(grid, s, fa, fb, fh0, fh, flast, T, D)
      : launch<1>(grid, s, fa, fb, fh0, fh, flast, T, D);
  return static_cast<int>(e);
}

const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
