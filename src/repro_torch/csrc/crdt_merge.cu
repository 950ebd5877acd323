// Versioned CRDT merge (row-wise last-writer-wins join) for Hopper, sm_90a.
//
//   out_val[i] = ver_a[i] >= ver_b[i] ? val_a[i] : val_b[i]   (rows of N elements)
//   out_ver[i] = max(ver_a[i], ver_b[i])
//
// Replaces the TPU kernel src/repro/kernels/crdt_merge/crdt_merge.py:24
// (_merge_kernel, launched by crdt_merge_pallas).  The Pallas kernel reads
// both (bm, bn) payload tiles and selects between them; the function needs
// only the winner's row, so here each row's two versions are read first and
// then only the winning row's payload: a third fewer bytes.
//
// Design:
//   * the kernel moves bits only, so one body templated on the word it
//     moves covers f32, bf16 and int32 payloads.  The launcher picks the
//     widest word (16, 8, 4 or 2 bytes) that divides a row's bytes and the
//     alignment of the three payload pointers: a YCSB row of 250 int32
//     (1,000 bytes) starts on an 8-byte boundary only, and a 16-byte word
//     would straddle two rows with different winners;
//   * one warp per group of 32 rows: lane i reads both versions of row i
//     (coalesced), writes its out_ver, and a ballot gives the warp the 32
//     winners as a bit mask;
//   * the group's rows are one contiguous span in all three arrays, so the
//     warp streams it word by word: lane l copies words l, l + 32, ...,
//     each from its row's winner, 8 loads in flight per lane before the
//     stores.  Each lane tracks the row of its word by steps of 32, with no
//     division.  (A first version copied the 32 rows one after another,
//     4 words per lane in flight, and was slower: PERF.md.)
//   * grid-stride over the row groups; 64-bit offsets throughout (M * N
//     passes 2^31 at 10^7 rows of 250 words).
//   Inputs are contiguous, versions int32; the wrapper checks that.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  It reads the winner's payload
// and both version vectors, and writes the payload and out_ver: at
// (10^7, 250) int32, 20.12 GB, 6.006 ms.  A kernel that reads both payloads
// moves 30.12 GB and cannot pass 66.8% of that bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kWordsPerLane = 8;   // loads in flight per lane

template <typename W>
__global__ void __launch_bounds__(kThreads) crdt_merge_kernel(
    const W* __restrict__ val_a, const int* __restrict__ ver_a,
    const W* __restrict__ val_b, const int* __restrict__ ver_b,
    W* __restrict__ out_val, int* __restrict__ out_ver,
    int64_t m, uint32_t words) {
  const uint32_t lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  const int64_t groups = (m + 31) / 32;
  for (int64_t grp = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       grp < groups; grp += warps) {
    const int64_t row0 = grp * 32;
    const int64_t my_row = row0 + lane;
    bool take_a = true;
    if (my_row < m) {
      const int va = ver_a[my_row], vb = ver_b[my_row];
      take_a = va >= vb;
      out_ver[my_row] = va >= vb ? va : vb;
    }
    const unsigned a_mask = __ballot_sync(0xffffffffu, take_a);
    if (words == 0) continue;

    // the group's rows are one contiguous span of rows * words words in all
    // three arrays; lane l copies words l, l + 32, ... of it, each from its
    // row's winner, tracking (row, col) of its word as it steps by 32
    const int64_t rows = m - row0 < 32 ? m - row0 : 32;
    const int64_t span = rows * words;
    const int64_t base = row0 * words;
    uint32_t row = lane / words, col = lane - row * words;
    for (int64_t f0 = lane; f0 < span; f0 += 32 * kWordsPerLane) {
      W buf[kWordsPerLane];
#pragma unroll
      for (int k = 0; k < kWordsPerLane; ++k) {
        const int64_t f = f0 + 32 * k;
        if (f < span) buf[k] = ((a_mask >> row) & 1u ? val_a : val_b)[base + f];
        col += 32;
        while (col >= words) {
          col -= words;
          ++row;
        }
      }
#pragma unroll
      for (int k = 0; k < kWordsPerLane; ++k) {
        const int64_t f = f0 + 32 * k;
        if (f < span) out_val[base + f] = buf[k];
      }
    }
  }
}

template <typename W>
int launch(const void* val_a, const int* ver_a, const void* val_b, const int* ver_b,
           void* out_val, int* out_ver, int64_t m, int64_t row_bytes, cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  if (words >= (int64_t)1 << 26) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t groups = (m + 31) / 32;
  int64_t blocks = (groups + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  crdt_merge_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(val_a), ver_a, static_cast<const W*>(val_b), ver_b,
      static_cast<W*>(out_val), out_ver, m, (uint32_t)words);
  return static_cast<int>(cudaGetLastError());
}

bool fits(int64_t bytes, const void* a, const void* b, const void* c, int64_t word) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c);
  return bytes % word == 0 && any % word == 0;
}

}  // namespace

extern "C" {

// val_a, val_b, out_val: (m, n) payloads of elem_size (2 or 4) bytes each;
// ver_a, ver_b, out_ver: (m,) int32.  Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for m < 1, a
// negative n, another element size or payload pointers off their elements'
// alignment.
int crdt_merge_forward(const void* val_a, const void* ver_a, const void* val_b,
                       const void* ver_b, void* out_val, void* out_ver, long long m,
                       long long n, int elem_size, void* stream) {
  if (m < 1 || n < 0 || (elem_size != 2 && elem_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = n * elem_size;
  const int* va = static_cast<const int*>(ver_a);
  const int* vb = static_cast<const int*>(ver_b);
  int* ov = static_cast<int*>(out_ver);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fits(row_bytes, val_a, val_b, out_val, 16))
    return launch<uint4>(val_a, va, val_b, vb, out_val, ov, m, row_bytes, s);
  if (fits(row_bytes, val_a, val_b, out_val, 8))
    return launch<uint2>(val_a, va, val_b, vb, out_val, ov, m, row_bytes, s);
  if (fits(row_bytes, val_a, val_b, out_val, 4))
    return launch<uint32_t>(val_a, va, val_b, vb, out_val, ov, m, row_bytes, s);
  if (fits(row_bytes, val_a, val_b, out_val, 2))
    return launch<uint16_t>(val_a, va, val_b, vb, out_val, ov, m, row_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* crdt_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
