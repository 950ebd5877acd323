// Versioned CRDT merge (row-wise last-writer-wins join) for Hopper, sm_90a.
//
//   out_val[i] = ver_a[i] >= ver_b[i] ? val_a[i] : val_b[i]   (rows of N elements)
//   out_ver[i] = max(ver_a[i], ver_b[i])
//
// and the same join straight into a table's rows, in place:
//
//   table[rows[i]] = new_val[i]   where new_rank[i] > cur_rank[i]
//   out_rank[i]    = max(cur_rank[i], new_rank[i])
//
// Replaces the TPU kernel src/repro/kernels/crdt_merge/crdt_merge.py:24
// (_merge_kernel, launched by crdt_merge_pallas).  The Pallas kernel reads
// both (bm, bn) payload tiles and selects between them; the function needs
// only the winner's row, so here each row's two versions are read first and
// then only the winning row's payload: a third fewer bytes.  The indexed
// join is the same function with side a gathered from the table's rows and
// scattered back; done in place it moves only the rows the batch takes.
//
// Design:
//   * both kernels move bits only, so one body templated on the word it
//     moves covers f32, bf16 and int32 payloads.  The launcher picks the
//     widest word (16, 8, 4 or 2 bytes) that divides a row's bytes and the
//     alignment of every payload pointer: a YCSB row of 250 int32 (1,000
//     bytes) starts on an 8-byte boundary only, and a 16-byte word would
//     straddle two rows with different winners.  The tables are contiguous,
//     so a row's bytes are also their row stride;
//   * one copy loop (copy_span) for both: lane l copies words l, l + 32,
//     ... of a span of whole rows, each from its row's winner, 8 loads in
//     flight per lane before the stores, tracking the row of its word by
//     steps of 32 with no division;
//   * the dense kernel gives a warp a group of `group` rows: lane i reads
//     both versions of row i (coalesced), writes its out_ver, and a ballot
//     gives the warp the winners as a bit mask.  The launcher takes 32 rows
//     a warp wherever that still makes kMinBlocksPerSm blocks an SM, and
//     halves the group below that, down to one row a warp: at 3,400 rows,
//     groups of 32 made 14 blocks, and 14 of the 132 SMs held the whole
//     batch's loads in flight (~219 KB; the card needs ~2 MB to cover its
//     latency);
//   * the indexed join gives a warp one row: every lane reads the row's
//     index and both ranks (one broadcast transaction each), lane 0 writes
//     out_rank, and a row the table keeps stops before any payload load; a
//     1,000-byte row is 125 8-byte words, 4 a lane, all in flight at once.
//     At 3,400 rows that is 425 blocks of 8 warps, one wave on the card.
//     An index outside [0, R) traps: the kernel writes nothing outside the
//     table.  Rows must be distinct (two warps writing one row race);
//   * grid-stride over the dense kernel's row groups; 64-bit offsets
//     throughout (M * N and rows[i] * N pass 2^31 at 10^7 rows of 250
//     words).
//   Inputs are contiguous, versions int32, indices int64; the wrapper
//   checks that.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The dense kernel reads the
// winner's payload and both version vectors, and writes the payload and
// out_ver: at (10^7, 250) int32, 20.12 GB, 6.006 ms.  A kernel that reads
// both payloads moves 30.12 GB and cannot pass 66.8% of that bound.  The
// join reads and writes the payload of the rows it takes, and the index and
// three ranks of every row: at 3,400 rows of 1,000 bytes, all taken, 6.87
// MB, 2.05 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;     // the dense kernel's grid cap
constexpr int kMinBlocksPerSm = 4;  // the dense kernel's aim below its cap
constexpr int kWordsPerLane = 8;    // loads in flight per lane

// Copies a span of `span` words (whole rows of `words` words each) into
// dst, word f from a where bit f / words of a_mask is set, else from b.
template <typename W>
__device__ __forceinline__ void copy_span(W* __restrict__ dst, const W* __restrict__ a,
                                          const W* __restrict__ b, unsigned a_mask,
                                          int64_t span, uint32_t words, uint32_t lane) {
  uint32_t row = lane / words, col = lane - row * words;
  for (int64_t f0 = lane; f0 < span; f0 += 32 * kWordsPerLane) {
    W buf[kWordsPerLane];
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int64_t f = f0 + 32 * k;
      if (f < span) buf[k] = ((a_mask >> row) & 1u ? a : b)[f];
      col += 32;
      while (col >= words) {
        col -= words;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < kWordsPerLane; ++k) {
      const int64_t f = f0 + 32 * k;
      if (f < span) dst[f] = buf[k];
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads) crdt_merge_kernel(
    const W* __restrict__ val_a, const int* __restrict__ ver_a,
    const W* __restrict__ val_b, const int* __restrict__ ver_b,
    W* __restrict__ out_val, int* __restrict__ out_ver,
    int64_t m, uint32_t words, uint32_t group) {
  const uint32_t lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t groups = (m + group - 1) / group;
  for (int64_t grp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); grp < groups;
       grp += warps) {
    const int64_t row0 = grp * group;
    const int64_t rows = m - row0 < group ? m - row0 : group;
    bool take_a = true;
    if (lane < rows) {
      const int64_t my_row = row0 + lane;
      const int va = ver_a[my_row], vb = ver_b[my_row];
      take_a = va >= vb;
      out_ver[my_row] = va >= vb ? va : vb;
    }
    const unsigned a_mask = __ballot_sync(0xffffffffu, take_a);
    if (words == 0) continue;
    // the group's rows are one contiguous span in all three arrays
    const int64_t base = row0 * words;
    copy_span(out_val + base, val_a + base, val_b + base, a_mask, rows * words, words, lane);
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads) crdt_merge_rows_kernel(
    W* __restrict__ table, int64_t n_rows, const int64_t* __restrict__ rows,
    const int* __restrict__ cur_rank, const W* __restrict__ new_val,
    const int* __restrict__ new_rank, int* __restrict__ out_rank, int64_t k, uint32_t words) {
  const int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= k) return;
  const uint32_t lane = threadIdx.x & 31;
  const int64_t row = rows[i];
  const int cur = cur_rank[i], nw = new_rank[i];
  if (row < 0 || row >= n_rows) __trap();
  if (lane == 0) out_rank[i] = nw > cur ? nw : cur;
  if (nw <= cur || words == 0) return;
  const W* src = new_val + i * words;
  copy_span(table + row * words, src, src, 0u, (int64_t)words, words, lane);
}

// launch(W{}) for the widest word W that divides `row_bytes` and `addrs`
// (the payload pointers OR'd together).
template <typename F>
int widest(int64_t row_bytes, uintptr_t addrs, F&& launch) {
  auto fits = [&](int64_t word) { return row_bytes % word == 0 && addrs % word == 0; };
  if (fits(16)) return launch(uint4{});
  if (fits(8)) return launch(uint2{});
  if (fits(4)) return launch(uint32_t{});
  if (fits(2)) return launch(uint16_t{});
  return static_cast<int>(cudaErrorInvalidValue);
}

uintptr_t addr(const void* p) { return reinterpret_cast<uintptr_t>(p); }

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
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
  return widest(row_bytes, addr(val_a) | addr(val_b) | addr(out_val), [&](auto w) {
    using W = decltype(w);
    const int64_t words = row_bytes / (int64_t)sizeof(W);
    if (words >= (int64_t)1 << 26) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t sms = sm_count(), cap = sms * kBlocksPerSm, aim = sms * kMinBlocksPerSm;
    auto blocks_for = [&](int64_t g) { return ((m + g - 1) / g + kWarps - 1) / kWarps; };
    uint32_t group = 32;
    while (group > 1 && blocks_for(group) < aim) group /= 2;
    const int64_t blocks = blocks_for(group) < cap ? blocks_for(group) : cap;
    crdt_merge_kernel<W><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const W*>(val_a), static_cast<const int*>(ver_a),
        static_cast<const W*>(val_b), static_cast<const int*>(ver_b), static_cast<W*>(out_val),
        static_cast<int*>(out_ver), m, (uint32_t)words, group);
    return static_cast<int>(cudaGetLastError());
  });
}

// table: (n_rows, n) payload of elem_size (2 or 4) bytes, contiguous,
// joined in place; rows: (k,) int64, distinct, each in [0, n_rows);
// cur_rank, new_rank, out_rank: (k,) int32; new_val: (k, n) of the table's
// element size.  Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for k < 1, a negative n or n_rows,
// another element size or payload pointers off their elements' alignment.
int crdt_merge_rows_forward(void* table, long long n_rows, const void* rows,
                            const void* cur_rank, const void* new_val, const void* new_rank,
                            void* out_rank, long long k, long long n, int elem_size,
                            void* stream) {
  if (k < 1 || n < 0 || n_rows < 0 || (elem_size != 2 && elem_size != 4) ||
      (k + kWarps - 1) / kWarps > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = n * elem_size;
  return widest(row_bytes, addr(table) | addr(new_val), [&](auto w) {
    using W = decltype(w);
    const int64_t words = row_bytes / (int64_t)sizeof(W);
    if (words >= (int64_t)1 << 26) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (k + kWarps - 1) / kWarps;
    crdt_merge_rows_kernel<W>
        <<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<W*>(table), n_rows, static_cast<const int64_t*>(rows),
            static_cast<const int*>(cur_rank), static_cast<const W*>(new_val),
            static_cast<const int*>(new_rank), static_cast<int*>(out_rank), k,
            (uint32_t)words);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* crdt_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
