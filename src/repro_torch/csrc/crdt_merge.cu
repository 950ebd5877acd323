// Versioned CRDT merge (row-wise last-writer-wins join) for Hopper, sm_90a.
//
//   out_val[i] = ver_a[i] >= ver_b[i] ? val_a[i] : val_b[i]   (rows of N elements)
//   out_ver[i] = max(ver_a[i], ver_b[i])
//
// and the same join straight into a table's rows, in place, in two forms:
//
//   crdt_merge_rows: int32 ranks compared, the table's versions kept apart
//     table[rows[i]] = new_val[i]   where new_rank[i] > cur_rank[i]
//     out_rank[i]    = max(cur_rank[i], new_rank[i])
//   crdt_join_rows: the table's own columns, versions (epoch, seq, node) int64
//     take[i] = !present[rows[i]] || new_ver[i] > ver[rows[i]]  (lexicographic)
//     where take[i]: value, version, length of rows[i] <- the batch's; present = 1
//     took[i] = take[i]
//
// Replaces the TPU kernel src/repro/kernels/crdt_merge/crdt_merge.py:24
// (_merge_kernel, launched by crdt_merge_pallas).  The Pallas kernel reads
// both (bm, bn) payload tiles and selects between them; the function needs
// only the winner's row, so here each row's two versions are read first and
// then only the winning row's payload: a third fewer bytes.  The indexed
// joins are the same function with side a gathered from the table's rows
// and scattered back; done in place they move only the rows the batch
// takes.  crdt_join_rows compares the full triple, so a table's join is one
// launch: no dense ranks of the versions first, no writes of the version,
// length and presence columns after.  A tie keeps the table's row, as the
// TPU kernel keeps side a; an absent row takes any version, as the store's
// apply stores into an absent key whatever its version.
//
// Design:
//   * every kernel moves bits only, so one body templated on the word it
//     moves covers f32, bf16 and int32 payloads.  The launcher picks the
//     widest word (16, 8, 4 or 2 bytes) that divides a row's bytes and the
//     alignment of every payload pointer: a YCSB row of 250 int32 (1,000
//     bytes) starts on an 8-byte boundary only, and a 16-byte word would
//     straddle two rows with different winners.  The tables are contiguous,
//     so a row's bytes are also their row stride;
//   * the dense kernel gives a warp a group of `group` rows: lane i reads
//     both versions of row i (coalesced), writes its out_ver, and a ballot
//     gives the warp the winners as a bit mask; one copy loop (copy_span)
//     then has lane l copy words l, l + 32, ... of the group's span of whole
//     rows, each from its row's winner, 8 loads in flight per lane before
//     the stores.  The launcher takes 32 rows a warp wherever that still
//     makes kMinBlocksPerSm blocks an SM, and halves the group below that,
//     down to one row a warp: at 3,400 rows, groups of 32 made 14 blocks,
//     and 14 of the 132 SMs held the whole batch's loads in flight (~219 KB;
//     the card needs ~2 MB to cover its latency);
//   * both indexed joins share one body (join_rows), templated on the
//     version rule.  A row's bytes get a group of lanes sized to the row:
//     the fewest of 4, 8, 16 or 32 lanes that hold its words in one or two
//     passes (TPC-C's 120-byte row is 15 8-byte words: 8 lanes, 4 rows a
//     warp; YCSB's 1,000 bytes are 125: the whole warp).  Each lane group
//     walks R rows (1, 2 or 4), so a warp takes (32 / lanes) * R rows at
//     once: lane l loads the index of row l and the batch's side of its
//     versions (coalesced across the warp) while each group loads the first
//     payload words of its rows, all before any returns; lane l then loads
//     the table's side (the join's triple, length and presence), decides row l
//     and writes its small columns; a ballot and shuffles hand each group
//     its rows' indices and outcomes, and it stores the taken rows' words.
//     So the chain of dependent device-memory round trips is paid once a
//     warp, not once a row: the index, then (the join only) the table's
//     versions, then the stores.  A row the table keeps stores nothing; its
//     payload was loaded on speculation (the commit takes nearly all its
//     rows).  The launcher takes the smallest R whose grid fits one wave of
//     resident blocks (34,000 rows of 15 words: 1,063 blocks at R = 1, 532
//     at R = 2, 266 at R = 4); past R = 4 the warps stride over the rest.
//     An index outside [0, R) traps: the kernel writes nothing outside the
//     table.  Rows must be distinct (two lane groups writing one row race);
//     a present row's presence byte is not stored again;
//   * 64-bit offsets throughout (M * N and rows[i] * N pass 2^31 at 10^7
//     rows of 250 words).
//   Inputs are contiguous; payload, versions, lengths, presence and indices
//   of the types below; the wrapper checks that.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The dense kernel reads the
// winner's payload and both version vectors, and writes the payload and
// out_ver: at (10^7, 250) int32, 20.12 GB, 6.006 ms.  A kernel that reads
// both payloads moves 30.12 GB and cannot pass 66.8% of that bound.
// crdt_join_rows reads each row's index, both triples, the batch's length
// and the presence byte, and writes took (66 bytes a row); a taken row also
// reads and writes its payload and writes its triple, length and presence
// (33 bytes more): at 34,000 rows of 120 bytes, all taken, 11.53 MB, 3.44
// us; at 3,400 rows of 1,000 bytes, 7.14 MB, 2.13 us.  The join touches
// four columns of a table's row at random (payload, triple, length,
// presence), each in sectors of its own: on the card it took 16-20 us at
// TPC-C's commit against the ranked join's 10-12 us on the same body, whose
// only column touched at random is the payload; the triple's and length's
// stores and the payload take most of it (tools/crdt_join_rows_parts.py).

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

// The ranked join's rule: int32 ranks of both sides, compared as the TPU
// kernel compares versions; out_rank written for every row.
struct RankVersions {
  const int* cur_rank;
  const int* new_rank;
  int* out_rank;

  struct Batch {
    int cur, nw;
  };

  // the loads that need no row index
  __device__ __forceinline__ Batch batch(int64_t i) const { return {cur_rank[i], new_rank[i]}; }

  __device__ __forceinline__ bool decide(int64_t i, int64_t, const Batch& b) const {
    out_rank[i] = b.nw > b.cur ? b.nw : b.cur;
    return b.nw > b.cur;
  }
};

// The table's join: the batch's (epoch, seq, node) triple against the row's,
// lexicographic in int64, an absent row taking any version; a taken row's
// triple, length and presence written here, took[i] for every row.
struct TripleVersions {
  int64_t* table_ver;        // (R, 3)
  int64_t* table_len;        // (R,)
  uint8_t* table_present;    // (R,) bool
  const int64_t* new_ver;    // (K, 3)
  const int64_t* new_len;    // (K,)
  uint8_t* took;             // (K,) bool

  struct Batch {
    int64_t n0, n1, n2, len;
  };

  __device__ __forceinline__ Batch batch(int64_t i) const {
    return {new_ver[3 * i], new_ver[3 * i + 1], new_ver[3 * i + 2], new_len[i]};
  }

  __device__ __forceinline__ bool decide(int64_t i, int64_t row, const Batch& b) const {
    int64_t* tv = table_ver + 3 * row;
    const int64_t c0 = tv[0], c1 = tv[1], c2 = tv[2];
    // read with the triple, so that the length's store finds its sector in
    // the L2 (a store into a sector not there cost the join 2.2 of 18.7 us
    // at TPC-C's commit, tools/crdt_join_rows_parts.py)
    const int64_t cur_len = table_len[row];
    const bool greater = b.n0 != c0 ? b.n0 > c0 : (b.n1 != c1 ? b.n1 > c1 : b.n2 > c2);
    const bool absent = table_present[row] == 0, take = absent || greater;
    if (take) {
      tv[0] = b.n0;
      tv[1] = b.n1;
      tv[2] = b.n2;
      if (cur_len != b.len) table_len[row] = b.len;
      if (absent) table_present[row] = 1;   // a present row's byte is not stored again
    }
    took[i] = take;
    return take;
  }
};

// Loads (or stores) words c0, c0 + lanes, ... (kPasses of them) of the R
// rows of a lane group where `on[r]`.
template <typename W, int R, int kPasses>
__device__ __forceinline__ void load_chunk(W (&buf)[kPasses][R], const W* __restrict__ src,
                                           const bool (&on)[R], uint32_t c0, uint32_t lanes,
                                           uint32_t words) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t c = c0 + p * lanes;
      if (on[r] && c < words) buf[p][r] = src[(int64_t)r * words + c];
    }
  }
}

template <typename W, int R, int kPasses>
__device__ __forceinline__ void store_chunk(W* __restrict__ table, const W (&buf)[kPasses][R],
                                            const int64_t (&dst)[R], const bool (&on)[R],
                                            uint32_t c0, uint32_t lanes, uint32_t words) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t c = c0 + p * lanes;
      if (on[r] && c < words) table[dst[r] + c] = buf[p][r];
    }
  }
}

// k rows of `words` words joined into `table` in place by Versions' rule.
// A warp takes (32 >> log2) * R rows a window: lane l loads row l's index
// and the batch's side of its versions, and lane group g (1 << log2 lanes)
// loads the first kPasses words a lane of the window's rows g * R .. g * R
// + R - 1, all before any of them returns (a row the table then keeps wastes
// its load, and moves nothing); lane l then reads the table's side, decides
// row l and writes its small columns; a ballot and shuffles give group g its
// rows' outcomes and indices, and it stores the words of the rows taken (a
// row wider than lanes * kPasses words loads the rest after the decision).
template <typename W, int R, typename Versions>
__device__ __forceinline__ void join_rows(W* __restrict__ table, int64_t n_rows,
                                          const int64_t* __restrict__ rows,
                                          const W* __restrict__ new_val, int64_t k,
                                          uint32_t words, uint32_t log2, const Versions& ver) {
  constexpr int kPasses = kWordsPerLane / R;   // a lane's words of a row buffered at once
  const uint32_t lane = threadIdx.x & 31, lanes = 1u << log2;
  const uint32_t g = lane >> log2, sub = lane & (lanes - 1);
  const uint32_t per_warp = (32u >> log2) * R;
  const int64_t windows = (k + per_warp - 1) / per_warp;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t w = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); w < windows; w += warps) {
    const int64_t i0 = w * per_warp, i = i0 + lane;
    const bool decides = lane < per_warp && i < k;
    long long row = 0;
    typename Versions::Batch b{};
    if (decides) {
      row = rows[i];
      b = ver.batch(i);
    }
    const W* src = new_val + (i0 + g * R) * words;
    bool exists[R];
#pragma unroll
    for (int r = 0; r < R; ++r) exists[r] = i0 + g * R + r < k;
    W buf[kPasses][R];
    load_chunk(buf, src, exists, sub, lanes, words);
    bool take = false;
    if (decides) {
      if (row < 0 || row >= n_rows) __trap();
      take = ver.decide(i, row, b);
    }
    const unsigned taken = __ballot_sync(0xffffffffu, take);
    if (words == 0 || taken == 0) continue;
    int64_t dst[R];
    bool mine[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t src_lane = g * R + r;
      dst[r] = (int64_t)__shfl_sync(0xffffffffu, row, src_lane) * words;
      mine[r] = (taken >> src_lane) & 1u;
    }
    store_chunk(table, buf, dst, mine, sub, lanes, words);
    for (uint32_t c0 = sub + lanes * kPasses; c0 < words; c0 += lanes * kPasses) {
      load_chunk(buf, src, mine, c0, lanes, words);
      store_chunk(table, buf, dst, mine, c0, lanes, words);
    }
  }
}

template <typename W, int R>
__global__ void __launch_bounds__(kThreads) crdt_merge_rows_kernel(
    W* __restrict__ table, int64_t n_rows, const int64_t* __restrict__ rows,
    const W* __restrict__ new_val, int64_t k, uint32_t words, RankVersions ver, uint32_t log2) {
  join_rows<W, R>(table, n_rows, rows, new_val, k, words, log2, ver);
}

template <typename W, int R>
__global__ void __launch_bounds__(kThreads) crdt_join_rows_kernel(
    W* __restrict__ table, int64_t n_rows, const int64_t* __restrict__ rows,
    const W* __restrict__ new_val, int64_t k, uint32_t words, TripleVersions ver,
    uint32_t log2) {
  join_rows<W, R>(table, n_rows, rows, new_val, k, words, log2, ver);
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

// Launches one of kernels[j] (R = 1, 2, 4 rows a lane group) over k rows of
// `words` words: lanes a row the fewest of 4, 8, 16, 32 that hold the words
// in two passes, R the smallest whose grid fits one wave of resident blocks
// (R = 4 past that, its warps striding over the rest).  The blocks an SM
// holds of each kernel are asked once.
template <typename Kernel, typename... Args>
int launch_rows(const Kernel (&kernels)[3], int64_t k, uint32_t words, cudaStream_t stream,
                Args... args) {
  static int per_sm[3] = {0, 0, 0};
  uint32_t log2 = 2;
  while (log2 < 5 && (2u << log2) < words) ++log2;
  const int64_t sms = sm_count();
  for (int j = 0; j < 3; ++j) {
    if (per_sm[j] == 0) {
      int n = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernels[j], kThreads, 0);
      per_sm[j] = n > 0 ? n : 1;
    }
    const int64_t per_block = (int64_t)kWarps * (32 >> log2) << j;
    const int64_t blocks = (k + per_block - 1) / per_block, wave = per_sm[j] * sms;
    if (blocks <= wave || j == 2) {
      kernels[j]<<<(unsigned)(blocks < wave ? blocks : wave), kThreads, 0, stream>>>(args...,
                                                                                    log2);
      return static_cast<int>(cudaGetLastError());
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (k < 1 || n < 0 || n_rows < 0 || (elem_size != 2 && elem_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = n * elem_size;
  return widest(row_bytes, addr(table) | addr(new_val), [&](auto w) {
    using W = decltype(w);
    const int64_t words = row_bytes / (int64_t)sizeof(W);
    if (words >= (int64_t)1 << 26) return static_cast<int>(cudaErrorInvalidValue);
    decltype(&crdt_merge_rows_kernel<W, 1>) kernels[3] = {
        crdt_merge_rows_kernel<W, 1>, crdt_merge_rows_kernel<W, 2>,
        crdt_merge_rows_kernel<W, 4>};
    const RankVersions ver{static_cast<const int*>(cur_rank), static_cast<const int*>(new_rank),
                           static_cast<int*>(out_rank)};
    return launch_rows(kernels, k, (uint32_t)words, static_cast<cudaStream_t>(stream),
                       static_cast<W*>(table), (int64_t)n_rows, static_cast<const int64_t*>(rows),
                       static_cast<const W*>(new_val), (int64_t)k, (uint32_t)words, ver);
  });
}

// table: (n_rows, n) payload of elem_size (2 or 4) bytes, contiguous, and its
// columns table_ver (n_rows, 3) int64, table_len (n_rows,) int64,
// table_present (n_rows,) bool, all joined in place; rows: (k,) int64,
// distinct, each in [0, n_rows); new_val: (k, n) of the table's element
// size; new_ver (k, 3) int64; new_len (k,) int64; took: (k,) bool, written.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for k < 1, a negative n or n_rows, another element
// size or payload pointers off their elements' alignment.
int crdt_join_rows_forward(void* table, void* table_ver, void* table_len, void* table_present,
                           long long n_rows, const void* rows, const void* new_val,
                           const void* new_ver, const void* new_len, void* took, long long k,
                           long long n, int elem_size, void* stream) {
  if (k < 1 || n < 0 || n_rows < 0 || (elem_size != 2 && elem_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t row_bytes = n * elem_size;
  return widest(row_bytes, addr(table) | addr(new_val), [&](auto w) {
    using W = decltype(w);
    const int64_t words = row_bytes / (int64_t)sizeof(W);
    if (words >= (int64_t)1 << 26) return static_cast<int>(cudaErrorInvalidValue);
    decltype(&crdt_join_rows_kernel<W, 1>) kernels[3] = {
        crdt_join_rows_kernel<W, 1>, crdt_join_rows_kernel<W, 2>, crdt_join_rows_kernel<W, 4>};
    const TripleVersions ver{static_cast<int64_t*>(table_ver), static_cast<int64_t*>(table_len),
                             static_cast<uint8_t*>(table_present),
                             static_cast<const int64_t*>(new_ver),
                             static_cast<const int64_t*>(new_len), static_cast<uint8_t*>(took)};
    return launch_rows(kernels, k, (uint32_t)words, static_cast<cudaStream_t>(stream),
                       static_cast<W*>(table), (int64_t)n_rows, static_cast<const int64_t*>(rows),
                       static_cast<const W*>(new_val), (int64_t)k, (uint32_t)words, ver);
  });
}

const char* crdt_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
