// G1: row gather out[i, :] = table[idx[i], :] for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels that compute table[idx] from a float32
// table:
//   S2 pallas_row_gather  (scripts/pallas_gather_bench.py:79, pallas_call :111)
//   S3 pallas_take_gather (scripts/pallas_gather_bench.py:128, pallas_call :147)
//   S4 pallas_dma_gather  (scripts/r5_gather_width_bench.py:52, pallas_call :98)
// S2 and S3 keep the whole [2^19, 2] table resident in VMEM and pick rows
// out of 128-lane packed vectors; S4 streams each row with its own
// HBM->VMEM DMA.  None of that carries over: on Hopper the table stays in
// device memory (L2 holds the hot part), every thread reads rows with
// vector loads and writes them with vector stores.
//
// What bounds it: bytes.  Each output row is written once and each index
// read once; the table rows are read at random, so a row narrower than a
// 32-byte sector wastes part of each sector it touches.  The hash encode
// gathers 8-byte rows (float32 W = 2), the baked-SDF sample 32-byte rows
// (float32 W = 8).  The design keeps many independent loads in flight and
// the accesses as wide as the row allows.  Two row sizes are taken:
//   * 8 bytes: a block takes a tile of 8 * 256 rows; each lane takes 4
//     slots of 2 rows, 32 slots apart: four 8-byte index loads, 8
//     independent row loads, four 16-byte stores, every access of a
//     warp on contiguous bytes.  The index and the output stream
//     through L2 at evict-first priority (ld/st .cs), so the table rows
//     (64 MiB on the main path, 50 MB of L2) are not pushed out by 1.6
//     GB of streamed index and output as fast.
//     In the encode's layout ([N, L, 8] rows, corners cx-major) lanes l
//     and l + 2 hold corners c and c + 4 of one (sample, level), the two
//     x-neighbours, in the same load instruction: the coalescer merges
//     them where they share a sector (adjacent rows on dense levels,
//     about 3/4 of the time on hashed levels, whose x prime is 1).  idx
//     and out must be 16-byte aligned; the rows past the last whole tile
//     are done one by one;
//   * a multiple of 16 bytes (q 16-byte vectors a row; the baked-SDF
//     sample's 32-byte rows are q = 2, S4's w = 32 q = 8, float64 W = 2
//     q = 1): bytes bound it too, and at these widths the output is most
//     of them.  S4 at w = 32 writes 537 MB and reads as many bytes of
//     rows, at random, from a 67 MB table: the bound counts each row
//     once, but L2 cannot hold the table, so many reads go to DRAM (on
//     the H100 the gather takes less time than a copy of its output's
//     bytes, and 56 % of its bound's).  A warp takes a tile of 32 * K
//     output vectors (K = 2; K = 1 for rows of one vector), 32 * K / q
//     whole rows: lane l loads the index of row l of the tile, each
//     index once per row, and a vector takes its row's index from the
//     lane holding it by __shfl_sync, with shifts for q = 1, 2, 4, 8 (no
//     division); each lane issues its index load, then its K table
//     loads, then its K stores, each store a warp-wide 512 contiguous
//     bytes.  More vectors a lane (4, 8, 16 were timed) were no faster:
//     the bytes, not the loads in flight, hold it back.  The index and
//     output stream through L2 evict-first, as on the 8-byte path, so
//     the bake's 68.7 MB table keeps what L2 it can.  Any other q runs
//     the same tiles with a division and an index load per vector.
//     table and out must be 16-byte aligned.
// Anything else is refused (cudaErrorInvalidValue).
//
// Loop counters are 32-bit (unsigned) when the work fits, else 64-bit.  A
// grid-stride step never takes a counter past the work's end (next()), so
// a counter cannot wrap whatever the grid's stride.
//
// The copy moves bits, not floats (uint2 / uint4 vectors), so the result
// is bit-equal to index_select for any 4- or 8-byte element type; the
// wrapper takes float32 and float64.  A negative index is an absent row
// (a row that another shard of a row-sharded table owns): its output row
// is zeros and no table row is read.  A device-side assert checks every
// other index against the table's row count, as K1 does.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// the 16-byte path: output vectors per lane of a warp tile, by log2 q
// (one for rows of one vector, two else: what timed fastest on the H100)
template <int LOG2Q>
constexpr int kVecsPerLane = LOG2Q == 0 ? 1 : 2;

__device__ __forceinline__ uint2 zero_of(uint2) { return make_uint2(0u, 0u); }
__device__ __forceinline__ uint4 zero_of(uint4) {
  return make_uint4(0u, 0u, 0u, 0u);
}

// vector `r` of the table, or zeros for an absent row (r < 0)
template <typename V>
__device__ __forceinline__ V row_or_zero(const V* __restrict__ table,
                                         long long r) {
  return r >= 0 ? __ldg(table + r) : zero_of(V());
}

// the next grid-stride position, or `end` where that would pass it
template <typename I>
__device__ __forceinline__ I next(I i, I stride, I end) {
  return end - i > stride ? i + stride : end;
}

// 8-byte rows in tiles of 8 * kThreads, one tile per block (grid-stride
// past 2^20 blocks).  Warp w of a block owns rows [256 w, 256 w + 256)
// of the tile as 128 slots of 2 rows; lane l takes slots l, l + 32,
// l + 64 and l + 96: four 8-byte index loads, 8 row loads, four 16-byte
// stores, each a warp-wide access of 256 or 512 contiguous bytes (whole
// sectors, so the evict-first stores never leave half-written sectors in
// L2).  The rows past the last whole tile are done one by one by block 0.
template <typename I>
__global__ void __launch_bounds__(kThreads)
    gather_rows8_kernel(const int* __restrict__ idx,
                        const uint2* __restrict__ table,
                        uint2* __restrict__ out, I m, int n_rows) {
  const int2* idx2 = reinterpret_cast<const int2*>(idx);
  uint4* out4 = reinterpret_cast<uint4*>(out);
  const I tiles = m / (8 * kThreads);
  const unsigned lane_slot = threadIdx.x / 32 * 128 + threadIdx.x % 32;
  for (I tile = blockIdx.x; tile < tiles;
       tile = next(tile, (I)gridDim.x, tiles)) {
    const I slot = tile * (4 * kThreads) + lane_slot;
    int2 a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = __ldcs(idx2 + slot + 32 * k);
    uint2 r[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      assert(a[k].x < n_rows && a[k].y < n_rows);
      r[2 * k] = row_or_zero(table, a[k].x);
      r[2 * k + 1] = row_or_zero(table, a[k].y);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      __stcs(out4 + slot + 32 * k, make_uint4(r[2 * k].x, r[2 * k].y,
                                              r[2 * k + 1].x, r[2 * k + 1].y));
  }
  if (blockIdx.x == 0) {
    for (I i = tiles * (8 * kThreads) + threadIdx.x; i < m;
         i = next(i, (I)kThreads, m)) {
      const int row = __ldcs(idx + i);
      assert(row < n_rows);
      __stcs(out + i, row_or_zero(table, row));
    }
  }
}

// Rows of q 16-byte vectors, as warp tiles of 32 * K output vectors:
// vector t of a tile goes to lane t % 32, slot t / 32, so each of the K
// stores of a warp is 512 contiguous bytes.  With q = 2^LOG2Q (q <= 8) a
// tile is 32 * K / q whole rows: lane l loads the index of row l of the
// tile (one coalesced evict-first load), and each vector takes its
// row's index from the lane that holds it (__shfl_sync), so an index is
// read once per row and nothing is divided.  LOG2Q < 0 takes any q: the
// row of each vector by a division, its index read by each of its
// vectors.  A lane issues its index loads, then checks them, then
// issues its K table loads before its K stores.  The tile past the last
// whole one is masked per index and per vector.
template <typename I, int LOG2Q>
__global__ void __launch_bounds__(kThreads)
    gather_rows16_kernel(const int* __restrict__ idx,
                         const uint4* __restrict__ table,
                         uint4* __restrict__ out, I total, I q, int n_rows) {
  constexpr int K = kVecsPerLane<LOG2Q>, kTile = 32 * K;
  const unsigned lane = threadIdx.x % 32;
  const I warps = (I)gridDim.x * (kThreads / 32);
  const I tiles = (total + (kTile - 1)) / kTile;
  for (I tile = (I)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       tile < tiles; tile = next(tile, warps, tiles)) {
    const I base = tile * kTile;
    const bool whole = total - base >= (I)kTile;
    long long src[K];  // table vector of each slot, or -1
    if constexpr (LOG2Q >= 0) {
      constexpr int kRows = kTile >> LOG2Q;  // 32, 32, 16 or 8
      const I r = (base >> LOG2Q) + lane;
      int a = (whole || r < (total >> LOG2Q)) && lane < kRows
                  ? __ldcs(idx + r)
                  : -1;
      assert(a < n_rows);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned t = k * 32 + lane;
        const int row = LOG2Q == 0 ? a
                                   : __shfl_sync(0xffffffffu, a, t >> LOG2Q);
        src[k] = row < 0 ? -1LL
                         : ((long long)row << LOG2Q) + (t % (1 << LOG2Q));
      }
    } else {
      int row[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const I i = base + k * 32 + lane;
        row[k] = whole || i < total ? __ldg(idx + i / q) : -1;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        assert(row[k] < n_rows);
        const I i = base + k * 32 + lane;
        src[k] = row[k] < 0 ? -1LL : (long long)row[k] * q + i % q;
      }
    }
    uint4 v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = row_or_zero(table, src[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const I i = base + k * 32 + lane;
      if (whole || i < total) __stcs(out + i, v[k]);
    }
  }
}

// blocks for `work` items, one per thread; the grid-stride loops cover
// the rest past 2^20 blocks
unsigned blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  if (b > (1 << 20)) b = 1 << 20;
  return (unsigned)(b > 0 ? b : 1);
}

constexpr long long kU32 = 0xffffffffLL;

// one warp tile per warp; q = 1, 2, 4, 8 by shifts, any other q by the
// general case
template <typename I, int LOG2Q>
void launch_rows16(const int* idx, const uint4* table, uint4* out, I total,
                   I q, int n_rows, cudaStream_t s) {
  constexpr long long kTile = 32 * kVecsPerLane<LOG2Q>;
  const unsigned blocks = blocks_for((total + kTile - 1) / kTile * 32);
  gather_rows16_kernel<I, LOG2Q>
      <<<blocks, kThreads, 0, s>>>(idx, table, out, total, q, n_rows);
}

template <typename I>
void launch_rows16(const int* idx, const uint4* table, uint4* out, I total,
                   I q, int n_rows, cudaStream_t s) {
  if (q == 1) launch_rows16<I, 0>(idx, table, out, total, q, n_rows, s);
  else if (q == 2) launch_rows16<I, 1>(idx, table, out, total, q, n_rows, s);
  else if (q == 4) launch_rows16<I, 2>(idx, table, out, total, q, n_rows, s);
  else if (q == 8) launch_rows16<I, 3>(idx, table, out, total, q, n_rows, s);
  else launch_rows16<I, -1>(idx, table, out, total, q, n_rows, s);
}

}  // namespace

// idx [m] int32; table [n_rows, row_bytes] bytes; out [m, row_bytes].
extern "C" int rise_gather_rows(const void* idx, const void* table,
                                void* out, long long m, long long row_bytes,
                                long long n_rows, void* stream) {
  if (m <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = (int)n_rows;
  const unsigned long long tab = (unsigned long long)table;
  const unsigned long long o = (unsigned long long)out;
  const unsigned long long ix = (unsigned long long)idx;
  if (row_bytes == 8) {
    if (tab % 8 != 0 || (ix | o) % 16 != 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = blocks_for(m / 8);  // one tile per block
    if (m <= kU32) {
      gather_rows8_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
          (const int*)idx, (const uint2*)table, (uint2*)out, (unsigned)m,
          rows);
    } else {
      gather_rows8_kernel<long long><<<blocks, kThreads, 0, s>>>(
          (const int*)idx, (const uint2*)table, (uint2*)out, m, rows);
    }
  } else if (row_bytes % 16 == 0) {
    if ((tab | o) % 16 != 0) return (int)cudaErrorInvalidValue;
    const long long q = row_bytes / 16;
    const long long total = m * q;
    // 32-bit counters while a tile's last vector (a tile is at most 64
    // vectors) stays below 2^32
    if (total <= kU32 - 64) {
      launch_rows16<unsigned>((const int*)idx, (const uint4*)table,
                              (uint4*)out, (unsigned)total, (unsigned)q, rows,
                              s);
    } else {
      launch_rows16<long long>((const int*)idx, (const uint4*)table,
                               (uint4*)out, total, q, rows, s);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rise_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
