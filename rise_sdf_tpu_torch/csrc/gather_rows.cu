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
//   * a multiple of 16 bytes: one thread per 16-byte vector, neighbouring
//     threads on neighbouring output vectors so the stores coalesce; table
//     and out must be 16-byte aligned.
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

// rows of q 16-byte vectors: one thread per output vector
template <typename I>
__global__ void gather_rows16_kernel(const int* __restrict__ idx,
                                     const uint4* __restrict__ table,
                                     uint4* __restrict__ out, I total, I q,
                                     int n_rows) {
  const I stride = (I)gridDim.x * blockDim.x;
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i = next(i, stride, total)) {
    const I r = i / q;
    const int row = __ldg(idx + r);
    assert(row < n_rows);
    out[i] = row_or_zero(table,
                         row < 0 ? -1LL : (long long)row * q + (i - r * q));
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
    const unsigned blocks = blocks_for(total);
    if (total <= kU32) {
      gather_rows16_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
          (const int*)idx, (const uint4*)table, (uint4*)out,
          (unsigned)total, (unsigned)q, rows);
    } else {
      gather_rows16_kernel<long long><<<blocks, kThreads, 0, s>>>(
          (const int*)idx, (const uint4*)table, (uint4*)out, total, q, rows);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rise_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
