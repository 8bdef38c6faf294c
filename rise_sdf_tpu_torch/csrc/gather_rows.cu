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
//   * 8 bytes: each thread takes 4 rows, reads their 4 indices with one
//     16-byte load, issues the 4 row loads back to back and writes the 4
//     rows as two 16-byte stores, so a warp reads and writes 1 KB of
//     contiguous output; idx and out must be 16-byte aligned;
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
// wrapper takes float32 and float64.  A device-side assert checks every
// index against the table's row count, as K1 does.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// the next grid-stride position, or `end` where that would pass it
template <typename I>
__device__ __forceinline__ I next(I i, I stride, I end) {
  return end - i > stride ? i + stride : end;
}

// 8-byte rows, 4 per thread: one 16-byte index load, 4 independent row
// loads, two 16-byte stores.  The last m % 4 rows are done one by one.
template <typename I>
__global__ void gather_rows8_x4_kernel(const int* __restrict__ idx,
                                       const uint2* __restrict__ table,
                                       uint2* __restrict__ out, I m,
                                       int n_rows) {
  const I quads = m / 4;
  const I stride = (I)gridDim.x * blockDim.x;
  for (I t = (I)blockIdx.x * blockDim.x + threadIdx.x; t < quads;
       t = next(t, stride, quads)) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(idx) + t);
    assert(r.x >= 0 && r.x < n_rows && r.y >= 0 && r.y < n_rows);
    assert(r.z >= 0 && r.z < n_rows && r.w >= 0 && r.w < n_rows);
    const uint2 a = __ldg(table + r.x);
    const uint2 b = __ldg(table + r.y);
    const uint2 c = __ldg(table + r.z);
    const uint2 d = __ldg(table + r.w);
    uint4* o = reinterpret_cast<uint4*>(out) + 2 * t;
    o[0] = make_uint4(a.x, a.y, b.x, b.y);
    o[1] = make_uint4(c.x, c.y, d.x, d.y);
  }
  if (blockIdx.x == 0 && threadIdx.x < m - quads * 4) {
    const I i = quads * 4 + threadIdx.x;
    const int row = __ldg(idx + i);
    assert(row >= 0 && row < n_rows);
    out[i] = __ldg(table + row);
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
    assert(row >= 0 && row < n_rows);
    out[i] = __ldg(table + (long long)row * q + (i - r * q));
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
    const unsigned blocks = blocks_for(m / 4);
    if (m <= kU32) {
      gather_rows8_x4_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
          (const int*)idx, (const uint2*)table, (uint2*)out, (unsigned)m,
          rows);
    } else {
      gather_rows8_x4_kernel<long long><<<blocks, kThreads, 0, s>>>(
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
