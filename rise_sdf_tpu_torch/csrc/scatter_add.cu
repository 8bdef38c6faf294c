// K1: hash-table gradient scatter-add for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pallas_scatter_add`
// (rise_sdf_tpu/ops/scatter_pallas.py:49, pl.pallas_call at :98).  It
// computes the same answer, out[idx[i], c] += vals[i, c] into a zeroed
// [table_size, F] float32 table, but not the TPU's block structure: the
// TPU kernel keeps the whole table resident in VMEM and walks the rows in
// order on one core; here blocks run in parallel on all SMs and the sums
// land in device memory / L2 through float2 vector atomics (RED).
//
// What bounds it: atomics on contended rows, then bytes.  The main path
// sends 16 levels x 8 corners x 1,048,576 samples = 134M rows (~1.6 GB of
// index and value reads) into a 64 MiB table per training step.  Samples
// are compacted ray-major, so consecutive samples are neighbouring points
// on one ray, and on the coarse levels (a level-0 cell holds ~20-37 of
// them) they name the same row; the dead slots of the buffer all name one
// row per level and corner.  Atomics on one address serialise in L2.
//
// Design (F = 2, vals and out 8-byte aligned): the caller's layout is
// entry i = n * P + j (the encode's [N, L_open, 8] rows, P = 8 * L_open),
// so a fixed column j across consecutive n is one (level, corner) along a
// ray.  A walk takes column j over kWalk consecutive rows n; each thread
// adds the values of each run of equal rows in registers and issues one
// float2 RED per run.  Equal rows that are not adjacent issue their own
// RED, which is still right; runs are cut at the walk's edge.
//
// Reads: consecutive threads take consecutive walks, so at each step the
// lanes of a warp read neighbouring columns of one row of the layout: at
// P = 128 a 128-byte idx access and a 256-byte vals access, whole
// sectors for every P >= 8, read straight from global memory.  Each
// thread issues kBatch steps' loads before it compares any, and idx and
// vals stream through L2 at evict-first priority (ld.cs), leaving L2 to
// the table the atomics land in.  P = 1 (no layout) walks 32-entry rows,
// so that its reads are whole sectors too.  The entries past the last
// whole row of the layout (P not dividing M) are added one by one.
//
// One wave of blocks takes the walks in grid-stride order, so at any
// moment the card works on one contiguous window of the entries: on a
// level-major stream its atomics stay among one level's rows, which L2
// holds.
//
// A negative index is an absent row (a row that another shard of a
// row-sharded table owns, XLA's drop mode): its values are dropped.  A
// run ends at an absent row and none starts there: the walk carries an
// absent row's values in its registers like a run's, and issues no RED
// for them.
//
// All levels go in one launch: the caller offsets level l's rows by
// l * T, and L * T (16 x 2^19 = 8.4M) fits int32.  Sums are taken in
// atomic order, which changes from run to run (not bit-reproducible).
// F != 2 or misaligned vals take a plain grid-stride loop with one scalar
// atomic per value.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>

namespace {

// One thread per row (grid-stride): read its index once, then add its F
// values; no integer division on the hot path.
__global__ void scatter_add_kernel(const int* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out,
                                   long long m,
                                   int f,
                                   long long table_size) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < m; i += stride) {
    const long long row = __ldg(idx + i);
    assert(row < table_size);
    if (row < 0) continue;  // absent
    for (int c = 0; c < f; ++c) {
      atomicAdd(out + row * f + c, __ldg(vals + i * f + c));
    }
  }
}

constexpr int kThreads = 128;
constexpr int kWalk = 32;   // rows per walk
constexpr int kBatch = 8;   // steps whose loads are in flight at once
constexpr int kNoLayout = 32;  // the row width P = 1 is walked as

// the run's sum into its row; nothing for an absent row (row < 0)
__device__ __forceinline__ void red(float2* out, int row, float2 v) {
  if (row >= 0) atomicAdd(out + row, v);  // result unused: a RED
}

// F = 2: walk w takes rows [g * kWalk, g * kWalk + kWalk) of column j,
// g = w / period, j = w % period, of the `rows` whole rows; the entries
// from rows * period on are added one by one.
__global__ void __launch_bounds__(kThreads)
    scatter_add_f2_walk_kernel(const int* __restrict__ idx,
                               const float2* __restrict__ vals,
                               float2* __restrict__ out, long long m,
                               int period, long long rows, int table_size) {
  const long long walks = (rows + kWalk - 1) / kWalk * period;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
       w < walks; w += stride) {
    const long long g = w / period;
    const long long n0 = g * kWalk;
    const int steps = (int)(rows - n0 < kWalk ? rows - n0 : kWalk);
    const long long e0 = n0 * period + (w - g * period);
    const int* ip = idx + e0;
    const float2* vp = vals + e0;
    int cur = __ldcs(ip);
    float2 acc = __ldcs(vp);
    assert(cur < table_size);
    for (int s = 1; s < steps; s += kBatch) {
      int r[kBatch];
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s + u < steps) {
          r[u] = __ldcs(ip + (long long)(s + u) * period);
          v[u] = __ldcs(vp + (long long)(s + u) * period);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s + u < steps) {
          assert(r[u] < table_size);
          if (r[u] == cur) {
            acc.x += v[u].x;
            acc.y += v[u].y;
          } else {
            red(out, cur, acc);
            cur = r[u];
            acc = v[u];
          }
        }
      }
    }
    red(out, cur, acc);
  }
  for (long long i = rows * period + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < m; i += stride) {
    const int row = idx[i];
    assert(row < table_size);
    red(out, row, vals[i]);
  }
}

}  // namespace

extern "C" int rise_scatter_add_f32(const void* idx, const void* vals,
                                    void* out, long long m, int f,
                                    long long table_size, long long period,
                                    void* stream) {
  if (m <= 0 || f <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (f != 2 || table_size > 0x7fffffffLL || period < 1 ||
      period > 0x7fffffffLL || ((unsigned long long)vals % 8 != 0) ||
      ((unsigned long long)out % 8 != 0)) {
    const int threads = 256;
    long long blocks = (m + threads - 1) / threads;
    // the grid-stride loop covers the rest; 64K blocks keep every SM busy
    if (blocks > 65536) blocks = 65536;
    scatter_add_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        (const int*)idx, (const float*)vals, (float*)out, m, f, table_size);
    return (int)cudaGetLastError();
  }
  if (period == 1) period = kNoLayout;
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, scatter_add_f2_walk_kernel, kThreads, 0)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long rows = m / period;
  const long long work = (rows + kWalk - 1) / kWalk * period + m % period;
  long long blocks = (long long)sms * per_sm;
  if (blocks > (work + kThreads - 1) / kThreads)
    blocks = (work + kThreads - 1) / kThreads;
  scatter_add_f2_walk_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const int*)idx, (const float2*)vals, (float2*)out, m, (int)period,
      rows, (int)table_size);
  return (int)cudaGetLastError();
}

extern "C" const char* rise_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
