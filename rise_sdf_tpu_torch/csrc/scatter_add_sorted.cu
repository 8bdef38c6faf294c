// K2: deterministic scatter-add for Hopper (sm_90a).
//
// Computes out[idx[i], c] += vals[i, c] into a zeroed [table_size, F]
// table, as K1 does, but bit-reproducibly: every row's sum is taken in an
// order fixed by the input alone, so two launches on the same input give
// the same bits.  It is the counterpart of the JAX package's
// `HashGridEncoding._encode_sorted_vjp` (rise_sdf_tpu/ops/hashgrid.py:448),
// whose table gradient is XLA ops (argsort, cumsum, searchsorted), not a
// Pallas kernel.  JAX differences float32 prefix sums over the whole
// stream, which rounds each row's sum at the magnitude of the running
// total; here each row's entries are added directly, in float64, and
// rounded once.
//
// Input: the caller has sorted the indices stably (`keys` = idx in
// ascending order, `order` = the position in `vals` of each sorted
// entry; torch.sort(stable=True), as JAX's argsort runs outside any
// kernel).  Equal rows are then runs of consecutive entries of `keys`,
// and within a run `order` ascends, so a run's entries are added in the
// order they had in the input.
//
// Design: a segmented sum as a fixed tree.  Level 0 cuts the sorted
// stream into ranges of kRange entries, one thread per range and tile of
// columns (all F up to 4, else one).  The thread loads kBatch entries'
// keys, positions and values at a time, so their loads are in flight
// together, and adds each run of equal keys inside its range in float64,
// in stream order.  A run that starts and ends inside the stream's own run
// boundaries (its neighbours across the range's edges have other keys)
// is a whole row: it is written to `out` at once.  Only the first and
// the last run of a range can continue into a neighbouring range; each
// becomes a piece (key, partial sum) in two fixed slots per range, and
// the pieces form the next level's stream, still sorted, 2 / kRange of
// the length.  The levels repeat until one range holds the stream, where
// every run is whole.  A piece that was written already carries a flag
// in the key's top bit (its value is 0), so nothing is written twice.
// The tree's shape depends on M alone and every addition's operands on
// the input alone: no atomics, no order that depends on scheduling.
//
// What bounds it: bytes.  The function must read idx (4 B) and vals
// (4F B) per entry and write the table (4F B per row).  This route also
// pays for the sort (torch's radix sort of int32 keys with int64
// positions: several passes of 12 B read and written per entry) and
// reads keys (4 B), order (8 B) and vals through `order`, a gather of
// 4F B (a 32-byte sector per entry where rows are scattered), once per
// column tile at level 0; the later levels move 2 / kRange of that.
// Each row is written once.
//
// vals and out are float32 or float64 (the hash tables' gradients, and
// the float64 prefix sums of the eval-style scans whose gathers it
// serves as a backward); sums are float64 in both cases.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>

namespace {

constexpr int kRange = 32;     // entries per thread and level
constexpr int kBatch = 8;      // entries whose loads are in flight at once
constexpr int kThreads = 128;
constexpr int kKeyMask = 0x7fffffff;
constexpr unsigned kDone = 0x80000000u;  // piece already written

// One level.  Entry i of the level's stream has key keys[i] (top bit:
// done) and, in column c, the value vals[row * row_stride + c *
// col_stride] with row = order[i] (level 0) or i.  A thread takes one
// range and FT columns (blockIdx.y * FT on).  next_keys / next_vals
// ([F][n_next], column-major) take the pieces; n_next == 0 marks the
// last level, whose single range holds only whole runs.
template <typename In, typename Out, int FT>
__global__ void __launch_bounds__(kThreads)
    segment_sum_level(const int* __restrict__ keys,
                      const long long* __restrict__ order,
                      const In* __restrict__ vals, long long row_stride,
                      long long col_stride, long long n, int f,
                      Out* __restrict__ out, long long table_size,
                      int* __restrict__ next_keys,
                      double* __restrict__ next_vals, long long n_next) {
  const int c0 = blockIdx.y * FT;
  const long long ranges = (n + kRange - 1) / kRange;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < ranges; r += stride) {
    const long long a = r * kRange;
    const long long b = a + kRange < n ? a + kRange : n;
    // the keys across the range's edges: a run touching an edge is
    // whole when the key there differs
    const int before = a > 0 ? (keys[a - 1] & kKeyMask) : -1;
    const int after = b < n ? (keys[b] & kKeyMask) : -1;
    int cur = -1, cur_raw = 0;
    long long start = a;
    double acc[FT];

    // the run [i, j) of key k: written when whole, else carried to the
    // next level; the range's first and last run fill its two slots
    auto emit = [&](long long i, long long j) {
      const bool whole =
          (i > a || before != cur) && (j < b || after != cur);
      int piece_key = cur;
      if (whole) {
        // a done run's pieces are all done: its row is written already
        if (cur_raw >= 0) {
#pragma unroll
          for (int t = 0; t < FT; ++t)
            out[(long long)cur * f + c0 + t] = (Out)acc[t];
        }
        piece_key = (int)((unsigned)cur | kDone);
      }
      if (n_next > 0 && (i == a || j == b)) {
        if (blockIdx.y == 0) {
          if (i == a) next_keys[2 * r] = piece_key;
          if (j == b) next_keys[2 * r + 1] = piece_key;
        }
#pragma unroll
        for (int t = 0; t < FT; ++t) {
          const double piece = whole ? 0.0 : acc[t];
          double* col = next_vals + (long long)(c0 + t) * n_next + 2 * r;
          if (i == a) col[0] = piece;
          // a range that is one run put its sum in the first slot
          if (j == b) col[1] = i == a ? 0.0 : piece;
        }
      }
    };

    for (long long base = a; base < b; base += kBatch) {
      int kr[kBatch];
      long long row[kBatch];
      In v[kBatch][FT];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u < b) {
          kr[u] = keys[base + u];
          row[u] = order != nullptr ? order[base + u] : base + u;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u < b) {
#pragma unroll
          for (int t = 0; t < FT; ++t)
            v[u][t] = vals[row[u] * row_stride + (c0 + t) * col_stride];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u < b) {
          const int k = kr[u] & kKeyMask;
          // level 0 holds the caller's indices, none flagged
          assert((order == nullptr || kr[u] >= 0) && k < table_size);
          if (base + u == a) {
            cur = k;
            cur_raw = kr[u];
#pragma unroll
            for (int t = 0; t < FT; ++t) acc[t] = (double)v[u][t];
          } else if (k == cur) {
#pragma unroll
            for (int t = 0; t < FT; ++t) acc[t] += (double)v[u][t];
          } else {
            emit(start, base + u);
            start = base + u;
            cur = k;
            cur_raw = kr[u];
#pragma unroll
            for (int t = 0; t < FT; ++t) acc[t] = (double)v[u][t];
          }
        }
      }
    }
    emit(start, b);
  }
}

long long next_length(long long n) {
  const long long ranges = (n + kRange - 1) / kRange;
  return ranges > 1 ? 2 * ranges : 0;
}

template <typename In, typename Out, int FT>
cudaError_t launch_ft(const int* keys, const long long* order,
                      const In* vals, long long row_stride,
                      long long col_stride, long long n, int f, Out* out,
                      long long table_size, int* next_keys,
                      double* next_vals, long long n_next, cudaStream_t s) {
  long long blocks = ((n + kRange - 1) / kRange + kThreads - 1) / kThreads;
  if (blocks > 65536) blocks = 65536;  // the grid-stride loop covers the rest
  dim3 grid((unsigned)blocks, (unsigned)(f / FT));
  segment_sum_level<In, Out, FT><<<grid, kThreads, 0, s>>>(
      keys, order, vals, row_stride, col_stride, n, f, out, table_size,
      next_keys, next_vals, n_next);
  return cudaGetLastError();
}

// Columns per thread: all of them up to 4, else one.
template <typename In, typename Out>
cudaError_t launch_level(const int* keys, const long long* order,
                         const In* vals, long long row_stride,
                         long long col_stride, long long n, int f, Out* out,
                         long long table_size, int* next_keys,
                         double* next_vals, long long n_next,
                         cudaStream_t s) {
  switch (f) {
    case 2:
      return launch_ft<In, Out, 2>(keys, order, vals, row_stride,
                                   col_stride, n, f, out, table_size,
                                   next_keys, next_vals, n_next, s);
    case 3:
      return launch_ft<In, Out, 3>(keys, order, vals, row_stride,
                                   col_stride, n, f, out, table_size,
                                   next_keys, next_vals, n_next, s);
    case 4:
      return launch_ft<In, Out, 4>(keys, order, vals, row_stride,
                                   col_stride, n, f, out, table_size,
                                   next_keys, next_vals, n_next, s);
    default:
      return launch_ft<In, Out, 1>(keys, order, vals, row_stride,
                                   col_stride, n, f, out, table_size,
                                   next_keys, next_vals, n_next, s);
  }
}

template <typename T>
int run(const int* keys, const long long* order, const T* vals, long long m,
        int f, T* out, long long table_size, int* ws_keys, double* ws_vals,
        long long ws_len, cudaStream_t s) {
  // level 0 reads the sorted stream through `order`; the pieces then
  // alternate between the two halves of the workspace
  long long n = m;
  long long n_next = next_length(n);
  int side = 0;
  cudaError_t err = launch_level<T, T>(
      keys, order, vals, f, 1, n, f, out, table_size, ws_keys,
      ws_vals, n_next, s);
  while (err == cudaSuccess && n_next > 0) {
    n = n_next;
    n_next = next_length(n);
    const int* k_in = ws_keys + side * ws_len;
    const double* v_in = ws_vals + (long long)side * ws_len * f;
    side ^= 1;
    err = launch_level<double, T>(
        k_in, nullptr, v_in, 1, n, n, f, out, table_size,
        ws_keys + side * ws_len, ws_vals + (long long)side * ws_len * f,
        n_next, s);
  }
  return (int)err;
}

}  // namespace

// Entries of one half of the workspace for m input entries: the length of
// level 1's stream, the longest after level 0.  The caller passes int32
// ws_keys [2 * len] and float64 ws_vals [2 * len * f].
extern "C" long long rise_scatter_add_sorted_workspace(long long m) {
  return next_length(m);
}

// keys [m] int32 sorted ascending, order [m] int64 (the stable sort's
// permutation), vals [m, f] float32 (is_double 0) or float64 (1), out
// [table_size, f] of vals' type, zeroed.
extern "C" int rise_scatter_add_sorted(const void* keys, const void* order,
                                       const void* vals, int is_double,
                                       long long m, int f, void* out,
                                       long long table_size, void* ws_keys,
                                       void* ws_vals, long long ws_len,
                                       void* stream) {
  if (m <= 0 || f <= 0) return (int)cudaSuccess;
  if (f > 65535 || table_size > 0x7fffffffLL ||
      ws_len < next_length(m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return run<double>((const int*)keys, (const long long*)order,
                       (const double*)vals, m, f, (double*)out, table_size,
                       (int*)ws_keys, (double*)ws_vals, ws_len, s);
  return run<float>((const int*)keys, (const long long*)order,
                    (const float*)vals, m, f, (float*)out, table_size,
                    (int*)ws_keys, (double*)ws_vals, ws_len, s);
}

extern "C" const char* rise_scatter_add_sorted_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
