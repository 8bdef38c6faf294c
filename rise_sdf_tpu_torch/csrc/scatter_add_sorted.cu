// K2: deterministic scatter-add for Hopper (sm_90a), as an exact
// fixed-point sum.
//
// Computes out[idx[i], c] += vals[i, c] into a zeroed [table_size, F]
// table, as K1 does, but bit-reproducibly: two launches on the same input
// give the same bits, whatever order the atomics land in.  It is the
// counterpart of the JAX package's `HashGridEncoding._encode_sorted_vjp`
// (rise_sdf_tpu/ops/hashgrid.py:448), whose table gradient is XLA ops
// (argsort, cumsum, searchsorted), not a Pallas kernel.  JAX makes the
// order fixed by sorting; here the order does not matter, because every
// value is turned exactly into an integer on a power-of-two scale that
// the input alone fixes, and integer addition is associative.
//
// The arithmetic, shared bit for bit with the plain version
// (ops/scatter_sorted.py, `scatter_add_sorted_plain`); e(x) is frexp's
// exponent, |x| < 2^e(x):
//   range   float32 values: e_hi = 128, W = 9 (32 buckets of 9 binades
//           hold every finite float32); float64 values: e_hi = e(max
//           |v|), e_lo = e(min |v|) over the finite nonzero values, W =
//           ceil((e_hi - e_lo + 1) / 32) binades per bucket;
//   bucket  a value's b = min(31, (e_hi - e(v)) / W); an entry's b* is
//           the least over its finite nonzero values (0 when none), so
//           every value of the entry has e(v) <= E = e_hi - W * b*, and
//           its largest has e(v) > E - W;
//   scale   the entry's s = 94 - bitlen(M) - E: |v| * 2^s < 2^(94 -
//           bitlen(M)) for its values, so each entry keeps 93 -
//           bitlen(M) - W bits below its own largest magnitude, however
//           far that lies below the call's;
//   value   q = rint(v * 2^s) (two exact power-of-two products), split
//           exactly as q = hi * 2^32 + lo, hi = floor(q * 2^-32) signed,
//           lo = q - hi * 2^32 in [0, 2^32);
//   sum     per entry H = sum hi (int64, |H| < 2^62) and L = sum lo (u64,
//           L < M * 2^32 <= 2^62 for M <= 2^30): exact in any order;
//   result  d = double(H + (L >> 32)) * 2^32 + double(L & (2^32 - 1)),
//           times 2^-s (two power-of-two products), rounded once to vals'
//           dtype.
// A negative index is an absent row (a row that another shard of a
// row-sharded table owns): its values take part in nothing, neither the
// range nor a bucket nor a sum (XLA's drop mode, as K1); M still counts
// every entry.
// Every step is an IEEE operation written as an intrinsic (__dmul_rn,
// __dadd_rn, rint, floor, the _rn conversions), so nvcc's FMA contraction
// cannot change a bit; the build has no --use_fast_math, so subnormals
// survive.  Against the exact sum an entry is within one ulp of vals'
// dtype plus count * 2^-(93 - bitlen(M) - W) times its own largest
// magnitude (2^-56 for float32 at M = 2^27).  A NaN or an infinity adds
// nothing to the integers: it ORs a flag into bits 62 (+Inf or NaN) and
// 63 (-Inf or NaN) of its entry's L word, which the sums of lo never
// reach, and the entry comes out NaN if both are set, else +-Inf, as a
// float sum would.
//
// Five passes (four for float32), one launch each, on the caller's
// stream:
//   1. zero:    the scratch: [table_size, F] pairs of 64-bit words (H, L),
//               the range words and [table_size, F] 32-bit bucket masks;
//   2. range:   float64 only: max |v| and min |v| over the finite nonzero
//               values, as the bit patterns (ordered as the magnitudes),
//               reduced per block and merged with one atomicMax each (the
//               min as the max of the complement): order-free;
//   3. buckets: K1's walk (below); each run of equal rows ORs the buckets
//               of its values into its entries' masks (bit b), one RED per
//               run and pair of columns;
//   4. scatter: the same walk; each run of equal rows is summed in
//               registers as integers on its entries' scales, and issues
//               one 64-bit RED per nonzero word per column;
//   5. convert: each entry's two words to the output dtype.
// The walk is K1's (csrc/scatter_add.cu): the caller's layout is entry
// i = n * P + j; a walk takes column j over kWalk consecutive rows n, and
// the lanes of a warp read neighbouring entries, streaming (ld.cs).  P = 1
// walks 32-entry rows; the entries past the last whole row of the layout
// are added one by one.  Columns of vals go in tiles of FT (all F up to
// 4) per thread.
//
// What bounds it: bytes, and on the recorded streams the REDs.  The
// function must read idx (4 B) and vals (F * 4 or 8 B) per entry and
// write the table once (0.501 ms on the training stream's 134M rows into
// 8.4M x 2 at 3.35 TB/s).  This design reads idx and vals twice (vals a
// third time for float64), zeroes and reads back 20 B of scratch per
// table entry, and
// issues one RED per run for the buckets and up to two 8-byte REDs per
// run and column for the sums (K1 issues one 8-byte float2 RED per run
// for both columns); the REDs land in L2, which holds one level's
// scratch while the walks in flight all take that level (the walks'
// order, below).  The quantisation is ~10 float64 operations per value,
// far under the card's float64 rate.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, every launch is followed by cudaGetLastError().

#include <cuda_runtime.h>

#include <cassert>
#include <type_traits>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 128;      // walk blocks
constexpr int kFlatThreads = 256;  // zero, range and convert blocks
constexpr int kWalk = 32;          // rows per walk
constexpr int kNoLayout = 32;      // the row width P = 1 is walked as
constexpr int kBuckets = 32;       // bucket bits per entry's mask
constexpr int kOnesBits = 94;      // |q| < 2^(94 - bitlen(M))
constexpr u64 kSumMask = (1ULL << 62) - 1;  // L's bits below the flags
constexpr long long kMaxRows = 1LL << 30;

// 2^k for k in [-1022, 1023]
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double((long long)(k + 1023) << 52);
}

// x * 2^k as two exact power-of-two products: 2^k1 with k1 = k clamped
// to [-1000, 1000], then 2^(k - k1) (the plain version's order)
struct Pow2 {
  double a, b;
};

__device__ __forceinline__ Pow2 pow2_pair(int k) {
  const int k1 = k > 1000 ? 1000 : (k < -1000 ? -1000 : k);
  return {pow2(k1), pow2(k - k1)};
}

__device__ __forceinline__ double times(double x, Pow2 p) {
  return __dmul_rn(__dmul_rn(x, p.a), p.b);
}

// frexp's exponent of a nonnegative double given as its bits: x < 2^e;
// a subnormal's from its leading bit; 0 for 0
__device__ __forceinline__ int exponent_of(u64 bits) {
  const int biased = (int)(bits >> 52);
  const u64 mant = bits & ((1ULL << 52) - 1);
  return biased ? biased - 1022 : (mant ? (64 - __clzll(mant)) - 1074 : 0);
}

__device__ __forceinline__ u64 abs_bits(double v) {
  return (u64)__double_as_longlong(fabs(v));
}

// The call's range: e_hi, the bucket width W and 94 - bitlen(M); for
// float64 values from the range words
struct Range {
  int e_hi, width, ones;
};

template <typename T>
__device__ __forceinline__ Range range_of(const u64* __restrict__ state,
                                          long long m) {
  const int ones = kOnesBits - (64 - __clzll(m));
  if constexpr (std::is_same_v<T, float>) {
    return {128, 9, ones};
  } else {
    const int e_hi = exponent_of(state[0]);
    // state[1] is the max of the complements: 0 when no value is nonzero
    const int e_lo = state[1] ? exponent_of(~state[1]) : e_hi;
    return {e_hi, (e_hi - e_lo + kBuckets) / kBuckets, ones};
  }
}

// A finite nonzero value's bucket bit
__device__ __forceinline__ unsigned bucket_bit(double v, Range r) {
  const int b = (r.e_hi - exponent_of(abs_bits(v))) / r.width;
  return 1u << (b < kBuckets - 1 ? b : kBuckets - 1);
}

// An entry's scale s from its mask
__device__ __forceinline__ int shift_of(unsigned mask, Range r) {
  const int b = mask ? __ffs(mask) - 1 : 0;
  return r.ones - (r.e_hi - r.width * b);
}

// One value: its (hi, lo) words, or its flags when it is not finite.
__device__ __forceinline__ void quantize(double v, Pow2 up, u64& hi, u64& lo,
                                         unsigned& flags) {
  if (!isfinite(v)) {
    flags |= isnan(v) ? 3u : (v > 0.0 ? 1u : 2u);
    hi = 0;
    lo = 0;
    return;
  }
  const double q = rint(times(v, up));
  const double h = floor(__dmul_rn(q, 0x1p-32));
  hi = (u64)__double2ll_rn(h);
  lo = __double2ull_rn(__dsub_rn(q, __dmul_rn(h, 0x1p32)));
}

// FT values of one entry; as one 8- or 16-byte load when kVec (the
// caller checked the alignment)
template <typename T, int FT, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         T (&v)[FT]) {
  if constexpr (kVec && std::is_same_v<T, float> && FT == 2) {
    const float2 x = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else if constexpr (kVec && std::is_same_v<T, float> && FT == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (kVec && std::is_same_v<T, double> && FT == 2) {
    const double2 x = __ldcs(reinterpret_cast<const double2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int t = 0; t < FT; ++t) v[t] = __ldcs(p + t);
  }
}

// The walks' two jobs: pass 3 ORs bucket bits, pass 4 adds the words
enum Job { kBucketJob, kSumJob };

// One run's work into its entry's scratch (results unused: REDs).  For
// the buckets, two neighbouring columns whose masks share an aligned
// 8-byte word take one 64-bit OR.
template <Job kJob, int FT>
__device__ __forceinline__ void red(u64* __restrict__ words,
                                    unsigned* __restrict__ masks, int row,
                                    int f, int c0, const u64 (&hi)[FT],
                                    const u64 (&lo)[FT],
                                    const unsigned (&bits)[FT]) {
  const long long e = (long long)row * f + c0;
  if constexpr (kJob == kBucketJob) {
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      if (t + 1 < FT && (e + t) % 2 == 0) {
        if (bits[t] | bits[t + 1])
          atomicOr(reinterpret_cast<u64*>(masks + e + t),
                   (u64)bits[t] | (u64)bits[t + 1] << 32);
        ++t;
      } else if (bits[t]) {
        atomicOr(masks + e + t, bits[t]);
      }
    }
  } else {
    u64* p = words + 2 * e;
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      if (hi[t]) atomicAdd(p + 2 * t, hi[t]);
      if (lo[t]) atomicAdd(p + 2 * t + 1, lo[t]);
      if (bits[t]) atomicOr(p + 2 * t + 1, (u64)bits[t] << 62);
    }
  }
}

// Pass 1: `pairs` pairs of 64-bit words to 0, one 16-byte store each
__global__ void __launch_bounds__(kFlatThreads)
    zero_kernel(ulonglong2* __restrict__ words, long long pairs) {
  const long long stride = (long long)gridDim.x * kFlatThreads;
  for (long long i = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
       i < pairs; i += stride)
    words[i] = make_ulonglong2(0ULL, 0ULL);
}

// Is value `i` of vals [m, f] in a present entry (its index >= 0)?
__device__ __forceinline__ bool present(const int* __restrict__ idx,
                                        long long i, int f) {
  return __ldg(idx + i / f) >= 0;
}

// A value into the running max of |v| and of the complement of |v|
// (finite nonzero values of present entries only)
__device__ __forceinline__ void range_add(double v, bool keep, u64& hi,
                                          u64& lo_c) {
  if (keep && isfinite(v) && v != 0.0) {
    const u64 b = abs_bits(v);
    hi = max(hi, b);
    lo_c = max(lo_c, ~b);
  }
}

// Pass 2: the range words.  kVec: 16-byte loads (vals 16-byte aligned).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFlatThreads)
    range_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                 long long n, int f, u64* __restrict__ state) {
  constexpr int kPer = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kFlatThreads;
  const long long first = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
  u64 hi = 0, lo_c = 0;
  long long done = 0;
  if constexpr (kVec) {
    const long long vecs = n / kPer;
    for (long long i = first; i < vecs; i += stride) {
      const long long v0 = i * kPer;
      if constexpr (std::is_same_v<T, float>) {
        const float4 x = __ldcs(reinterpret_cast<const float4*>(vals) + i);
        range_add(x.x, present(idx, v0, f), hi, lo_c);
        range_add(x.y, present(idx, v0 + 1, f), hi, lo_c);
        range_add(x.z, present(idx, v0 + 2, f), hi, lo_c);
        range_add(x.w, present(idx, v0 + 3, f), hi, lo_c);
      } else {
        const double2 x = __ldcs(reinterpret_cast<const double2*>(vals) + i);
        range_add(x.x, present(idx, v0, f), hi, lo_c);
        range_add(x.y, present(idx, v0 + 1, f), hi, lo_c);
      }
    }
    done = vecs * kPer;
  }
  for (long long i = done + first; i < n; i += stride)
    range_add(__ldcs(vals + i), present(idx, i, f), hi, lo_c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo_c = max(lo_c, __shfl_xor_sync(0xffffffffu, lo_c, off));
  }
  __shared__ u64 warp_hi[kFlatThreads / 32], warp_lo[kFlatThreads / 32];
  if ((threadIdx.x & 31) == 0) {
    warp_hi[threadIdx.x >> 5] = hi;
    warp_lo[threadIdx.x >> 5] = lo_c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kFlatThreads / 32; ++w) {
      hi = max(hi, warp_hi[w]);
      lo_c = max(lo_c, warp_lo[w]);
    }
    if (hi) atomicMax(state, hi);
    if (lo_c) atomicMax(state + 1, lo_c);
  }
}

// Per entry of the run being walked: the bucket bits (pass 3), or the
// scales and the integer sums (pass 4)
template <Job kJob, int FT>
struct Run {
  u64 hi[FT], lo[FT];
  unsigned bits[FT];  // bucket bits, or the non-finite flags
  Pow2 up[FT];

  __device__ __forceinline__ void start(const unsigned* __restrict__ masks,
                                        int row, int f, int c0, Range r) {
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      hi[t] = lo[t] = 0;
      bits[t] = 0;
    }
    if constexpr (kJob == kSumJob) {
      const unsigned* mk = masks + (long long)row * f + c0;
#pragma unroll
      for (int t = 0; t < FT; ++t) up[t] = pow2_pair(shift_of(mk[t], r));
    }
  }

  template <typename T>
  __device__ __forceinline__ void add(const T (&v)[FT], Range r) {
#pragma unroll
    for (int t = 0; t < FT; ++t) {
      const double x = (double)v[t];
      if constexpr (kJob == kBucketJob) {
        if (isfinite(x) && x != 0.0) bits[t] |= bucket_bit(x, r);
      } else {
        u64 h, l;
        quantize(x, up[t], h, l, bits[t]);
        hi[t] += h;
        lo[t] += l;
      }
    }
  }
};

// Passes 3 and 4: walk w takes rows [g * kWalk, g * kWalk + kWalk) of
// column j of the `rows` whole rows of the layout, and the columns [c0,
// c0 + FT) of vals, c0 = blockIdx.y * FT; the entries from rows * period
// on are added one by one.  Walks go in groups of `group` neighbouring
// columns (a level's 8 corners), all of a group's walks before the next
// group's: w = (k * row_groups + g) * group + c, j = k * group + c.  So
// the walks in flight at any moment hit one level's rows, whose scratch
// (2^19 rows x 40 B at the NeuS widths) L2 holds while their REDs land;
// in the layout's own order (group = period) they would hit every
// level's rows at once, and most REDs would miss L2.  A warp still reads
// whole sectors: four 32-byte runs of idx per step.
template <Job kJob, typename T, int FT, bool kVec>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                u64* __restrict__ words, unsigned* __restrict__ masks,
                const u64* __restrict__ state, long long m, int f,
                int period, int group, long long rows, int table_size) {
  // entries whose loads are in flight at once
  constexpr int kBatch = FT * sizeof(T) <= 8 ? 8 : 4;
  const int c0 = blockIdx.y * FT;
  const Range range = range_of<T>(state, m);
  const long long row_groups = (rows + kWalk - 1) / kWalk;
  const long long walks = row_groups * period;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long vstep = (long long)period * f;
  Run<kJob, FT> run;
  for (long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
       w < walks; w += stride) {
    const long long kg = w / group;
    const long long k = kg / row_groups;
    const long long g = kg - k * row_groups;
    const long long n0 = g * kWalk;
    const int steps = (int)(rows - n0 < kWalk ? rows - n0 : kWalk);
    const long long e0 = n0 * period + k * group + (w - kg * group);
    const int* ip = idx + e0;
    const T* vp = vals + e0 * f + c0;
    // an absent row (cur < 0) starts no run: its values are skipped and
    // the next present row starts one
    int cur = __ldcs(ip);
    assert(cur < table_size);
    if (cur >= 0) {
      T v0[FT];
      load_row<T, FT, kVec>(vp, v0);
      run.start(masks, cur, f, c0, range);
      run.add(v0, range);
    }
    for (int s = 1; s < steps; s += kBatch) {
      int r[kBatch];
      T v[kBatch][FT];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s + u < steps) {
          r[u] = __ldcs(ip + (long long)(s + u) * period);
          load_row<T, FT, kVec>(vp + (s + u) * vstep, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (s + u < steps) {
          assert(r[u] < table_size);
          if (r[u] != cur) {
            if (cur >= 0)
              red<kJob, FT>(words, masks, cur, f, c0, run.hi, run.lo,
                            run.bits);
            cur = r[u];
            if (cur >= 0) run.start(masks, cur, f, c0, range);
          }
          if (cur >= 0) run.add(v[u], range);
        }
      }
    }
    if (cur >= 0)
      red<kJob, FT>(words, masks, cur, f, c0, run.hi, run.lo, run.bits);
  }
  for (long long i = rows * period + (long long)blockIdx.x * kThreads +
                     threadIdx.x;
       i < m; i += stride) {
    const int row = idx[i];
    assert(row < table_size);
    if (row < 0) continue;  // absent
    T v[FT];
    load_row<T, FT, false>(vals + i * f + c0, v);
    run.start(masks, row, f, c0, range);
    run.add(v, range);
    red<kJob, FT>(words, masks, row, f, c0, run.hi, run.lo, run.bits);
  }
}

template <typename T>
__device__ __forceinline__ T to_out(double d);
template <>
__device__ __forceinline__ float to_out<float>(double d) {
  return __double2float_rn(d);
}
template <>
__device__ __forceinline__ double to_out<double>(double d) {
  return d;
}

// NaN when both flags are set, else +Inf (flag 1) or -Inf (flag 2)
template <typename T>
__device__ __forceinline__ T non_finite(unsigned flags);
template <>
__device__ __forceinline__ float non_finite<float>(unsigned flags) {
  return __int_as_float(flags == 3u ? 0x7fc00000
                        : (flags == 1u ? 0x7f800000 : (int)0xff800000u));
}
template <>
__device__ __forceinline__ double non_finite<double>(unsigned flags) {
  return __longlong_as_double(
      flags == 3u ? 0x7ff8000000000000LL
                  : (flags == 1u ? 0x7ff0000000000000LL
                                 : (long long)0xfff0000000000000ULL));
}

// Pass 5: n = table_size * F entries, each from its (H, L) words and its
// mask
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
    convert_kernel(const ulonglong2* __restrict__ words,
                   const unsigned* __restrict__ masks,
                   const u64* __restrict__ state, T* __restrict__ out,
                   long long n, long long m) {
  const Range range = range_of<T>(state, m);
  const long long stride = (long long)gridDim.x * kFlatThreads;
  for (long long i = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
       i < n; i += stride) {
    const ulonglong2 w = __ldcs(words + i);
    const unsigned flags = (unsigned)(w.y >> 62);
    const u64 low = w.y & kSumMask;
    const long long h = (long long)(w.x + (low >> 32));
    const double d = __dadd_rn(__dmul_rn(__ll2double_rn(h), 0x1p32),
                               __ull2double_rn(low & 0xffffffffULL));
    out[i] = flags ? non_finite<T>(flags)
                   : to_out<T>(times(d, pow2_pair(-shift_of(
                                            __ldcs(masks + i), range))));
  }
}

// The card's SMs, asked once per process (the port runs one kind of
// card per process).
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (!cached) {
    cudaError_t err;
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(
             &cached, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// Blocks for a grid-stride pass over `work` items: one wave of `per_sm`
// blocks on every SM, fewer when the work is smaller.
cudaError_t wave(int per_sm, int threads, long long work, unsigned* blocks) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  long long n = (long long)sms * per_sm;
  const long long need = (work + threads - 1) / threads;
  if (n > need) n = need;
  *blocks = (unsigned)(n > 0 ? n : 1);
  return cudaSuccess;
}

// Resident blocks of `kernel` per SM, asked once per instantiation.
template <typename K>
cudaError_t occupancy(K kernel, int threads, int* cached) {
  if (*cached) return cudaSuccess;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      cached, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  return *cached < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The flat passes: 2048 threads per SM, as many as an SM holds
constexpr int kFlatPerSm = 2048 / kFlatThreads;

// Where the scratch's parts lie: the (H, L) pairs, the two range words,
// then the masks (as many 64-bit words as hold them, a whole 16 bytes)
struct Scratch {
  u64* words;
  u64* state;
  unsigned* masks;
  long long pairs;  // 16-byte pairs of the whole scratch
};

long long scratch_pairs(long long entries) {
  return entries + 1 + (entries + 3) / 4;
}

Scratch scratch_of(void* base, long long entries) {
  u64* words = (u64*)base;
  return {words, words + 2 * entries, (unsigned*)(words + 2 * entries + 2),
          scratch_pairs(entries)};
}

struct Walk {
  const int* idx;
  Scratch sc;
  long long m;
  int f, period, group, table_size;
  cudaStream_t s;
};

template <Job kJob, typename T, int FT, bool kVec>
cudaError_t launch_walk(const Walk& a, const T* vals) {
  static int per_sm = 0;
  const long long rows = a.m / a.period;
  const long long work =
      (rows + kWalk - 1) / kWalk * a.period + a.m % a.period;
  unsigned blocks = 0;
  cudaError_t err;
  if ((err = occupancy(walk_kernel<kJob, T, FT, kVec>, kThreads,
                       &per_sm)) != cudaSuccess ||
      (err = wave(per_sm, kThreads, work, &blocks)) != cudaSuccess)
    return err;
  dim3 grid(blocks, (unsigned)(a.f / FT));
  walk_kernel<kJob, T, FT, kVec><<<grid, kThreads, 0, a.s>>>(
      a.idx, vals, a.sc.words, a.sc.masks, a.sc.state, a.m, a.f, a.period,
      a.group, rows, a.table_size);
  return cudaGetLastError();
}

// Column tile: all of F up to 4, else the largest of 4 and 2 dividing F,
// else 1; one vector load per entry where the tile is 8 or 16 bytes and
// vals is aligned to it.
template <Job kJob, typename T>
cudaError_t dispatch_walk(const Walk& a, const T* vals) {
  const int f = a.f;
  const int ft = f <= 4 ? f : (f % 4 == 0 ? 4 : (f % 2 == 0 ? 2 : 1));
  const int bytes = ft * (int)sizeof(T);
  const bool vec = (bytes == 8 || bytes == 16) &&
                   (unsigned long long)vals % bytes == 0;
  switch (ft) {
    case 4:
      return vec ? launch_walk<kJob, T, 4, true>(a, vals)
                 : launch_walk<kJob, T, 4, false>(a, vals);
    case 3:
      return launch_walk<kJob, T, 3, false>(a, vals);
    case 2:
      return vec ? launch_walk<kJob, T, 2, true>(a, vals)
                 : launch_walk<kJob, T, 2, false>(a, vals);
    default:
      return launch_walk<kJob, T, 1, false>(a, vals);
  }
}

template <typename T>
cudaError_t run(const Walk& a, const T* vals, T* out, int passes) {
  const long long entries = (long long)a.table_size * a.f;
  cudaError_t err = cudaSuccess;
  unsigned blocks = 0;
  if (passes & 1) {  // zero
    if ((err = wave(kFlatPerSm, kFlatThreads, a.sc.pairs, &blocks)) !=
        cudaSuccess)
      return err;
    zero_kernel<<<blocks, kFlatThreads, 0, a.s>>>(
        reinterpret_cast<ulonglong2*>(a.sc.words), a.sc.pairs);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((passes & 2) && std::is_same_v<T, double>) {  // range
    const long long n = a.m * a.f;
    if ((unsigned long long)vals % 16 == 0) {
      if ((err = wave(kFlatPerSm, kFlatThreads, n / (16 / sizeof(T)) + 1,
                      &blocks)) != cudaSuccess)
        return err;
      range_kernel<T, true><<<blocks, kFlatThreads, 0, a.s>>>(
          a.idx, vals, n, a.f, a.sc.state);
    } else {
      if ((err = wave(kFlatPerSm, kFlatThreads, n, &blocks)) != cudaSuccess)
        return err;
      range_kernel<T, false><<<blocks, kFlatThreads, 0, a.s>>>(
          a.idx, vals, n, a.f, a.sc.state);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((passes & 4) &&
      (err = dispatch_walk<kBucketJob, T>(a, vals)) != cudaSuccess)
    return err;
  if ((passes & 8) &&
      (err = dispatch_walk<kSumJob, T>(a, vals)) != cudaSuccess)
    return err;
  if (passes & 16) {  // convert
    if ((err = wave(kFlatPerSm, kFlatThreads, entries, &blocks)) !=
        cudaSuccess)
      return err;
    convert_kernel<T><<<blocks, kFlatThreads, 0, a.s>>>(
        reinterpret_cast<const ulonglong2*>(a.sc.words), a.sc.masks,
        a.sc.state, out, entries, a.m);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// 64-bit words of scratch for a [table_size, f] table: the (H, L) pair of
// every entry, the two range words, then the entries' 32-bit masks in
// whole 16-byte pairs.
extern "C" long long rise_scatter_add_sorted_words(long long table_size,
                                                   int f) {
  return 2 * scratch_pairs(table_size * f);
}

// idx [m] int32, vals [m, f] float32 (is_double 0) or float64 (1), out
// [table_size, f] of vals' type, words the scratch (16-byte aligned);
// `period` the row stride of the caller's layout (1: none).  `passes`:
// a bit mask of the passes to run (1 zero, 2 range (float64 values
// only), 4 buckets, 8 scatter, 16 convert; 31 the whole function, the
// others for timing a pass alone).
extern "C" int rise_scatter_add_sorted(const void* idx, const void* vals,
                                       int is_double, long long m, int f,
                                       long long period, void* out,
                                       long long table_size, void* words,
                                       int passes, void* stream) {
  if (m < 0 || f <= 0 || m > kMaxRows || f > 65535 || table_size < 0 ||
      table_size > 0x7fffffffLL || period < 1 || period > 0x7fffffffLL ||
      (unsigned long long)words % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (table_size == 0) return (int)cudaSuccess;
  // P = 1 (no layout) is walked as rows of kNoLayout entries, in their
  // own order; a layout of levels of 8 corners in groups of 8 columns
  const int p = period == 1 ? kNoLayout : (int)period;
  const Walk a{(const int*)idx, scratch_of(words, table_size * f), m, f, p,
               period > 1 && period % 8 == 0 ? 8 : p, (int)table_size,
               (cudaStream_t)stream};
  // no entries: nothing to walk, the table comes out 0
  if (m == 0) passes &= ~(2 | 4 | 8);
  if (is_double)
    return (int)run<double>(a, (const double*)vals, (double*)out, passes);
  return (int)run<float>(a, (const float*)vals, (float*)out, passes);
}

extern "C" const char* rise_scatter_add_sorted_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
