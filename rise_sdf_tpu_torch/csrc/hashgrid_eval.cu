// E1: the hash-grid encode where no graph through it is kept, for Hopper
// (sm_90a): the features of points x [N, 3] in [0, 1]^3 (E1f) and the
// position gradient of a cotangent of those features (E1b).
//
// Replaces no TPU kernel: the JAX package leaves the cell, the corner
// rows, the gathers and the trilinear sum of its encode to XLA, and
// XLA fuses them.  The port ran them as a chain of ~85 torch launches
// around G1 (ops/hashgrid.py), most of them broadcasting elementwise
// kernels over [N, L, 8] and [N, L, 8, 2] tensors; this pair takes that
// chain's place in eval (no table gradient, no second derivative).  G1
// stays as it is for training and for the bake's reads.
//
// E1f, one thread per (point, level): the cell at the level's
// resolution, the 8 corner rows (the dense index below the dense prefix,
// else the instant-ngp hash in uint32 masked with T - 1, the same low
// bits as the chain's int64), the 8 gathers of 8-byte rows and the
// trilinear sum in registers; it writes the [N, L * 2] features only (a
// level outside [lo, hi) writes zeros).  A point's 16 levels are 16
// consecutive lanes, so their 128 bytes of features are one store of a
// half warp, and a warp's gathers for one level fall in nearby cells of
// two consecutive samples along a ray.
//
// E1b, one thread per (point, level): the rows gathered again (saving
// them would cost 1 KB a point), the derivative of the 8 corner weights
// by each axis fraction times the level's resolution and the cotangent
// (masked), then the sum over the levels, done per point from shared
// memory; it writes [N, 3].
//
// What bounds them: bytes.  E1f reads x (12 B a point) and writes the
// features (8 B a level); E1b reads x and the cotangent (8 B a level)
// and writes 12 B a point; both read each distinct table row once (8 B;
// a sector of 32 B holds four).  At 393,216 points and 14 open levels
// of 16 the streams are 4.7 + 50.3 MB and 4.7 + 44.0 + 4.7 MB, plus the
// distinct rows.  Every output has one writer: no atomics, so both are
// deterministic.  On the H100 there (5.75 M distinct rows) E1f takes
// 0.22 ms and E1b 0.21 ms, 14 % of that bound, against 7.0 ms for the
// chain's forward and position backward: the rows are 8 bytes at random
// addresses, each fetches a 32-byte sector, and most miss L2.
//
// Both reproduce the chain's float32 arithmetic in the chain's order on
// the card, so the features are bit-equal to the chain's and the
// gradient is the one autograd takes through it:
//   pos = u * res; i0 = min(max(floor(pos), 0), res - 1); w = pos - i0;
//   the axis pairs (1 - w, w), the corner weight (wx * wy) * wz;
//   each product rounded; the 8-corner sum as torch's reduction takes a
//   dimension that is not the fastest (four accumulators, element k into
//   k mod 4, then ((a0 + a1) + a2) + a3); the mask as a multiply.
// The backward mirrors autograd's nodes: d corner = sum over the two
// features of cotangent * row; the products' broadcast reductions (two
// terms, or four in the order (0,0), (0,1), (1,0), (1,1) for the z
// pair); d w = d(w) - d(1 - w); times res; the level sum with the same
// four accumulators.  Every multiply and add is __fmul_rn / __fadd_rn,
// so nvcc cannot contract a pair of them into an FMA.
//
// Plain C interface, loaded with ctypes: pointers and the stream come in
// as void*, the launch returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
// instant-ngp spatial hash primes (x's is 1)
constexpr unsigned kPrimeY = 2654435761u;
constexpr unsigned kPrimeZ = 805459861u;

struct Levels {
  float res[kMaxLevels];   // resolution (an integer, exact in float32)
  int stride[kMaxLevels];  // dense stride res + 1
  float mask[kMaxLevels];  // progressive mask, 1 or 0
  int n_levels;            // L: the features are [N, L * 2]
  int lo, hi;              // levels in range
  int n_dense;             // levels below it index densely
  unsigned hash_mask;      // T - 1
  long long level_rows;    // T: rows of one level in the [L * T, 2] table
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
// a reduction of two terms as torch's takes it: the terms from zero
// accumulators, the rest of the accumulators zeros
__device__ __forceinline__ float sum2(float a, float b) {
  return add(add(a, b), 0.f);
}

// One (point, level): the axis pairs, the 4 products wx * wy and the 8
// rows of the cell, corners cx-major (c = 4 i + 2 j + k).
struct Cell {
  float wx[2], wy[2], wz[2];
  float ab[4];  // ab[2 i + j] = wx[i] * wy[j]
  float2 v[8];
};

__device__ __forceinline__ void load_cell(const float* __restrict__ x,
                                          const float2* __restrict__ table,
                                          const Levels& lv, long long n,
                                          int l, Cell& c) {
  const float r = lv.res[l];
  const float top = add(r, -1.f);
  float w[3];
  int i0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = mul(__ldg(x + 3 * n + a), r);
    // fmaxf takes a NaN to 0, so an index stays in the table
    const float f = fminf(fmaxf(floorf(pos), 0.f), top);
    w[a] = add(pos, -f);
    i0[a] = (int)f;
  }
  c.wx[0] = add(1.f, -w[0]);
  c.wx[1] = w[0];
  c.wy[0] = add(1.f, -w[1]);
  c.wy[1] = w[1];
  c.wz[0] = add(1.f, -w[2]);
  c.wz[1] = w[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) c.ab[2 * i + j] = mul(c.wx[i], c.wy[j]);
  const float2* rows = table + (long long)l * lv.level_rows;
  unsigned row[8];
  if (l < lv.n_dense) {
    const int s = lv.stride[l];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[k] = (unsigned)((i0[0] + (k >> 2)) +
                          s * ((i0[1] + ((k >> 1) & 1)) +
                               s * (i0[2] + (k & 1))));
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      row[k] = ((unsigned)(i0[0] + (k >> 2)) ^
                (unsigned)(i0[1] + ((k >> 1) & 1)) * kPrimeY ^
                (unsigned)(i0[2] + (k & 1)) * kPrimeZ) &
               lv.hash_mask;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) c.v[k] = __ldg(rows + row[k]);
}

// E1f: block = kThreads / L points of L levels each; thread t is level
// t % L of point t / L of the block's points.
__global__ void __launch_bounds__(kThreads)
    encode_features_kernel(const float* __restrict__ x,
                           const float2* __restrict__ table,
                           float2* __restrict__ out, long long n_points,
                           const Levels lv) {
  const int per_block = kThreads / lv.n_levels;
  const int p = threadIdx.x / lv.n_levels;
  const int l = threadIdx.x - p * lv.n_levels;
  const long long n = (long long)blockIdx.x * per_block + p;
  if (p >= per_block || n >= n_points) return;
  float2 f = make_float2(0.f, 0.f);
  if (l >= lv.lo && l < lv.hi) {
    Cell c;
    load_cell(x, table, lv, n, l, c);
    float acc0[4], acc1[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float o = mul(c.ab[k >> 1], c.wz[k & 1]);
      acc0[k] = add(0.f, mul(o, c.v[k].x));
      acc1[k] = add(0.f, mul(o, c.v[k].y));
    }
#pragma unroll
    for (int k = 4; k < 8; ++k) {
      const float o = mul(c.ab[k >> 1], c.wz[k & 1]);
      acc0[k - 4] = add(acc0[k - 4], mul(o, c.v[k].x));
      acc1[k - 4] = add(acc1[k - 4], mul(o, c.v[k].y));
    }
    const float m = lv.mask[l];
    f.x = mul(add(add(add(acc0[0], acc0[1]), acc0[2]), acc0[3]), m);
    f.y = mul(add(add(add(acc1[0], acc1[1]), acc1[2]), acc1[3]), m);
  }
  out[n * lv.n_levels + l] = f;
}

// E1b: the same threads; each writes its level's d x to shared memory,
// then 3 threads a point sum the levels of one axis in the chain's
// order.
__global__ void __launch_bounds__(kThreads)
    encode_position_grad_kernel(const float* __restrict__ x,
                                const float2* __restrict__ table,
                                const float* __restrict__ grad,
                                long long grad_ld,
                                float* __restrict__ grad_x,
                                long long n_points, const Levels lv) {
  __shared__ float part[kThreads * 3];
  const int per_block = kThreads / lv.n_levels;
  const int p = threadIdx.x / lv.n_levels;
  const int l = threadIdx.x - p * lv.n_levels;
  const long long first = (long long)blockIdx.x * per_block;
  const long long n = first + p;
  if (p < per_block && n < n_points && l >= lv.lo && l < lv.hi) {
    Cell c;
    load_cell(x, table, lv, n, l, c);
    const float m = lv.mask[l];
    const float g0 = mul(__ldg(grad + n * grad_ld + 2 * l), m);
    const float g1 = mul(__ldg(grad + n * grad_ld + 2 * l + 1), m);
    float d[8];  // d feature / d corner weight
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[k] = sum2(mul(g0, c.v[k].x), mul(g1, c.v[k].y));
    // (wx * wy) * wz: d (wx * wy) over z, d wz over (i, j)
    float dab[4];
#pragma unroll
    for (int ij = 0; ij < 4; ++ij)
      dab[ij] = sum2(mul(d[2 * ij], c.wz[0]), mul(d[2 * ij + 1], c.wz[1]));
    float dz[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float s = 0.f;
#pragma unroll
      for (int ij = 0; ij < 4; ++ij) s = add(s, add(0.f, mul(d[2 * ij + k],
                                                           c.ab[ij])));
      dz[k] = s;
    }
    // wx * wy: d wx over j, d wy over i
    float dx[2], dy[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      dx[i] = sum2(mul(dab[2 * i], c.wy[0]), mul(dab[2 * i + 1], c.wy[1]));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      dy[j] = sum2(mul(dab[j], c.wx[0]), mul(dab[2 + j], c.wx[1]));
    const float r = lv.res[l];
    part[3 * threadIdx.x + 0] = mul(add(dx[1], -dx[0]), r);
    part[3 * threadIdx.x + 1] = mul(add(dy[1], -dy[0]), r);
    part[3 * threadIdx.x + 2] = mul(add(dz[1], -dz[0]), r);
  }
  __syncthreads();
  // (point, axis) pairs of the block, consecutive in grad_x
  for (int qa = threadIdx.x; qa < 3 * per_block; qa += kThreads) {
    const int q = qa / 3;
    const int a = qa - 3 * q;
    if (first + q >= n_points) break;
    // torch's loop: four accumulators over whole groups of four levels,
    // then the rest into the first ones
    const float* t = part + 3 * q * lv.n_levels + a;
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    int l2 = lv.lo;
    for (; l2 + 3 < lv.hi; l2 += 4) {
      acc0 = add(acc0, t[3 * l2]);
      acc1 = add(acc1, t[3 * (l2 + 1)]);
      acc2 = add(acc2, t[3 * (l2 + 2)]);
      acc3 = add(acc3, t[3 * (l2 + 3)]);
    }
    if (l2 < lv.hi) acc0 = add(acc0, t[3 * l2]);
    if (l2 + 1 < lv.hi) acc1 = add(acc1, t[3 * (l2 + 1)]);
    if (l2 + 2 < lv.hi) acc2 = add(acc2, t[3 * (l2 + 2)]);
    grad_x[3 * (first + q) + a] = add(add(add(acc0, acc1), acc2), acc3);
  }
}

int fill_levels(Levels& lv, const float* res, const int* stride,
                const float* mask, int n_levels, int lo, int hi,
                int n_dense, long long level_rows, long long hash_mask) {
  if (n_levels < 1 || n_levels > kMaxLevels || lo < 0 || hi > n_levels ||
      lo >= hi || level_rows < 1 || hash_mask < 0 ||
      hash_mask >= level_rows || (long long)n_levels * level_rows >
      0x7fffffffLL)
    return 1;
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = res[l];
    lv.stride[l] = stride[l];
    lv.mask[l] = mask[l];
  }
  lv.n_levels = n_levels;
  lv.lo = lo;
  lv.hi = hi;
  lv.n_dense = n_dense;
  lv.hash_mask = (unsigned)hash_mask;
  lv.level_rows = level_rows;
  return 0;
}

unsigned blocks_for(long long n_points, int n_levels) {
  const long long per_block = kThreads / n_levels;
  return (unsigned)((n_points + per_block - 1) / per_block);
}

bool too_many(long long n_points, int n_levels) {
  return (n_points + kThreads) / (kThreads / n_levels) > 0x7fffffffLL;
}

}  // namespace

// x [n, 3] float32; table [n_levels * level_rows, 2] float32 (8-byte
// aligned); out [n, n_levels * 2] float32; res, stride, mask: host arrays
// of n_levels.
extern "C" int rise_encode_features(const void* x, const void* table,
                                    void* out, long long n,
                                    const float* res, const int* stride,
                                    const float* mask, int n_levels, int lo,
                                    int hi, int n_dense, long long level_rows,
                                    long long hash_mask, void* stream) {
  Levels lv;
  if (fill_levels(lv, res, stride, mask, n_levels, lo, hi, n_dense,
                  level_rows, hash_mask) ||
      (unsigned long long)table % 8 != 0 || (unsigned long long)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (too_many(n, n_levels)) return (int)cudaErrorInvalidValue;
  encode_features_kernel<<<blocks_for(n, n_levels), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (float2*)out, n, lv);
  return (int)cudaGetLastError();
}

// grad [n, grad_ld] float32 (the features' cotangent in its first
// n_levels * 2 columns); grad_x [n, 3] float32.
extern "C" int rise_encode_position_grad(
    const void* x, const void* table, const void* grad, long long grad_ld,
    void* grad_x, long long n, const float* res, const int* stride,
    const float* mask, int n_levels, int lo, int hi, int n_dense,
    long long level_rows, long long hash_mask, void* stream) {
  Levels lv;
  if (fill_levels(lv, res, stride, mask, n_levels, lo, hi, n_dense,
                  level_rows, hash_mask) ||
      (unsigned long long)table % 8 != 0 || grad_ld < 2LL * n_levels)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (too_many(n, n_levels)) return (int)cudaErrorInvalidValue;
  encode_position_grad_kernel<<<blocks_for(n, n_levels), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const float2*)table, (const float*)grad, grad_ld,
      (float*)grad_x, n, lv);
  return (int)cudaGetLastError();
}

extern "C" const char* rise_encode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
