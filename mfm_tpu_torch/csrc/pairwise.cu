// K2a/K2b: O(T^2) pairwise sums for the evaluation metrics.
//
// Replaces mfm_tpu/ops/pairwise_pallas.py::stein_pairwise_sum (kernel body
// _stein_tile_kernel) and ::rbf_kernel_sum (_mmd_tile_kernel).
//   stein: sum_ij -4b(b+1) r/(1+r)^(b+2) + 2b (d + cross)/(1+r)^(b+1)
//                 + s_i.s_j/(1+r)^b,  r = |x_i-x_j|^2,
//          cross = (s_i - s_j).(x_i - x_j)   (IMQ Stein kernel, b = -beta)
//   rbf:   sum_ij exp(-|a_i - b_j|^2 * inv2s2)
//
// What bounds them on an H100. At the eval sizes the inputs are a few
// hundred KB to 160 MB for 1e6 to 1.6e8 pairs: never the bytes. At d = 2
// a pair costs a handful of fp32 operations and one special-function
// operation (the exp, or the IMQ power); the special-function pipe does 16
// a clock an SM against 128 FMAs, so it is the floor. From d = 32 on the
// three length-d products a pair are, and the tensor cores take them; in
// between, the 3 d FMAs a pair of the differences form.
//
// The design, shared by every kernel here.
// - Work in 64x64 tiles of pairs, on a schedule the host builds
//   (ops/pairwise.py::tile_schedule): an item is one strip of 64 i-rows
//   and a run of consecutive j-tiles, the runs cut so that the grid has
//   about sixteen blocks an SM: the strips of a symmetric sum differ in
//   length, and with two blocks an SM the card waited for the longest
//   (1.2 to 1.4 times slower at T = 12800). One block per item, one fp64
//   partial per block.
// - Half the pairs. The Stein term is symmetric in (i, j), and so is the
//   RBF term when both sides are the same points: such a sum's items hold
//   only tiles with j >= i, and a tile with j > i counts twice.
// - One special-function operation a pair. exp(-r/(2 s^2)) is ex2.approx
//   of coordinates scaled by sqrt(log2(e)/(2 s^2)) when they are staged.
//   The IMQ powers (1+r)^-(b+2), ^-(b+1), ^-b are p q^2, p q, p with
//   p = (1+r)^-b and q = 1/(1+r): at b = 1/2 (the only value the package
//   uses) p = rsqrt(1+r), with one Newton step, and q = p p; any other b takes
//   p = exp2(-b log2(1+r)) and a reciprocal.
// - fp32 inside a tile, fp64 across tiles. A thread sums its pairs of one
//   tile in fp32 (16 or 32 terms) and adds that to an fp64 total once per
//   tile; the block's total is reduced with warp shuffles.
// - One launch. Each block writes its partial, then takes a ticket from an
//   integer counter; the block that draws the last ticket adds all the
//   partials in index order (the same order whichever block that is, so
//   the sum has the same bits on every run) and resets the counter. The
//   TPU kernels add every grid cell into one fp32 scalar, which is safe
//   there because a TPU runs its grid in sequence (pairwise_pallas.py:8-10).
// - Three routes, chosen by d alone.
//   d <= 4: the i-points of a thread (4 rows) stay in registers for the
//   whole run, the j-points of up to 4 tiles are staged at once and read
//   back as float2/float4.
//   4 < d: 32 columns of the row tiles are staged at a time (only the
//   columns that exist), each thread owns a 4x4 micro-tile. r and cross
//   come from the differences themselves rather than the Gram expansion
//   |x|^2+|y|^2-2x.y, which loses digits to cancellation when the points
//   are far from the origin.
//   Stein at wide d (ops/pairwise.py::GRAM_MIN_D): the Gram form on the
//   tensor cores, in 3xTF32 as K1 (common.cuh). X is centred by its column
//   mean first: r and cross do not change under a shift of x, the norms
//   shrink and with them the cancellation. Three products a tile, not the
//   TPU kernel's four: with u = x + s,
//   s_i.x_j + x_i.s_j = u_i.u_j - x_i.x_j - s_i.s_j. Four warps, each
//   32x32 of the tile; the operand tiles (64 rows x 32 columns of x_i,
//   s_i, x_j, s_j) go through shared memory with cp.async, double-buffered
//   over d and across the tiles of the run, and are read back as mma
//   fragments with ldmatrix. A first launch centres X into
//   a zero-padded copy (rows to a multiple of 64, columns of 32), so the
//   product loop has no edges, and takes |x_i|^2 and s_i.x_i of the
//   centred rows.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;    // rows per tile on each side
constexpr int kThreads = 256;
constexpr int kT = 16;       // 16x16 threads, 4x4 pairs each
constexpr int kDC = 32;      // columns staged per chunk
constexpr int kPad = kDC + 1;
constexpr int kStageTiles = 4;  // d <= 4: j-tiles staged at once
constexpr float kLog2e = 1.4426950408889634f;

// Item k of the schedule is (i-tile, first j-tile, j-tiles, sum): sums 0
// and 1 pair the first, or the second, point set with itself (tiles j >= i
// only); sum 2 pairs the first with the second. Partials [ends[s-1],
// ends[s]) belong to sum s.
struct SumEnds {
  int e[3];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The IMQ Stein term of one pair from r, cross and s_i.s_j.
template <bool kHalf>  // b == 1/2
struct Imq {
  float b, c1, c2, c2d;  // c1 = -4b(b+1), c2 = 2b, c2d = 2b d
  __device__ __forceinline__ float operator()(float r, float cross, float ss) const {
    const float base = 1.f + r;
    float p, q;
    if (kHalf) {
      // rsqrt.approx is good to 2^-22.4 and leans one way: over 1e8 terms
      // of both signs that shows in the sixth digit of the sum. One Newton
      // step (four instructions) leaves fp32 rounding only.
      const float p0 = rsqrt_approx(base);
      p = fmaf(p0, fmaf(-0.5f * base * p0, p0, 0.5f), p0);
      q = p * p;
    } else {
      p = exp2f(-b * log2f(base));
      q = __frcp_rn(base);
    }
    return p * fmaf(q, fmaf(c1 * r, q, fmaf(c2, cross, c2d)), ss);
  }
};

template <bool kHalf>
Imq<kHalf> make_imq(float b, int d) {
  return Imq<kHalf>{b, -4.f * b * (b + 1.f), 2.f * b, 2.f * b * static_cast<float>(d)};
}

// The sum of v over the block, valid in thread 0, in a fixed order.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;
}

// The block's partial, and from the last block to arrive, the sums.
__device__ __forceinline__ void finish(double acc, const SumEnds ends, double* partials,
                                       unsigned* counter, double* out) {
  __shared__ bool last;
  const double total = block_sum(acc);
  if (threadIdx.x == 0) {
    __stcg(partials + blockIdx.x, total);
    __threadfence();
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  int start = 0;
  for (int s = 0; s < 3; ++s) {
    double v = 0.0;
    for (int n = start + (int)threadIdx.x; n < ends.e[s]; n += (int)blockDim.x)
      v += __ldcg(partials + n);
    v = block_sum(v);
    if (threadIdx.x == 0) out[s] = v;
    start = ends.e[s];
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch
}

// The two sides of an item's sum.
struct Sides {
  const float *A, *B;
  int Ta, Tb;
  bool symmetric;
};

__device__ __forceinline__ Sides sides_of(int sum, const float* P0, int T0, const float* P1,
                                          int T1) {
  return Sides{sum == 1 ? P1 : P0, sum == 0 ? P0 : P1, sum == 1 ? T1 : T0,
               sum == 0 ? T0 : T1, sum != 2};
}

// A point of up to V coordinates, read back from shared memory as a vector.
template <int V>
struct alignas(4 * V) Pt {
  float v[V];
};

template <int V>
__device__ __forceinline__ Pt<V> load_pt(const float* P, int T, int d, int row, float scale) {
  Pt<V> p;
#pragma unroll
  for (int c = 0; c < V; ++c) p.v[c] = (c < d && row < T) ? P[(size_t)row * d + c] * scale : 0.f;
  return p;
}

// ---------------------------------------------------------------- K2b --

// exp2(-|a - b|^2) summed over a thread's 4x4 pairs (coordinates pre-scaled).
template <int V, bool kMasked>
__device__ __forceinline__ float rbf_pairs(const Pt<V> (&a)[4], const Pt<V> (&b)[4],
                                           const bool (&ok_i)[4], const bool (&ok_j)[4]) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float e = 0.f;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float diff = a[u].v[c] - b[v].v[c];
        e = fmaf(-diff, diff, e);
      }
      const float k = ex2_approx(e);
      s += (!kMasked || (ok_i[u] && ok_j[v])) ? k : 0.f;
    }
  return s;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
rbf_small_kernel(const float* __restrict__ P0, int T0, const float* __restrict__ P1, int T1, int d,
                 float scale, const int4* __restrict__ items, SumEnds ends,
                 double* __restrict__ partials, unsigned* counter, double* __restrict__ out) {
  __shared__ Pt<V> bj[kStageTiles * kTile];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int4 item = items[blockIdx.x];
  const Sides sd = sides_of(item.w, P0, T0, P1, T1);
  const int i0 = item.x * kTile;
  Pt<V> a[4];
  bool ok_i[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a[u] = load_pt<V>(sd.A, sd.Ta, d, i0 + ty + kT * u, scale);
    ok_i[u] = i0 + ty + kT * u < sd.Ta;
  }
  double acc = 0.0;
  for (int t0 = 0; t0 < item.z; t0 += kStageTiles) {
    const int nt = min(kStageTiles, item.z - t0);
    const int jbase = (item.y + t0) * kTile;
    __syncthreads();  // the tiles staged before have been read
    for (int idx = tid; idx < nt * kTile; idx += kThreads)
      bj[idx] = load_pt<V>(sd.B, sd.Tb, d, jbase + idx, scale);
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const int j0 = jbase + t * kTile;
      Pt<V> b[4];
      bool ok_j[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        b[v] = bj[t * kTile + tx + kT * v];
        ok_j[v] = j0 + tx + kT * v < sd.Tb;
      }
      const bool edge = i0 + kTile > sd.Ta || j0 + kTile > sd.Tb;
      const float s = edge ? rbf_pairs<V, true>(a, b, ok_i, ok_j)
                           : rbf_pairs<V, false>(a, b, ok_i, ok_j);
      const bool twice = sd.symmetric && item.y + t0 + t > item.x;
      acc += (double)(twice ? 2.f * s : s);
    }
  }
  finish(acc, ends, partials, counter, out);
}

__global__ void __launch_bounds__(kThreads)
rbf_general_kernel(const float* __restrict__ P0, int T0, const float* __restrict__ P1, int T1,
                   int d, float scale, const int4* __restrict__ items, SumEnds ends,
                   double* __restrict__ partials, unsigned* counter, double* __restrict__ out) {
  __shared__ float ai[kTile][kPad], bj[kTile][kPad];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int4 item = items[blockIdx.x];
  const Sides sd = sides_of(item.w, P0, T0, P1, T1);
  const int i0 = item.x * kTile;
  double acc = 0.0;
  for (int t = 0; t < item.z; ++t) {
    const int j0 = (item.y + t) * kTile;
    float r[4][4] = {};
    for (int c0 = 0; c0 < d; c0 += kDC) {
      const int dc = min(kDC, d - c0);
      __syncthreads();  // the chunk staged before has been read
      for (int idx = tid; idx < kTile * kDC; idx += kThreads) {
        const int row = idx / kDC, c = idx % kDC;
        if (c < dc) {  // only the columns that exist
          const int gi = i0 + row, gj = j0 + row;
          ai[row][c] = gi < sd.Ta ? sd.A[(size_t)gi * d + c0 + c] * scale : 0.f;
          bj[row][c] = gj < sd.Tb ? sd.B[(size_t)gj * d + c0 + c] * scale : 0.f;
        }
      }
      __syncthreads();
      for (int c = 0; c < dc; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u] = ai[ty + kT * u][c];
          bb[u] = bj[tx + kT * u][c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float diff = a[u] - bb[v];
            r[u][v] = fmaf(-diff, diff, r[u][v]);
          }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool ok = i0 + ty + kT * u < sd.Ta && j0 + tx + kT * v < sd.Tb;
        s += ok ? ex2_approx(r[u][v]) : 0.f;
      }
    const bool twice = sd.symmetric && item.y + t > item.x;
    acc += (double)(twice ? 2.f * s : s);
  }
  finish(acc, ends, partials, counter, out);
}

// ---------------------------------------------------------------- K2a --

template <int V, bool kHalf, bool kMasked>
__device__ __forceinline__ float stein_pairs(const Imq<kHalf>& imq, const Pt<V> (&ax)[4],
                                             const Pt<V> (&as)[4], const Pt<V> (&bx)[4],
                                             const Pt<V> (&bs)[4], const bool (&ok_i)[4],
                                             const bool (&ok_j)[4]) {
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float r = 0.f, cross = 0.f, ss = 0.f;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float dx = ax[u].v[c] - bx[v].v[c], ds = as[u].v[c] - bs[v].v[c];
        r = fmaf(dx, dx, r);
        cross = fmaf(ds, dx, cross);
        ss = fmaf(as[u].v[c], bs[v].v[c], ss);
      }
      const float term = imq(r, cross, ss);
      sum += (!kMasked || (ok_i[u] && ok_j[v])) ? term : 0.f;
    }
  return sum;
}

template <int V, bool kHalf>
__global__ void __launch_bounds__(kThreads)
stein_small_kernel(const float* __restrict__ X, const float* __restrict__ S, int T, int d,
                   Imq<kHalf> imq, const int4* __restrict__ items, SumEnds ends,
                   double* __restrict__ partials, unsigned* counter, double* __restrict__ out) {
  __shared__ Pt<V> xj[kStageTiles * kTile], sj[kStageTiles * kTile];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int4 item = items[blockIdx.x];
  const int i0 = item.x * kTile;
  Pt<V> ax[4], as[4];
  bool ok_i[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    ax[u] = load_pt<V>(X, T, d, i0 + ty + kT * u, 1.f);
    as[u] = load_pt<V>(S, T, d, i0 + ty + kT * u, 1.f);
    ok_i[u] = i0 + ty + kT * u < T;
  }
  double acc = 0.0;
  for (int t0 = 0; t0 < item.z; t0 += kStageTiles) {
    const int nt = min(kStageTiles, item.z - t0);
    const int jbase = (item.y + t0) * kTile;
    __syncthreads();  // the tiles staged before have been read
    for (int idx = tid; idx < nt * kTile; idx += kThreads) {
      xj[idx] = load_pt<V>(X, T, d, jbase + idx, 1.f);
      sj[idx] = load_pt<V>(S, T, d, jbase + idx, 1.f);
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const int j0 = jbase + t * kTile;
      Pt<V> bx[4], bs[4];
      bool ok_j[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        bx[v] = xj[t * kTile + tx + kT * v];
        bs[v] = sj[t * kTile + tx + kT * v];
        ok_j[v] = j0 + tx + kT * v < T;
      }
      const bool edge = i0 + kTile > T || j0 + kTile > T;
      const float s = edge ? stein_pairs<V, kHalf, true>(imq, ax, as, bx, bs, ok_i, ok_j)
                           : stein_pairs<V, kHalf, false>(imq, ax, as, bx, bs, ok_i, ok_j);
      acc += (double)(item.y + t0 + t > item.x ? 2.f * s : s);
    }
  }
  finish(acc, ends, partials, counter, out);
}

template <bool kHalf>
__global__ void __launch_bounds__(kThreads)
stein_general_kernel(const float* __restrict__ X, const float* __restrict__ S, int T, int d,
                     Imq<kHalf> imq, const int4* __restrict__ items, SumEnds ends,
                     double* __restrict__ partials, unsigned* counter,
                     double* __restrict__ out) {
  __shared__ float xi[kTile][kPad], si[kTile][kPad], xj[kTile][kPad], sj[kTile][kPad];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int4 item = items[blockIdx.x];
  const int i0 = item.x * kTile;
  double acc = 0.0;
  for (int t = 0; t < item.z; ++t) {
    const int j0 = (item.y + t) * kTile;
    float r[4][4] = {}, cross[4][4] = {}, ss[4][4] = {};
    for (int c0 = 0; c0 < d; c0 += kDC) {
      const int dc = min(kDC, d - c0);
      __syncthreads();  // the chunk staged before has been read
      for (int idx = tid; idx < kTile * kDC; idx += kThreads) {
        const int row = idx / kDC, c = idx % kDC;
        if (c < dc) {  // only the columns that exist
          const int gi = i0 + row, gj = j0 + row;
          xi[row][c] = gi < T ? X[(size_t)gi * d + c0 + c] : 0.f;
          si[row][c] = gi < T ? S[(size_t)gi * d + c0 + c] : 0.f;
          xj[row][c] = gj < T ? X[(size_t)gj * d + c0 + c] : 0.f;
          sj[row][c] = gj < T ? S[(size_t)gj * d + c0 + c] : 0.f;
        }
      }
      __syncthreads();
      for (int c = 0; c < dc; ++c) {
        float a_x[4], a_s[4], b_x[4], b_s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a_x[u] = xi[ty + kT * u][c];
          a_s[u] = si[ty + kT * u][c];
          b_x[u] = xj[tx + kT * u][c];
          b_s[u] = sj[tx + kT * u][c];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float dx = a_x[u] - b_x[v], ds = a_s[u] - b_s[v];
            r[u][v] = fmaf(dx, dx, r[u][v]);
            cross[u][v] = fmaf(ds, dx, cross[u][v]);
            ss[u][v] = fmaf(a_s[u], b_s[v], ss[u][v]);
          }
      }
    }
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const bool ok = i0 + ty + kT * u < T && j0 + tx + kT * v < T;
        const float term = imq(r[u][v], cross[u][v], ss[u][v]);
        s += ok ? term : 0.f;
      }
    acc += (double)(item.y + t > item.x ? 2.f * s : s);
  }
  finish(acc, ends, partials, counter, out);
}

// ------------------------------------------- K2a on the tensor cores --

constexpr int kGThreads = 128;        // 4 warps, 2x2, each 32x32 of the tile
constexpr int kGK = 32;               // columns per staged chunk
constexpr int kGLd = kGK + 4;         // row stride: 8 rows of 16 bytes hit 32 banks
constexpr int kGOperand = kTile * kGLd;
constexpr int kGStage = 4 * kGOperand;  // x_i, s_i, x_j, s_j
constexpr int kGBlocks = 3;          // blocks an SM: at most 168 registers a thread
constexpr int kGSmem = 2 * kGStage * (int)sizeof(float);

// Column means of X (T, d): block b takes columns [32 b, 32 b + 32), thread
// (c, y) the rows y, y + 32, ...; the 32 row sums of a column are added in
// order. Any shift of x leaves the Stein sum unchanged, so the mean needs
// no accuracy, only the same bits on every run.
__global__ void __launch_bounds__(1024)
column_mean_kernel(const float* __restrict__ X, int T, int d, float* __restrict__ mean) {
  __shared__ float part[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (c < d)
    for (int row = threadIdx.y; row < T; row += 32) s += X[(size_t)row * d + c];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float total = 0.f;
    for (int y = 0; y < 32; ++y) total += part[y][threadIdx.x];
    mean[c] = total / (float)T;
  }
}

// One warp a row of the padded copies: Xc = X - mean and Sp = S inside
// (T, d), zeros outside; sq = |xc|^2 and sxx = s.xc of the row.
__global__ void __launch_bounds__(kThreads)
centre_rows_kernel(const float* __restrict__ X, const float* __restrict__ S,
                   const float* __restrict__ mean, int T, int d, int Tp, int dp,
                   float* __restrict__ Xc, float* __restrict__ Sp, float* __restrict__ sq,
                   float* __restrict__ sxx) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= Tp) return;
  float q = 0.f, sx = 0.f;
  for (int c = lane; c < dp; c += 32) {
    const bool in = row < T && c < d;
    const float x = in ? X[(size_t)row * d + c] - mean[c] : 0.f;
    const float s = in ? S[(size_t)row * d + c] : 0.f;
    Xc[(size_t)row * dp + c] = x;
    Sp[(size_t)row * dp + c] = s;
    q = fmaf(x, x, q);
    sx = fmaf(s, x, sx);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    q += __shfl_xor_sync(0xffffffffu, q, o);
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
  }
  if (lane == 0) {
    sq[row] = q;
    sxx[row] = sx;
  }
}

// acc[i][j] += A_i B_j^T for one k-step of a warp's 32x32 block: a holds
// the A fragments of its two 16-row tiles, b the B fragments of its four
// 8-column tiles.
__device__ __forceinline__ void gram_step(float (&acc)[2][4][4], const float (&a)[2][4],
                                          const float (&b)[4][2]) {
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32_open(a[i][e], ah[i][e], al[i][e]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) split_tf32_open(b[j][e], bh[j][e], bl[j][e]);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_3xtf32(acc[i][j], ah[i], al[i], bh[j], bl[j]);
}

template <bool kHalf>
__global__ void __launch_bounds__(kGThreads, kGBlocks)
stein_gram_kernel(const float* __restrict__ Xc, const float* __restrict__ Sp,
                  const float* __restrict__ sq, const float* __restrict__ sxx, int T, int dp,
                  Imq<kHalf> imq, const int4* __restrict__ items, SumEnds ends,
                  double* __restrict__ partials, unsigned* counter, double* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int4 item = items[blockIdx.x];
  const int i0 = item.x * kTile, nk = dp / kGK, total = item.z * nk;

  // step s is chunk s % nk of tile s / nk of the run; it lives in stage s % 2
  auto fetch = [&](int s) {
    const int t = s / nk, c0 = (s - t * nk) * kGK, j0 = (item.y + t) * kTile;
    float* st = smem + (s & 1) * kGStage;
    for (int idx = tid; idx < 4 * kTile * (kGK / 4); idx += kGThreads) {
      const int op = idx / (kTile * (kGK / 4)), rem = idx % (kTile * (kGK / 4));
      const int row = rem / (kGK / 4), c = (rem % (kGK / 4)) * 4;
      const float* src = ((op & 1) ? Sp : Xc) + (size_t)((op < 2 ? i0 : j0) + row) * dp + c0 + c;
      cp_async16(st + op * kGOperand + row * kGLd + c, src, true);
    }
    cp_async_commit();
  };

  float cxx[2][4][4], css[2][4][4], cuu[2][4][4];
  double acc = 0.0;
  fetch(0);
  for (int s = 0, k = 0, t = 0; s < total; ++s) {
    if (k == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cxx[i][j][e] = css[i][j][e] = cuu[i][j][e] = 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();  // step s has landed for every thread; step s - 1 has been read
    if (s + 1 < total) fetch(s + 1);
    const float* st = smem + (s & 1) * kGStage;
    // ldmatrix reads four 8x4 blocks of fp32 (8 rows of 16 bytes) and hands
    // lane (g, q) entry (g, q) of each: the mma's fragment layout. Lane
    // 8 m + r gives the address of row r of block m. For A (x_i, s_i) the
    // blocks are rows 0-7 and 8-15 at columns 0-3, then at columns 4-7; for
    // B (x_j, s_j) columns 0-3 and 4-7 of rows 0-7, then of rows 8-15.
    const int m = lane >> 3, r8 = lane & 7;
    const float* pa = st + (wm * 32 + r8 + 8 * (m & 1)) * kGLd + 4 * (m >> 1);
    const float* pb = st + 2 * kGOperand + (wn * 32 + r8 + 8 * (m >> 1)) * kGLd + 4 * (m & 1);
#pragma unroll
    for (int ks = 0; ks < kGK; ks += 8) {
      float ax[2][4], as[2][4], bx[4][2], bs[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(ax[i], pa + i * 16 * kGLd + ks);
        ldmatrix_x4(as[i], pa + kGOperand + i * 16 * kGLd + ks);
      }
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        float vx[4], vs[4];
        ldmatrix_x4(vx, pb + j * 8 * kGLd + ks);
        ldmatrix_x4(vs, pb + kGOperand + j * 8 * kGLd + ks);
        bx[j][0] = vx[0], bx[j][1] = vx[1], bx[j + 1][0] = vx[2], bx[j + 1][1] = vx[3];
        bs[j][0] = vs[0], bs[j][1] = vs[1], bs[j + 1][0] = vs[2], bs[j + 1][1] = vs[3];
      }
      gram_step(cxx, ax, bx);
      gram_step(css, as, bs);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) ax[i][e] += as[i][e];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) bx[j][e] += bs[j][e];
      gram_step(cuu, ax, bx);
    }
    if (++k < nk) continue;
    // the tile's epilogue on the accumulator fragments
    const int j0 = (item.y + t) * kTile;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i0 + wm * 32 + i * 16 + g + h * 8;
        const float sq_i = sq[row], sxx_i = sxx[row];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int l = 0; l < 2; ++l) {
            const int col = j0 + wn * 32 + j * 8 + 2 * q + l, e = 2 * h + l;
            const float gxx = cxx[i][j][e], gss = css[i][j][e], guu = cuu[i][j][e];
            // a point with itself: r and cross are 0, not the Gram form's
            // rounding noise (at r = 0 the term is at its largest)
            const bool self = row == col;
            const float r = self ? 0.f : fmaxf(sq_i + sq[col] - 2.f * gxx, 0.f);
            const float cross = self ? 0.f : sxx_i + sxx[col] - (guu - gxx - gss);
            const float term = imq(r, cross, gss);
            sum += (row < T && col < T) ? term : 0.f;
          }
      }
    acc += (double)(item.y + t > item.x ? 2.f * sum : sum);
    k = 0, ++t;
  }
  finish(acc, ends, partials, counter, out);
}

template <class Kernel, class... Args>
int launch_items(Kernel kernel, int n_items, int threads, size_t smem, cudaStream_t stream,
                 Args... args) {
  kernel<<<n_items, threads, smem, stream>>>(args...);
  return mfm_last_error();
}

}  // namespace

MFM_EXPORT int mfm_pairwise_tile() { return kTile; }

// The Stein sum of X, S (T, d) on the differences routes; out[0] is the sum.
MFM_EXPORT int mfm_stein_sum(const float* X, const float* S, int T, int d, float b,
                             const int* items, int n_items, double* partials, unsigned* counter,
                             double* out, cudaStream_t stream) {
  if (T <= 0 || d <= 0 || n_items <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int4* it = reinterpret_cast<const int4*>(items);
  const SumEnds ends{{n_items, n_items, n_items}};
  auto run = [&](auto kernel_half, auto kernel_any) {
    return b == 0.5f ? launch_items(kernel_half, n_items, kThreads, 0, stream, X, S, T, d,
                                    make_imq<true>(b, d), it, ends, partials, counter, out)
                     : launch_items(kernel_any, n_items, kThreads, 0, stream, X, S, T, d,
                                    make_imq<false>(b, d), it, ends, partials, counter, out);
  };
  if (d <= 2) return run(stein_small_kernel<2, true>, stein_small_kernel<2, false>);
  if (d <= 4) return run(stein_small_kernel<4, true>, stein_small_kernel<4, false>);
  return run(stein_general_kernel<true>, stein_general_kernel<false>);
}

// The first launches of the Gram route: the column means of X, then the
// centred, zero-padded copies Xc, Sp (Tp, dp) with sq and sxx (Tp).
MFM_EXPORT int mfm_stein_gram_prepare(const float* X, const float* S, int T, int d, int Tp,
                                      int dp, float* mean, float* Xc, float* Sp, float* sq,
                                      float* sxx, cudaStream_t stream) {
  if (T <= 0 || d <= 0 || Tp < T || dp < d || Tp % kTile || dp % kGK)
    return static_cast<int>(cudaErrorInvalidValue);
  column_mean_kernel<<<(d + 31) / 32, dim3(32, 32), 0, stream>>>(X, T, d, mean);
  const int err = mfm_last_error();
  if (err) return err;
  const int rows = kThreads / 32;
  centre_rows_kernel<<<(Tp + rows - 1) / rows, kThreads, 0, stream>>>(X, S, mean, T, d, Tp, dp,
                                                                     Xc, Sp, sq, sxx);
  return mfm_last_error();
}

// The Stein sum on the tensor cores from what mfm_stein_gram_prepare wrote.
MFM_EXPORT int mfm_stein_gram_sum(const float* Xc, const float* Sp, const float* sq,
                                  const float* sxx, int T, int d, int dp, float b,
                                  const int* items, int n_items, double* partials,
                                  unsigned* counter, double* out, cudaStream_t stream) {
  if (T <= 0 || d <= 0 || dp < d || dp % kGK || n_items <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(stein_gram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGSmem),
      cudaFuncSetAttribute(stein_gram_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGSmem)};
  if (attr[0] != cudaSuccess || attr[1] != cudaSuccess)
    return static_cast<int>(attr[0] != cudaSuccess ? attr[0] : attr[1]);
  const int4* it = reinterpret_cast<const int4*>(items);
  const SumEnds ends{{n_items, n_items, n_items}};
  return b == 0.5f ? launch_items(stein_gram_kernel<true>, n_items, kGThreads, kGSmem, stream, Xc,
                                  Sp, sq, sxx, T, dp, make_imq<true>(b, d), it, ends, partials,
                                  counter, out)
                   : launch_items(stein_gram_kernel<false>, n_items, kGThreads, kGSmem, stream,
                                  Xc, Sp, sq, sxx, T, dp, make_imq<false>(b, d), it, ends,
                                  partials, counter, out);
}

// Up to three RBF sums in one launch, as the schedule's items say: out[0]
// over P0 x P0, out[1] over P1 x P1, out[2] over P0 x P1. Partials
// [0, end0) belong to the first, [end0, end1) to the second, the rest to
// the third.
MFM_EXPORT int mfm_rbf_mmd_sums(const float* P0, int T0, const float* P1, int T1, int d,
                                float inv2s2, const int* items, int n_items, int end0, int end1,
                                double* partials, unsigned* counter, double* out,
                                cudaStream_t stream) {
  if (T0 <= 0 || T1 <= 0 || d <= 0 || n_items <= 0 || inv2s2 < 0.f || end0 < 0 || end1 < end0 ||
      n_items < end1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int4* it = reinterpret_cast<const int4*>(items);
  const SumEnds ends{{end0, end1, n_items}};
  // exp(-r inv2s2) = exp2(-|scale (a - b)|^2)
  const float scale = sqrtf(inv2s2 * kLog2e);
  if (d <= 2)
    return launch_items(rbf_small_kernel<2>, n_items, kThreads, 0, stream, P0, T0, P1, T1, d,
                        scale, it, ends, partials, counter, out);
  if (d <= 4)
    return launch_items(rbf_small_kernel<4>, n_items, kThreads, 0, stream, P0, T0, P1, T1, d,
                        scale, it, ends, partials, counter, out);
  return launch_items(rbf_general_kernel, n_items, kThreads, 0, stream, P0, T0, P1, T1, d, scale,
                      it, ends, partials, counter, out);
}
