// K2a/K2b: O(T^2) pairwise sums for the evaluation metrics.
//
// Replaces mfm_tpu/ops/pairwise_pallas.py::stein_pairwise_sum (kernel body
// _stein_tile_kernel) and ::rbf_kernel_sum (_mmd_tile_kernel).
//   stein: sum_ij -4b(b+1) r/(1+r)^(b+2) + 2b (d + cross)/(1+r)^(b+1)
//                 + s_i.s_j/(1+r)^b,  r = |x_i-x_j|^2,
//          cross = (s_i - s_j).(x_i - x_j)   (IMQ Stein kernel, b = -beta)
//   rbf:   sum_ij exp(-|a_i - b_j|^2 * inv2s2)
//
// One block per (i-tile, j-tile) of 64x64 pairs; each thread owns a 4x4
// micro-tile and accumulates its pairs' dot products over d in its own
// loops, staging 32 columns of the four (or two) row tiles through shared
// memory at a time. r and cross come from the differences themselves
// rather than the Gram expansion |x|^2+|y|^2-2x.y, which loses digits to
// cancellation when the points are far from the origin. Pairs beyond T are
// masked. Each block writes ONE fp64 partial sum; a second launch reduces
// the partials in a fixed order. The TPU kernels instead add every grid
// cell into one fp32 scalar, which is safe there only because a TPU runs
// its grid in sequence (pairwise_pallas.py:8-10); CUDA blocks run
// concurrently and in no order, and fp32 atomics would make the sum
// depend on the schedule.
//
// What bounds it on an H100: per pair ~6 FMAs per dimension plus one or
// three powf/expf; at the eval sizes (T=12800, d=2: 1.6e8 pairs; T=1024,
// d=64: 1e6 pairs x 64) it is bound by the FMA and SFU pipes, not memory
// (each tile reads 2x64xd floats for 4096 pairs).

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;    // rows per tile on each side
constexpr int kThreads = 256;
constexpr int kT = 16;       // 16x16 threads, 4x4 pairs each
constexpr int kDC = 32;      // columns staged per chunk
constexpr int kPad = kDC + 1;

__device__ __forceinline__ void block_store_sum(double v, double* out) {
  __shared__ double red[kThreads];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

__global__ void __launch_bounds__(kThreads)
stein_tile_kernel(const float* __restrict__ X, const float* __restrict__ S, int T, int d,
                  float b, double* __restrict__ partials) {
  __shared__ float xi[kTile][kPad], si[kTile][kPad], xj[kTile][kPad], sj[kTile][kPad];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  float r[4][4] = {}, cross[4][4] = {}, ss[4][4] = {};
  for (int c0 = 0; c0 < d; c0 += kDC) {
    const int dc = min(kDC, d - c0);
    for (int idx = tid; idx < kTile * kDC; idx += kThreads) {
      const int row = idx / kDC, c = idx % kDC;
      const bool col_ok = c < dc;
      const int gi = i0 + row, gj = j0 + row;
      xi[row][c] = (col_ok && gi < T) ? X[(size_t)gi * d + c0 + c] : 0.f;
      si[row][c] = (col_ok && gi < T) ? S[(size_t)gi * d + c0 + c] : 0.f;
      xj[row][c] = (col_ok && gj < T) ? X[(size_t)gj * d + c0 + c] : 0.f;
      sj[row][c] = (col_ok && gj < T) ? S[(size_t)gj * d + c0 + c] : 0.f;
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
    __syncthreads();
  }
  double acc = 0.0;
  const float c1 = -4.f * b * (b + 1.f), c2 = 2.f * b;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gi = i0 + ty + kT * u, gj = j0 + tx + kT * v;
      if (gi < T && gj < T) {
        const float base = 1.f + r[u][v];
        const float term = c1 * r[u][v] / powf(base, b + 2.f) +
                           c2 * ((float)d + cross[u][v]) / powf(base, b + 1.f) +
                           ss[u][v] / powf(base, b);
        acc += (double)term;
      }
    }
  block_store_sum(acc, partials + (size_t)blockIdx.y * gridDim.x + blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
rbf_tile_kernel(const float* __restrict__ A, int Ta, const float* __restrict__ Bm, int Tb,
                int d, float inv2s2, double* __restrict__ partials) {
  __shared__ float ai[kTile][kPad], bj[kTile][kPad];
  const int tid = threadIdx.x, ty = tid / kT, tx = tid % kT;
  const int i0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  float r[4][4] = {};
  for (int c0 = 0; c0 < d; c0 += kDC) {
    const int dc = min(kDC, d - c0);
    for (int idx = tid; idx < kTile * kDC; idx += kThreads) {
      const int row = idx / kDC, c = idx % kDC;
      const bool col_ok = c < dc;
      ai[row][c] = (col_ok && i0 + row < Ta) ? A[(size_t)(i0 + row) * d + c0 + c] : 0.f;
      bj[row][c] = (col_ok && j0 + row < Tb) ? Bm[(size_t)(j0 + row) * d + c0 + c] : 0.f;
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
          r[u][v] = fmaf(diff, diff, r[u][v]);
        }
    }
    __syncthreads();
  }
  double acc = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int gi = i0 + ty + kT * u, gj = j0 + tx + kT * v;
      if (gi < Ta && gj < Tb) acc += (double)expf(-r[u][v] * inv2s2);
    }
  block_store_sum(acc, partials + (size_t)blockIdx.y * gridDim.x + blockIdx.x);
}

// One block: per-thread strided sums, then a tree -- the same order on
// every run.
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const double* __restrict__ partials, int n, double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  block_store_sum(acc, out);
}

inline dim3 tile_grid(int ta, int tb) {
  return dim3((ta + kTile - 1) / kTile, (tb + kTile - 1) / kTile);
}

}  // namespace

MFM_EXPORT int mfm_pairwise_tile() { return kTile; }

MFM_EXPORT int mfm_stein_partials(const float* X, const float* S, int T, int d, float b,
                                  double* partials, cudaStream_t stream) {
  if (T <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stein_tile_kernel<<<tile_grid(T, T), kThreads, 0, stream>>>(X, S, T, d, b, partials);
  return mfm_last_error();
}

MFM_EXPORT int mfm_rbf_partials(const float* A, int Ta, const float* Bm, int Tb, int d,
                                float inv2s2, double* partials, cudaStream_t stream) {
  if (Ta <= 0 || Tb <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rbf_tile_kernel<<<tile_grid(Ta, Tb), kThreads, 0, stream>>>(A, Ta, Bm, Tb, d, inv2s2,
                                                               partials);
  return mfm_last_error();
}

MFM_EXPORT int mfm_reduce_sum(const double* partials, int n, double* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  reduce_kernel<<<1, kThreads, 0, stream>>>(partials, n, out);
  return mfm_last_error();
}
