// K3: the phi^4 lattice log-likelihood and its score, in one pass.
//
// Replaces mfm_tpu/ops/phi_four_pallas.py::phi_four_log_lik (kernel body
// _phi4_kernel). Per row x (d sites), with c = a d:
//   log_lik = -beta (U + V),  V = sum_i (1 - x_i^2)^2 / (4c),
//   U = (c/2) sum of squared first differences, the ends held at bc_value
//       (Dirichlet) or wrapped (periodic);
//   score_i = -beta [-x_i (1 - x_i^2) / c + c (2 x_i - x_{i-1} - x_{i+1})]
// with the same boundary neighbours. The score is what MALA consumes with
// the value; the TPU kernel returns the value only, and pads the batch to
// 256-row tiles with a (B, 8) output for Mosaic's layout rules. Here the
// output is (B,) and nothing is padded.
//
// One warp per row: the lanes stride over the sites, read both neighbours
// through L1 (the row is read once from device memory), and reduce U and V
// with fp32 warp shuffles. What bounds it on an H100: memory, 4 bytes read
// and (with the score) 4 written per site for ~15 flops; at the slice's
// (1024, 64) it moves 0.5 MB and is bound by the launch itself.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // one warp each
constexpr int kThreads = 32 * kRowsPerBlock;

__global__ void __launch_bounds__(kThreads)
phi_four_kernel(const float* __restrict__ x, int B, int d, float coef, float inv4c,
                float beta, int pbc, float bc, float* __restrict__ value,
                float* __restrict__ score) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  const float* xr = x + (size_t)row * d;
  float* sr = score ? score + (size_t)row * d : nullptr;
  float u = 0.f, v = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float xi = xr[i];
    const float left = i > 0 ? xr[i - 1] : (pbc ? xr[d - 1] : bc);
    const float right = i < d - 1 ? xr[i + 1] : (pbc ? xr[0] : bc);
    const float w = 1.f - xi * xi;
    v = fmaf(w, w, v);
    const float dr = right - xi;  // each difference once, as the right one
    u = fmaf(dr, dr, u);
    if (i == 0 && !pbc) {  // Dirichlet: the left end's difference too
      const float dl = xi - bc;
      u = fmaf(dl, dl, u);
    }
    if (sr) sr[i] = -beta * (-xi * w / coef + coef * (2.f * xi - left - right));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, off);
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (lane == 0) value[row] = -beta * (0.5f * coef * u + v * inv4c);
}

}  // namespace

MFM_EXPORT int mfm_phi_four(const float* x, int B, int d, float coef, float inv4c, float beta,
                            int pbc, float bc, float* value, float* score,
                            cudaStream_t stream) {
  if (B <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  phi_four_kernel<<<blocks, kThreads, 0, stream>>>(x, B, d, coef, inv4c, beta, pbc, bc, value,
                                                   score);
  return mfm_last_error();
}
