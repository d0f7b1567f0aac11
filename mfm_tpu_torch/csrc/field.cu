// K1: fused vector-field apply with a batch of x-tangents.
//
// Replaces mfm_tpu/ops/field_pallas.py::_pallas_apply (kernel body _forward).
// One launch evaluates the whole VectorFieldNet MLP for a tile of rows --
// Fourier features, t-trunk, x-trunk, joint trunk, gate and field heads --
// and pushes K x-tangents through the same weights:
//   field = MLP(x, t), gate = gate_head(t-trunk), dfield[k] = dMLP/dx . ex[k].
// The score gate stays outside (the wrapper adds gate * clip(score)).
//
// Layout. The weights arrive packed in one fp32 buffer in the order of
// field_pallas.split_params, each matrix (in, out) row-major; meta holds
// each layer's offsets and sizes. Block (bx, by) takes rows
// [bx*TB, bx*TB+TB) and tangents [by*KC, by*KC+KC): its activation buffer
// holds TB primal rows followed by KC*TB tangent rows (tangent kc of row r
// at TB + kc*TB + r), so each layer is ONE product of an (R, in) tile with
// the layer's weights, R = TB*(1+KC). The epilogue writes act(z) for the
// primal rows and keeps act'(z); the tangent rows get act'(z) * (dh @ W).
// The split first layers of the TPU kernel (cos/sin, x/t) need no special
// case for the t-trunk -- [cos | sin] sits in one shared-memory row -- and
// the joint layer's t-half is a second product over the primal rows only
// (tangents carry no t component).
//
// What bounds it on an H100. Per row the phi-four field (d=64, widths 128,
// F=128) costs ~0.14 MFLOP-pairs primal and ~0.065 per tangent: with 64
// tangents, ~8.6 GFLOP per call at B=1024, against ~0.56 MB of weights.
// It is arithmetic bound. This version runs the products on the fp32 FMA
// pipes from shared memory (no tensor cores: the reference is exact fp32),
// each thread holding a 5x8 register tile, weights staged through shared
// memory 32 rows at a time from L2. wgmma/TF32 variants are later work.

#include <cuda_runtime.h>
#include <math.h>

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxLayers = 16;
constexpr int kThreads = 256;
constexpr int kTY = 16, kTX = 16;  // thread grid within a block
constexpr int kRM = 5;             // rows per thread: ty + 16*i -> R <= 80
constexpr int kNM = 8;             // cols per thread: tx + 16*j -> N <= 128
constexpr int kMaxRows = kTY * kRM;
constexpr int kMaxN = kTX * kNM;
constexpr int kKT = 32;            // weight rows staged per chunk
constexpr float kTwoPi = 6.283185307179586f;

// Plain ints only, in this order: the Python side fills it as an int array.
struct FieldMeta {
  int n_t, n_x, n_xt;   // layers per trunk; the joint first layer is xt[0]
  int F, d, act;        // act: 0 relu, 1 tanh
  int wt_off, ht;       // joint first layer: offset and rows of its t-half
  int max_w, max_t;     // widest row of the x/joint and t activations
  // per layer, in order t-trunk, x-trunk, xt-trunk, gate, field
  int w_off[kMaxLayers], b_off[kMaxLayers], k_in[kMaxLayers], n_out[kMaxLayers];
};

__device__ __forceinline__ float act_fn(float z, int act) {
  return act == 0 ? fmaxf(z, 0.f) : tanhf(z);
}

__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == 0) return z > 0.f ? 1.f : 0.f;
  const float th = tanhf(z);
  return 1.f - th * th;
}

// acc (+)= in[0:rows, 0:K] @ W[0:K, 0:N]; rows beyond `rows` contribute 0.
__device__ __forceinline__ void gemm_tile(float (&acc)[kRM][kNM], const float* in,
                                          int ld_in, int rows, int K,
                                          const float* __restrict__ W, int N,
                                          float* ws, bool accumulate) {
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  if (!accumulate) {
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kNM; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < K; k0 += kKT) {
    const int kt = min(kKT, K - k0);
    for (int idx = tid; idx < kt * N; idx += kThreads) ws[idx] = W[k0 * N + idx];
    __syncthreads();
    for (int kk = 0; kk < kt; ++kk) {
      float a[kRM], b[kNM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = ty + kTY * i;
        a[i] = r < rows ? in[r * ld_in + k0 + kk] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kNM; ++j) {
        const int n = tx + kTX * j;
        b[j] = n < N ? ws[kk * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < kNM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// t-trunk epilogue: primal rows only.
__device__ __forceinline__ void epilogue_act(const float (&acc)[kRM][kNM], int TB, int N,
                                             const float* __restrict__ bias, float* out,
                                             int ld, int act) {
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kNM; ++j) {
      const int r = ty + kTY * i, n = tx + kTX * j;
      if (r < TB && n < N) out[r * ld + n] = act_fn(acc[i][j] + bias[n], act);
    }
  __syncthreads();
}

// Hidden layer with tangents: primal rows first (they leave act'(z) in dz),
// then the tangent rows scale their product by it.
__device__ __forceinline__ void epilogue_hidden(const float (&acc)[kRM][kNM], int R, int TB,
                                                int N, const float* __restrict__ bias,
                                                float* out, float* dz, int ld, int act) {
  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kNM; ++j) {
      const int r = ty + kTY * i, n = tx + kTX * j;
      if (r < TB && n < N) {
        const float z = acc[i][j] + bias[n];
        dz[r * ld + n] = act_grad(z, act);
        out[r * ld + n] = act_fn(z, act);
      }
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kNM; ++j) {
      const int r = ty + kTY * i, n = tx + kTX * j;
      if (r >= TB && r < R && n < N) out[r * ld + n] = dz[((r - TB) % TB) * ld + n] * acc[i][j];
    }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
field_kernel(const FieldMeta m, const float* __restrict__ P, const float* __restrict__ freqs,
             const float* __restrict__ x, const float* __restrict__ t,
             const float* __restrict__ ex, float* __restrict__ field,
             float* __restrict__ gate, float* __restrict__ dfield, int B, int K, int TB,
             int KC) {
  extern __shared__ float smem[];
  const int ld_t = m.max_t + 1, ld_x = m.max_w + 1;  // +1: no bank conflicts
  const int R = TB * (1 + KC);
  float* tb0 = smem;
  float* tb1 = tb0 + TB * ld_t;
  float* xa = tb1 + TB * ld_t;
  float* xb = xa + R * ld_x;
  float* dz = xb + R * ld_x;
  float* ws = dz + TB * ld_x;

  const int tid = threadIdx.x, ty = tid / kTX, tx = tid % kTX;
  const int row0 = blockIdx.x * TB, k0 = blockIdx.y * KC;
  const int d = m.d, F = m.F;

  // Fourier features [cos | sin](2 pi t f) for the primal rows
  for (int idx = tid; idx < TB * 2 * F; idx += kThreads) {
    const int r = idx / (2 * F), f = idx % (2 * F), row = row0 + r;
    const float tv = row < B ? t[row] : 0.f;
    const float ang = (kTwoPi * tv) * freqs[f < F ? f : f - F];
    tb0[r * ld_t + f] = f < F ? cosf(ang) : sinf(ang);
  }
  for (int idx = tid; idx < TB * d; idx += kThreads) {
    const int r = idx / d, c = idx % d, row = row0 + r;
    xa[r * ld_x + c] = row < B ? x[(size_t)row * d + c] : 0.f;
  }
  for (int idx = tid; idx < TB * KC * d; idx += kThreads) {
    const int q = idx / d, c = idx % d;
    const int k = k0 + q / TB, row = row0 + q % TB;
    xa[(TB + q) * ld_x + c] = (k < K && row < B) ? ex[((size_t)k * B + row) * d + c] : 0.f;
  }
  __syncthreads();

  float acc[kRM][kNM];
  int L = 0;

  // t-trunk (primal rows only)
  float* t_in = tb0;
  float* t_out = tb1;
  for (int l = 0; l < m.n_t; ++l, ++L) {
    gemm_tile(acc, t_in, ld_t, TB, m.k_in[L], P + m.w_off[L], m.n_out[L], ws, false);
    epilogue_act(acc, TB, m.n_out[L], P + m.b_off[L], t_out, ld_t, m.act);
    float* tmp = t_in; t_in = t_out; t_out = tmp;
  }
  const float* h_t = t_in;

  // x-trunk, then the joint trunk, primal and tangent rows together
  float* x_in = xa;
  float* x_out = xb;
  for (int l = 0; l < m.n_x + m.n_xt; ++l, ++L) {
    gemm_tile(acc, x_in, ld_x, R, m.k_in[L], P + m.w_off[L], m.n_out[L], ws, false);
    if (l == m.n_x)  // joint first layer: + h_t @ W_t on the primal rows
      gemm_tile(acc, h_t, ld_t, TB, m.ht, P + m.wt_off, m.n_out[L], ws, true);
    epilogue_hidden(acc, R, TB, m.n_out[L], P + m.b_off[L], x_out, dz, ld_x, m.act);
    float* tmp = x_in; x_in = x_out; x_out = tmp;
  }

  // gate head from the t-trunk (written once, by the first tangent block)
  if (blockIdx.y == 0) {
    gemm_tile(acc, h_t, ld_t, TB, m.k_in[L], P + m.w_off[L], d, ws, false);
    const float* bg = P + m.b_off[L];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kNM; ++j) {
        const int r = ty + kTY * i, n = tx + kTX * j;
        if (r < TB && n < d && row0 + r < B) gate[(size_t)(row0 + r) * d + n] = acc[i][j] + bg[n];
      }
  }
  ++L;

  // field head: field on the primal rows, dfield on the tangent rows
  gemm_tile(acc, x_in, ld_x, R, m.k_in[L], P + m.w_off[L], d, ws, false);
  const float* bf = P + m.b_off[L];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kNM; ++j) {
      const int r = ty + kTY * i, n = tx + kTX * j;
      if (n >= d || r >= R) continue;
      if (r < TB) {
        if (blockIdx.y == 0 && row0 + r < B) field[(size_t)(row0 + r) * d + n] = acc[i][j] + bf[n];
      } else {
        const int q = r - TB, k = k0 + q / TB, row = row0 + q % TB;
        if (k < K && row < B) dfield[((size_t)k * B + row) * d + n] = acc[i][j];
      }
    }
}

}  // namespace

MFM_EXPORT int mfm_field_apply(const float* packed, const int* meta_host, const float* freqs,
                               const float* x, const float* t, const float* ex, float* field,
                               float* gate, float* dfield, int B, int K, int TB, int KC,
                               cudaStream_t stream) {
  FieldMeta m;
  static_assert(sizeof(FieldMeta) == sizeof(int) * (10 + 4 * kMaxLayers), "int-only struct");
  memcpy(&m, meta_host, sizeof(FieldMeta));
  const int n_layers = m.n_t + m.n_x + m.n_xt + 2;
  const int R = TB * (1 + KC);
  bool ok = n_layers <= kMaxLayers && m.n_xt >= 1 && R <= kMaxRows && TB >= 1 && KC >= 0 &&
            (K == 0) == (KC == 0) && B > 0;
  for (int l = 0; ok && l < n_layers; ++l) ok = m.n_out[l] <= kMaxN;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * (size_t)TB * (m.max_t + 1) +
                                       (2 * (size_t)R + TB) * (m.max_w + 1) + kKT * kMaxN);
  cudaError_t err =
      cudaFuncSetAttribute(field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB, K > 0 ? (K + KC - 1) / KC : 1);
  field_kernel<<<grid, kThreads, smem, stream>>>(m, packed, freqs, x, t, ex, field, gate,
                                                  dfield, B, K, TB, KC);
  return mfm_last_error();
}

MFM_EXPORT const char* mfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
