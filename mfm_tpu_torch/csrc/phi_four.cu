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
//
// The second kernel, phi_four_score_gate_kernel, is the score gate of one
// RK4 stage of a transport with its x-tangents, in one pass. It replaces,
// on the transport's path, the score-gate term of jax.jvp of the
// reference's VectorFieldNet.apply (mfm_tpu/flows/cnf.py:72 with
// score_fn=target.score, mfm_tpu/drivers/mfm.py:142-143): the score above
// and its derivative H e. For x, gate, field (B, d) and ex, dfield
// (K, B, d), in place:
//   field     += gate * clip(s),
//   dfield[k] += gate * m * (H ex[k]),   m = (-clip < s < clip),
// s the score plus the tilt's beta lam (val - mean x) / (2 d^2), and
//   H e = -beta [(3 x^2 - 1)/c e + c (2e - e_l - e_r)] - beta lam / (2 d^3) sum e,
// the tangent's neighbours 0 beyond a Dirichlet end, wrapped when periodic.
// Without a clip, m = 1 and nothing is clamped.
//
// What bounds it on an H100: bytes. At B=1024, d=64, K=64 it reads ex and
// dfield and writes dfield (50.3 MB, plus 1 MB of x, gate and field) for
// ~10 operations a site: 0.015 ms at 3.35 TB/s. The design:
// - a segment of S lanes (the power of two that covers the row's d/V
//   vectors, at most a warp) owns one row; lane l holds the vectors
//   l + c S (c < NV) of V = 4 sites (V = 1 when d is not a multiple of 4
//   or a pointer is not 16-byte aligned), so that every load and store is
//   16 bytes and a segment's are coalesced;
// - the row's coefficients (gate * m, and gate * m times H's diagonal) are
//   computed once per block from x and gate and stay in registers for all
//   of the block's tangents;
// - the neighbours across a vector's edge come from warp shuffles of the
//   adjacent lane (or chunk), never from a second read; the tilt's row sum
//   is a segmented xor reduction;
// - the grid is (row groups) x (tangent chunks), about 1024 blocks of 256
//   threads, so that every SM holds several; the blocks of the first chunk
//   also write field. Every output element has one writer: no atomics.
// A row wider than 8 such chunks (d > 1024, or d > 256 with V = 1) goes to
// phi_four_score_gate_wide_kernel instead: one warp a row, the lanes
// striding over the sites and reading the neighbours through L1, a site's
// coefficients recomputed from x and gate for every tangent. Same grid,
// same single writer.

#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int kGateThreads = 256;
constexpr int kGateTargetBlocks = 1024;
constexpr int kGateMaxChunks = 8;  // NV: d <= 1024 with V = 4, d <= 256 with V = 1; wider
                                   // rows take the wide kernel
constexpr unsigned kFull = 0xffffffffu;

struct GateArgs {
  const float* x;
  const float* gate;
  float* field;
  const float* ex;
  float* dfield;
  int B, d, K, seg, kc, pbc, has_clip;
  float coef, beta, bc, lam_g, lam_h, val, clip;
};

template <int V>
__device__ __forceinline__ void load_ro(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_rw(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

__device__ __forceinline__ float seg_sum(float v, int S) {
  for (int off = S >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, S);
  return v;
}

// One site of the gate: returns gate * clip(s) for the field and sets gm =
// gate * m and pa = gm times H's diagonal, for the site's tangents. xl and
// xr are its neighbours, off the row's val - mean x.
__device__ __forceinline__ float gate_site(const GateArgs& a, float xl, float xi, float xr,
                                           float off, float g, float& gm, float& pa) {
  const float w = 1.f - xi * xi;
  const float s = -a.beta * (-xi * w / a.coef + a.coef * (2.f * xi - xl - xr)) + a.lam_g * off;
  float clipped = s;
  bool inside = true;
  if (a.has_clip) {
    inside = s > -a.clip && s < a.clip;
    clipped = s < -a.clip ? -a.clip : (s > a.clip ? a.clip : s);
  }
  gm = inside ? g : 0.f;
  pa = -a.beta * gm * ((3.f * xi * xi - 1.f) / a.coef + 2.f * a.coef);
  return g * clipped;
}

// The site before each chunk's first and the site after its last, for a
// row held as v[c][.] by the S lanes of a segment (lane sl holds vector
// c S + sl of the row's nvr): the neighbouring lane's, the neighbouring
// chunk's, or the boundary's (bnd beyond a Dirichlet end, the row's other
// end when periodic). Every lane runs every shuffle.
template <int V, int NV>
__device__ __forceinline__ void halo(const float (&v)[NV][V], int S, int sl, int nvr, int pbc,
                                     float bnd, float (&left)[NV], float (&right)[NV]) {
  const int last = nvr - 1;
  float row_first = bnd, row_last = bnd;
  if (pbc) {
    row_first = __shfl_sync(kFull, v[0][0], 0, S);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float t = __shfl_sync(kFull, v[c][V - 1], last & (S - 1), S);
      if (c == last / S) row_last = t;
    }
  }
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const float up = __shfl_sync(kFull, v[c][V - 1], (sl + S - 1) & (S - 1), S);
    const float dn = __shfl_sync(kFull, v[c][0], (sl + 1) & (S - 1), S);
    float prev = 0.f, next = 0.f;
    if (c > 0) prev = __shfl_sync(kFull, v[c - 1][V - 1], S - 1, S);
    if (c + 1 < NV) next = __shfl_sync(kFull, v[c + 1][0], 0, S);
    const int j = c * S + sl;
    left[c] = j == 0 ? row_last : (sl == 0 ? prev : up);
    right[c] = j == last ? row_first : (sl == S - 1 ? next : dn);
  }
}

template <int V, int NV>
__global__ void __launch_bounds__(kGateThreads) phi_four_score_gate_kernel(const GateArgs a) {
  constexpr int KU = NV >= 4 ? 1 : 4 / NV;  // tangents whose loads are in flight together
  const int S = a.seg;
  const int sl = threadIdx.x & (S - 1);
  const int row = blockIdx.x * (kGateThreads / S) + threadIdx.x / S;
  const int nvr = a.d / V;
  const bool live = row < a.B;
  const size_t roff = static_cast<size_t>(row) * a.d;

  bool ok[NV];
  float xv[NV][V], gv[NV][V];
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int j = c * S + sl;
    ok[c] = live && j < nvr;
#pragma unroll
    for (int q = 0; q < V; ++q) xv[c][q] = gv[c][q] = 0.f;
    if (ok[c]) {
      load_ro<V>(a.x + roff + j * V, xv[c]);
      load_ro<V>(a.gate + roff + j * V, gv[c]);
    }
  }
  float left[NV], right[NV];
  halo<V, NV>(xv, S, sl, nvr, a.pbc, a.bc, left, right);
  float xsum = 0.f;
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int q = 0; q < V; ++q) xsum += xv[c][q];
  const float off = a.val - seg_sum(xsum, S) / a.d;

  // per site, for every tangent: gm = gate * m, pa = gm * (H's diagonal)
  float gm[NV][V], pa[NV][V];
  const bool writes_field = blockIdx.y == 0;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float* fp = a.field + roff + (c * S + sl) * V;
    float f[V];
#pragma unroll
    for (int q = 0; q < V; ++q) f[q] = 0.f;
    if (writes_field && ok[c]) load_rw<V>(fp, f);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float xl = q == 0 ? left[c] : xv[c][q > 0 ? q - 1 : 0];
      const float xr = q == V - 1 ? right[c] : xv[c][q < V - 1 ? q + 1 : 0];
      f[q] += gate_site(a, xl, xv[c][q], xr, off, gv[c][q], gm[c][q], pa[c][q]);
    }
    if (writes_field && ok[c]) store<V>(fp, f);
  }
  if (a.K == 0) return;

  const float bn = a.beta * a.coef;  // H's neighbour coefficient
  const int k0 = blockIdx.y * a.kc;
  const int k1 = min(a.K, k0 + a.kc);
  for (int k = k0; k < k1; k += KU) {
    float ev[KU][NV][V], dv[KU][NV][V];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const size_t o = (static_cast<size_t>(k + u) * a.B + row) * a.d + (c * S + sl) * V;
#pragma unroll
        for (int q = 0; q < V; ++q) ev[u][c][q] = dv[u][c][q] = 0.f;
        if (k + u < k1 && ok[c]) {
          load_ro<V>(a.ex + o, ev[u][c]);
          load_rw<V>(a.dfield + o, dv[u][c]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      halo<V, NV>(ev[u], S, sl, nvr, a.pbc, 0.f, left, right);
      float esum = 0.f;
      if (a.lam_h != 0.f) {
#pragma unroll
        for (int c = 0; c < NV; ++c)
#pragma unroll
          for (int q = 0; q < V; ++q) esum += ev[u][c][q];
        esum = seg_sum(esum, S);
      }
      const float tilt = a.lam_h * esum;
#pragma unroll
      for (int c = 0; c < NV; ++c) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float e = ev[u][c][q];
          const float el = q == 0 ? left[c] : ev[u][c][q > 0 ? q - 1 : 0];
          const float er = q == V - 1 ? right[c] : ev[u][c][q < V - 1 ? q + 1 : 0];
          dv[u][c][q] += pa[c][q] * e + gm[c][q] * (bn * (el + er) - tilt);
        }
        if (k + u < k1 && ok[c]) {
          const size_t o = (static_cast<size_t>(k + u) * a.B + row) * a.d + (c * S + sl) * V;
          store<V>(a.dfield + o, dv[u][c]);
        }
      }
    }
  }
}

// Site i's neighbours in row r (d sites): bnd beyond a Dirichlet end, the
// row's other end when periodic.
__device__ __forceinline__ void neighbours(const float* r, int i, int d, int pbc, float bnd,
                                           float& left, float& right) {
  left = i > 0 ? __ldg(r + i - 1) : (pbc ? __ldg(r + d - 1) : bnd);
  right = i < d - 1 ? __ldg(r + i + 1) : (pbc ? __ldg(r) : bnd);
}

__global__ void __launch_bounds__(kGateThreads)
phi_four_score_gate_wide_kernel(const GateArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kGateThreads / 32) + (threadIdx.x >> 5);
  if (row >= a.B) return;  // the whole warp leaves together
  const int d = a.d;
  const size_t roff = static_cast<size_t>(row) * d;
  const float* xr = a.x + roff;
  const float* gr = a.gate + roff;
  float xsum = 0.f;
  for (int i = lane; i < d; i += 32) xsum += __ldg(xr + i);
  const float off = a.val - seg_sum(xsum, 32) / d;
  float gm, pa, xl, xrt;
  if (blockIdx.y == 0) {
    for (int i = lane; i < d; i += 32) {
      neighbours(xr, i, d, a.pbc, a.bc, xl, xrt);
      a.field[roff + i] += gate_site(a, xl, __ldg(xr + i), xrt, off, __ldg(gr + i), gm, pa);
    }
  }
  const float bn = a.beta * a.coef;  // H's neighbour coefficient
  const int k0 = blockIdx.y * a.kc;
  const int k1 = min(a.K, k0 + a.kc);
  for (int k = k0; k < k1; ++k) {
    const size_t o = (static_cast<size_t>(k) * a.B + row) * d;
    const float* er = a.ex + o;
    float* dr = a.dfield + o;
    float tilt = 0.f;
    if (a.lam_h != 0.f) {
      float esum = 0.f;
      for (int i = lane; i < d; i += 32) esum += __ldg(er + i);
      tilt = a.lam_h * seg_sum(esum, 32);
    }
    for (int i = lane; i < d; i += 32) {
      float el, ert;
      neighbours(xr, i, d, a.pbc, a.bc, xl, xrt);
      neighbours(er, i, d, a.pbc, 0.f, el, ert);
      gate_site(a, xl, __ldg(xr + i), xrt, off, __ldg(gr + i), gm, pa);
      dr[i] += pa * __ldg(er + i) + gm * (bn * (el + ert) - tilt);
    }
  }
}

template <int V, int NV>
int launch_score_gate(const GateArgs& a, dim3 grid, cudaStream_t stream) {
  phi_four_score_gate_kernel<V, NV><<<grid, kGateThreads, 0, stream>>>(a);
  return mfm_last_error();
}

template <int V>
int dispatch_score_gate(const GateArgs& a, int nv, dim3 grid, cudaStream_t stream) {
  switch (nv) {
    case 1: return launch_score_gate<V, 1>(a, grid, stream);
    case 2: return launch_score_gate<V, 2>(a, grid, stream);
    case 4: return launch_score_gate<V, 4>(a, grid, stream);
    case 8: return launch_score_gate<V, 8>(a, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// ex and dfield may be NULL when K = 0.
MFM_EXPORT int mfm_phi_four_score_gate(const float* x, const float* gate, float* field,
                                       const float* ex, float* dfield, int B, int d, int K,
                                       float coef, float beta, int pbc, float bc,
                                       float tilt_lambda, float tilt_val, int has_clip,
                                       float clip, cudaStream_t stream) {
  if (B <= 0 || d <= 0 || K < 0 || (K > 0 && (ex == nullptr || dfield == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gate) |
                   reinterpret_cast<uintptr_t>(field);
  if (K > 0) addr |= reinterpret_cast<uintptr_t>(ex) | reinterpret_cast<uintptr_t>(dfield);
  const int V = (d % 4 == 0 && (addr & 15) == 0) ? 4 : 1;
  const int nvr = d / V;
  int seg = 1;
  while (seg < nvr && seg < 32) seg <<= 1;
  int nv = 1;
  while (nv * seg < nvr) nv <<= 1;
  const bool wide = nv > kGateMaxChunks;  // one warp a row, striding
  if (wide) seg = 32;

  const int rows_per_block = kGateThreads / seg;
  const int row_blocks = (B + rows_per_block - 1) / rows_per_block;
  // tangents per block: about kGateTargetBlocks blocks, a multiple of KU
  int kc = 0, chunks = 1;
  if (K > 0) {
    const int ku = wide || nv >= 4 ? 1 : 4 / nv;  // the kernel's KU
    const int want = kGateTargetBlocks / row_blocks;
    chunks = want < 1 ? 1 : (want > K ? K : want);
    kc = (K + chunks - 1) / chunks;
    kc = (kc + ku - 1) / ku * ku;
    chunks = (K + kc - 1) / kc;
  }
  const float df = static_cast<float>(d);
  GateArgs a{x, gate, field, ex, dfield, B, d, K, seg, kc, pbc, has_clip,
             coef, beta, bc, beta * tilt_lambda / (2.f * df * df),
             beta * tilt_lambda / (2.f * df * df * df), tilt_val, clip};
  const dim3 grid(row_blocks, chunks);
  if (wide) {
    phi_four_score_gate_wide_kernel<<<grid, kGateThreads, 0, stream>>>(a);
    return mfm_last_error();
  }
  return V == 4 ? dispatch_score_gate<4>(a, nv, grid, stream)
                : dispatch_score_gate<1>(a, nv, grid, stream);
}
