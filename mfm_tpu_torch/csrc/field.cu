// K1: fused vector-field apply with a batch of x-tangents.
//
// Replaces mfm_tpu/ops/field_pallas.py::_pallas_apply (kernel body _forward).
// One launch evaluates the whole VectorFieldNet MLP for a tile of rows --
// Fourier features, t-trunk, x-trunk, joint trunk, gate and field heads --
// and pushes K x-tangents through the same weights:
//   field = MLP(x, t), gate = gate_head(t-trunk), dfield[k] = dMLP/dx . ex[k].
// The score gate stays outside (the wrapper adds gate * clip(score)).
//
// What bounds it on an H100. At the phi-four slice (B=1024, d=64, widths
// 128, F=128, K=64) a row costs 139,264 multiply-adds for the primal and
// 65,536 per tangent: 8.875 GFLOP per call against ~35 MB of inputs and
// outputs (ex and dfield are 16.8 MB each). It is bound by arithmetic:
// 0.1325 ms at the fp32 FMA peak (67 TFLOP/s), 0.054 ms in three TF32
// passes on the tensor cores (495 TFLOP/s / 3), 0.010 ms for the bytes.
//
// The design.
// - Tensor cores, fp32-accurate (3xTF32). Every product is
//   mma.sync.m16n8k8 in TF32 with fp32 accumulation, taken three times:
//   each operand v is split into hi = tf32(v) and lo = tf32(v - hi), both
//   rounded to nearest, and the sum is lo*hi + hi*lo + hi*hi; the dropped
//   lo*lo term is ~2^-22 of each product. The tensor core's accumulation
//   truncates, so each k-step's three products go into a fresh fragment
//   that is added to the fp32 sum (one FADD each). Against an fp64
//   reference the kernel is then as close as cuBLAS's fp32 product (4.8e-7
//   and 6.0e-7 relative at the slice, H100 80GB HBM3); truncating splits
//   and one accumulation chain per sum gave 6.7e-6 in 16 % less time
//   (tools/field_variants.py). One TF32 pass would give ~1e-3; the
//   reference is exact fp32.
// - The primal once per row tile. Block b owns rows [8b, 8b+8). It runs the
//   t-trunk, the gate head, the x and joint trunks and the field head once
//   for its rows, keeping act'(z) of every hidden x/joint layer in shared
//   memory, then loops over the K tangents in chunks of 16: the chunk's
//   16 x 8 = 128 tangent rows are the M dimension of one product per layer,
//   and each tangent epilogue multiplies by the stored act'(z).
// - Activations resident, weights streamed. A layer's output is written
//   back into the shared-memory buffer it read (after a barrier), as the
//   next layer's A operand; it never returns to device memory. The weights
//   (0.56 MB at the slice) do not fit in shared memory: they are streamed
//   in tiles of 64 rows, double-buffered with cp.async, the copy of the
//   next tile running (across layer boundaries) while a tile is being
//   multiplied. The host builds the tile schedule (the order in which the
//   kernel consumes the matrices), which the block keeps in shared memory.
//   Each block reads the primal's weights once and the tangent weights
//   (0.25 MB) once per chunk: at the slice 128 blocks x (0.56 + 4 x 0.25)
//   MB ~ 0.2 GB from L2 per call.
// - Warps and tiles. 16 warps; a 128-row chunk with a 128-wide layer gives
//   each warp 32 x 32 outputs (2 x 4 mma tiles, 32 fp32 accumulators per
//   thread); a 64-wide head 16 x 32; a 16-row pass (the primal, or one
//   Hutchinson tangent) 16 x 8. A warp computes all its mma tiles without
//   predicates (padding rows and columns are finite and masked in the
//   epilogue): a predicated mma.sync costs a warp sync each. Shared-memory
//   strides are padded so that the fragment loads hit 32 distinct banks.
// - The grid is one block per 8 rows: 128 blocks at B=1024, one per SM (the
//   weight buffers, the 128-row chunk and act'(z) take 177 KB of shared
//   memory). 4-row tiles give 256 blocks, two waves on 132 SMs with the
//   same work per SM, twice the padded primal rows and twice the weight
//   traffic: 13 % slower (tools/field_variants.py).
// - The seed axis. S independent nets (a seed sweep, the reference's
//   pallas_call under jax.vmap) run in one launch: blockIdx.y is the seed,
//   which offsets the weights (p_stride floats a seed), the frequencies and
//   the rows (seed-major: seed s owns rows s*B ... s*B+B-1 of x and of each
//   tangent slice). A row tile never straddles two seeds, so B need not be
//   a multiple of 8; the block body is the single-seed one.
// - Measured limits (H100 80GB HBM3, 700 W): mma.sync in TF32 peaks at
//   ~314 TFLOP/s on this card (tools/field_variants.py), so the three
//   passes alone need 0.086 ms at the slice; the kernel takes ~0.27 ms.
//   The rest is the latency of each k-step's shared-memory loads and
//   splits ahead of its mma.sync calls, which 16 warps hide only in part,
//   the per-k-step FADDs, and the primal's weight tiles, each with little
//   work to hide its copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;       // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTB = 8;               // rows per block
constexpr int kKC = 16;              // tangents per chunk: 128 rows
constexpr int kKS = 64;              // weight rows per streamed tile
constexpr int kStages = 2;           // tiles in flight: double buffering
constexpr int kMaxLayers = 16;
constexpr int kMaxTiles = 144;       // primal tiles + one chunk's tiles
constexpr int kMaxSmem = 232448;     // 227 KB, the most a block may have
constexpr float kTwoPi = 6.283185307179586f;

// Plain ints only, in this order: ops/field.py builds it as an int array.
struct FieldMeta {
  int n_t, n_x, n_xt;   // layers per trunk; the joint first layer is xt[0]
  int F, d, act;        // act: 0 relu, 1 tanh
  int wt_off, ht;       // joint first layer: offset and rows of its t-half
  int lda, ldt, ldw;    // shared-memory row strides (floats)
  int n_ptiles, n_ctiles;  // weight tiles of the primal pass, of one chunk
  // per layer, in order t-trunk, x-trunk, xt-trunk, gate, field
  int w_off[kMaxLayers], b_off[kMaxLayers], k_in[kMaxLayers], n_out[kMaxLayers];
  // weight tiles in the order the kernel consumes them: the primal pass,
  // then one tangent chunk (repeated for every chunk). Tile i is rows
  // [0, tile_rows[i]) of a (., tile_n[i]) row-major slice at tile_off[i].
  int tile_off[kMaxTiles], tile_rows[kMaxTiles], tile_n[kMaxTiles];
};

__device__ __forceinline__ float act_fn(float z, int act) {
  return act == 0 ? fmaxf(z, 0.f) : tanhf(z);
}

__device__ __forceinline__ float act_grad(float z, int act) {
  if (act == 0) return z > 0.f ? 1.f : 0.f;
  const float th = tanhf(z);
  return 1.f - th * th;
}

// The weight ring: tile u lives in slot u % kStages. The schedule's tile
// descriptors are copied to shared memory once (reading a kernel parameter
// at a varying index is slow); `next` walks them, wrapping from the last
// tile of a chunk to the chunk's first.
struct Pipe {
  float* ring;
  const int4* tiles;  // (offset, rows, n, -) per tile of the schedule
  const float* P;
  int issued, used, total, next;
  bool aligned;  // P is 16-byte aligned
};

__device__ __forceinline__ float* ring_slot(const Pipe& p, const FieldMeta& m, int u) {
  return p.ring + (u % kStages) * (kKS * m.ldw);
}

// Starts the copy of the next tile of the schedule (rows past the tile's
// end, up to a multiple of 8, are zero-filled), and always commits a group
// so that the wait count below stays uniform.
__device__ __forceinline__ void pipe_issue(Pipe& p, const FieldMeta& m) {
  if (p.issued < p.total) {
    const int4 tile = p.tiles[p.next];
    p.next = p.next + 1 < m.n_ptiles + m.n_ctiles ? p.next + 1 : m.n_ptiles;
    const int off = tile.x, kt = tile.y, N = tile.z, ldw = m.ldw;
    const int rows = (kt + 7) & ~7;
    const float* src = p.P + off;
    float* dst = ring_slot(p, m, p.issued);
    const int n4 = N >> 2;
    if (p.aligned && (off & 3) == 0 && (N & 3) == 0 && kThreads % n4 == 0) {
      // 16-byte copies; thread i takes column 4 * (i % n4) of every
      // (kThreads / n4)-th row
      const int step = kThreads / n4, c = (threadIdx.x % n4) << 2;
      for (int r = threadIdx.x / n4; r < rows; r += step)
        cp_async16(dst + r * ldw + c, r < kt ? src + r * N + c : src, r < kt);
    } else {
      for (int i = threadIdx.x; i < rows * N; i += kThreads) {
        const int r = i / N, c = i - r * N;
        cp_async4(dst + r * ldw + c, r < kt ? src + r * N + c : src, r < kt);
      }
    }
  }
  cp_async_commit();
  ++p.issued;
}

// The next tile, landed and visible to every thread; the slot of the tile
// before it (which every thread has finished with) takes the next copy.
__device__ __forceinline__ const float* pipe_acquire(Pipe& p, const FieldMeta& m) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  pipe_issue(p, m);
  return ring_slot(p, m, p.used++);
}

// acc += A @ W over K, W streamed through the pipe (ceil(K / kKS) tiles).
// Warp w owns the mma tiles [mt0, mt0+MTW) x [nt0, nt0+NTW) and computes
// all of them if it owns any valid one: tiles past the valid rows or
// columns read finite padding (every buffer is zeroed once and only ever
// holds finite values) and their outputs are dropped by the epilogue.
// No predicate inside the loop, so the mma.sync calls stay unconditional.
// Every thread takes part in every acquire.
template <int MTW, int NTW, int WN>
__device__ __forceinline__ void mma_gemm(float (&acc)[MTW][NTW][4], Pipe& p, const FieldMeta& m,
                                         const float* A, int lda, int K, int m_tiles,
                                         int n_tiles) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mt0 = (warp / WN) * MTW, nt0 = (warp % WN) * NTW;
  const bool active = mt0 < m_tiles && nt0 < n_tiles;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    const float* W = pipe_acquire(p, m);
    if (!active) continue;
    const int steps = (min(kKS, K - k0) + 7) >> 3;
    const float* a0 = A + (mt0 * 16 + g) * lda + k0 + q;
    const float* w0 = W + q * m.ldw + nt0 * 8 + g;
    for (int s = 0; s < steps; ++s, a0 += 8, w0 += 8 * m.ldw) {
      uint32_t ah[MTW][4], al[MTW][4], bh[NTW][2], bl[NTW][2];
#pragma unroll
      for (int i = 0; i < MTW; ++i) {
        const float* a = a0 + i * 16 * lda;
        split_tf32(a[0], ah[i][0], al[i][0]);
        split_tf32(a[8 * lda], ah[i][1], al[i][1]);
        split_tf32(a[4], ah[i][2], al[i][2]);
        split_tf32(a[8 * lda + 4], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        split_tf32(w0[j * 8], bh[j][0], bl[j][0]);
        split_tf32(w0[j * 8 + 4 * m.ldw], bh[j][1], bl[j][1]);
      }
      // lo*hi + hi*lo + hi*hi of one k-step in a zeroed fragment, added
      // to the fp32 sum: the tensor core's own accumulation truncates, so
      // its chains are kept three products long
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al[i], bh[j][0], bh[j][1]);
          mma_tf32(t, ah[i], bl[j][0], bl[j][1]);
          mma_tf32(t, ah[i], bh[j][0], bh[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
    }
  }
}

// One layer: A @ W (+ A2 @ W2 when K2 > 0), a barrier (every warp has read
// A, so the epilogue may overwrite it), then epi(row, col, value) for every
// output inside the 16*m_tiles x N block.
template <int MTW, int NTW, int WN, class Epi>
__device__ __forceinline__ void layer(Pipe& p, const FieldMeta& m, const float* A, int lda, int K,
                                      const float* A2, int lda2, int K2, int N, int m_tiles,
                                      Epi epi) {
  float acc[MTW][NTW][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int n_tiles = (N + 7) >> 3;
  mma_gemm<MTW, NTW, WN>(acc, p, m, A, lda, K, m_tiles, n_tiles);
  if (K2 > 0) mma_gemm<MTW, NTW, WN>(acc, p, m, A2, lda2, K2, m_tiles, n_tiles);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mt0 = (warp / WN) * MTW, nt0 = (warp % WN) * NTW;
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      if (mt0 + i >= m_tiles || nt0 + j >= n_tiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (mt0 + i) * 16 + g + (e >> 1) * 8;
        const int c = (nt0 + j) * 8 + 2 * q + (e & 1);
        if (c < N) epi(r, c, acc[i][j][e]);
      }
    }
}

// Warp layouts over the 16 warps: a 16-row pass (the primal, or one
// Hutchinson tangent) covers 16 x 128 outputs, 1 x 1 mma tiles a warp; a
// chunk of up to 128 rows covers 128 x 128, 2 x 4 tiles a warp, or for a
// head of <= 64 columns 128 x 64, 1 x 4 tiles a warp.
constexpr int kRowWN = kWarps, kRowNT = 16 / kWarps;
constexpr int kWideWN = kWarps / 4, kWideNT = 16 / kWideWN;
constexpr int kHeadWN = kWarps / 8, kHeadNT = 8 / kHeadWN;

template <class Epi>
__device__ __forceinline__ void primal_layer(Pipe& p, const FieldMeta& m, const float* A, int lda,
                                             int K, const float* A2, int lda2, int K2, int N,
                                             Epi epi) {
  layer<1, kRowNT, kRowWN>(p, m, A, lda, K, A2, lda2, K2, N, 1, epi);
}

// A tangent chunk of 16*m_tiles rows: the warp layout follows its shape.
template <class Epi>
__device__ __forceinline__ void chunk_layer(Pipe& p, const FieldMeta& m, const float* A, int lda,
                                            int K, int N, int m_tiles, Epi epi) {
  if (m_tiles == 1)
    layer<1, kRowNT, kRowWN>(p, m, A, lda, K, nullptr, 0, 0, N, 1, epi);
  else if (N <= 64)
    layer<1, kHeadNT, kHeadWN>(p, m, A, lda, K, nullptr, 0, 0, N, m_tiles, epi);
  else
    layer<2, kWideNT, kWideWN>(p, m, A, lda, K, nullptr, 0, 0, N, m_tiles, epi);
}

// The chunk buffer holds a full chunk whenever there are tangents: a warp
// whose first mma tile is valid reads all of its tiles.
__host__ __device__ inline int chunk_rows_of(int K) { return K > 0 ? kKC * kTB : 0; }

__host__ __device__ inline size_t smem_floats(const FieldMeta& m, int K) {
  const int chunk_rows = chunk_rows_of(K);
  return (size_t)kStages * kKS * m.ldw + (size_t)chunk_rows * m.lda + 16 * (size_t)m.ldt +
         16 * (size_t)m.lda + (size_t)(m.n_x + m.n_xt) * kTB * m.lda + 4 * kMaxTiles;
}

__global__ void __launch_bounds__(kThreads, 1)
field_kernel(const __grid_constant__ FieldMeta m, const float* __restrict__ P,
             const float* __restrict__ freqs, const float* __restrict__ x,
             const float* __restrict__ t, const float* __restrict__ ex,
             float* __restrict__ field, float* __restrict__ gate, float* __restrict__ dfield,
             int B, int K, int S, int p_stride, int aligned) {
  extern __shared__ __align__(16) float smem[];
  const int chunk_rows = chunk_rows_of(K);
  const int lda = m.lda, ldt = m.ldt, d = m.d, F = m.F, act = m.act;
  const int n_h = m.n_x + m.n_xt;
  float* ring = smem;
  float* xc = ring + kStages * kKS * m.ldw;  // the tangent chunk's rows
  float* tb = xc + chunk_rows * lda;         // Fourier features, then the t-trunk
  float* xp = tb + 16 * ldt;                 // the primal x/joint rows
  float* dz = xp + 16 * lda;                 // act'(z) per hidden layer, kTB rows each
  int4* tiles = reinterpret_cast<int4*>(dz + n_h * kTB * lda);  // the weight schedule

  // Zeros everywhere: padding rows and columns are read (finite) and their
  // products masked or multiplied by zero-filled weight rows.
  const int n_zero = static_cast<int>(reinterpret_cast<float*>(tiles) - smem);
  for (int i = threadIdx.x; i < n_zero; i += kThreads) smem[i] = 0.f;
  for (int i = threadIdx.x; i < m.n_ptiles + m.n_ctiles; i += kThreads)
    tiles[i] = make_int4(m.tile_off[i], m.tile_rows[i], m.tile_n[i], 0);
  __syncthreads();

  // the seed axis: seed s owns weights P[s * p_stride ...], frequencies
  // freqs[s * F ...] and rows s * B ... s * B + B - 1 of x, t, field, gate
  // and of each tangent slice of ex and dfield (K, S * B, d)
  const int s = blockIdx.y;
  const size_t ex_rows = (size_t)S * B;
  P += (size_t)s * p_stride;
  freqs += (size_t)s * F;
  x += (size_t)s * B * d;
  t += (size_t)s * B;
  field += (size_t)s * B * d;
  gate += (size_t)s * B * d;
  if (K) {
    ex += (size_t)s * B * d;
    dfield += (size_t)s * B * d;
  }
  const int row0 = blockIdx.x * kTB;
  Pipe p{ring, tiles, P, 0, 0, m.n_ptiles + (K + kKC - 1) / kKC * m.n_ctiles, 0, aligned != 0};
  for (int s = 0; s < kStages - 1; ++s) pipe_issue(p, m);

  // [cos | sin](2 pi t f) and x for the primal rows (made visible by the
  // barrier of the first acquire)
#pragma unroll 8
  for (int i = threadIdx.x; i < kTB * 2 * F; i += kThreads) {
    const int r = i / (2 * F), f = i % (2 * F), row = row0 + r;
    const float tv = row < B ? t[row] : 0.f;
    const float ang = (kTwoPi * tv) * freqs[f < F ? f : f - F];
    tb[r * ldt + f] = f < F ? cosf(ang) : sinf(ang);
  }
#pragma unroll 8
  for (int i = threadIdx.x; i < kTB * d; i += kThreads) {
    const int r = i / d, c = i % d, row = row0 + r;
    xp[r * lda + c] = row < B ? x[(size_t)row * d + c] : 0.f;
  }

  // t-trunk, in place
  for (int L = 0; L < m.n_t; ++L) {
    const float* bias = P + m.b_off[L];
    primal_layer(p, m, tb, ldt, m.k_in[L], nullptr, 0, 0, m.n_out[L],
                 [&](int r, int c, float v) {
                   if (r < kTB) tb[r * ldt + c] = act_fn(v + bias[c], act);
                 });
  }
  // gate head from the t-trunk
  const int Lg = m.n_t + n_h, Lf = Lg + 1;
  {
    const float* bias = P + m.b_off[Lg];
    primal_layer(p, m, tb, ldt, m.k_in[Lg], nullptr, 0, 0, d, [&](int r, int c, float v) {
      if (r < kTB && row0 + r < B) gate[(size_t)(row0 + r) * d + c] = v + bias[c];
    });
  }
  // x-trunk, then the joint trunk (its first layer adds h_t @ W_t), in
  // place; act'(z) kept for the tangents
  for (int h = 0; h < n_h; ++h) {
    const int L = m.n_t + h;
    const bool joint = h == m.n_x;
    const float* bias = P + m.b_off[L];
    float* dzh = dz + h * kTB * lda;
    primal_layer(p, m, xp, lda, m.k_in[L], joint ? tb : nullptr, ldt, joint ? m.ht : 0,
                 m.n_out[L], [&](int r, int c, float v) {
                   if (r < kTB) {
                     const float z = v + bias[c];
                     dzh[r * lda + c] = act_grad(z, act);
                     xp[r * lda + c] = act_fn(z, act);
                   }
                 });
  }
  {
    const float* bias = P + m.b_off[Lf];
    primal_layer(p, m, xp, lda, m.k_in[Lf], nullptr, 0, 0, d, [&](int r, int c, float v) {
      if (r < kTB && row0 + r < B) field[(size_t)(row0 + r) * d + c] = v + bias[c];
    });
  }

  // the tangents, kKC at a time: chunk row j is tangent c0 + j / kTB of row
  // row0 + j % kTB
  for (int c0 = 0; c0 < K; c0 += kKC) {
    const int rows = min(kKC, K - c0) * kTB, m_tiles = (rows + 15) >> 4;
#pragma unroll 8
    for (int i = threadIdx.x; i < m_tiles * 16 * d; i += kThreads) {
      const int j = i / d, c = i % d, row = row0 + j % kTB;
      xc[j * lda + c] =
          j < rows && row < B ? ex[((size_t)(c0 + j / kTB) * ex_rows + row) * d + c] : 0.f;
    }
    for (int h = 0; h < n_h; ++h) {
      const int L = m.n_t + h;
      const float* dzh = dz + h * kTB * lda;
      chunk_layer(p, m, xc, lda, m.k_in[L], m.n_out[L], m_tiles, [&](int r, int c, float v) {
        xc[r * lda + c] = dzh[(r % kTB) * lda + c] * v;
      });
    }
    chunk_layer(p, m, xc, lda, m.k_in[Lf], d, m_tiles, [&](int r, int c, float v) {
      const int row = row0 + r % kTB;
      if (r < rows && row < B) dfield[((size_t)(c0 + r / kTB) * ex_rows + row) * d + c] = v;
    });
  }
}

}  // namespace

MFM_EXPORT int mfm_field_apply(const float* packed, const int* meta_host, const float* freqs,
                               const float* x, const float* t, const float* ex, float* field,
                               float* gate, float* dfield, int B, int K, int S, int p_stride,
                               cudaStream_t stream) {
  // once per process: allow up to the whole 227 KB of dynamic shared memory
  static const cudaError_t attr = cudaFuncSetAttribute(
      field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  FieldMeta m;
  static_assert(sizeof(FieldMeta) == sizeof(int) * (13 + 4 * kMaxLayers + 3 * kMaxTiles),
                "int-only struct");
  memcpy(&m, meta_host, sizeof(FieldMeta));
  const int n_layers = m.n_t + m.n_x + m.n_xt + 2;
  bool ok = B > 0 && K >= 0 && S > 0 && S <= 65535 && p_stride >= 0 && n_layers <= kMaxLayers && m.n_xt >= 1 && m.n_ptiles > 0 &&
            m.n_ctiles > 0 && m.n_ptiles + m.n_ctiles <= kMaxTiles &&
            sizeof(float) * smem_floats(m, K) <= (size_t)kMaxSmem;
  for (int l = 0; ok && l < n_layers; ++l) ok = m.n_out[l] <= 128 && m.k_in[l] <= 256;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  // every seed's weights 16-byte aligned, or the copies go 4 bytes at a time
  const int aligned = (reinterpret_cast<uintptr_t>(packed) & 15) == 0 && (S == 1 || p_stride % 4 == 0);
  const dim3 grid((B + kTB - 1) / kTB, S);
  field_kernel<<<grid, kThreads, sizeof(float) * smem_floats(m, K), stream>>>(
      m, packed, freqs, x, t, ex, field, gate, dfield, B, K, S, p_stride, aligned);
  return mfm_last_error();
}

MFM_EXPORT const char* mfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
