// Shared by the port's kernels: the launch-error convention of the C
// interface, and the device helpers of the kernels that multiply on the
// tensor cores (cp.async staging, the TF32 hi/lo split, mma.sync).
//
// Every exported launcher returns cudaGetLastError() as an int, which the
// Python wrapper raises on (a refused launch never runs, and
// torch.cuda.synchronize() would not report it).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#define MFM_EXPORT extern "C" __attribute__((visibility("default")))

static inline int mfm_last_error() { return static_cast<int>(cudaGetLastError()); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 16 (or 4) bytes, or writes zeros when !fill (src is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo, both TF32 values rounded to nearest (add half a TF32 ulp,
// clear the low 13 mantissa bits): the tensor core then reads them exactly,
// and v keeps ~22 bits. Two integer and one fp32 instruction per half;
// cvt.rna.tf32.f32 rounds the same way at 13 % more kernel time in K1.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// The same with lo left as fp32's v - hi: the tensor core reads its top 19
// bits, so lo is cut, not rounded (an error of 2^-21 |v| of either sign,
// against 2^-22), for two instructions fewer.
__device__ __forceinline__ void split_tf32_open(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Four 8x8 blocks of 16-bit entries, or 8x4 blocks of fp32, from shared
// memory: lane 8 m + r names row r (16 bytes) of block m, and lane (g, q)
// receives the 32 bits at row g, bytes 4 q of each block.
__device__ __forceinline__ void ldmatrix_x4(float (&r)[4], const float* p) {
  uint32_t u[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
               : "r"(smem_u32(p)));
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = __uint_as_float(u[e]);
}

// c += a (16x8, row) * b (8x8, col) in TF32 with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b: a zero addend needs no registers.
__device__ __forceinline__ void mma_tf32_zero(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// One k-step (depth 8) of acc += A B^T in 3xTF32: lo*hi + hi*lo + hi*hi of
// the step in a zeroed fragment, added to the fp32 sum. The tensor core's
// own accumulation truncates, so its chains are kept three products long.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float t[4];
  mma_tf32_zero(t, al, bh[0], bh[1]);
  mma_tf32(t, ah, bl[0], bl[1]);
  mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}
