#!/usr/bin/env python3
"""K1 (csrc/field.cu) beside variants of itself, on one CUDA card.

    python3 tools/field_variants.py            # all variants, ~1 min
    python3 tools/field_variants.py built one_chain

Each variant is the kernel's source with one design choice undone, by a
text substitution that must apply (the script fails if the source has
moved on). All are built in parallel with the flags of ops/build.py and
timed in one process on the phi-four slice's field (B=1024, d=64, widths
128, F=128, relu): the primal alone and with K=64 tangents, CUDA events
over 50 launches after a warm one, with the error of every output against
an fp64 evaluation of the plain version (the plain fp32 version's own
error is printed first). Then the card's mma.sync TF32 rate, register
operands only, which bounds any kernel built on mma.sync.

Variants:
  built              the kernel as it is
  one_chain          each output's products accumulate in the tensor core
                     (no fresh fragment per k-step)
  truncating_split   hi/lo by clearing the low 13 bits, without rounding
  fast               one_chain and truncating_split together
  cvt_split          hi/lo by cvt.rna.tf32.f32
  tiles32            32-row weight tiles in a 4-deep cp.async ring
  warps8             8 compute warps instead of 16
  rows4              4 rows a block and 32 tangents a chunk (still 128-row
                     products): 256 blocks instead of 128
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from mfm_tpu_torch.ops import build, field  # noqa: E402

OUT = build.BUILD_ROOT.parent / "field_variants"
SRC = (build.CSRC / "field.cu").read_text()

SPLIT = """  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;"""
SPLIT_TRUNC = """  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));"""
SPLIT_CVT = """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(v));
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(v - __uint_as_float(hi)));"""
CHAINS = """        for (int j = 0; j < NTW; ++j) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, al[i], bh[j][0], bh[j][1]);
          mma_tf32(t, ah[i], bl[j][0], bl[j][1]);
          mma_tf32(t, ah[i], bh[j][0], bh[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }"""
ONE_CHAIN = """        for (int j = 0; j < NTW; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int j = 0; j < NTW; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);"""
TILES = ("constexpr int kKS = 64;", "constexpr int kStages = 2;")
TILES32 = ("constexpr int kKS = 32;", "constexpr int kStages = 4;")
WARPS = "constexpr int kThreads = 512;"
WARPS8 = "constexpr int kThreads = 256;"
ROWS = ("constexpr int kTB = 8;", "constexpr int kKC = 16;")
ROWS4 = ("constexpr int kTB = 4;", "constexpr int kKC = 32;")

# (substitutions, weight-tile rows of the schedule)
VARIANTS = {
    "built": ([], 64),
    "one_chain": ([(CHAINS, ONE_CHAIN)], 64),
    "truncating_split": ([(SPLIT, SPLIT_TRUNC)], 64),
    "fast": ([(CHAINS, ONE_CHAIN), (SPLIT, SPLIT_TRUNC)], 64),
    "cvt_split": ([(SPLIT, SPLIT_CVT)], 64),
    "tiles32": (list(zip(TILES, TILES32)), 32),
    "warps8": ([(WARPS, WARPS8)], 64),
    "rows4": (list(zip(ROWS, ROWS4)), 64),
}

MMA_PEAK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int NACC>
__global__ void peak(float* out, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x, a2 = 5u * threadIdx.x,
                 a3 = 7u * threadIdx.x, b1 = 13u * threadIdx.x;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(11u * threadIdx.x + j), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" float mma_peak_ms(int blocks, int threads, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  peak<16><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e0);
  peak<16><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return ms;
}
"""


def source(subs):
    # the shared helpers inline, so that a substitution may reach them
    src = SRC.replace('#include "common.cuh"', (build.CSRC / "common.cuh").read_text())
    for old, new in subs:
        if src.count(old) != 1:
            raise SystemExit(f"field_variants: the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def compile_lib(name, src):
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise SystemExit(f"field_variants: {name} does not build:\n{log[-3000:]}")
    ptxas = [l.split("ptxas info    :")[-1].strip() for l in log.splitlines()
             if "spill" in l or "registers" in l]
    return so, " | ".join(ptxas[:2])


def main(names):
    OUT.mkdir(parents=True, exist_ok=True)
    names = names or list(VARIANTS)
    with ThreadPoolExecutor(len(names) + 1) as pool:
        built = dict(zip(names, pool.map(
            lambda n: compile_lib(n, source(VARIANTS[n][0])), names)))
        peak_so = pool.submit(compile_lib, "mma_peak", MMA_PEAK).result()[0]
    chip_smoke.phase_device(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, d, W, F, K = 1024, 64, 128, 128, 64
    net, params = chip_smoke.perturbed_net(torch, d, W, F, None)
    layout = field.field_layout(params, F)
    packed = field.pack_field_params(params, layout)
    freqs = net.fourier_freqs.contiguous()
    x = torch.randn((B, d), generator=gen, device=dev)
    t = torch.rand(B, generator=gen, device=dev)
    ex = torch.randn((K, B, d), generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for k in (0, K):
        e = ex if k else None
        ref = field.field_apply_plain(packed, layout, "relu", freqs, x, t, e)
        ref64 = field.field_apply_plain(packed.double(), layout, "relu", freqs.double(),
                                        x.double(), t.double(), e.double() if k else None)
        err = max(chip_smoke.errors(torch, a, b)[1] for a, b in zip(ref, ref64))
        print(f"[K={k}] plain fp32 vs fp64: rel {err:.2e}", flush=True)
        for name in names:
            so, ptxas = built[name]
            field.TILE_ROWS = VARIANTS[name][1]
            field.kernel_meta.cache_clear()
            meta = field.kernel_meta(layout, "relu")
            fn = ctypes.CDLL(str(so)).mfm_field_apply
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            out = [torch.empty_like(x), torch.empty_like(x), torch.empty((K, B, d), device=dev)]
            args = (packed.data_ptr(), ctypes.addressof(meta), freqs.data_ptr(), x.data_ptr(),
                    t.data_ptr(), ex.data_ptr(), *(o.data_ptr() for o in out), B, k, 1, layout.size,
                    stream)
            if fn(*args) != 0:
                raise SystemExit(f"field_variants: {name} did not launch")
            torch.cuda.synchronize()
            err = max(chip_smoke.errors(torch, a, b)[1] for a, b in zip(out, ref64))
            ms = chip_smoke.cuda_ms(torch, lambda: fn(*args), 50)
            print(f"[K={k}] {name:17s} {ms:.4f} ms, rel err vs fp64 {err:.2e}; {ptxas}", flush=True)
    field.TILE_ROWS = VARIANTS["built"][1]
    peak = ctypes.CDLL(str(peak_so))
    peak.mma_peak_ms.restype = ctypes.c_float
    blocks, threads, iters = 132, 512, 4096
    ms = peak.mma_peak_ms(blocks, threads, iters)
    flop = 2048.0 * 16 * iters * blocks * threads / 32
    print(f"[mma.sync m16n8k8 tf32] {flop / ms / 1e9:.1f} TFLOP/s "
          f"({blocks} blocks x {threads} threads, register operands)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
