#!/usr/bin/env python3
"""K2a/K2b (csrc/pairwise.cu) beside an earlier commit's, and K2a's two
routes beside each other, on one CUDA card.

    git archive --prefix=build/parent/ <commit> | tar x
    python3 tools/pairwise_variants.py build/parent     # ~1 min
    python3 tools/pairwise_variants.py                  # without the parent

With a parent directory (a checkout of a commit whose pairwise.cu still
has the two-launch interface mfm_stein_partials / mfm_rbf_partials /
mfm_reduce_sum): the parent's source is built with the flags of
ops/build.py and timed in turns with the kernels of this tree (parent,
new, new, parent; CUDA events, launches queued) on the inputs of
chip_smoke.pairwise_inputs, and each pair of sums is held to 1e-6
relative. The script fails if they disagree.

Before that, each kernel at the eval's large shapes on schedules of 2 to
32 blocks an SM (ops/pairwise.py::BLOCKS_PER_SM); the Stein sum at
T = 12800 on both routes for a range of d, with each route's error against
the float64 plain version: the d from which the Gram route on the tensor
cores is the faster one is ops/pairwise.py::GRAM_MIN_D; and the Stein sum
beside variants of its source (text substitutions that must apply, so
edit them with the kernel): without the Newton step on rsqrt.approx, with
the hi/lo split's lo rounded, and with parts of the Gram kernel knocked
out (no splits, no loads, one TF32 pass), whose sums are wrong and whose
times say what each part costs.
"""

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from mfm_tpu_torch.ops import build, pairwise  # noqa: E402

OUT = build.BUILD_ROOT.parent / "pairwise_variants"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PARENT_SIGNATURES = {
    "mfm_stein_partials": (_P, _P, _I, _I, _F, _P, _P),
    "mfm_rbf_partials": (_P, _I, _P, _I, _I, _F, _P, _P),
    "mfm_reduce_sum": (_P, _I, _P, _P),
}


def parent_library(parent: Path):
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / "parent_pairwise.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so),
           str(parent / "mfm_tpu_torch" / "csrc" / "pairwise.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"pairwise_variants: the parent does not build:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in PARENT_SIGNATURES.items():
        getattr(lib, name).restype = _I
        getattr(lib, name).argtypes = argtypes
    return lib


def parent_sum(lib, first, n_tiles, dev):
    """The parent's two launches: per-tile fp64 partials, then their sum."""
    partials = torch.empty(n_tiles, dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = first(partials.data_ptr(), stream) or lib.mfm_reduce_sum(
        partials.data_ptr(), n_tiles, out.data_ptr(), stream)
    if err:
        raise SystemExit(f"pairwise_variants: the parent's kernel did not launch ({err})")
    return out


def against_parent(parent: Path):
    lib = parent_library(parent)
    tiles = lambda n: math.ceil(n / 64)
    for label, (P, Q) in chip_smoke.pairwise_inputs(torch).items():
        T, d = P.shape
        if label.startswith("K2a"):
            new = lambda: pairwise.stein_pairwise_sum(P, Q)
            old = lambda: parent_sum(lib, lambda part, st: lib.mfm_stein_partials(
                P.data_ptr(), Q.data_ptr(), T, d, 0.5, part, st), tiles(T) ** 2, P.device)
        else:
            new = lambda: pairwise.rbf_kernel_sum(P, Q)
            old = lambda: parent_sum(lib, lambda part, st: lib.mfm_rbf_partials(
                P.data_ptr(), T, Q.data_ptr(), Q.shape[0], d, 0.5, part, st),
                tiles(T) * tiles(Q.shape[0]), P.device)
        rel = chip_smoke.errors(torch, new(), old())[1]
        new_ms, old_ms = chip_smoke.in_turns(torch, new, old, 50, 50)
        print(f"[parent {label}] parent {old_ms:.4f} ms, this tree {new_ms:.4f} ms "
              f"({old_ms / new_ms:.2f}x); sums agree to rel {rel:.3e} (tol 1e-6)", flush=True)
        if not rel <= 1e-6:
            raise SystemExit(f"pairwise_variants: {label} disagrees with the parent's kernel")


def routes(T=12800, dims=(8, 16, 32, 64, 96, 128, 256, 512)):
    gen = torch.Generator(device="cuda").manual_seed(6)
    for d in dims:
        X = torch.randn((T, d), generator=gen, device="cuda")
        S = -X
        ref = pairwise.stein_pairwise_sum_plain(X.double(), S.double())
        cells = []
        for route in ("diff", "gram"):
            fn = lambda: pairwise.stein_pairwise_sum(X, S, route=route)
            rel = chip_smoke.errors(torch, fn(), ref)[1]
            cells.append(f"{route} {chip_smoke.cuda_ms(torch, fn, 5, True):.4f} ms "
                         f"(rel {rel:.2e})")
        print(f"[routes T={T} d={d}] " + ", ".join(cells), flush=True)
    # two modes at +-8 in every coordinate: the centring takes no offset
    # away, and the Gram form's norms are 65 times a within-mode distance
    modes = 8.0 * (2.0 * torch.randint(0, 2, (T, 1), generator=gen, device="cuda") - 1.0)
    X = torch.randn((T, 64), generator=gen, device="cuda") + modes
    S = modes - X
    ref = pairwise.stein_pairwise_sum_plain(X.double(), S.double())
    rel = [chip_smoke.errors(torch, pairwise.stein_pairwise_sum(X, S, route=route), ref)[1]
           for route in ("diff", "gram")]
    plain = chip_smoke.errors(torch, pairwise.stein_pairwise_sum_plain(X, S), ref)[1]
    print(f"[routes T={T} d=64, two modes at +-8] rel diff {rel[0]:.2e}, gram {rel[1]:.2e}, "
          f"plain fp32 {plain:.2e}", flush=True)


def granularity(blocks_per_sm=(2, 4, 8, 16, 32)):
    """Each kernel at the eval's large shapes for schedules of so many
    blocks an SM (ops/pairwise.py::BLOCKS_PER_SM)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    old = chip_smoke.pairwise_inputs(torch)
    X2, S2 = old["K2a T=12800 d=2"]
    A, B = old["K2b Ta=Tb=12800 d=2"]
    X64 = 0.5 * torch.randn((12800, 64), generator=gen, device="cuda")
    X1600 = torch.randn((12800, 1600), generator=gen, device="cuda")
    cases = [
        ("K2a T=12800 d=2", lambda: pairwise.stein_pairwise_sum(X2, S2), 50),
        ("K2a T=12800 d=64 diff", lambda: pairwise.stein_pairwise_sum(X64, -X64, route="diff"), 10),
        ("K2a T=12800 d=64 gram", lambda: pairwise.stein_pairwise_sum(X64, -X64, route="gram"), 10),
        ("K2a T=12800 d=1600 gram", lambda: pairwise.stein_pairwise_sum(X1600, -X1600), 3),
        ("K2b Ta=Tb=12800 d=2", lambda: pairwise.rbf_kernel_sum(A, B), 50),
        ("K2b MMD T=12800 d=2", lambda: pairwise.rbf_mmd_sums(A, B), 50),
    ]
    built = pairwise.BLOCKS_PER_SM
    for label, fn, reps in cases:
        cells = []
        for n in blocks_per_sm:
            pairwise.BLOCKS_PER_SM = n
            pairwise._device_schedule.cache_clear()
            cells.append(f"{n}: {chip_smoke.cuda_ms(torch, fn, reps, True):.4f}")
        print(f"[blocks an SM, {label}] ms " + ", ".join(cells), flush=True)
    pairwise.BLOCKS_PER_SM = built
    pairwise._device_schedule.cache_clear()


NEWTON = "      p = fmaf(p0, fmaf(-0.5f * base * p0, p0, 0.5f), p0);"
OPEN_LO = "  lo = __float_as_uint(v - __uint_as_float(hi));"
THREE_PASSES = """  float t[4];
  mma_tf32_zero(t, al, bh[0], bh[1]);
  mma_tf32(t, ah, bl[0], bl[1]);
  mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];"""
LOAD = "      cp_async16(st + op * kGOperand + row * kGLd + c, src, true);"
NO_SPLIT = (OPEN_LO, "  hi = __float_as_uint(v);\n  lo = hi;")
ONE_PASS = (THREE_PASSES, "  mma_tf32(acc, ah, bh[0], bh[1]);")
NO_LOADS = (LOAD, "      if (s < 2) " + LOAD.strip())
# name: the substitutions. The first two undo a design choice and stay
# right; the others knock a part of the Gram kernel out (wrong sums: their
# times say what that part costs).
VARIANTS = {
    "built": [],
    "no_newton": [(NEWTON, "      p = p0;")],
    "rounded_lo": [(OPEN_LO, "  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u)"
                             " & 0xffffe000u;")],
    "no_split": [NO_SPLIT],
    "no_loads": [NO_LOADS],
    "one_pass": [ONE_PASS],
    "one_pass_no_split_no_loads": [ONE_PASS, NO_SPLIT, NO_LOADS],
}


def variant_library(name):
    src = (build.CSRC / "pairwise.cu").read_text().replace(
        '#include "common.cuh"', (build.CSRC / "common.cuh").read_text())
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"pairwise_variants: the source no longer holds {old!r}")
        src = src.replace(old, new)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"pairwise_variants: {name} does not build:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = list(argtypes)
    return lib


def variants():
    """The kernels beside variants of their source, each with one choice
    undone or one part knocked out: time, and error against float64."""
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(variant_library, VARIANTS)))
    gen = torch.Generator(device="cuda").manual_seed(8)
    X2, S2 = chip_smoke.pairwise_inputs(torch)["K2a T=12800 d=2"]
    X64 = 0.5 * torch.randn((12800, 64), generator=gen, device="cuda") + 0.5
    X1600 = torch.randn((12800, 1600), generator=gen, device="cuda") + 0.5
    cases = [("T=12800 d=2", X2, S2, 50), ("T=12800 d=64", X64, -X64, 10),
             ("T=12800 d=1600", X1600, -X1600, 3)]
    refs = [pairwise.stein_pairwise_sum_plain(X.double(), S.double()) for _, X, S, _ in cases]
    built = build.load_library
    for name, lib in libs.items():
        build.load_library = lambda lib=lib: lib
        cells = []
        for (label, X, S, reps), ref in zip(cases, refs):
            fn = lambda: pairwise.stein_pairwise_sum(X, S)
            rel = chip_smoke.errors(torch, fn(), ref)[1]
            cells.append(f"{label} {chip_smoke.cuda_ms(torch, fn, reps, True):.4f} ms "
                         f"(rel {rel:.2e})")
        print(f"[variant {name}] K2a " + ", ".join(cells), flush=True)
    build.load_library = built


def main(argv):
    chip_smoke.phase_device(torch)
    build.load_library()
    granularity()
    routes()
    variants()
    if argv:
        against_parent(Path(argv[0]))


if __name__ == "__main__":
    main(sys.argv[1:])
