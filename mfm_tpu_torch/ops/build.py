"""Build and load the port's CUDA kernels.

The sources under ``mfm_tpu_torch/csrc`` have a plain C interface. The
first call compiles them with ``nvcc`` for ``sm_90a`` (one process per
source, side by side) into
``build/mfm_tpu_torch/<hash>/libmfm_kernels.so`` (the hash covers the
sources and the flags, so an edit rebuilds) and loads the library with
``ctypes``. Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mfm_tpu_torch"
SOURCES = ("field.cu", "pairwise.cu", "phi_four.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.c_char_p
# (restype, argtypes) of every exported C function, in csrc's order
SIGNATURES = {
    # packed, meta (host int*), freqs, x, t, ex, field, gate, dfield, B, K, S,
    # p_stride, stream
    "mfm_field_apply": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # X, S, T, d, b, items, n_items, partials, counter, out (3), stream
    "mfm_stein_sum": (_I, (_P, _P, _I, _I, _F, _P, _I, _P, _P, _P, _P)),
    # X, S, T, d, Tp, dp, mean, Xc, Sp, sq, sxx, stream
    "mfm_stein_gram_prepare": (_I, (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P)),
    # Xc, Sp, sq, sxx, T, d, dp, b, items, n_items, partials, counter, out (3), stream
    "mfm_stein_gram_sum": (_I, (_P, _P, _P, _P, _I, _I, _I, _F, _P, _I, _P, _P, _P, _P)),
    # P0, T0, P1, T1, d, inv2s2, items, n_items, end0, end1, partials, counter, out (3), stream
    "mfm_rbf_mmd_sums": (_I, (_P, _I, _P, _I, _I, _F, _P, _I, _I, _I, _P, _P, _P, _P)),
    "mfm_pairwise_tile": (_I, ()),
    # x, B, d, coef, inv4c, beta, pbc, bc_value, value, score (or NULL), stream
    "mfm_phi_four": (_I, (_P, _I, _I, _F, _F, _F, _I, _F, _P, _P, _P)),
    # x, gate, field, ex, dfield, B, d, K, coef, beta, pbc, bc_value,
    # tilt_lambda, tilt_val, has_clip, clip, stream
    "mfm_phi_four_score_gate": (
        _I, (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _F, _F, _I, _F, _P)
    ),
    "mfm_error_string": (_S, (_I,)),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. The compiler's output (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside it as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libmfm_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    nvcc, tmp = _nvcc(), work / lib.name
    t0 = time.perf_counter()

    def run(cmd):
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc.returncode, f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"

    # one nvcc per source, all at once, then the link
    objects = [str(work / f"{Path(s).stem}.o") for s in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        results = list(pool.map(
            lambda so: run([nvcc, *NVCC_FLAGS, "-c", "-o", so[1], str(CSRC / so[0])]),
            zip(SOURCES, objects),
        ))
    if not any(rc for rc, _ in results):
        results.append(run([nvcc, "-shared", "-o", str(tmp), *objects]))
    log = "".join(text for _, text in results)
    (out_dir / "build.log").write_text(log)
    if any(rc for rc, _ in results):
        shutil.rmtree(work)
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    shutil.rmtree(work)
    if verbose:
        print(log, f"built in {time.perf_counter() - t0:.1f} s", sep="\n")
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every exported
    function's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        msg = load_library().mfm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
