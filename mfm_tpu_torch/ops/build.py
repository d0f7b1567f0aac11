"""Build and load the port's CUDA kernels.

The sources under ``mfm_tpu_torch/csrc`` have a plain C interface. The
first call compiles them with ``nvcc`` for ``sm_90a`` into
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
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "mfm_tpu_torch"
SOURCES = ("field.cu", "pairwise.cu", "phi_four.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.c_char_p
# (restype, argtypes) of every exported C function, in csrc's order
SIGNATURES = {
    # packed, meta (host int*), freqs, x, t, ex, field, gate, dfield, B, K, stream
    "mfm_field_apply": (_I, (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P)),
    # X, S, T, d, b, per-tile partials, stream
    "mfm_stein_partials": (_I, (_P, _P, _I, _I, _F, _P, _P)),
    # A, Ta, B, Tb, d, inv2s2, per-tile partials, stream
    "mfm_rbf_partials": (_I, (_P, _I, _P, _I, _I, _F, _P, _P)),
    # partials, n, out, stream
    "mfm_reduce_sum": (_I, (_P, _I, _P, _P)),
    "mfm_pairwise_tile": (_I, ()),
    # x, B, d, coef, inv4c, beta, pbc, bc_value, value, score (or NULL), stream
    "mfm_phi_four": (_I, (_P, _I, _I, _F, _F, _F, _I, _F, _P, _P, _P)),
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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
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
