"""Profiling helpers (counterpart of ``mfm_tpu/utils/profiling.py``).

``trace`` profiles a block with ``torch.profiler`` (CPU activity, and CUDA
activity for a CUDA device) and writes a Chrome trace, which Perfetto or
``chrome://tracing`` opens; ``timed`` measures the steady-state wall clock
of a callable, warm-up excluded, after ``torch.cuda.synchronize()``.
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """``with trace("traces/run") as prof: step(...)`` writes
    ``log_dir/trace.json``; ``prof.key_averages()`` sums the kernels."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, repeats: int = 3, warmup: int = 1):
    """(mean seconds, last output) of ``fn(*args)`` over ``repeats`` calls
    after ``warmup`` calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    start = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - start) / repeats, out
