"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits and per-layer metrics are
found by name from ``BENCHMARK.json``, or from ``parked/<cell>.json`` for a
cell measured and left out of it (``harness.load_cell``). The run
builds the port's program and its inputs from ``--seed``, warms up every
shape the window uses (counted in ``setup_s``), measures for ``--seconds``
(whole cycles or whole evaluations), then checks what the timed path
produced against the plain reference under ``cardbench/reference``.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, from CUDA events around every call of the window and a
profiler trace of part of it. The last line of standard output is one JSON
object; the numbers compared, each with its limit, are the last lines of
standard error and the last key of that object.

It needs CUDA cards: without enough of them it prints no result and exits
with 2. It exits with 3, and prints no result, if JAX or the JAX package is
loaded once the window has closed.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches inside the checkout, at fixed paths (the kernel library is
    # built under build/mfm_tpu_torch by the program itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from cardbench import harness
    from cardbench.session import run_cell

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, check_lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                                   START)
    found = harness.forbidden_modules()
    if found:
        print(f"cardbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in check_lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
