"""The readings that a cell's limits are set from, one JSON line a seed.

    python3 cardbench/controls.py --workload <name> --seeds 1 2 3 [--seconds S] [--out FILE]

For each seed, in one process: the cell's set-up and its window of whole
units (a cycle, an evaluation; one unit unless ``--seconds`` asks for
more), as a run makes them; then each number the check
compares, read for the program (``sound``), for the control (the
reference in the program's place at the next precision below the
configuration's: fp8 for a bf16 field, TF32 for an fp32 one), and for each
fault the cell can have, planted in the reference put in the program's
place (``half``: half of each batch left out, the loss or the row taken on
the rest; ``unchanged``: a training step that returns its state unchanged;
``answer``: one flow draw moved where it is produced). The benchmark's own
runs do not run this.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent

CONTROL = {"default": "fp8", "highest": "tf32"}
FAULTS = {"train_sweep": ("half", "unchanged"), "eval": ("half", "answer")}


def readings(cell, seed, device, overrides=None, seconds=0.0):
    """{side: {number: reading}} of one seed."""
    import torch

    from cardbench import harness
    from cardbench.session import window

    clock = harness.Clock(time.perf_counter())
    state = cell.kind.setup(cell, seed, device, clock, overrides or {})
    window(cell.kind, state, seconds, device, False)
    cell.kind.release(state)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    kind = cell.traffic["kind"]
    sides = {"sound": {}, "control": {"prec": CONTROL[state.cfg.field_precision]}}
    sides.update({f"fault_{f}": {"fault": f} for f in FAULTS[kind]})
    runs = state.kept if kind == "train_sweep" else cell.kind.checked_runs(state)
    out = {}
    for side, kw in sides.items():
        t0 = time.perf_counter()
        out[side] = cell.kind.reference_readings(state, runs, cell.limits, **kw)
        out[side]["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from cardbench import harness

    if not torch.cuda.is_available():
        print("cardbench controls: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "device": torch.cuda.get_device_name(),
                           **readings(cell, seed, "cuda", seconds=args.seconds)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
