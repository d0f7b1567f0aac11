"""Run a set of runs of one cell, one process after another, and report each
end-to-end metric's median and spread.

    python3 cardbench/sets.py --workload <name> --seconds <s> --seeds 1 2 3 4 5 6 \
        [--trace 0|1] [--out FILE]

Each run is ``cardbench/run.py`` as the benchmark's command runs it; its
result line (and the end of its standard error when it fails) is appended
to ``--out`` as one JSON line. The spread is (Q3 - Q1) / median by Python's
``statistics.quantiles(values, n=4)``; beside it the same with the run
farthest from the median left out.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def spread_trimmed(values):
    """The spread with the run farthest from the median left out."""
    if len(values) < 3:
        return None
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", nargs="+", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    values = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(RUN), "--workload", args.workload, "--seed", seed,
             "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True)
        record = {"workload": args.workload, "seed": seed, "seconds": args.seconds,
                  "trace": args.trace, "rc": proc.returncode,
                  "wall_s": time.perf_counter() - t0,
                  "info": [line for line in proc.stdout.splitlines()
                           if line.startswith("cardbench:")]}
        try:
            record["result"] = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            record["stderr"] = proc.stderr[-4000:]
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(record) + "\n")
        result = record.get("result", {})
        print(f"seed {seed} rc {proc.returncode} wall {record['wall_s']:.1f} s correct "
              f"{result.get('correct')} " + " ".join(
                  f"{k}={v['value']:.6g}" for k, v in result.get("metrics", {}).items())
              + " checks " + " ".join(f"{k}={v[0]:.3g}" for k, v in
                                      result.get("checks", {}).items()), flush=True)
        for k, v in result.get("metrics", {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, v in values.items():
        print(f"{k}: median {statistics.median(v):.6g} spread {spread(v)} "
              f"spread_trimmed {spread_trimmed(v)} n {len(v)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
