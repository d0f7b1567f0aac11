#!/usr/bin/env python3
"""Two packages' many-well runs side by side, over seeds: the share of seeds
whose flow row is not finite in each, with the two-sided Fisher p between
them, and the training curves' means iteration by iteration.

The rows come from the JSON that ``tools/seed_band_reference.py
--many-well`` writes (``many_well``/``many_well_more``, or an ``--out``
file) or from the last line of ``tools/many_well_nonfinite.py``; the curves
are the JSON lines both tools write with ``--curves``. For every metric the
script reports the first iteration at which the two means part by more
than ``--se`` standard errors of their difference (each mean's SE over its
seeds), the same at the last iteration, and AdamW's skipped steps.

    python3 tools/many_well_curves.py --rows-a tools/seed_band_reference.json \\
        --rows-b card.txt --curves-a ref.jsonl --curves-b port.jsonl

Prints one JSON object; ``--table PATH`` also writes every iteration's
means and standard errors there. Needs numpy only."""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mfm_tpu_torch.drivers.eval import fisher_exact  # noqa: E402


def read_rows(paths, seeds=None):
    """{seed: row} of every many-well row in ``paths``: a reference JSON
    (both sections) or a port tool's last line; a later file's row replaces
    an earlier one's."""
    rows = {}
    for path in paths:
        text = Path(path).read_text().strip()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:  # a tool's output: the last line
            data = json.loads(text.splitlines()[-1])
        sections = [data[k] for k in ("many_well", "many_well_more") if k in data] or [data]
        for sec in sections:
            rows.update({r["seed"]: r for r in sec["rows"]})
    if seeds is not None:
        rows = {s: r for s, r in rows.items() if s in seeds}
    return rows


def read_curves(paths, seeds=None):
    """{seed: curve record} of the JSON lines in ``paths``."""
    out = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                out[rec["seed"]] = rec
    if seeds is not None:
        out = {s: r for s, r in out.items() if s in seeds}
    return out


def share(rows):
    bad = sum(not r["flow_row_finite"] for r in rows.values())
    return dict(seeds=len(rows), nan_rows=bad, share=bad / max(len(rows), 1),
                nonfinite_samples=sum(r["nonfinite_samples"] for r in rows.values()))


def mean_se(curves, key):
    """(mean, SE) over seeds of one metric, (n_iter,) each."""
    arr = np.array([c["metrics"][key] for c in curves.values()], dtype=np.float64)
    n = np.sum(np.isfinite(arr), axis=0)
    mean = np.nanmean(arr, axis=0)
    sd = np.nanstd(arr, axis=0, ddof=1) if arr.shape[0] > 1 else np.zeros_like(mean)
    return mean, sd / np.sqrt(np.maximum(n, 1))


def compare_curves(a, b, limit):
    """Per metric: the first iteration (1-based) whose means part by more
    than ``limit`` SE of the difference, and the z at the last one."""
    out, table = {}, {}
    keys = set(next(iter(a.values()))["metrics"]) & set(next(iter(b.values()))["metrics"])
    for key in sorted(keys):
        ma, sa = mean_se(a, key)
        mb, sb = mean_se(b, key)
        se = np.sqrt(sa**2 + sb**2)
        # a metric with no spread over seeds (the learning rate) parts only
        # beyond fp32 rounding
        same = np.abs(ma - mb) <= 1e-5 * np.maximum(np.abs(ma), np.abs(mb))
        with np.errstate(divide="ignore", invalid="ignore"):
            z = np.where(se > 0, np.abs(ma - mb) / se, np.where(same, 0.0, np.inf))
        over = np.flatnonzero(z > limit)
        out[key] = dict(first_parting=int(over[0]) + 1 if over.size else None,
                        first_parting_z=float(z[over[0]]) if over.size else None,
                        partings=int(over.size), last_z=float(z[-1]), last_a=float(ma[-1]),
                        last_b=float(mb[-1]), max_z=float(np.nanmax(z)),
                        max_z_at=int(np.nanargmax(z)) + 1)
        table[key] = dict(mean_a=ma.tolist(), se_a=sa.tolist(), mean_b=mb.tolist(),
                          se_b=sb.tolist(), z=z.tolist())
    return out, table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows-a", nargs="+", required=True, metavar="PATH")
    p.add_argument("--rows-b", nargs="+", required=True, metavar="PATH")
    p.add_argument("--curves-a", nargs="*", default=[], metavar="PATH")
    p.add_argument("--curves-b", nargs="*", default=[], metavar="PATH")
    p.add_argument("--seeds", default=None, metavar="FIRST-LAST",
                   help="only these seeds, on both sides")
    p.add_argument("--se", type=float, default=4.0, help="the parting limit in SE")
    p.add_argument("--table", default=None, metavar="PATH")
    args = p.parse_args(argv)
    seeds = None
    if args.seeds:
        first, _, last = args.seeds.partition("-")
        seeds = set(range(int(first), int(last or first) + 1))
    ra, rb = read_rows(args.rows_a, seeds), read_rows(args.rows_b, seeds)
    sa, sb = share(ra), share(rb)
    out = dict(a=sa, b=sb, fisher_p=fisher_exact(sa["nan_rows"], sa["seeds"], sb["nan_rows"],
                                                   sb["seeds"]))
    if args.curves_a and args.curves_b:
        ca, cb = read_curves(args.curves_a, seeds), read_curves(args.curves_b, seeds)
        out["curve_seeds"] = dict(a=len(ca), b=len(cb))
        out["curves"], table = compare_curves(ca, cb, args.se)
        out["skipped"] = dict(a=sum(c["skipped"] for c in ca.values()),
                              b=sum(c["skipped"] for c in cb.values()))
        if args.table:
            Path(args.table).write_text(json.dumps(table) + "\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
