#!/usr/bin/env python3
"""The reference seed band: ``mfm_tpu``'s metric row over the CLI's 10
replication seeds (``i**10``, ``i < 10``), on the CPU in float32, written to
``tools/seed_band_reference.json``.

Each seed's row is what the reference's single-seed path computes for
``--seed s``: ``config.preset(example, seed=s, **overrides)``, ``run_mfm``,
``sample_flow`` on ``fold_in(PRNGKey(s), 999)``, ``evaluate_samples``
against exact draws from ``fold_in(PRNGKey(s), 1000)`` where the target has
a sampler, and the IS estimate of log Z; beside its fp32 KSD-U and KSD-U*,
the same statistics of the same samples in float64 (``stein_u_f64``). (The
reference's ``--vmap-seeds`` rows share one eval draw across seeds and are
not used.) The port holds its
own sweeps to these rows: ``chip_smoke.py``'s band phases on the card and
``tests/test_torch_seed_band.py`` on the CPU; neither imports this file.

    python tools/seed_band_reference.py                 # all five bands
    python tools/seed_band_reference.py --bands pines   # one band, merged in
    python tools/seed_band_reference.py --many-well     # many-well's NaN rows

``--many-well`` runs many-well as preset at ``learning_iter=100`` over the
same seeds and records, for each seed, whether the flow row is finite and
how many of its 12,800 eval samples and log-weights are not; with
``--seeds FIRST-LAST`` over those seeds instead, merged by seed into
``many_well_more`` (a seed already there is replaced, the others kept).
``--out PATH`` writes that section to a file of its own instead, so that
ranges run in parallel processes never race on the JSON; ``--merge PATH
...`` then merges such files' rows into it. ``--curves PATH`` appends one
JSON line a seed: every iteration's training metrics (``run_mfm``'s
``metrics``) and AdamW's count of skipped non-finite steps
(``tools/many_well_curves.py`` compares two packages' curves).

    python tools/seed_band_reference.py --many-well --seeds 1020-1039 \
        --out /tmp/mw_1020.json --curves /tmp/mw_1020.jsonl
    python tools/seed_band_reference.py --merge /tmp/mw_1020.json /tmp/mw_1040.json

The file's ``notes`` say what the reference computes differently on a CPU
from the port on the card (``NOTES``).
"""

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mfm_tpu import config  # noqa: E402
from mfm_tpu.cli import make_target  # noqa: E402
from mfm_tpu.drivers import evaluate_samples, run_mfm, sample_flow  # noqa: E402

OUT = ROOT / "tools" / "seed_band_reference.json"
RUNS = {}  # seed -> the last run of seed_run, for --curves
SEEDS = [i**10 for i in range(10)]
COMMON = dict(
    num_chain=64, hidden_x=(32, 32), hidden_t=(32, 32), hidden_xt=(32, 32), fourier_dim=16,
    ode_steps=8, learning_iter=300, chunk_size=300, eval_iter=8,
)
# name: (example, the band's own overrides, what the port's card run adds)
BANDS = {
    "4-mode": ("4-mode", {}, {}),
    "gaussian-mixture": ("gaussian-mixture", {}, {}),
    "phi-four": ("phi-four", {}, {}),
    "phi-four-fused": ("phi-four", {"field_precision": "highest"}, {"pallas_field": True}),
    "pines": ("pines", {}, {}),
}
COLUMNS = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star",
           "stein_v_star", "mmd_star", "is_log_z", "is_ess", "is_unique",
           "stein_u_f64", "stein_u_star_f64")
MANY_WELL = dict(learning_iter=100)
NOTES = [
    "float32 on XLA:CPU throughout: the reference's field_precision='default' (phi-four and "
    "pines as shipped) multiplies fp32 operands there (bf16 only on a TPU), while the "
    "port's 'default' rounds both operands to bf16 on every device.",
    "KSD on the CPU is the reference's plain fp32 statistic (its kernels are off at "
    "d >= 1024): r = |x_i|^2 + |x_j|^2 - 2 x_i.x_j of uncentred points, which at pines' "
    "flow samples (|x|^2 ~ 3e4) loses a few per cent of KSD-U to cancellation; the port's "
    "K2a centres the points first (tools/ksd_cancellation.py). So each row also holds "
    "stein_u_f64 and stein_u_star_f64: KSD-U of the same samples in float64 (their fp32 "
    "score), the statistic K2a computes on the card, which chip_smoke.py holds it to.",
]


def overrides_of(name):
    example, own, _ = BANDS[name]
    return example, {**COMMON, **own}


def reduced(example, overrides):
    """Each cut against the preset, as 'field: preset -> band'."""
    base = dataclasses.asdict(config.preset(example))
    return [f"{k}: {base[k]!r} -> {v!r}" for k, v in overrides.items() if base[k] != v]


def held_columns(target):
    """logpdf and KSD-U of the flow and the IS-resampled rows, MMD and MMD*
    where the target has an exact sampler, and the IS estimate of log Z."""
    mmd = ("mmd", "mmd_star") if target.can_sample else ()
    return ["logpdf", "stein_u", "logpdf_star", "stein_u_star", *mmd, "is_log_z"]


def stein_u_f64(X, S, beta=-0.5):
    """KSD-U of X (T, d) with its score S, every sum in float64."""
    X, S = np.asarray(X, np.float64), np.asarray(S, np.float64)
    T, d = X.shape
    b = -beta
    sq, sxx = np.sum(X * X, -1), np.sum(S * X, -1)
    r = np.maximum(sq[:, None] + sq[None, :] - 2.0 * X @ X.T, 0.0)
    base = 1.0 + r
    cross = sxx[:, None] - S @ X.T - X @ S.T + sxx[None, :]
    term = (-4.0 * b * (b + 1.0) * r / base ** (b + 2.0) + 2.0 * b * (d + cross) / base ** (b + 1.0)
            + (S @ S.T) / base**b)
    return float((term.sum() - np.trace(term)) / (T * (T - 1)))


def seed_run(example, overrides, seed):
    """The reference's single-seed path: (config, target, flow samples,
    exact samples, log-weights, metric row)."""
    cfg = config.preset(example, seed=seed, **overrides)
    target = make_target(example)
    key = jax.random.PRNGKey(seed)
    n = cfg.eval_iter * cfg.num_chain
    real = target.sample(jax.random.fold_in(key, 1000), (n,)) if target.can_sample else None
    run = run_mfm(target, cfg)
    flow, exact, log_w = sample_flow(run, jax.random.fold_in(key, 999), n, target)
    RUNS[seed] = run
    m = evaluate_samples(target, flow, exact, real)
    w = jax.nn.softmax(log_w)
    m["is_log_z"] = float(jax.scipy.special.logsumexp(log_w)) - math.log(n)
    m["is_ess"] = float(1.0 / jnp.sum(w * w))
    m["is_unique"] = int(np.unique(np.asarray(exact), axis=0).shape[0])
    m["stein_u_f64"] = stein_u_f64(flow, target.score(flow))
    m["stein_u_star_f64"] = stein_u_f64(exact, target.score(exact))
    return cfg, target, flow, exact, log_w, {c: float(m[c]) for c in COLUMNS}


def reference_row(name, seed):
    """One seed's row of band ``name``, with its wall seconds."""
    example, overrides = overrides_of(name)
    t0 = time.perf_counter()
    *_, row = seed_run(example, overrides, seed)
    return dict(seed=seed, **row, seconds=time.perf_counter() - t0)


def band(name, seeds):
    example, overrides = overrides_of(name)
    rows = []
    for s in seeds:
        rows.append(reference_row(name, s))
        print(f"[{name}] seed {s}: {json.dumps(rows[-1])}", flush=True)
    _, _, port_adds = BANDS[name]
    return dict(
        example=example, overrides=overrides, port_overrides=port_adds,
        reduced=reduced(example, overrides), held=held_columns(make_target(example)),
        seeds=list(seeds), rows=rows, jax_version=jax.__version__,
    )


def curve(seed, run):
    """One seed's training curves: every iteration's metrics and AdamW's
    skipped steps (applied steps fewer than iterations)."""
    opt = run.train.opt_state
    return dict(package="reference", seed=seed,
                metrics={k: np.asarray(v, np.float64).tolist() for k, v in run.metrics.items()},
                skipped=int(run.train.step) - int(opt.count),
                notfinite_count=int(opt.notfinite_count))


def many_well(seeds, curves=None):
    """many-well as preset at learning_iter=100: each seed's flow row and
    its non-finite eval samples and log-weights; with ``curves`` a path,
    each seed's training curves appended there."""
    out = []
    for s in seeds:
        t0 = time.perf_counter()
        cfg, _, flow, _, log_w, row = seed_run("many-well", MANY_WELL, s)
        bad = ~np.all(np.isfinite(np.asarray(flow)), axis=-1)
        rec = dict(seed=s, n_eval=int(flow.shape[0]),
                   flow_row_finite=all(math.isfinite(row[c]) for c in ("logpdf", "stein_u")),
                   nonfinite_samples=int(bad.sum()),
                   nonfinite_log_w=int((~np.isfinite(np.asarray(log_w))).sum()),
                   **row, seconds=time.perf_counter() - t0)
        out.append(rec)
        print(f"[many-well] {json.dumps(rec)}", flush=True)
        if curves:
            with open(curves, "a") as fh:
                fh.write(json.dumps(curve(s, RUNS.pop(s))) + "\n")
        RUNS.clear()
    return dict(example="many-well", overrides=MANY_WELL, seeds=list(seeds), rows=out,
                jax_version=jax.__version__)


def merge_rows(old, new):
    """A many-well section whose rows are ``old``'s and ``new``'s by seed
    (``new``'s where both have one), sorted by seed."""
    rows = {r["seed"]: r for r in (old or {}).get("rows", [])}
    rows.update({r["seed"]: r for r in new["rows"]})
    merged = {**(old or {}), **{k: v for k, v in new.items() if k != "rows"}}
    merged["rows"] = [rows[k] for k in sorted(rows)]
    merged["seeds"] = sorted(rows)
    return merged


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bands", nargs="*", choices=list(BANDS), default=None,
                   help="bands to (re)compute; the others in the file are kept (default: all)")
    p.add_argument("--many-well", action="store_true",
                   help="many-well's NaN rows instead of the bands")
    p.add_argument("--seeds", default=None, metavar="FIRST-LAST",
                   help="with --many-well: these seeds instead, merged into many_well_more")
    p.add_argument("--out", default=None, metavar="PATH",
                   help="with --seeds: write the section to PATH, not into the JSON")
    p.add_argument("--merge", nargs="+", default=None, metavar="PATH",
                   help="merge the rows of --out files into many_well_more")
    p.add_argument("--curves", default=None, metavar="PATH",
                   help="with --many-well: append each seed's training curves to PATH")
    args = p.parse_args(argv)
    if args.seeds and not args.many_well:
        p.error("--seeds applies to --many-well only: the bands use the replication seeds")
    if (args.out or args.curves) and not args.many_well:
        p.error("--out and --curves apply to --many-well only")
    if args.out and not args.seeds:
        p.error("--out writes a --seeds range")
    if args.merge:
        new = {}
        for path in args.merge:
            part = json.loads(Path(path).read_text())["many_well_more"]
            new = merge_rows(new, part) if new else part
    elif args.seeds:
        first, _, last = args.seeds.partition("-")
        new = many_well(list(range(int(first), int(last or first) + 1)), args.curves)
        if args.out:
            Path(args.out).write_text(json.dumps({"many_well_more": new}, indent=1) + "\n")
            return
    elif args.many_well:
        new = {"many_well": many_well(SEEDS, args.curves)}
    else:
        new = {"bands": {n: band(n, SEEDS) for n in (args.bands or BANDS)}}
    # read only now: another run may have written other sections meanwhile
    data = json.loads(OUT.read_text()) if OUT.exists() else {}
    if args.merge or args.seeds:
        data["many_well_more"] = merge_rows(data.get("many_well_more"), new)
    else:
        data.setdefault("bands", {}).update(new.get("bands", {}))
        data.update({k: v for k, v in new.items() if k != "bands"})
    data["generator"] = "tools/seed_band_reference.py"
    data["notes"] = NOTES
    OUT.write_text(json.dumps(data, indent=1) + "\n")


if __name__ == "__main__":
    main()
