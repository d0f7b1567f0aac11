#!/usr/bin/env python3
"""many-well's NaN flow rows as a paired study of the port's draws against
the reference's: many-well as preset (d=32, 128 chains, trunks 128, 24 RK4
steps, exact divergence), every seed trained twice as a seed sweep
(``run_mfm_seeds``, the CLI's ``--vmap-seeds`` path), once on the port's
own step noise (arm P) and once on the reference's (arm R: the draws
``mfm_tpu``'s ``run_mfm`` takes from ``PRNGKey(seed)``'s loop keys, made by
``tools/jax_threefry.py``), each trained flow then evaluated on both latent
sets of 12,800 draws: the port's (``sample_flow`` on ``EVAL_STREAM``) and
the reference's (``fold_in(PRNGKey(seed), 999)``). The initial positions,
Fourier frequencies and weights are the port's in both arms. That gives
four cells a seed, PP, PR, RP and RR (noise, then latents), each with its
NaN flag, its count of non-finite samples and each such sample's largest
|latent coordinate|.

    python3 tools/many_well_paired.py --seeds 2000-2999 --workers 4 --out study.jsonl  # the card
    python3 tools/many_well_paired.py --summary tools/many_well_paired_h100.jsonl        # the tables
    python3 tools/many_well_paired.py --device cpu --learning-iter 4 --seeds 0-2 \\
        --set num_chain=8 --set eval_iter=4 --out /tmp/dry.jsonl          # a tiny dry run

The seeds run in sweeps of ``--chunk`` (100) seeds, both arms a chunk;
``--out`` gets one JSON line a seed and arm as each sweep ends, so a run
that is cut keeps its finished chunks. ``--workers N`` shares the device
between N processes of this script each on every N-th chunk.
``--arms`` and ``--latents`` pick the step-noise arms and eval latent sets;
``--init cpu`` or ``--init reference`` starts every chain from the initial
positions a CPU generator draws or the reference draws (N(0, I) on
``key_pos``, the second of ``split(PRNGKey(seed), 3)``), a third
factor, whose cells are named ``C:`` and ``T:``. ``--metrics`` adds each
cell's metric row (``evaluate_samples`` against exact draws on
``REAL_STREAM``, the plain statistics).

``--summary`` pairs the lines by seed and prints the four shares with
Wilson 95 % intervals, the latent effect (PP against PR, RP against RR) and
the noise effect (PP against RP, PR against RR), each with the exact
McNemar p of its discordant seeds and the verdict of the rule below; RR
against the reference's committed share (``tools/seed_band_reference.json``,
two-sided Fisher); every other initial position's cell against the port's;
every cell against the reference's own flag on the seeds the JSON holds;
the metric rows; and the rate at which a port whose true share is PP's
fails ``chip_smoke.py`` phase 52 at each candidate limit, with the limit
``choose_limit`` picks. The committed runs on the card:
``tools/many_well_paired_h100.jsonl`` (100 iterations, seeds 2000-2999)
and ``tools/many_well_preset_length_h100.jsonl`` (the preset's 2,000).

The rule, fixed before the study ran: a factor (the step noise, the eval
latents) is a law difference when the mean of its two pairs' effects is at
least ``RULE_POINTS`` points and its McNemar p is below ``RULE_P`` in both
pairs."""

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import jax_threefry as tf  # noqa: E402
import many_well_nonfinite as nf  # noqa: E402
from mfm_tpu_torch import cli, config  # noqa: E402
from mfm_tpu_torch.drivers import mfm, multi_seed  # noqa: E402
from mfm_tpu_torch.drivers.eval import evaluate_samples, fisher_exact  # noqa: E402
from mfm_tpu_torch.drivers.mfm import (  # noqa: E402
    EVAL_STREAM, REAL_STREAM, make_generator, sample_flow_parts,
)
from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds, seed_run  # noqa: E402

ARMS = ("P", "R")  # P: the port's draws, R: the reference's
CELLS = ("PP", "PR", "RP", "RR")  # step noise, then eval latents
INITS = {"port": "", "cpu": "C:", "reference": "T:"}  # a cell's prefix by its initial positions
RULE_POINTS, RULE_P = 4.0, 0.01
LIMITS, FALSE_FAILURE = (0.01, 0.005, 0.002, 0.001), 1 / 200  # phase 52's gate
METRIC_COLUMNS = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star",
                  "stein_v_star", "mmd_star")
BAND_FILE = ROOT / "tools" / "seed_band_reference.json"
PORT_BUILD = mfm.build_mfm


def mcnemar_exact(b: int, c: int) -> float:
    """Two-sided exact McNemar p of ``b`` against ``c`` discordant pairs:
    twice the smaller binomial tail of Bin(b + c, 1/2), at most 1."""
    n, k = b + c, min(b, c)
    if n == 0:
        return 1.0
    tail = sum(math.comb(n, i) for i in range(k + 1)) / 2**n
    return min(1.0, 2 * tail)


def wilson(k: int, n: int, z: float = 1.959963984540054):
    """The Wilson score 95 % interval of the share k / n."""
    p = k / n
    centre = (p + z * z / (2 * n)) / (1 + z * z / n)
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / (1 + z * z / n)
    return centre - half, centre + half


def false_failure_rate(share: float, n: int, ref_bad: int, ref_n: int, limit: float) -> float:
    """The chance that ``n`` seeds of a port whose true share of NaN rows is
    ``share`` fail phase 52's rule (two-sided Fisher p of their count
    against ``ref_bad`` of ``ref_n`` below ``limit``): the exact binomial."""
    return sum(math.comb(n, x) * share**x * (1 - share) ** (n - x)
               for x in range(n + 1) if fisher_exact(x, n, ref_bad, ref_n) < limit)


def choose_limit(share: float, n: int, ref_bad: int, ref_n: int) -> float:
    """Phase 52's limit: the largest of ``LIMITS`` at which a port whose
    true share is ``share`` fails less often than ``FALSE_FAILURE``, else
    the smallest of them."""
    for limit in LIMITS:
        if false_failure_rate(share, n, ref_bad, ref_n, limit) < FALSE_FAILURE:
            return limit
    return LIMITS[-1]


def reference_positions(target, seed, n_chain):
    """The reference's initial chain positions at ``seed``: ``run_mfm``'s
    ``target.init_positions(key_pos, B)``, N(0, I) on the second of
    ``split(PRNGKey(seed), 3)``, made by ``jax_threefry``."""
    key_pos = tf.split(tf.prng_key(seed), 3)[1]
    return torch.from_numpy(tf.normal(key_pos, (n_chain, target.dim)))


def use_draws(arm, init, cfg, device, seeds):
    """Make ``run_mfm_seeds`` draw its step noise as arm ``arm`` does: the
    port's own (P), or the reference's loop keys (R); and start from the
    initial positions of ``init``: the port's own on ``device`` (port), a
    CPU generator's (cpu), or the reference's (reference). The Fourier
    frequencies and initial weights stay the port's."""
    multi_seed.build_mfm = mfm.build_mfm = PORT_BUILD
    positions = {"port": None, "cpu": nf.cpu_positions, "reference": reference_positions}[init]
    nf.patch_draws(cfg, device, seeds, "reference" if arm == "R" else "port", positions)


def cell(seed, flow, exact, log_w, u, target, real, metrics):
    """One cell's record: ``nf.record``'s flag and counts, and with
    ``metrics`` its metric row against the exact draws ``real``."""
    rec = nf.record(seed, flow, log_w, u)
    out = {k: rec[k] for k in ("flow_row_finite", "nonfinite_samples", "nonfinite_log_w",
                               "nonfinite_max_abs_u", "max_abs_u")}
    if metrics:
        out["metrics"] = evaluate_samples(target, flow, exact, real, fused_metrics=False)
    return out


def evaluate(run, seed, cfg, target, device, latents="PR", metrics=False):
    """``{latents: cell}`` of one trained flow on the port's eval latents
    (P: ``sample_flow`` as the CLI samples) and on the reference's (R)."""
    n = cfg.eval_iter * cfg.num_chain
    real = target.sample(make_generator(device, seed, REAL_STREAM), (n,)) if metrics else None
    gen = make_generator(device, seed, EVAL_STREAM)
    out = {}
    if "P" in latents:
        u = run.ref_dist.sample(make_generator(device, seed, EVAL_STREAM), (n,))  # its first draw
        flow, exact, log_w = cli.sample_flow(run, n, target, gen)
        out["P"] = cell(seed, flow, exact, log_w, u, target, real, metrics)
    if "R" in latents:
        u_ref = nf.reference_latents(seed, n, cfg.dim, device)
        flow, exact, log_w = sample_flow_parts(run.transport, run.train.params, run.ref_dist,
                                               target, u_ref, generator=gen)
        out["R"] = cell(seed, flow, exact, log_w, u_ref, target, real, metrics)
    return out


def sweep(args, seeds, arm, target):
    """One arm's sweep over ``seeds``: a line a seed, and its timing."""
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    use_draws(arm, args.init, cfg, args.device, seeds)
    t0 = time.perf_counter()
    trained = run_mfm_seeds(target, cfg, seeds, args.device)
    mfm._synchronize(args.device)
    t1 = time.perf_counter()
    lines = []
    for i, seed in enumerate(seeds):
        run = seed_run(trained, cfg, i)
        lines.append(dict(seed=seed, init=args.init, noise=arm, learning_iter=cfg.learning_iter,
                          train_finite=all(bool(torch.isfinite(v).all())
                                           for v in run.metrics.values()),
                          latents=evaluate(run, seed, cfg, target, args.device, args.latents,
                                           args.metrics)))
    t2 = time.perf_counter()
    return lines, dict(seeds=[seeds[0], seeds[-1]], init=args.init, noise=arm, train_s=t1 - t0,
                       eval_s=t2 - t1)


def chunks(args):
    return [args.seeds[i:i + args.chunk] for i in range(0, len(args.seeds), args.chunk)]


def run_study(args):
    target = cli.make_target("many-well", args.device)
    for seeds in chunks(args):
        for arm in args.arms:
            lines, timing = sweep(args, seeds, arm, target)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.writelines(json.dumps(line) + "\n" for line in lines)
            timing["nan_rows"] = {arm + lat: sum(not ln["latents"][lat]["flow_row_finite"]
                                                 for ln in lines) for lat in args.latents}
            sys.stdout.write(json.dumps(timing) + "\n")  # one write: workers share stdout
            sys.stdout.flush()


def spans(seeds):
    """``seeds`` as the "FIRST-LAST,..." text ``nf.seed_range`` reads."""
    out, first = [], seeds[0]
    for prev, seed in zip(seeds, seeds[1:] + [None]):
        if seed != prev + 1:
            out.append(f"{first}-{prev}")
            first = seed
    return ",".join(out)


def run_workers(args, argv):
    """The chunks dealt round-robin to ``--workers`` processes of this
    script, each with its own ``--out`` file (``OUT.w<k>``) and an equal
    share of the host's cores; the children are killed if this process is
    interrupted, and a child that failed fails it."""
    keep, skip = [], {"--seeds", "--out", "--workers"}
    it = iter(argv)
    for a in it:
        if a.split("=")[0] in skip:
            if "=" not in a:
                next(it)
        else:
            keep.append(a)
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // args.workers)))
    procs = []
    for k in range(args.workers):
        mine = [s for c in chunks(args)[k::args.workers] for s in c]
        if mine:
            cmd = [sys.executable, __file__, *keep, "--seeds", spans(mine),
                   "--out", f"{args.out}.w{k}"]
            procs.append(subprocess.Popen(cmd, env=env, start_new_session=True))
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    if any(codes):
        raise SystemExit(f"a worker failed: exit codes {codes}")


def flags(paths):
    """{seed: {cell: NaN flag}}: every cell a seed has, named by its
    initial positions (``INITS``' prefix), step noise and eval latents."""
    by_seed = {}
    for path in paths:
        for text in Path(path).read_text().splitlines():
            line = json.loads(text)
            name = INITS[line["init"]] + line["noise"]
            for lat, rec in line["latents"].items():
                by_seed.setdefault(line["seed"], {})[name + lat] = not rec["flow_row_finite"]
    return dict(sorted(by_seed.items()))


def metric_rows(paths):
    """{cell: {column: (mean, 1.96 sigma)}} over the seeds whose row in that
    cell is finite, for lines written with ``--metrics``."""
    rows = {}
    for path in paths:
        for text in Path(path).read_text().splitlines():
            line = json.loads(text)
            name = INITS[line["init"]] + line["noise"]
            for lat, rec in line["latents"].items():
                if "metrics" in rec and rec["flow_row_finite"]:
                    rows.setdefault(name + lat, []).append(rec["metrics"])
    return {c: {k: (float(np.mean([r[k] for r in rs])), 1.96 * float(np.std([r[k] for r in rs])))
                for k in METRIC_COLUMNS} | {"seeds": len(rs)} for c, rs in sorted(rows.items())}


def paired(cells, a, b):
    """Cell ``a`` against cell ``b`` on the same seeds: the effect in points
    (a's share minus b's), the discordant seeds each way and McNemar's p."""
    only_a = sum(f[a] and not f[b] for f in cells.values())
    only_b = sum(f[b] and not f[a] for f in cells.values())
    return dict(pair=f"{a}-{b}", effect_points=100 * (only_a - only_b) / len(cells),
                only_first=only_a, only_second=only_b, p=mcnemar_exact(only_a, only_b))


def factor(cells, pairs):
    """A factor's two pairs and whether it meets the rule."""
    rows = [paired(cells, a, b) for a, b in pairs]
    mean = sum(r["effect_points"] for r in rows) / len(rows)
    law = abs(mean) >= RULE_POINTS and all(r["p"] < RULE_P for r in rows)
    return dict(pairs=rows, mean_effect_points=mean, law_difference=law)


def reference_flags(path=BAND_FILE):
    """{seed: NaN flag} of the reference's committed many-well rows."""
    data = json.loads(Path(path).read_text())
    return {r["seed"]: not r["flow_row_finite"]
            for k in ("many_well", "many_well_more") for r in data[k]["rows"]}


def reference_pool(path=BAND_FILE):
    """(NaN seeds, seeds) of the reference's committed many-well rows."""
    ref = reference_flags(path)
    return sum(ref.values()), len(ref)


def against(every, name, other):
    """Cell ``name`` against cell ``other`` over the seeds that have both."""
    both = {s: f for s, f in every.items() if name in f and other in f}
    k = sum(f[name] for f in both.values())
    return dict(paired(both, name, other), seeds=len(both), share_first=k / len(both),
                ci95_first=wilson(k, len(both)))


def share(every, name):
    """Cell ``name``'s NaN seeds, seeds, share and Wilson 95 % interval."""
    flags_ = [f[name] for f in every.values() if name in f]
    k, n = sum(flags_), len(flags_)
    return dict(nan_seeds=k, seeds=n, share=k / n, ci95=list(wilson(k, n)))


def summary(paths, reference=BAND_FILE, phase_seeds=60):
    """The study's tables: every cell's share over its seeds; each cell on
    other initial positions against the same cell on the port's, and each
    cell against the reference's own flag, over the seeds that have both;
    the metric rows; and, over the seeds that have all four cells on the
    port's initial positions, the two factors, RR against the reference's
    pool and phase 52's false-failure rate by limit."""
    every = flags(paths)
    ref = reference_flags(reference)
    ref_bad, ref_n = sum(ref.values()), len(ref)
    names = sorted({c for f in every.values() for c in f})
    out = dict(shares={c: share(every, c) for c in names}, reference=[ref_bad, ref_n])
    for s, f in every.items():
        if s in ref:
            f["ref"] = ref[s]
    pairs = [(c, c[2:]) for c in names if ":" in c] + [(c, "ref") for c in names]
    out["init_effect"], out["reference_same_seeds"] = [], []
    for a, b in pairs:
        if any(a in f and b in f for f in every.values()):
            out["init_effect" if b != "ref" else "reference_same_seeds"].append(
                against(every, a, b))
    out["metric_rows"] = metric_rows(paths)
    cells = {s: f for s, f in every.items() if all(c in f for c in CELLS)}
    if cells:
        n = len(cells)
        rr = sum(f["RR"] for f in cells.values())
        pp = sum(f["PP"] for f in cells.values()) / n
        out.update(
            seeds=n, first=min(cells), last=max(cells),
            latent_effect=factor(cells, (("PP", "PR"), ("RP", "RR"))),
            noise_effect=factor(cells, (("PP", "RP"), ("PR", "RR"))),
            rr_against_reference=dict(rr=[rr, n], fisher_p=fisher_exact(rr, n, ref_bad, ref_n)),
            phase52_false_failure=dict(
                share=pp, seeds=phase_seeds,
                by_limit={str(lim): false_failure_rate(pp, phase_seeds, ref_bad, ref_n, lim)
                          for lim in LIMITS},
                limit=choose_limit(pp, phase_seeds, ref_bad, ref_n)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--learning-iter", type=int, default=100)
    p.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    p.add_argument("--seeds", type=nf.seed_range, default=None, metavar="FIRST-LAST[,...]")
    p.add_argument("--chunk", type=int, default=100, help="seeds a sweep")
    p.add_argument("--arms", default="PR", help="the step-noise arms to train: P, R or PR")
    p.add_argument("--latents", default="PR", help="the eval latent sets: P, R or PR")
    p.add_argument("--init", choices=INITS, default="port",
                   help="the initial positions: the port's on --device, a CPU generator's, or "
                        "the reference's (threefry)")
    p.add_argument("--metrics", action="store_true", help="add each cell's metric row")
    p.add_argument("--out", default=None, metavar="PATH", help="append a JSON line a seed and arm")
    p.add_argument("--workers", type=int, default=1,
                   help="processes sharing the device, each on every WORKERS-th chunk, each "
                        "writing OUT.w<k>")
    p.add_argument("--summary", nargs="+", default=None, metavar="PATH",
                   help="pair the lines of these files and print the tables")
    args = p.parse_args(argv)
    if args.summary:
        print(json.dumps(summary(args.summary), indent=1))
        return
    if not args.seeds:
        p.error("--seeds is required unless --summary")
    if not args.arms or set(args.arms) - set(ARMS):
        p.error("--arms takes P, R or PR")
    if not args.latents or set(args.latents) - set(ARMS):
        p.error("--latents takes P, R or PR")
    if args.workers > 1:
        if not args.out:
            p.error("--workers needs --out")
        return run_workers(args, sys.argv[1:] if argv is None else list(argv))
    run_study(args)


if __name__ == "__main__":
    main()
