#!/usr/bin/env python3
"""many-well's non-finite flow rows in the port: many-well as preset at 100
iterations, the seeds trained as one sweep (``run_mfm_seeds``, the CLI's
``--vmap-seeds`` path) and each then sampled as the CLI samples it
(``sample_flow`` on the seed's stream 999), and for each seed how many of
its 12,800 eval samples and IS log-weights are not finite (one such sample
makes the flow row NaN); with ``--single``, each seed trained alone
instead (``run_mfm``, the CLI's ``--seed s`` path). The reference's counts
come from ``tools/seed_band_reference.py --many-well``.

    python3 tools/many_well_nonfinite.py                     # the CLI's 10 seeds, on the card
    python3 tools/many_well_nonfinite.py --seeds 1000-1039   # other seeds
    python3 tools/many_well_nonfinite.py --device cpu --single --seeds 1000-1019
    python3 tools/many_well_nonfinite.py --device cpu --learning-iter 4 \
        --set num_chain=8 --set eval_iter=4                  # a tiny dry run

``--save PATH`` keeps the first seed's parameters, latent draws and flow
samples; ``--replay PATH`` transports such a file's draws with its
parameters on ``--device`` and compares the samples with the saved ones
(the same non-finite rows, the largest difference of the rest), which
tells a device's transport from its training.

Prints one JSON line a seed and, last, all of them as one JSON object."""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mfm_tpu_torch import cli  # noqa: E402
from mfm_tpu_torch import config  # noqa: E402
from mfm_tpu_torch.drivers.mfm import build_mfm, make_generator, run_mfm  # noqa: E402
from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds, seed_run  # noqa: E402


def seed_range(text):
    first, _, last = text.partition("-")
    return list(range(int(first), int(last or first) + 1))


def record(seed, flow, log_w):
    bad = ~torch.isfinite(flow).all(-1)
    return dict(seed=seed, n_eval=int(flow.shape[0]), flow_row_finite=not bool(bad.any()),
                nonfinite_samples=int(bad.sum()),
                nonfinite_log_w=int((~torch.isfinite(log_w)).sum()))


def seed_sweep(args, seeds):
    """``seeds`` as one sweep, each seed then sampled as the CLI samples it:
    a record a seed, and the first seed's (frequencies, parameters, latent
    draws, flow samples)."""
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    target = cli.make_target("many-well", args.device)
    sweep = run_mfm_seeds(target, cfg, seeds, args.device)
    n = cfg.eval_iter * cfg.num_chain
    recs, first = [], None
    for i, seed in enumerate(seeds):
        run = seed_run(sweep, cfg, i)
        flow, _, log_w = cli.sample_flow(run, n, target, make_generator(args.device, seed, 999))
        recs.append(record(seed, flow, log_w))
        if first is None:  # sample_flow's first draw: the latent points
            u = run.ref_dist.sample(make_generator(args.device, seed, 999), (n,))
            first = (sweep.fourier[i], run.train.params, u, flow)
    return recs, first


def single_seeds(args, seeds):
    """Each seed trained and sampled alone, as the CLI's ``--seed s`` runs
    it: a record a seed."""
    target = cli.make_target("many-well", args.device)
    recs = []
    for seed in seeds:
        cfg = config.preset("many-well", seed=seed, learning_iter=args.learning_iter,
                            **cli._parse_set(args.set))
        run = run_mfm(target, cfg, args.device)
        flow, _, log_w = cli.sample_flow(run, cfg.eval_iter * cfg.num_chain, target,
                                         make_generator(args.device, seed, 999))
        recs.append(record(seed, flow, log_w))
        print(json.dumps(recs[-1]), flush=True)
    return recs


def replay(args):
    """The saved draws through the saved parameters on ``--device``."""
    saved = torch.load(args.replay)
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    pieces = build_mfm(cli.make_target("many-well", args.device), cfg, args.device,
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(saved["freqs"].to(args.device))
        params = {k: v.to(args.device) for k, v in saved["params"].items()}
        x, _ = pieces.transport.forward(params, saved["u"].to(args.device), None)
    x = x.cpu()
    bad, bad_saved = ~torch.isfinite(x).all(-1), ~torch.isfinite(saved["x"]).all(-1)
    ok = ~bad & ~bad_saved
    out = dict(replay=args.replay, saved_device=saved["device"], device=args.device,
               seed=saved["seed"], nonfinite=int(bad.sum()), nonfinite_saved=int(bad_saved.sum()),
               same_rows=bool(torch.equal(bad, bad_saved)),
               max_abs_dx=float((x[ok] - saved["x"][ok]).abs().max()))
    print(json.dumps(out), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--learning-iter", type=int, default=100)
    p.add_argument("--set", action="append", default=[], metavar="FIELD=VALUE")
    p.add_argument("--seeds", type=seed_range, default=[i**10 for i in range(10)],
                   metavar="FIRST-LAST", help="default: the CLI's 10 replication seeds")
    p.add_argument("--single", action="store_true",
                   help="train each seed alone (the CLI's --seed s path), not as one sweep")
    p.add_argument("--save", default=None, metavar="PATH",
                   help="save the first seed's parameters, draws and flow samples")
    p.add_argument("--replay", default=None, metavar="PATH",
                   help="transport a saved file's draws on --device and compare")
    args = p.parse_args(argv)
    if args.replay:
        return replay(args)
    if args.single and args.save:
        p.error("--save keeps a sweep's first seed: it does not apply to --single")

    t0 = time.perf_counter()
    if args.single:
        recs = single_seeds(args, args.seeds)
    else:
        recs, first = seed_sweep(args, args.seeds)
        for rec in recs:
            print(json.dumps(rec), flush=True)
    wall = time.perf_counter() - t0
    if args.save:
        freqs, params, u, flow = first
        torch.save(dict(seed=recs[0]["seed"], device=args.device, freqs=freqs.cpu(), u=u.cpu(),
                        x=flow.cpu(), params={k: v.detach().cpu() for k, v in params.items()}),
                   args.save)
    name = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "cpu"
    print(json.dumps({"device": name, "path": "single" if args.single else "sweep",
                      "learning_iter": args.learning_iter, "wall_s": wall,
                      "seeds": len(recs), "nan_rows": sum(not r["flow_row_finite"] for r in recs),
                      "nonfinite_samples": sum(r["nonfinite_samples"] for r in recs),
                      "rows": recs}))


if __name__ == "__main__":
    main()
