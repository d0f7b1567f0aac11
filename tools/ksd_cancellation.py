#!/usr/bin/env python3
"""KSD-U of pines' flow samples four ways: the plain fp32 statistic on the
points as they are (the reference's arithmetic on a CPU:
r = |x_i|^2 + |x_j|^2 - 2 x_i.x_j), the same on centred points, float64,
and K2a (``stein_disc_fused``: centred, fp64 tile sums) where the points
lie on a CUDA device.

The samples are the port's own at the pines band of
``tools/seed_band_reference.json`` (64 chains, widths 32, 300 iterations,
512 flow samples, drawn as the CLI draws them), or a saved set:

    python3 tools/ksd_cancellation.py --device cpu --seeds 0 --save build/pines_0.pt
    python3 tools/ksd_cancellation.py --samples build/pines_0.pt     # the same points, K2a too

Prints one JSON line a seed: each statistic and its relative gap to float64.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mfm_tpu_torch import cli  # noqa: E402
from mfm_tpu_torch import config  # noqa: E402
from mfm_tpu_torch.diagnostics.metrics import stein_disc  # noqa: E402
from mfm_tpu_torch.drivers.mfm import make_generator, run_mfm, sample_flow  # noqa: E402
from mfm_tpu_torch.ops.pairwise import stein_disc_fused  # noqa: E402


def band_samples(seed, device):
    band = json.loads((ROOT / "tools" / "seed_band_reference.json").read_text())["bands"]["pines"]
    overrides = {k: tuple(v) if isinstance(v, list) else v for k, v in band["overrides"].items()}
    cfg = config.preset("pines", seed=seed, **overrides)
    target = cli.make_target("pines", device)
    run = run_mfm(target, cfg, device)
    flow, _, _ = sample_flow(run, cfg.eval_iter * cfg.num_chain, target,
                             make_generator(device, seed, 999))
    return flow


def statistics(X, target):
    """KSD-U of X (T, d) by each arithmetic; the score once, in fp32."""
    S = target.score(X)
    out = {"fp32": float(stein_disc(X, lambda _: S)[0]),
           "fp32_centred": float(stein_disc(X - X.mean(0), lambda _: S)[0]),
           "fp64": float(stein_disc(X.double(), lambda _: S.double())[0])}
    if X.is_cuda:
        out["k2a"] = float(stein_disc_fused(X, lambda _: S)[0])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seeds", type=int, nargs="*", default=[0])
    p.add_argument("--samples", default=None, help="a saved set (--save) instead of training")
    p.add_argument("--save", default=None, help="save the first seed's samples here")
    args = p.parse_args(argv)
    target = cli.make_target("pines", args.device)
    if args.samples:
        saved = torch.load(args.samples)
        sets = [(saved["seed"], saved["device"], saved["flow"].to(args.device))]
    else:
        sets = [(s, args.device, band_samples(s, args.device)) for s in args.seeds]
        if args.save:
            torch.save(dict(seed=sets[0][0], device=args.device, flow=sets[0][2].cpu()), args.save)
    for seed, made_on, X in sets:
        stats = statistics(X, target)
        print(json.dumps({"seed": seed, "samples_from": made_on, "device": args.device,
                          "T": X.shape[0], "d": X.shape[1],
                          "max_sq_norm": float(torch.max(torch.sum(X * X, -1))), **stats,
                          **{f"{k}_rel_to_fp64": v / stats["fp64"] - 1.0 for k, v in stats.items()
                             if k != "fp64"}}), flush=True)


if __name__ == "__main__":
    main()
