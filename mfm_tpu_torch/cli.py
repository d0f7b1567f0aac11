"""Command-line driver for the port (counterpart of ``mfm_tpu.cli``).

    python -m mfm_tpu_torch.cli --example 4-mode --seed 0 --learning-iter 200
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --learning-iter 500
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --ref-dist phifour

Each example runs its preset as ``mfm_tpu`` ships it (phi-four: the bf16
field, ``field_precision='default'``); ``--set`` overrides any config field,
e.g. ``--set field_precision=highest --set pallas_field=true`` for the
fused fp32 field kernel.

Trains, samples through the flow with the IS correction, evaluates, and
prints the reference's metric row (logpdf / KSD-U / KSD-V / MMD / time; the
second row is the IS-corrected set). With no ``--seed`` it replicates the
reference's seeds i**10, i < 10. The run needs the device it is given
(default ``cuda``); it never falls back to another.
"""

import argparse
import ast
import dataclasses
import logging

import numpy as np
import torch

from mfm_tpu_torch.config import MFMConfig, preset
from mfm_tpu_torch.drivers import evaluate_samples, run_mfm, sample_flow
from mfm_tpu_torch.drivers.mfm import ess_of, make_generator
from mfm_tpu_torch.targets import PhiFour, four_mode_mixture, random_mixture

log = logging.getLogger("mfm_tpu_torch")

EXAMPLES = {
    "4-mode": four_mode_mixture,
    "gaussian-mixture": random_mixture,
    "phi-four": lambda device: PhiFour(64),
}
NOT_PORTED_EXAMPLES = ("pines", "funnel", "many-well")
# flags of the reference CLI whose code paths are not ported yet, with the
# reference's defaults (any other value is refused)
NOT_PORTED_FLAGS = {
    "do_smc": False, "do_fab": False, "do_flowmc": False, "do_dds": False,
    "vmap_seeds": False, "move_correct": 0, "flow_smc": 0, "defensive_alpha": 1.0,
}


class _ChunkLogger:
    def log(self, metrics: dict):
        log.info(" ".join(f"{k}={v:.4g}" for k, v in metrics.items()))


def _parse_set(items):
    settable = {f.name for f in dataclasses.fields(MFMConfig)}
    out = {}
    for item in items:
        key, eq, raw = item.partition("=")
        if not eq or key not in settable:
            raise SystemExit(f"--set: unknown config field {key!r}")
        lowered = raw.strip().lower()
        if lowered in ("true", "false"):
            value = lowered == "true"
        elif lowered in ("none", "null"):
            value = None
        else:
            try:
                value = ast.literal_eval(raw)
            except (ValueError, SyntaxError):
                value = raw  # plain string
        out[key] = value
    return out


def run_one(target, cfg, device) -> dict:
    """One seed: train, sample, evaluate. Returns the metric row with
    ``train_time``, ``it_per_s``, and the IS weights' ESS and the number of
    distinct resampled points (``is_ess``, ``is_unique``), which say how
    far the ``*_star`` row rests on a few points."""
    n_eval = cfg.eval_iter * cfg.num_chain
    real_samples = None
    if target.can_sample:
        real_samples = target.sample(make_generator(device, cfg.seed, 1000), (n_eval,))
    run = run_mfm(target, cfg, device, logger=_ChunkLogger())
    flow_samples, exact_samples, log_w = sample_flow(
        run, n_eval, target, make_generator(device, cfg.seed, 999)
    )
    metrics = evaluate_samples(target, flow_samples, exact_samples, real_samples)
    metrics["is_ess"] = float(ess_of(log_w))
    metrics["is_unique"] = int(torch.unique(exact_samples, dim=0).shape[0])
    metrics["train_time"] = run.train_time
    metrics["it_per_s"] = cfg.learning_iter / run.train_time
    return metrics


def main(argv=None):
    """Run the CLI; returns the per-seed metric dicts."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--example", default="4-mode",
                   choices=[*EXAMPLES, *NOT_PORTED_EXAMPLES])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--seed", type=int, default=None,
                   help="single seed; default replicates seeds i**10, i<10")
    p.add_argument("--mcmc-per-flow-steps", type=float, default=10.0)
    p.add_argument("--learning-iter", type=int, default=None)
    p.add_argument("--num-chain", type=int, default=None)
    p.add_argument("--hutchs", action="store_true")
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--ref-dist", default=None,
                   help="flow reference (default: preset choice)")
    p.add_argument("--ode-steps", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any MFMConfig field (repeatable)")
    for flag, default in NOT_PORTED_FLAGS.items():
        name = "--" + flag.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(name, action="store_true", help="not ported yet")
        else:
            p.add_argument(name, type=type(default), default=default, help="not ported yet")
    args = p.parse_args(argv)

    if args.example in NOT_PORTED_EXAMPLES:
        raise SystemExit(f"--example {args.example} is not ported yet")
    # `!=` against each flag's own default: `True in (False, 0, 1.0)` holds
    given = [f for f, default in NOT_PORTED_FLAGS.items() if getattr(args, f) != default]
    if given:
        flags = ", ".join("--" + f.replace("_", "-") for f in given)
        raise SystemExit(f"{flags}: not ported yet (the port runs the plain MFM path)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    overrides = {"mcmc_per_flow_steps": args.mcmc_per_flow_steps}
    if args.ref_dist is not None:
        overrides["ref_dist"] = args.ref_dist
    if args.hutchs:
        overrides["hutchinson"] = True
    for name in ("learning_iter", "num_chain", "step_size", "learning_rate",
                 "ode_steps", "alpha", "chunk_size"):
        val = getattr(args, name)
        if val is not None:
            overrides[name] = val
    overrides.update(_parse_set(args.set))
    cfg = preset(args.example, **overrides)
    target = EXAMPLES[args.example](device)

    seeds = [args.seed] if args.seed is not None else [i**10 for i in range(10)]
    results = []
    for seed in seeds:
        cfg.seed = seed
        results.append(run_one(target, cfg, device))

    cols = ("logpdf", "stein_u", "stein_v", "mmd", "train_time")
    rows = np.asarray([[m[c] for c in cols] for m in results])
    rows_exact = np.asarray(
        [[m[c + "_star"] if c != "train_time" else m[c] for c in cols] for m in results]
    )
    print(
        f"mcmc_per_flow_steps={cfg.mcmc_per_flow_steps},"
        f"learning_iter={cfg.learning_iter}" + (",hutchs" if cfg.hutchinson else "")
    )
    print("-" * 100)
    print("logprob\t & stein-u\t & stein-v\t & mmd  \t & time \t")
    for data in (rows, rows_exact):
        mean, std = data.mean(axis=0), data.std(axis=0)
        print(*[f"{m:.2e} \\pm {s * 1.96:.2e}" for m, s in zip(mean, std)], sep="$ & $")
    print("-" * 100)
    return results


if __name__ == "__main__":
    main()
