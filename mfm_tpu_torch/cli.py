"""Command-line driver for the port (counterpart of ``mfm_tpu.cli``).

    python -m mfm_tpu_torch.cli --example 4-mode --seed 0 --learning-iter 200
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --learning-iter 500
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --ref-dist phifour
    python -m mfm_tpu_torch.cli --example pines --seed 0 --learning-iter 300
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --mcmc-kernel nuts
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --do-smc
    python -m mfm_tpu_torch.cli --example pines --seed 0 --flow-smc 4

Each example runs its preset as ``mfm_tpu`` ships it (phi-four and pines:
the bf16 field, ``field_precision='default'``; pines: the 'prior'
reference); ``--set`` overrides any config field, e.g.
``--set field_precision=highest --set pallas_field=true`` for the fused
fp32 field kernel, ``--set divergence_mode=exact_disc`` for the discrete
map's exact logdet. ``--num-importance-samples N`` picks the flow kernel
(N > 0 CIS, N < 0 independence MH, 0 pullback RWM), ``--ot-cond-flow`` the
minibatch-OT coupling, ``--no-cond-flow`` the path to a standard normal,
``--check`` adds the metrics of exact draws against themselves.
``--mcmc-kernel`` picks the MCMC move (mala, hmc, nuts; hmc and nuts adapt
their step size and mass in the loop).

Trains, samples through the flow with the IS correction, evaluates, and
prints the reference's metric row (logpdf / KSD-U / KSD-V / MMD / time; the
second row is the IS-corrected set). ``--do-smc`` runs the adaptive tempered
SMC baseline instead (both rows are its harvested particles);
``--flow-smc N`` replaces the IS correction by N flow-annealed SMC steps in
the flow's latent space (the second row is that ensemble, resampled by its
weights). With no ``--seed`` it replicates the
reference's seeds i**10, i < 10. The run needs the device it is given
(default ``cuda``); it never falls back to another.
"""

import argparse
import ast
import dataclasses
import functools
import logging

import numpy as np
import torch

from mfm_tpu_torch.config import MFMConfig, preset
from mfm_tpu_torch.drivers import (
    check_floor,
    evaluate_samples,
    run_flow_smc,
    run_mfm,
    run_smc,
    sample_flow,
)
from mfm_tpu_torch.drivers.mfm import ess_of, make_generator
from mfm_tpu_torch.targets import (
    Funnel,
    LogGaussianCoxPines,
    ManyWell,
    PhiFour,
    four_mode_mixture,
    random_mixture,
)

log = logging.getLogger("mfm_tpu_torch")

# example -> factory(device=...) of its target, built on the run's device
EXAMPLES = {
    "4-mode": four_mode_mixture,
    "gaussian-mixture": random_mixture,
    "phi-four": functools.partial(PhiFour, 64),
    "pines": functools.partial(LogGaussianCoxPines, 1600),
    "funnel": functools.partial(Funnel, 10),
    "many-well": functools.partial(ManyWell, 32),
}
# flags of the reference CLI whose code paths are not ported yet, with the
# reference's defaults (any other value is refused)
NOT_PORTED_FLAGS = {
    "do_fab": False, "do_flowmc": False, "do_dds": False,
    "vmap_seeds": False, "move_correct": 0, "defensive_alpha": 1.0,
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


def run_one(target, cfg, device, check: bool = False, do_smc: bool = False,
            flow_smc: int = 0) -> dict:
    """One seed: train, sample, evaluate. Returns the metric row with
    ``train_time``, ``it_per_s``, and the ESS of the weights behind the
    ``*_star`` row and its number of distinct points (``is_ess``,
    ``is_unique``), which say how far that row rests on a few points.
    ``check`` adds the floor: the metrics of the exact draws against
    themselves (``*_real``).

    ``do_smc``: the SMC baseline instead of MFM, with its ``log_z`` and
    final ``lmbda``; its rows are its harvested particles, which carry no
    importance weights (``is_ess`` and ``is_unique`` None). ``flow_smc`` N:
    the star row is the flow-SMC ensemble after N steps, resampled by its
    weights (``flow_smc_log_z``, ``flow_smc_lmbda``,
    ``flow_smc_ess_fraction``). An MFM run that adapts its step size reports
    the last one (``step_size``)."""
    n_eval = cfg.eval_iter * cfg.num_chain
    real_samples = None
    if target.can_sample:
        real_samples = target.sample(make_generator(device, cfg.seed, 1000), (n_eval,))
    extra = {}
    if do_smc:
        result = run_smc(target, cfg, device)
        flow_samples = exact_samples = result.particles
        train_time = result.train_time
        extra = {"log_z": float(result.log_z), "lmbda": float(result.lmbda),
                 "is_ess": None, "is_unique": None}
        log.info(f"SMC log_z={extra['log_z']:.6g} lmbda={extra['lmbda']:.6g}")
    else:
        run = run_mfm(target, cfg, device, logger=_ChunkLogger())
        train_time = run.train_time
        gen = make_generator(device, cfg.seed, 999)
        flow_samples, exact_samples, log_w = sample_flow(run, n_eval, target, gen)
        is_ess = ess_of(log_w)
        if flow_smc:
            r = run_flow_smc(
                target, cfg, run.transport, run.train.params, run.ref_dist, gen,
                n_particles=n_eval, n_steps=flow_smc,
            )
            idx = torch.multinomial(r.weights, n_eval, replacement=True, generator=gen)
            exact_samples = r.samples[idx]
            is_ess = r.ess_fraction * n_eval
            extra = {"flow_smc_log_z": float(r.log_z), "flow_smc_lmbda": float(r.lmbda),
                     "flow_smc_ess_fraction": float(r.ess_fraction),
                     "flow_smc_time": r.train_time}
            log.info(" ".join(f"{k}={v:.6g}" for k, v in extra.items()))
        extra["is_ess"] = float(is_ess)
        extra["is_unique"] = int(torch.unique(exact_samples, dim=0).shape[0])
        if "step_size" in run.metrics:
            extra["step_size"] = float(run.metrics["step_size"][-1])
    metrics = evaluate_samples(target, flow_samples, exact_samples, real_samples)
    if check and real_samples is not None:
        floor = check_floor(target, real_samples)
        log.info(" ".join(f"{k}={v:.4g}" for k, v in floor.items()))
        metrics.update(floor)
    metrics.update(extra)
    metrics["train_time"] = train_time
    metrics["it_per_s"] = cfg.learning_iter / train_time
    return metrics


def main(argv=None):
    """Run the CLI; returns the per-seed metric dicts."""
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        level=logging.INFO,
    )
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--example", default="4-mode", choices=list(EXAMPLES))
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--seed", type=int, default=None,
                   help="single seed; default replicates seeds i**10, i<10")
    p.add_argument("--mcmc-per-flow-steps", type=float, default=10.0)
    p.add_argument("--learning-iter", type=int, default=None)
    p.add_argument("--num-chain", type=int, default=None)
    p.add_argument("--num-importance-samples", type=int, default=0,
                   help="flow kernel: > 0 CIS with that many candidates, < 0 "
                        "independence MH, 0 pullback random-walk MH")
    p.add_argument("--hutchs", action="store_true")
    p.add_argument("--step-size", type=float, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--ref-dist", default=None,
                   help="flow reference (default: preset choice)")
    p.add_argument("--no-cond-flow", action="store_true")
    p.add_argument("--ot-cond-flow", action="store_true")
    p.add_argument("--ode-steps", type=int, default=None)
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--check", action="store_true",
                   help="also report the metrics of exact draws against themselves")
    p.add_argument("--chunk-size", type=int, default=None)
    p.add_argument("--mcmc-kernel", default="mala", choices=["mala", "hmc", "nuts"])
    p.add_argument("--do-smc", action="store_true",
                   help="run the adaptive tempered SMC baseline instead of MFM")
    p.add_argument("--flow-smc", type=int, default=0, metavar="N",
                   help="replace the final IS correction with N flow-annealed SMC "
                        "steps in the flow's latent space")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any MFMConfig field (repeatable)")
    for flag, default in NOT_PORTED_FLAGS.items():
        name = "--" + flag.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(name, action="store_true", help="not ported yet")
        else:
            p.add_argument(name, type=type(default), default=default, help="not ported yet")
    args = p.parse_args(argv)

    # `!=` against each flag's own default: `True in (False, 0, 1.0)` holds
    given = [f for f, default in NOT_PORTED_FLAGS.items() if getattr(args, f) != default]
    if given:
        flags = ", ".join("--" + f.replace("_", "-") for f in given)
        raise SystemExit(f"{flags}: not ported yet (the port runs the plain MFM path)")
    if args.flow_smc and args.do_smc:
        raise SystemExit("--flow-smc applies only to the MFM run and replaces its final "
                         "correction; drop --do-smc or --flow-smc")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    overrides = {"mcmc_per_flow_steps": args.mcmc_per_flow_steps,
                 "num_importance_samples": args.num_importance_samples}
    if args.ref_dist is not None:
        overrides["ref_dist"] = args.ref_dist
    if args.hutchs:
        overrides["hutchinson"] = True
    if args.no_cond_flow:
        overrides["cond_flow"] = False
    if args.ot_cond_flow:
        overrides["ot_cond_flow"] = True
    for name in ("learning_iter", "num_chain", "step_size", "learning_rate",
                 "ode_steps", "alpha", "chunk_size"):
        val = getattr(args, name)
        if val is not None:
            overrides[name] = val
    overrides["mcmc_kernel"] = args.mcmc_kernel
    overrides.update(_parse_set(args.set))
    cfg = preset(args.example, **overrides)
    target = EXAMPLES[args.example](device=device)

    seeds = [args.seed] if args.seed is not None else [i**10 for i in range(10)]
    results = []
    for seed in seeds:
        cfg.seed = seed
        results.append(run_one(target, cfg, device, check=args.check, do_smc=args.do_smc,
                               flow_smc=args.flow_smc))

    cols = ("logpdf", "stein_u", "stein_v", "mmd", "train_time")
    rows = np.asarray([[m[c] for c in cols] for m in results])
    rows_exact = np.asarray(
        [[m[c + "_star"] if c != "train_time" else m[c] for c in cols] for m in results]
    )
    print("SMC" if args.do_smc else (
        f"mcmc_per_flow_steps={cfg.mcmc_per_flow_steps},"
        f"learning_iter={cfg.learning_iter}" + (",hutchs" if cfg.hutchinson else "")
    ))
    print("-" * 100)
    print("logprob\t & stein-u\t & stein-v\t & mmd  \t & time \t")
    for data in (rows, rows_exact):
        mean, std = data.mean(axis=0), data.std(axis=0)
        print(*[f"{m:.2e} \\pm {s * 1.96:.2e}" for m, s in zip(mean, std)], sep="$ & $")
    print("-" * 100)
    return results


if __name__ == "__main__":
    main()
