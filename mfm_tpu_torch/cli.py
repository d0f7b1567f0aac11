"""Command-line driver for the port (counterpart of ``mfm_tpu.cli``).

    python -m mfm_tpu_torch.cli --example 4-mode --seed 0 --learning-iter 200
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --learning-iter 500
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --ref-dist phifour
    python -m mfm_tpu_torch.cli --example pines --seed 0 --learning-iter 300
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --mcmc-kernel nuts
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --do-smc
    python -m mfm_tpu_torch.cli --example pines --seed 0 --flow-smc 4
    python -m mfm_tpu_torch.cli --example phi-four --seed 0 --do-fab
    python -m mfm_tpu_torch.cli --example pines --seed 0 --move-correct 100
    python -m mfm_tpu_torch.cli --example many-well --seed 0 --defensive-alpha 0.9
    python -m mfm_tpu_torch.cli --example 4-mode --vmap-seeds --run-dir runs
    python -m torch.distributed.run --standalone --nproc-per-node 2 -m mfm_tpu_torch.cli \
        --example phi-four --seed 0 --set mesh_shape='(1,2)'

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
``--do-fab``, ``--do-flowmc``, ``--do-dds`` run those baselines instead
(first row their sampler's draws, second row those draws IS-resampled);
``--flow-smc N`` replaces the IS correction by N flow-annealed SMC steps in
the flow's latent space (the second row is that ensemble, resampled by its
weights); ``--move-correct N`` follows the IS correction (or the flow-SMC
ensemble) with N self-tuning MALA moves on the target (the first row is
then the IS-resampled set, the second the moved one); ``--defensive-alpha
a`` draws 1 - a of the IS proposal from N(0, defensive_var I) (the first
row is the flow's share). With no ``--seed`` it replicates the
reference's seeds i**10, i < 10; ``--vmap-seeds`` trains them as one
seed-batched run (``drivers.multi_seed``) and evaluates each seed as a run
of its own is evaluated. Each seed logs to
``<run-dir>/<example>-seed<seed>.jsonl`` (``utils.logging``; chunk means,
the final row, and with ``--full-metrics`` every iteration's metrics);
``--wandb`` adds Weights & Biases where it is installed. The run needs the
device it is given (default ``cuda``); it never falls back to another.

``--set mesh_shape=(e,c)`` shards one run's chains over e c ranks started
by ``torchrun`` (``parallel.mesh``; ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` come from its environment). Rank r
computes on card ``LOCAL_RANK % device_count``; the backend is NCCL where
each rank has a card of its own and gloo where ranks share one (or on the
CPU); each rank logs its card and the backend. Every rank trains its
rows; rank 0 evaluates, prints the row and writes ``--run-dir``. A mesh
is refused without a process group of its size, and with
``--vmap-seeds``, the baselines (``--do-fab``, ``--do-flowmc``,
``--do-dds``), ``--flow-smc`` and ``--move-correct``, which have no
sharded path (the reference runs them unsharded or drops the mesh).
"""

import argparse
import ast
import dataclasses
import functools
import logging
from typing import Optional

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
from mfm_tpu_torch.drivers.baselines import BASELINES, run_baseline
from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds, seed_run
from mfm_tpu_torch.drivers.mfm import (
    check_normalised,
    defensive_split,
    draw_move_noise,
    ess_of,
    make_generator,
    mala_move_correct,
    reference_of,
    sample_flow_defensive,
    sample_flow_move,
)
from mfm_tpu_torch.targets import (
    Funnel,
    IndepGaussian,
    LogGaussianCoxPines,
    ManyWell,
    PhiFour,
    four_mode_mixture,
    random_mixture,
)
from mfm_tpu_torch.utils.logging import MetricLogger


# example -> factory(device=...) of its target, built on the run's device
EXAMPLES = {
    "4-mode": four_mode_mixture,
    "gaussian-mixture": random_mixture,
    "phi-four": functools.partial(PhiFour, 64),
    "pines": functools.partial(LogGaussianCoxPines, 1600),
    "funnel": functools.partial(Funnel, 10),
    "many-well": functools.partial(ManyWell, 32),
}
RUN_DIR = "runs"  # --run-dir's default, the reference's


def make_target(example: str, device="cuda"):
    """The example's target, built on ``device``."""
    if example not in EXAMPLES:
        raise ValueError(f"unknown example {example!r}")
    return EXAMPLES[example](device=device)


def make_logger(cfg, args) -> MetricLogger:
    """The reference's per-seed logger: ``<run_dir>/<example>-seed<seed>.jsonl``."""
    return MetricLogger(
        run_dir=args.run_dir,
        run_name=f"{cfg.example}-seed{cfg.seed}",
        use_wandb=args.wandb,
        wandb_kwargs={
            "project": cfg.example,
            "group": f"dim={cfg.dim}",
            "job_type": f"mcmc_per_flow_steps={cfg.mcmc_per_flow_steps}",
        },
    )


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
            flow_smc: int = 0, baseline: str = None, move_correct: int = 0,
            defensive_alpha: float = 1.0, defensive_var: float = 4.0,
            logger: MetricLogger = None, full_metrics: bool = False, run=None,
            fused_metrics: Optional[bool] = None, plots: bool = False) -> dict:
    """One seed: train, sample, evaluate. Returns the metric row with
    ``train_time``, ``it_per_s``, and the ESS of the weights behind the
    ``*_star`` row and its number of distinct points (``is_ess``,
    ``is_unique``), which say how far that row rests on a few points.
    ``check`` adds the floor: the metrics of the exact draws against
    themselves (``*_real``).

    ``do_smc``: the SMC baseline instead of MFM, with its ``log_z`` and
    final ``lmbda``; its rows are its harvested particles, which carry no
    importance weights (``is_ess`` and ``is_unique`` None). ``baseline``
    (fab, flowmc, dds): that baseline instead, its extras (``log_z_is``,
    ``is_ess_frac``, and ``final_loss``, ``mean_accept``... as it has them)
    in the row. ``flow_smc`` N: the star row is the flow-SMC ensemble after
    N steps, resampled by its weights (``flow_smc_log_z``,
    ``flow_smc_lmbda``, ``flow_smc_ess_fraction``). ``move_correct`` N: N
    MALA moves after the IS correction (or after flow-SMC); the first row is
    then the IS-resampled set (or the raw flow draws under flow-SMC), the
    star row the moved set. ``defensive_alpha`` < 1: the IS proposal mixes
    in N(0, defensive_var I); the first row is the flow's share of the
    draws. An MFM run that adapts its step size reports the last one
    (``step_size``).

    ``logger`` (default: none) gets the chunk means, the extras and the
    final row, and with ``full_metrics`` every iteration's metrics. ``run``:
    an MFM run already trained (one seed of a sweep), evaluated in place of
    a training run. ``fused_metrics`` is ``evaluate_samples``' choice of
    the pairwise kernels (``--pallas-metrics``); ``plots`` renders the
    reference's figure set (``drivers.plots.make_run_figures``) into the
    logger's run directory. Under a chain mesh every rank trains and rank
    0 alone evaluates: the other ranks return None."""
    log_to = logger if logger is not None else MetricLogger(stdout_every=0)
    n_eval = cfg.eval_iter * cfg.num_chain
    real_samples = None
    if target.can_sample:
        real_samples = target.sample(make_generator(device, cfg.seed, 1000), (n_eval,))
    extra = {}
    if do_smc:
        result = run_smc(target, cfg, device)
        if not _is_primary():
            return None
        flow_samples = exact_samples = result.particles
        train_time = result.train_time
        extra = {"log_z": float(result.log_z), "lmbda": float(result.lmbda),
                 "is_ess": None, "is_unique": None}
        log_to.log({"lmbda": extra["lmbda"], "log_z": extra["log_z"]})
    elif baseline is not None:
        result = run_baseline(baseline, target, cfg, seed=cfg.seed, n_eval=n_eval, device=device)
        flow_samples, exact_samples = result.flow_samples, result.exact_samples
        train_time = result.train_time
        extra = {k: v for k, v in result.extras.items() if isinstance(v, float)}
        extra["is_ess"] = extra["is_ess_frac"] * n_eval
        extra["is_unique"] = int(torch.unique(exact_samples, dim=0).shape[0])
        log_to.log(dict(extra))
    else:
        if run is None:
            run = run_mfm(target, cfg, device, logger=log_to)
        if not _is_primary():  # under a mesh rank 0 evaluates the gathered run
            return None
        train_time = run.train_time
        gen = make_generator(device, cfg.seed, 999)
        if defensive_alpha < 1.0:
            n_flow, _ = defensive_split(n_eval, defensive_alpha)
            mixture, exact_samples, log_w = sample_flow_defensive(
                run, n_eval, target, IndepGaussian(cfg.dim, var=defensive_var),
                defensive_alpha, gen)
            flow_samples = mixture[:n_flow]  # the flow's draws, not the mixture's
            extra["defensive_n_flow"] = n_flow
        elif move_correct and not flow_smc:
            moved, flow_samples, log_w = sample_flow_move(
                run, n_eval, target, gen, n_moves=move_correct, init_step=cfg.step_size)
            exact_samples = moved
        else:
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
            log_to.log(dict(extra))
            if move_correct:  # the annealed ensemble seeds the move kernel
                noises = draw_move_noise(gen, move_correct, n_eval, cfg.dim)
                exact_samples = mala_move_correct(exact_samples, target, noises,
                                                  init_step=cfg.step_size)
        extra["is_ess"] = float(is_ess)
        extra["is_unique"] = int(torch.unique(exact_samples, dim=0).shape[0])
        if "step_size" in run.metrics:
            extra["step_size"] = float(run.metrics["step_size"][-1])
    metrics = evaluate_samples(target, flow_samples, exact_samples, real_samples,
                               fused_metrics=fused_metrics)
    if check and real_samples is not None:
        floor = check_floor(target, real_samples, fused_metrics=fused_metrics)
        log_to.summary(floor)
        metrics.update(floor)
    metrics.update(extra)
    metrics["train_time"] = train_time
    metrics["it_per_s"] = cfg.learning_iter / train_time
    log_to.summary(metrics)
    if plots:
        from mfm_tpu_torch.drivers.plots import make_run_figures

        log_to.log_figures(make_run_figures(target, cfg, flow_samples, exact_samples, run=run,
                                            noise=make_generator(device, cfg.seed, 999)))
    if full_metrics and run is not None:
        log_to.log_per_iteration(run.metrics)
    log_to.finish()
    return metrics


def _is_primary() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


MESH_REFUSED = ("vmap_seeds", "do_fab", "do_flowmc", "do_dds", "flow_smc", "move_correct")


def start_mesh(mesh_shape, args):
    """Join the ``torchrun`` process group for ``mesh_shape`` (or take the
    one the calling program initialised) and return (this rank's device,
    whether the group was started here); refuses by name the flags that
    have no sharded path and a group that is missing or of another size."""
    import os

    import torch.distributed as dist

    from mfm_tpu_torch.parallel.mesh import device_of_rank, init_from_env, make_mesh

    refused = [f"--{f.replace('_', '-')}" for f in MESH_REFUSED if getattr(args, f)]
    if refused:
        raise SystemExit(
            f"--set mesh_shape={tuple(mesh_shape)}: {', '.join(refused)} has no sharded path "
            "(the reference runs it unsharded or drops the mesh); drop one of them")
    started = not (dist.is_available() and dist.is_initialized())
    try:
        if started:
            _, _, _, device = init_from_env(args.device)
        else:
            device = device_of_rank(args.device, int(os.environ.get("LOCAL_RANK",
                                                                    dist.get_rank())))
        mesh = make_mesh(tuple(mesh_shape), device=device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"--set mesh_shape={tuple(mesh_shape)}: {e}") from None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logging.getLogger("mfm_tpu_torch").info(
        "mesh %s: rank %d of %d on %s (%s), backend %s", mesh.shape, mesh.rank, mesh.size,
        device, name, mesh.backend)
    return device, started


def run_seeds_vmapped(target, cfg, seeds, device, args) -> list:
    """All seeds trained as one seed-batched run (``run_mfm_seeds``), then
    each seed evaluated as ``run_one`` evaluates a run of its own, with the
    sweep's train_time shared out evenly. Returns the per-seed rows."""
    sweep = run_mfm_seeds(target, cfg, seeds, device)
    results = []
    for i, seed in enumerate(seeds):
        cfg.seed = seed
        results.append(run_one(target, cfg, device, logger=make_logger(cfg, args),
                               run=seed_run(sweep, cfg, i), fused_metrics=args.pallas_metrics,
                               plots=args.plots))
    return results


def _check_flags(args) -> None:
    """The reference's conflict guards (``mfm_tpu/cli.py:334-354``) and the
    port's own: ``--defensive-alpha`` below 1 is refused wherever the
    reference would ignore it; ``--pallas-metrics`` off the card, where
    there is no kernel; ``--plots`` where matplotlib does not import, before
    training and not after it."""
    if args.pallas_metrics and torch.device(args.device).type != "cuda":
        raise SystemExit(
            f"--pallas-metrics: the pairwise kernels (K2a/K2b) run only on a CUDA device, "
            f"not on {args.device}; drop it or pass --no-pallas-metrics")
    if args.plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--plots needs matplotlib, which does not import here; "
                             "drop --plots") from None
    non_mfm = [f"--{f.replace('_', '-')}" for f in ("do_smc", "do_fab", "do_flowmc", "do_dds")
               if getattr(args, f)]
    if args.move_correct and non_mfm:
        raise SystemExit(
            f"--move-correct applies only to the MFM run (the * columns of {non_mfm[0]} are "
            "not move-corrected); drop one of the conflicting flags")
    if args.flow_smc and non_mfm:
        raise SystemExit(
            "--flow-smc applies only to the MFM run and replaces its final correction; drop "
            f"{non_mfm[0]} or --flow-smc (it does compose with --move-correct)")
    if args.vmap_seeds:
        baselines = [f for f in non_mfm if f != "--do-smc"]
        if baselines:
            raise SystemExit(
                "--vmap-seeds only applies to the MFM sampler; drop it or the baseline flag "
                f"({', '.join(baselines)})")
        if not args.do_smc:
            conflicts = [f for f, on in (
                ("--move-correct", args.move_correct), ("--flow-smc", args.flow_smc),
                ("--defensive-alpha", args.defensive_alpha < 1.0), ("--check", args.check),
                ("--full-metrics", args.full_metrics)) if on]
            if conflicts:
                raise SystemExit(
                    f"--vmap-seeds trains the seeds as one run and evaluates each with the "
                    f"plain IS correction; {', '.join(conflicts)} would be ignored: drop it "
                    "or --vmap-seeds")
    if not 0.0 < args.defensive_alpha <= 1.0:
        raise SystemExit(f"--defensive-alpha must be in (0, 1], got {args.defensive_alpha}")
    if args.defensive_alpha < 1.0:
        other = non_mfm + [f for f, on in (("--flow-smc", args.flow_smc),
                                           ("--move-correct", args.move_correct)) if on]
        if other:
            raise SystemExit(
                f"--defensive-alpha applies only to the plain IS correction of the MFM run; "
                f"it would be ignored with {', '.join(other)}")


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
    for name in BASELINES:
        p.add_argument(f"--do-{name}", action="store_true",
                       help=f"run the {name} baseline instead of MFM")
    p.add_argument("--move-correct", type=int, default=0, metavar="N",
                   help="after the IS correction (or --flow-smc), N self-tuning MALA "
                        "moves on the target")
    p.add_argument("--defensive-alpha", type=float, default=1.0,
                   help="final IS proposal a*q_flow + (1-a)*N(0, defensive_var I); "
                        "1.0 (default) is the flow alone")
    p.add_argument("--defensive-var", type=float, default=4.0,
                   help="variance of the defensive component")
    p.add_argument("--vmap-seeds", action="store_true",
                   help="train every replication seed as one seed-batched run, then "
                        "evaluate each seed (the MFM sampler only; --do-smc runs its "
                        "seeds one by one)")
    p.add_argument("--run-dir", default=RUN_DIR,
                   help=f"directory of the per-seed JSONL logs (default: {RUN_DIR})")
    p.add_argument("--full-metrics", action="store_true",
                   help="also log every training iteration's metrics")
    p.add_argument("--wandb", action="store_true",
                   help="also log to Weights & Biases, where it is installed")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any MFMConfig field (repeatable)")
    p.add_argument("--pallas-metrics", action=argparse.BooleanOptionalAction, default=None,
                   help="evaluate KSD/MMD with the pairwise CUDA kernels (K2a/K2b); "
                        "default: on for a CUDA device; --no-pallas-metrics runs the "
                        "tiled plain PyTorch statistics (refused with --device cpu, "
                        "where there is no kernel)")
    p.add_argument("--plots", action="store_true",
                   help="save the reference's end-of-run figures (pair scatters, phi-four "
                        "fields, the 2-D flow progression) as PNGs under the run dir; "
                        "needs matplotlib")
    args = p.parse_args(argv)
    _check_flags(args)
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
    mesh_shape = overrides.get("mesh_shape")
    started = False
    if mesh_shape is not None:
        device, started = start_mesh(mesh_shape, args)
    try:
        return _run(args, overrides, device)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, overrides, device) -> list:
    cfg = preset(args.example, **overrides)
    target = make_target(args.example, device)
    if args.defensive_alpha < 1.0:  # refused before training, not after
        try:
            check_normalised(reference_of(target, cfg, device))
            defensive_split(cfg.eval_iter * cfg.num_chain, args.defensive_alpha)
        except ValueError as e:
            raise SystemExit(f"--defensive-alpha: {e}") from None
    # the reference's precedence: SMC, then fab, flowmc, dds
    baseline = next((n for n in BASELINES if getattr(args, f"do_{n}")), None)

    seeds = [args.seed] if args.seed is not None else [i**10 for i in range(10)]
    if args.vmap_seeds and not args.do_smc:
        results = run_seeds_vmapped(target, cfg, seeds, device, args)
    else:
        results = []
        for seed in seeds:
            cfg.seed = seed
            results.append(run_one(
                target, cfg, device, check=args.check, do_smc=args.do_smc,
                flow_smc=args.flow_smc, baseline=None if args.do_smc else baseline,
                move_correct=args.move_correct, defensive_alpha=args.defensive_alpha,
                defensive_var=args.defensive_var, logger=make_logger(cfg, args),
                full_metrics=args.full_metrics, fused_metrics=args.pallas_metrics,
                plots=args.plots))
    if not _is_primary():  # the row is rank 0's to print
        return []

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
