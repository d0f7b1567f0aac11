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

``--curves PATH`` appends one JSON line a seed: every iteration's training
metrics and AdamW's count of skipped non-finite steps, as
``tools/seed_band_reference.py --curves`` writes the reference's
(``tools/many_well_curves.py`` compares the two).

``--noise reference`` trains on the reference's step noise instead of the
port's own: every iteration's draws as ``mfm_tpu``'s ``run_mfm`` takes
them from ``PRNGKey(seed)``'s loop keys, made without JAX by
``tools/jax_threefry.py``; the initial draws and the eval stay the port's.

``--cpu-init`` starts every seed from the initial positions a run on the CPU
draws: with ``--noise reference --reference-latents`` on the card, the draws
of ``tools/many_well_arms.py``'s R-init arm (the port's initial draws, the
reference's step noise and eval latents), so that the two packages'
arithmetic meets on equal draws over many seeds.

``--reference-init PATH`` starts every seed from the reference's own
initial draws (positions, Fourier frequencies and weights), saved on a
machine with JAX by ``tools/many_well_arms.py --save-init``; with
``--noise reference --reference-latents`` the port then runs on every draw
of the reference's ``run_mfm`` and ``sample_flow``.

``--scan-noise`` draws each seed's step noise as its run would, without
training, and counts its standard normals outside ``jax_normal_range()``
([-5.42, 5.22]: ``jax.random.normal`` in float32 draws nothing outside
it); ``--clamp-noise`` trains with every such normal clamped to that range.

``--reference-latents`` also sends each seed's flow the reference's eval
latents (``sample_flow_parts``' draw from ``fold_in(PRNGKey(seed), 999)``,
made by ``tools/jax_threefry.py``) and records its non-finite samples
there. Each record gives, for every non-finite sample, the largest
|coordinate| of its latent point.

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

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax_threefry as tf  # noqa: E402
from mfm_tpu_torch import cli  # noqa: E402
from mfm_tpu_torch import config  # noqa: E402
from mfm_tpu_torch.drivers import mfm, multi_seed  # noqa: E402
from mfm_tpu_torch.drivers.mfm import (  # noqa: E402
    EVAL_STREAM, FMNoise, MalaNoise, RwmNoise, _interleave_is_flow, build_mfm, cat_rows,
    init_generator, make_generator, run_mfm, sample_flow_parts, stack_trees,
)
from mfm_tpu_torch.drivers.multi_seed import run_mfm_seeds, seed_run  # noqa: E402
from mfm_tpu_torch.flows.train import create_train_state  # noqa: E402


def seed_range(text):
    """Seeds from "FIRST-LAST" ranges and single seeds joined by commas."""
    out = []
    for part in text.split(","):
        first, _, last = part.partition("-")
        out += range(int(first), int(last or first) + 1)
    return out


def record(seed, flow, log_w, u):
    """A seed's record: its non-finite samples and log-weights, and the
    largest |latent coordinate| of each non-finite sample and of all."""
    bad = ~torch.isfinite(flow).all(-1)
    top = u.abs().amax(-1)
    return dict(seed=seed, n_eval=int(flow.shape[0]), flow_row_finite=not bool(bad.any()),
                nonfinite_samples=int(bad.sum()),
                nonfinite_log_w=int((~torch.isfinite(log_w)).sum()),
                nonfinite_max_abs_u=sorted(top[bad].tolist()), max_abs_u=float(top.max()))


def reference_latents(seed, n, d, device):
    """The reference's eval latents at ``seed``: ``sample_flow_parts``'s
    draw from ``fold_in(PRNGKey(seed), 999)``, made by ``jax_threefry``."""
    key_ref = tf.split(tf.fold_in(tf.prng_key(seed), 999), 3)[0]
    return torch.from_numpy(tf.normal(key_ref, (n, d))).to(device)


def evaluate(run, seed, cfg, target, device, with_reference_latents=False):
    """``seed``'s eval as the CLI's: (record, latent draws, flow samples);
    with ``with_reference_latents`` the record also holds the flow's
    non-finite samples on the reference's latents (``reference_latents``)."""
    n = cfg.eval_iter * cfg.num_chain
    flow, _, log_w = cli.sample_flow(run, n, target, make_generator(device, seed, EVAL_STREAM))
    u = run.ref_dist.sample(make_generator(device, seed, EVAL_STREAM), (n,))  # its first draw
    rec = record(seed, flow, log_w, u)
    if with_reference_latents:
        u_ref = reference_latents(seed, n, cfg.dim, device)
        flow_ref, _, log_w_ref = sample_flow_parts(run.transport, run.train.params, run.ref_dist,
                                                   target, u_ref)
        sub = record(seed, flow_ref, log_w_ref, u_ref)
        rec["reference_latents"] = {k: sub[k] for k in ("flow_row_finite", "nonfinite_samples",
                                                        "nonfinite_max_abs_u", "max_abs_u")}
    return rec, u, flow


def reference_noise(seed, cfg, device):
    """``draw(count) -> (move noise, FMNoise)``: the draws the reference's
    step takes at ``seed`` (``mfm_tpu/drivers/mfm.py:347``, its flow and
    MALA kernels and ``cond_fm_sample``), replayed from its loop keys."""
    B, d = cfg.num_chain, cfg.dim
    keys = tf.split(tf.split(tf.prng_key(seed), 3)[2], cfg.learning_iter)
    t = lambda a: torch.from_numpy(a).to(device)

    def draw(count):
        k_gen, k_loss = tf.split(keys[count - 1])
        if _interleave_is_flow(count, cfg.mcmc_per_flow_steps):
            kg, ka, _, _ = tf.split(k_gen, 4)
            move = RwmNoise(t(tf.normal(kg, (B, d))), t(tf.uniform(ka, (B,))))
        else:
            kn, ka = tf.split(k_gen)
            move = MalaNoise(t(tf.normal(kn, (B, d))), t(tf.uniform(ka, (B,))))
        kt, kr, ke, _ = tf.split(k_loss, 4)
        return move, FMNoise(t(tf.uniform(kt, (B,))), t(tf.normal(kr, (B, d))),
                             t(tf.normal(ke, (B, d))))

    return draw


NORMAL_FIELDS = {"mala": ("MalaNoise", "noise"), "rwm": ("RwmNoise", "eps"),
                 "x0": ("FMNoise", "x0"), "eps": ("FMNoise", "eps")}


def jax_normal_range():
    """(lowest, highest) value ``jax.random.normal`` draws in float32: its
    uniform on (-1, 1) is 2 f + lo for f in steps of 2**-23 below 1, lo the
    float above -1, so its range is erfinv's at the two ends, [-5.420,
    5.220]."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    top = np.float32(1 - 2.0**-23) * (np.float32(1) - lo) + lo
    z = lambda u: float(np.sqrt(np.float32(2)) * tf.erfinv(u))
    return z(lo), z(top)


def normal_fields(move, fm):
    """{group: tensor} of one iteration's standard normal draws."""
    out = {}
    for group, (kind, field) in NORMAL_FIELDS.items():
        for noise in (move, fm):
            if type(noise).__name__ == kind and getattr(noise, field) is not None:
                out[group] = getattr(noise, field)
    return out


def clamped(move, fm, bounds):
    """The iteration's noise with every standard normal clamped to
    ``bounds`` (the uniforms untouched)."""
    clip = lambda v: v.clamp(*bounds)
    names = {field for kind, field in NORMAL_FIELDS.values()}
    move = move._replace(**{k: clip(getattr(move, k)) for k in names if k in move._fields
                            and getattr(move, k) is not None})
    return move, fm._replace(x0=clip(fm.x0), eps=clip(fm.eps))


def scan_noise(args):
    """Each seed's step noise as its run draws it (no training): for every
    group of standard normals, the draws outside the reference's range
    ``jax_normal_range()`` and the largest |z|."""
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    target = cli.make_target("many-well", args.device)
    pieces = build_mfm(target, cfg, args.device, init_generator(0))
    lo, hi = jax_normal_range()
    recs = []
    for seed in args.seeds:
        gen = make_generator(args.device, seed)
        target.init_positions(gen, cfg.num_chain)
        over = {g: 0 for g in NORMAL_FIELDS}
        top = {g: 0.0 for g in NORMAL_FIELDS}
        for count in range(1, cfg.learning_iter + 1):
            for g, v in normal_fields(*pieces.draw_step_noise(gen, count)).items():
                over[g] += int(((v < lo) | (v > hi)).sum())
                top[g] = max(top[g], float(v.abs().max()))
        recs.append(dict(seed=seed, over=over, max_abs=top))
        print(json.dumps(recs[-1]), flush=True)
    print(json.dumps({"device": args.device, "range": [lo, hi], "seeds": len(recs),
                      "seeds_over": sum(any(r["over"].values()) for r in recs), "rows": recs}))


def cpu_positions(target, seed, n_chain):
    """The initial positions a run of ``seed`` on the CPU draws."""
    return target.init_positions(make_generator("cpu", seed), n_chain)


def patch_draws(cfg, device, seeds, noise, positions=None, reference_init=None, clamp=None):
    """Make ``build_mfm`` (a sweep's over ``seeds``, or one run's at
    ``cfg.seed``) draw each iteration's noise from the reference's keys
    (``noise == "reference"``); with ``positions`` (``(target, seed,
    n_chain) -> (n_chain, d)``, say ``cpu_positions``) start from those
    initial positions, moved to ``device``; with ``reference_init`` (a file of
    ``tools/many_well_arms.py --save-init``) from the reference's initial
    positions, Fourier frequencies and weights; with ``clamp`` every
    standard normal of the step noise clamped to [-clamp, clamp]."""
    if noise == "reference" and (cfg.num_importance_samples or cfg.mcmc_kernel != "mala"
                                 or not cfg.cond_flow):
        raise SystemExit("--noise reference replays the preset's draws: pullback RWM, MALA "
                         "and the conditional path")

    def patched(target, cfg_, device_, init_generator_, mesh=None):
        pieces = build_mfm(target, cfg_, device_, init_generator_, mesh)
        swept = not isinstance(init_generator_, torch.Generator)
        run_seeds = seeds if swept else [cfg_.seed]
        if positions is not None:
            start = torch.cat([positions(target, s, cfg_.num_chain)
                               for s in run_seeds]).to(device_)
            init_fn = pieces.init_fn
            pieces = pieces._replace(init_fn=lambda _: init_fn(start))
        if reference_init is not None:
            drawn = [reference_init[s] for s in run_seeds]
            start_ref = torch.cat([d[0] for d in drawn]).to(device_)
            freqs = torch.stack([d[1] for d in drawn]).to(device_)
            with torch.no_grad():
                pieces.fourier.copy_(freqs if swept else freqs[0])
            states = [create_train_state({k: v.to(device_) for k, v in d[2].items()}, pieces.tx)
                      for d in drawn]
            train = stack_trees(states) if swept else states[0]
            init_fn = pieces.init_fn
            pieces = pieces._replace(init_fn=lambda _: init_fn(start_ref)._replace(train=train))
        if clamp is not None:
            draw_own = pieces.draw_step_noise
            pieces = pieces._replace(
                draw_step_noise=lambda gen, count: clamped(*draw_own(gen, count), clamp))
        if noise != "reference":
            return pieces
        draws = [reference_noise(s, cfg_, device_) for s in run_seeds]

        def draw_step_noise(gen, count):
            if not swept:
                return draws[0](count)
            moves, fms = zip(*(draw(count) for draw in draws))
            return cat_rows(moves), stack_trees(fms)

        return pieces._replace(draw_step_noise=draw_step_noise)

    multi_seed.build_mfm = mfm.build_mfm = patched


def curve(seed, metrics, train):
    """One seed's training curves: every iteration's metrics and AdamW's
    skipped steps (applied steps fewer than iterations)."""
    opt = train.opt_state
    return dict(package="port", seed=seed,
                metrics={k: v.double().cpu().tolist() for k, v in metrics.items()},
                skipped=int(train.step) - int(opt.count),
                notfinite_count=int(opt.notfinite_count))


def write_curve(path, rec):
    if path:
        with open(path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


def seed_sweep(args, seeds):
    """``seeds`` as one sweep, each seed then sampled as the CLI samples it:
    a record a seed, and the first seed's (frequencies, parameters, latent
    draws, flow samples)."""
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    target = cli.make_target("many-well", args.device)
    sweep = run_mfm_seeds(target, cfg, seeds, args.device)
    recs, first = [], None
    for i, seed in enumerate(seeds):
        run = seed_run(sweep, cfg, i)
        write_curve(args.curves, curve(seed, run.metrics, run.train))
        rec, u, flow = evaluate(run, seed, cfg, target, args.device, args.reference_latents)
        recs.append(rec)
        if first is None:
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
        write_curve(args.curves, curve(seed, run.metrics, run.train))
        recs.append(evaluate(run, seed, cfg, target, args.device, args.reference_latents)[0])
        print(json.dumps(recs[-1]), flush=True)
    return recs


def replay(args):
    """The saved draws through the saved parameters on ``--device``."""
    saved = torch.load(args.replay)
    cfg = config.preset("many-well", learning_iter=args.learning_iter, **cli._parse_set(args.set))
    pieces = build_mfm(cli.make_target("many-well", args.device), cfg, args.device,
                       init_generator(0))
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
                   metavar="FIRST-LAST[,...]", help="default: the CLI's 10 replication seeds")
    p.add_argument("--single", action="store_true",
                   help="train each seed alone (the CLI's --seed s path), not as one sweep")
    p.add_argument("--curves", default=None, metavar="PATH",
                   help="append each seed's training curves to PATH (JSON lines)")
    p.add_argument("--noise", choices=("port", "reference"), default="port",
                   help="the step noise: the port's generators, or the reference's keys")
    p.add_argument("--cpu-init", action="store_true",
                   help="start from the initial positions a CPU run draws (as tools/"
                        "many_well_arms.py's R-init arm does)")
    p.add_argument("--reference-init", default=None, metavar="PATH",
                   help="start from the reference's initial draws, saved by "
                        "tools/many_well_arms.py --save-init")
    p.add_argument("--clamp-noise", action="store_true",
                   help="clamp the step noise's standard normals to the reference's range")
    p.add_argument("--scan-noise", action="store_true",
                   help="only draw each seed's step noise and count its normals outside "
                        "the reference's range")
    p.add_argument("--reference-latents", action="store_true",
                   help="also transport the reference's eval latents (jax_threefry)")
    p.add_argument("--save", default=None, metavar="PATH",
                   help="save the first seed's parameters, draws and flow samples")
    p.add_argument("--replay", default=None, metavar="PATH",
                   help="transport a saved file's draws on --device and compare")
    args = p.parse_args(argv)
    if args.replay:
        return replay(args)
    if args.single and args.save:
        p.error("--save keeps a sweep's first seed: it does not apply to --single")

    if args.scan_noise:
        return scan_noise(args)
    clamp = jax_normal_range() if args.clamp_noise else None
    if args.noise == "reference" or args.cpu_init or args.reference_init or clamp:
        patch_draws(config.preset("many-well", learning_iter=args.learning_iter,
                                  **cli._parse_set(args.set)),
                    args.device, args.seeds, args.noise,
                    cpu_positions if args.cpu_init else None,
                    torch.load(args.reference_init) if args.reference_init else None, clamp)
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
                      "noise": args.noise, "cpu_init": args.cpu_init,
                      "reference_init": args.reference_init, "clamp_noise": clamp,
                      "learning_iter": args.learning_iter, "wall_s": wall,
                      "seeds": len(recs), "nan_rows": sum(not r["flow_row_finite"] for r in recs),
                      "nonfinite_samples": sum(r["nonfinite_samples"] for r in recs),
                      "rows": recs}))


if __name__ == "__main__":
    main()
