#!/usr/bin/env python3
"""Where the time of one of the port's examples goes, on one CUDA card.

    python3 tools/profile_slice.py              # the phi-four slice at full size
    python3 tools/profile_slice.py --example pines    # pines as shipped
    python3 tools/profile_slice.py --device cpu --set num_chain=8 \\
        --set dim=4 --set ode_steps=2 ...       # a dry run of the script
    python3 tools/profile_slice.py --example pines --do-smc     # one SMC step
    python3 tools/profile_slice.py --example pines --flow-smc   # one flow-SMC step
    python3 tools/profile_slice.py --set mcmc_kernel=nuts \\
        --set field_precision=default --set pallas_field=false  # NUTS on phi-four
    python3 tools/profile_slice.py --baseline fab     # one FAB epoch on phi-four

Builds the example's run with ``build_mfm``, at its initial carry. For
``phi-four`` (the default) that is the preset with field_precision=highest
and pallas_field=true (the fused field kernel) unless ``--set`` says
otherwise; ``--set field_precision=default --set pallas_field=false``
profiles the preset as shipped (the bf16 nn.Module field). Any other
``--example`` runs its preset as shipped, with ``--set`` on top. After a
warm call of each, one MCMC-type and one flow-type ``step_fn`` run under
``utils.profiling.trace`` into ``build/profile_slice/steps``: it prints the
``spans.json`` summary (each of the program's spans by path: count, host
ms in all and self, device ms from its CUDA events, the device time it
launched and the idle gaps charged to it; the counters; the device's busy
and idle time and kernels), then the top of the kernels' ``key_averages()``
table. The MCMC-type iteration is the preset's kernel (``--set
mcmc_kernel=nuts`` for NUTS, with its in-loop adaptation).

``--do-smc`` profiles one step of the SMC baseline instead (``build_smc``
at the example's preset, after a warm step): host ms over ``--reps``
steps, and one step under ``utils.profiling.trace`` (as below, each mode
into its own directory under ``build/profile_slice``); and the ESS solve at that step's log-likelihoods two ways, the early-exit
bisection reading its condition on the host each trip
(``smc.solvers.dichotomy``) against the same bisection with all 100 trips
masked and queued without a read (host ms each, and their trip counts).

``--baseline fab|flowmc|dds`` profiles one step of that baseline at the
example's preset (the widths and batch ``cli.py`` gives it): a FAB epoch
after one prefill pass (and its AIS pass and one gradient update alone), a
flowMC round, a DDS iteration; host ms over ``--reps`` steps after a warm
one, and one step traced.

``--flow-smc`` profiles one flow-SMC tempering step (latent MALA through
the run's eval transport: two forward transports and two forward and
reverse passes) on the untrained net of the initial carry, at
``num_chain`` particles: host ms of one step and one step traced.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mfm_tpu_torch.cli import EXAMPLES, _parse_set  # noqa: E402
from mfm_tpu_torch.config import preset  # noqa: E402
from mfm_tpu_torch.drivers.mfm import _interleave_is_flow, build_mfm, make_generator  # noqa: E402
from mfm_tpu_torch.utils import profiling  # noqa: E402

TRACES = ROOT / "build" / "profile_slice"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, reps: int, device) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return 1e3 * (time.perf_counter() - t0) / reps


def traced(fn, device, name: str):
    """(``spans.json``, profile) of one call of ``fn`` (already warm) under
    ``utils.profiling.trace`` into ``TRACES / name``; prints the summary."""
    out = TRACES / name
    with profiling.trace(str(out), device) as prof:
        fn()
    summary = json.loads((out / "spans.json").read_text())
    print(f"trace: {out}/trace.json; window {summary['window_ms']:.3f} ms; device "
          f"{json.dumps(summary.get('device', 'not measured'))}", flush=True)
    print(f"{'span':<52} {'count':>6} {'host ms':>10} {'self ms':>10} {'device ms':>10} "
          f"{'launched':>10} {'idle ms':>9} {'gaps':>6}", flush=True)
    for path, row in summary["spans"].items():
        cells = [row.get(k) for k in ("device_ms", "launched_ms", "idle_ms")]
        print(f"{path:<52} {row['count']:>6} {row['host_ms']:>10.3f} {row['self_ms']:>10.3f} "
              + " ".join(f"{'-' if v is None else f'{v:.3f}':>{w}}"
                         for v, w in zip(cells, (10, 10, 9)))
              + f" {row.get('idle_gaps', '-'):>6}", flush=True)
    print(f"counters {json.dumps(summary['counters'])}", flush=True)
    sort_by = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=12), flush=True)
    return summary, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--example", default="phi-four", choices=list(EXAMPLES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a field of the example's preset (repeatable)")
    ap.add_argument("--do-smc", action="store_true", help="profile one SMC baseline step")
    ap.add_argument("--flow-smc", action="store_true", help="profile one flow-SMC step")
    ap.add_argument("--baseline", choices=["fab", "flowmc", "dds"], default=None,
                    help="profile one step of this baseline")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(), flush=True)

    fused = {"field_precision": "highest", "pallas_field": True}
    phi_fused = (args.example == "phi-four" and not args.do_smc and not args.flow_smc
                 and args.baseline is None)
    overrides = {**(fused if phi_fused else {}), **_parse_set(args.set)}
    cfg = preset(args.example, **overrides)
    cfg.seed = 0
    if args.example == "phi-four":  # the only example whose --set may change dim
        target = EXAMPLES[args.example].func(cfg.dim, device=device)
    else:
        target = EXAMPLES[args.example](device=device)
    if args.do_smc:
        return profile_smc(target, cfg, device, args.reps)
    if args.baseline is not None:
        return profile_baseline(target, cfg, device, args.baseline, args.reps)
    pieces = build_mfm(target, cfg, device, torch.Generator().manual_seed(0))
    gen = make_generator(device, 0)
    if args.flow_smc:
        return profile_flow_smc(target, cfg, device, pieces, gen)
    carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
    flow_count = next(c for c in range(1, 1000) if _interleave_is_flow(c, cfg.mcmc_per_flow_steps))
    mala_count = next(c for c in range(1, 1000)
                      if not _interleave_is_flow(c, cfg.mcmc_per_flow_steps))
    noise = {c: pieces.draw_step_noise(gen, c) for c in (mala_count, flow_count)}
    print(f"cfg {args.example} B={cfg.num_chain} d={cfg.dim} widths={tuple(cfg.hidden_xt)} "
          f"F={cfg.fourier_dim} ode_steps={cfg.ode_steps} {cfg.divergence} "
          f"field_precision={cfg.field_precision} pallas_field={cfg.pallas_field}", flush=True)
    steps = lambda: [pieces.step_fn(carry, c, *noise[c]) for c in (mala_count, flow_count)]
    steps()  # warm: builds the kernels, initialises the libraries
    traced(steps, device, "steps")


def masked_dichotomy(fun, min_delta, max_delta, eps: float = 1e-4, max_iter: int = 100):
    """``smc.solvers.dichotomy`` with every trip queued and masked: no host
    read inside the loop. A finished bracket keeps its ``a``, so the result
    is the same."""
    max_delta = torch.as_tensor(max_delta, dtype=torch.float32)
    a = torch.as_tensor(min_delta, dtype=torch.float32, device=max_delta.device)
    b = max_delta
    f_min, f_max = fun(a), fun(b)
    f_a, f_b = f_min, f_max
    for _ in range(max_iter):
        live = f_a - f_b > eps
        mid = 0.5 * (a + b)
        f_mid = fun(mid)
        low = f_mid < 0
        a, f_a = torch.where(live & ~low, mid, a), torch.where(live & ~low, f_mid, f_a)
        b, f_b = torch.where(live & low, mid, b), torch.where(live & low, f_mid, f_b)
    nan = torch.full_like(b, torch.nan)
    return torch.where(f_max > 0, max_delta, torch.where(f_min > 0, a, nan))


def profile_smc(target, cfg, device, reps: int):
    from mfm_tpu_torch.drivers.smc_run import build_smc
    from mfm_tpu_torch.smc import ess, solvers

    pieces = build_smc(target, cfg)
    gen = make_generator(device, 0)
    carry = pieces.init_fn(pieces.target.init_positions(gen, cfg.num_chain))
    print(f"cfg {cfg.example} SMC N={cfg.num_chain} d={cfg.dim} kernel={cfg.mcmc_kernel} "
          f"moves={cfg.iter_per_temp} waste_free_p={cfg.waste_free_p} path={cfg.smc_path}",
          flush=True)
    carry, _ = pieces.step_fn(carry, pieces.draw_step_noise(gen))  # warm
    step = lambda: pieces.step_fn(carry, pieces.draw_step_noise(gen))
    loglik = pieces.target.log_lik(carry.state.particles)
    max_delta = 1.0 - carry.state.lmbda
    trips = [0]

    def counted(fun):
        def f(x):
            trips[0] += 1
            return fun(x)
        return f

    solve = lambda solver: ess.ess_solver(loglik, cfg.alpha, max_delta,
                                          lambda fun, s, lo, hi: solver(counted(fun), lo, hi))
    delta_host = solve(lambda fun, lo, hi: solvers.dichotomy(fun, 0.0, lo, hi))
    trips_host, trips[0] = trips[0], 0
    delta_masked = solve(masked_dichotomy)
    trips_masked, trips[0] = trips[0], 0
    out = {
        "step_ms": host_ms(step, reps, device),
        "ess_solve_host_read_ms": host_ms(
            lambda: solve(lambda fun, lo, hi: solvers.dichotomy(fun, 0.0, lo, hi)), reps, device),
        "ess_solve_masked_ms": host_ms(lambda: solve(masked_dichotomy), reps, device),
        "ess_solve_trips_host_read": trips_host - 2,  # without f(min) and f(max)
        "ess_solve_trips_masked": trips_masked - 2,
        "ess_solve_delta": [float(delta_host), float(delta_masked)],
        "lmbda": float(carry.state.lmbda),
    }
    print(json.dumps({"smc": out}), flush=True)
    traced(step, device, "smc")


def profile_baseline(target, cfg, device, name: str, reps: int):
    """One step of a baseline, built as ``cli.py`` builds it."""
    from mfm_tpu_torch.drivers.dds import build_dds, dds_sigma
    from mfm_tpu_torch.drivers.fab import build_fab
    from mfm_tpu_torch.drivers.flowmc import build_flowmc, flowmc_n_layers

    gen = make_generator(device, 0)
    out = {}
    if name == "fab":
        pieces = build_fab(target, cfg.example, 0, cfg.learning_iter, cfg.num_chain,
                           overrides={"flow": {"conditioner_mlp_units": list(cfg.hidden_xt)}},
                           device=device)
        carry = pieces.prefill_one(pieces.init_carry(pieces.params), pieces.draw_ais_noise(gen))
        step = lambda: pieces.train_iter(carry, pieces.draw_iter_noise(gen))
        ais = pieces.draw_ais_noise(gen)
        x = carry.buf_x[: pieces.batch]
        w = torch.full((pieces.batch,), 1.0 / pieces.batch, device=device)
        out = {
            "ais_pass_ms": host_ms(
                lambda: pieces.ais_forward(carry.params, carry.step_sizes, ais), reps, device),
            "grad_update_ms": host_ms(
                lambda: pieces.grad_update(carry, x, w, carry.buf_log_q[: pieces.batch]),
                reps, device),
        }
        label = f"B={pieces.batch} K+1={len(carry.step_sizes)} layers={pieces.flow.module.n_layers}"
    elif name == "flowmc":
        steps = max(int(cfg.mcmc_per_flow_steps), 1)
        pieces = build_flowmc(
            target, 0, n_chain=cfg.num_chain, n_local_steps=steps, n_global_steps=steps,
            n_epochs=steps, step_size=cfg.step_size, learning_rate=cfg.learning_rate,
            n_layers=flowmc_n_layers(cfg), hidden=tuple(cfg.hidden_xt),
            max_samples=cfg.num_chain * (steps + 1), batch_size=cfg.num_chain, device=device)
        carry = pieces.init_carry(pieces.params, target.init_positions(gen, cfg.num_chain))
        step = lambda: pieces.one_loop(carry, pieces.draw_loop_noise(gen, carry))
        label = f"chains={cfg.num_chain} steps={steps} layers={flowmc_n_layers(cfg)}"
    else:
        pieces = build_dds(target, 0, cfg.learning_iter, batch_size=cfg.num_chain,
                           learning_rate=cfg.learning_rate, hidden=tuple(cfg.hidden_xt),
                           sigma=dds_sigma(cfg, device), device=device)
        carry = pieces.init_carry(pieces.params)
        step = lambda: pieces.train_step(carry, pieces.draw_noise(gen))
        label = f"B={cfg.num_chain} steps=100"
    print(f"cfg {cfg.example} {name} d={cfg.dim} widths={tuple(cfg.hidden_xt)} {label}",
          flush=True)
    out = {"step_ms": host_ms(step, reps, device), **out}
    print(json.dumps({name: out}), flush=True)
    traced(step, device, name)


def profile_flow_smc(target, cfg, device, pieces, gen):
    from mfm_tpu_torch.drivers.flow_smc import build_flow_smc
    from mfm_tpu_torch.flows import make_transport

    carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
    transport = make_transport(
        pieces.field_bind, divergence=cfg.divergence, n_steps=cfg.eval_ode_steps or cfg.ode_steps,
        method=cfg.ode_method, num_probes=cfg.eval_hutchinson_probes,
        probe_dist=cfg.eval_probe_dist,
    )
    fs = build_flow_smc(target, cfg, transport, carry.train.params, pieces.ref_dist)
    state = fs.init_fn(pieces.ref_dist.sample(gen, (cfg.num_chain,)))
    print(f"cfg {cfg.example} flow-SMC N={cfg.num_chain} d={cfg.dim} kernel={cfg.mcmc_kernel} "
          f"moves={cfg.iter_per_temp} ode_steps={cfg.eval_ode_steps or cfg.ode_steps} "
          f"{cfg.divergence} probes={cfg.eval_hutchinson_probes} {cfg.eval_probe_dist}",
          flush=True)
    state, _, _ = fs.step_fn(state, fs.draw_step_noise(gen))  # warm
    step = lambda: fs.step_fn(state, fs.draw_step_noise(gen))
    out = {"step_ms": host_ms(step, 1, device)}
    print(json.dumps({"flow_smc": out}), flush=True)
    traced(step, device, "flow_smc")


if __name__ == "__main__":
    main()
