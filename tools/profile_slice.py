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

Builds the example's run with ``build_mfm``, at its initial carry. For
``phi-four`` (the default) that is the preset with field_precision=highest
and pallas_field=true (the fused field kernel) unless ``--set`` says
otherwise; ``--set field_precision=default --set pallas_field=false``
profiles the preset as shipped (the bf16 nn.Module field). Any other
``--example`` runs its preset as shipped, with ``--set`` on top. A stage is
timed with the tangents the run's divergence gives it: the d basis vectors
(exact) or one probe (Hutchinson); the K1 piece only where the run uses K1.
It prints two JSON lines:

1. ``pieces``: host-clock ms per call, after a warm call, over ``--reps``
   calls that end in a device synchronisation: a MALA-type and a flow-type
   ``step_fn``, one forward transport, one RK4 stage with the exact
   divergence and its parts (K1 with d tangents, whichever field the run
   uses; the score gate with its d tangents on the run's route, which is
   PhiFour's fused kernel, and on the generic route, ``vmap(jvp)`` of the
   score); ``PhiFour.value_and_score``, the FM loss gradient, AdamW, and
   the tempering bisection;
2. ``profiled``: for ``--mala-steps`` MALA-type iterations and for one
   flow-type iteration under ``torch.profiler``, the wall time of the
   profiled region, the device-busy time inside it (the union of the
   kernels' intervals), their ratio, and the number of kernel launches.
   Wall and busy time come from the same run; the wall includes the
   profiler's own overhead, so the busy share is a lower bound.

Then the top of the flow iteration's ``key_averages()`` table. The
MCMC-type iteration is the preset's kernel (``--set mcmc_kernel=nuts``
for NUTS, with its in-loop adaptation).

``--do-smc`` profiles one step of the SMC baseline instead (``build_smc``
at the example's preset, after a warm step): host ms over ``--reps``
steps, and one step under the profiler (wall, device-busy time, launches);
and the ESS solve at that step's log-likelihoods two ways, the early-exit
bisection reading its condition on the host each trip
(``smc.solvers.dichotomy``) against the same bisection with all 100 trips
masked and queued without a read (host ms each, and their trip counts).

``--flow-smc`` profiles one flow-SMC tempering step (latent MALA through
the run's eval transport: two forward transports and two forward and
reverse passes) on the untrained net of the initial carry, at
``num_chain`` particles: host ms of one step and one step profiled.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.func import grad_and_value

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mfm_tpu_torch.cli import EXAMPLES, _parse_set  # noqa: E402
from mfm_tpu_torch.config import preset  # noqa: E402
from mfm_tpu_torch.drivers.mfm import (  # noqa: E402
    _interleave_is_flow,
    build_mfm,
    make_generator,
    next_beta,
)
from mfm_tpu_torch.flows import apply_gradients, draw_probe  # noqa: E402
from mfm_tpu_torch.flows.cnf import _DIVERGENCES  # noqa: E402
from mfm_tpu_torch.ops.field import field_apply, field_layout, pack_field_params  # noqa: E402
from mfm_tpu_torch.targets.base import generic_score_gate  # noqa: E402

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


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


def profiled(fn, device):
    """(summary, profile) of one call of ``fn`` (already warm)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy_us, end = 0.0, None
    for s, e in spans:  # union of the kernels' intervals
        if end is None or s >= end:
            busy_us, end = busy_us + (e - s), e
        elif e > end:
            busy_us, end = busy_us + (e - end), e
    summary = {
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3 if spans else "not measured",
        "busy_share": busy_us / wall_us if spans else "not measured",
        "device_events": len(spans),
        "launches": sum(1 for e in events if e.name in LAUNCH_CALLS),
    }
    return summary, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--example", default="phi-four", choices=list(EXAMPLES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mala-steps", type=int, default=10)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a field of the example's preset (repeatable)")
    ap.add_argument("--do-smc", action="store_true", help="profile one SMC baseline step")
    ap.add_argument("--flow-smc", action="store_true", help="profile one flow-SMC step")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(), flush=True)

    fused = {"field_precision": "highest", "pallas_field": True}
    phi_fused = args.example == "phi-four" and not args.do_smc and not args.flow_smc
    overrides = {**(fused if phi_fused else {}), **_parse_set(args.set)}
    cfg = preset(args.example, **overrides)
    cfg.seed = 0
    if args.example == "phi-four":  # the only example whose --set may change dim
        target = EXAMPLES[args.example].func(cfg.dim, device=device)
    else:
        target = EXAMPLES[args.example](device=device)
    if args.do_smc:
        return profile_smc(target, cfg, device, args.reps)
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

    params = carry.train.params
    x = carry.chain.position.contiguous()
    B, d = x.shape
    t = torch.full((B,), 0.5, device=device)
    probe = draw_probe(pieces.transport, gen, B, d)  # None unless Hutchinson
    if probe is None:
        basis = torch.eye(d, device=device)[:, None, :].expand(d, B, d).contiguous()
    else:
        basis = probe.reshape(-1, B, d).contiguous()  # the stage's tangents: the probes
    div_fn = _DIVERGENCES.get(cfg.divergence, _DIVERGENCES["exact"])
    f = pieces.field_bind(params)
    loss_grad = grad_and_value(pieces.loss_fn)
    grads, _ = loss_grad(params, x, noise[mala_count][1])
    step = lambda c: pieces.step_fn(carry, c, *noise[c])

    reps = args.reps
    gate, field = 0.01 * torch.randn_like(x), torch.zeros_like(x)
    dfield = torch.zeros_like(basis)
    with torch.no_grad():
        stage = {
            f"stage_{cfg.divergence}_div_ms": host_ms(
                lambda: div_fn(f, x, t, probe), reps, device),
            # in place on field and dfield (the fused route): fine for timing
            "stage_score_gate_ms": host_ms(
                lambda: pieces.net.score_gate(x, gate, field, basis, dfield), reps, device
            ),
            "stage_score_gate_generic_ms": host_ms(
                lambda: generic_score_gate(target.score, x, gate, field, basis, dfield),
                reps, device,
            ),
            "transport_fwd_ms": host_ms(
                lambda: pieces.transport.forward(params, x, probe), 1, device),
        }
        if cfg.pallas_field:
            layout = field_layout(params, cfg.fourier_dim)
            packed = pack_field_params(params, layout)
            freqs = pieces.net.fourier_freqs.contiguous()
            stage["stage_K1_ms"] = host_ms(
                lambda: field_apply(packed, layout, cfg.non_linearity, freqs, x, t, basis),
                reps, device,
            )
    pieces_ms = {
        f"step_{cfg.mcmc_kernel}_ms": host_ms(lambda: step(mala_count), reps, device),
        "step_flow_ms": host_ms(lambda: step(flow_count), 1, device),
        **stage,
        "value_and_score_ms": host_ms(lambda: target.value_and_score(x), reps, device),
        "loss_grad_ms": host_ms(lambda: loss_grad(params, x, noise[mala_count][1]), reps, device),
        "adamw_ms": host_ms(lambda: apply_gradients(carry.train, grads, pieces.tx), reps, device),
        "temper_ms": host_ms(
            lambda: next_beta(carry.beta, target.log_lik(x), cfg.alpha, B), reps, device
        ),
    }
    print(json.dumps({"pieces": pieces_ms}), flush=True)

    mala, _ = profiled(lambda: [step(mala_count) for _ in range(args.mala_steps)], device)
    flow, prof = profiled(lambda: step(flow_count), device)
    print(json.dumps({"profiled": {f"{cfg.mcmc_kernel}_x{args.mala_steps}": mala,
                                   "flow_x1": flow}}), flush=True)
    sort_by = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=12), flush=True)


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
    summary, prof = profiled(step, device)
    print(json.dumps({"profiled": {"smc_step_x1": summary}}), flush=True)
    sort_by = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=12), flush=True)


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
    summary, prof = profiled(step, device)
    print(json.dumps({"profiled": {"flow_smc_step_x1": summary}}), flush=True)
    sort_by = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=12), flush=True)


if __name__ == "__main__":
    main()
