#!/usr/bin/env python3
"""Where the time of the port's phi-four slice goes, on one CUDA card.

    python3 tools/profile_slice.py              # the slice at full size
    python3 tools/profile_slice.py --device cpu --set num_chain=8 \\
        --set dim=4 --set ode_steps=2 ...       # a dry run of the script

Builds the phi-four slice with ``build_mfm``, at its initial carry: the
``phi-four`` preset with field_precision=highest and pallas_field=true
(the fused field kernel) unless ``--set`` says otherwise;
``--set field_precision=default --set pallas_field=false`` profiles the
preset as shipped (the bf16 nn.Module field). It prints two JSON lines:

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

Then the top of the flow iteration's ``key_averages()`` table.
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

from mfm_tpu_torch.cli import _parse_set  # noqa: E402
from mfm_tpu_torch.config import preset  # noqa: E402
from mfm_tpu_torch.drivers.mfm import (  # noqa: E402
    _interleave_is_flow,
    build_mfm,
    make_generator,
    next_beta,
)
from mfm_tpu_torch.flows import apply_gradients, exact_divergence  # noqa: E402
from mfm_tpu_torch.ops.field import field_apply, field_layout, pack_field_params  # noqa: E402
from mfm_tpu_torch.targets import PhiFour  # noqa: E402
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
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--mala-steps", type=int, default=10)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a field of the phi-four preset (repeatable)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip(), flush=True)

    overrides = {"field_precision": "highest", "pallas_field": True, **_parse_set(args.set)}
    cfg = preset("phi-four", **overrides)
    cfg.seed = 0
    target = PhiFour(cfg.dim)
    pieces = build_mfm(target, cfg, device, torch.Generator().manual_seed(0))
    gen = make_generator(device, 0)
    carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
    flow_count = next(c for c in range(1, 1000) if _interleave_is_flow(c, cfg.mcmc_per_flow_steps))
    mala_count = next(c for c in range(1, 1000)
                      if not _interleave_is_flow(c, cfg.mcmc_per_flow_steps))
    noise = {c: pieces.draw_step_noise(gen, c) for c in (mala_count, flow_count)}
    print(f"cfg B={cfg.num_chain} d={cfg.dim} widths={tuple(cfg.hidden_xt)} "
          f"F={cfg.fourier_dim} ode_steps={cfg.ode_steps} {cfg.divergence} "
          f"field_precision={cfg.field_precision} pallas_field={cfg.pallas_field}", flush=True)

    params = carry.train.params
    x = carry.chain.position.contiguous()
    B, d = x.shape
    t = torch.full((B,), 0.5, device=device)
    basis = torch.eye(d, device=device)[:, None, :].expand(d, B, d).contiguous()
    layout = field_layout(params, cfg.fourier_dim)
    packed = pack_field_params(params, layout)
    freqs = pieces.net.fourier_freqs.contiguous()
    f = pieces.field_bind(params)
    loss_grad = grad_and_value(pieces.loss_fn)
    grads, _ = loss_grad(params, x, noise[mala_count][1])
    step = lambda c: pieces.step_fn(carry, c, *noise[c])

    reps = args.reps
    gate, field = 0.01 * torch.randn_like(x), torch.zeros_like(x)
    dfield = torch.zeros_like(basis)
    with torch.no_grad():
        stage = {
            "stage_exact_div_ms": host_ms(lambda: exact_divergence(f, x, t), reps, device),
            "stage_K1_ms": host_ms(
                lambda: field_apply(packed, layout, cfg.non_linearity, freqs, x, t, basis),
                reps, device,
            ),
            # in place on field and dfield (the fused route): fine for timing
            "stage_score_gate_ms": host_ms(
                lambda: pieces.net.score_gate(x, gate, field, basis, dfield), reps, device
            ),
            "stage_score_gate_generic_ms": host_ms(
                lambda: generic_score_gate(target.score, x, gate, field, basis, dfield),
                reps, device,
            ),
            "transport_fwd_ms": host_ms(lambda: pieces.transport.forward(params, x), 1, device),
        }
    pieces_ms = {
        "step_mala_ms": host_ms(lambda: step(mala_count), reps, device),
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
    print(json.dumps({"profiled": {f"mala_x{args.mala_steps}": mala, "flow_x1": flow}}),
          flush=True)
    sort_by = "self_device_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort_by, row_limit=12), flush=True)


if __name__ == "__main__":
    main()
