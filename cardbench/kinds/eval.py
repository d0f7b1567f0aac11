"""Traffic kind ``eval``: back-to-back end-of-run evaluations of one flow.

One evaluation is what the program's CLI does after training: the
transport of ``eval_iter * num_chain`` latents with its log-determinant and
the importance resampling (``drivers/mfm.py::sample_flow_parts``), then the
metric row against exact draws (``drivers/eval.py::evaluate_samples``: the
mean log-density, KSD U and V on K2a, MMD^2 on K2b, of the flow's draws and
of the resampled set). Each evaluation takes fresh latents and fresh
resampling uniforms from the feed; the exact draws are made once.

Set-up builds the program's flow (``build_mfm``, one net) and gives it the
benchmark's weights and frequencies, makes the exact draws, and runs one
evaluation. The window keeps every evaluation's inputs and outputs; the
check runs the reference (``reference/evaluation.py``) on ``checked`` of
them, drawn from the seed, and compares the flow's draws, the
log-weights and the metric row.
"""

import math
import random
from typing import NamedTuple

import torch

from cardbench import harness, inputs

ROW = ("logpdf", "stein_u", "stein_v", "logpdf_star", "stein_u_star", "stein_v_star", "mmd",
       "mmd_star")


class State(NamedTuple):
    config: dict
    traffic: dict
    cfg: object
    n: int
    seed: int
    device: str
    feed_gen: torch.Generator
    box: dict  # the program
    kept: dict  # inputs and outputs for the check


def feed(state: State):
    g = state.feed_gen
    u = torch.randn((state.n, state.cfg.dim), generator=g, device=g.device)
    draws = torch.rand(state.n, generator=g, device=g.device, dtype=torch.float64)
    return u, draws


def evaluation(state: State, spans, u, draws):
    """One evaluation through the program: (flow draws, log-weights, row)."""
    from mfm_tpu_torch.drivers import eval as prog_eval
    from mfm_tpu_torch.drivers import mfm as prog_mfm

    box = state.box
    flow, exact, log_w = spans.run(
        "eval.transport", prog_mfm.sample_flow_parts, box["transport"], box["params"],
        box["ref_dist"], box["target"], u, None, draws)
    row = spans.run("eval.metrics", prog_eval.evaluate_samples, box["target"], flow, exact,
                    box["real"])
    return flow, log_w, row


def setup(cell, seed: int, device, clock, overrides: dict):
    from mfm_tpu_torch.drivers.mfm import build_mfm, eval_transport
    from mfm_tpu_torch.ops import build
    from mfm_tpu_torch.targets import ManyWell

    from cardbench.reference.targets import ManyWell as RefManyWell
    from cardbench.session import _sync

    config = {**cell.config, "config": {**cell.config["config"], **overrides.get("config", {})}}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    if torch.device(device).type == "cuda":
        build.load_library()
    clock.part("build")

    cfg = inputs.program_config(config)
    target = ManyWell(cfg.dim)
    pieces = build_mfm(target, cfg, device, torch.Generator().manual_seed(0))
    transport = eval_transport(cfg, pieces.field_bind, pieces.transport)
    clock.part("program")

    params, freqs = inputs.make_field(inputs.flat_conf(config), 1,
                                      inputs.generator(device, seed, "weights"))
    got = {k: tuple(v.shape) for k, v in pieces.net.named_parameters()}
    if got != {k: tuple(v.shape[1:]) for k, v in params.items()}:
        raise RuntimeError(f"the program's field has other parameters: {got}")
    pieces.net.fourier_freqs.copy_(freqs[0])
    n = cfg.eval_iter * cfg.num_chain
    real = RefManyWell(cfg.dim).sample(inputs.generator(device, seed, "real"), n)
    box = {"transport": transport, "params": {k: v[0] for k, v in params.items()},
           "ref_dist": pieces.ref_dist, "target": target, "real": real, "failed": 0}
    state = State(config, traffic, cfg, n, seed, device, inputs.generator(device, seed, "feed"),
                  box, {"params": params, "freqs": freqs, "real": real, "runs": []})
    evaluation(state, harness.Spans(torch, False), *feed(state))
    _sync(device)
    clock.part("warm")
    return state


def unit(state: State, spans) -> None:
    """One whole evaluation of the window."""
    u, draws = spans.run("feed", feed, state)
    flow, log_w, row = evaluation(state, spans, u, draws)
    if not all(math.isfinite(row[k]) for k in ROW):
        state.box["failed"] += 1
    state.kept["runs"].append((u, draws, flow, log_w, row))


def summarize(state: State, units: int, seconds: float) -> dict:
    return {
        "attempted": units,
        "failed": state.box["failed"],
        "e2e": {"eval_samples_per_s": units * state.n / seconds},
        "window": {"evaluations": units, "samples": units * state.n, "seconds": seconds},
    }


def release(state: State) -> None:
    state.box.clear()


def _gap(prog, ref, scale):
    """max |prog - ref| / scale over the entries; a non-finite entry on
    one side only, or NaN, reads inf."""
    both = torch.isfinite(prog) & torch.isfinite(ref)
    same = both | ((prog == ref) & ~torch.isnan(ref))
    if not bool(same.all()):
        return math.inf
    if not bool(both.any()):
        return 0.0
    return float(((prog - ref).abs() / scale)[both].max())


def reference_readings(state: State, runs, limits: dict, prec=None, fault=None) -> dict:
    """The numbers compared over ``runs`` (latents, draws, and the judged
    side's draws, log-weights and row); ``prec`` or ``fault`` make the
    reference the judged side (the control and the planted faults). A row
    entry's gap is taken against the scale its rounding is relative to
    (``reference.evaluation.metric_row``)."""
    from cardbench.reference.evaluation import evaluate
    from cardbench.reference.targets import ManyWell as RefManyWell

    cfg, kept = state.cfg, state.kept
    target = RefManyWell(cfg.dim)
    base = cfg.field_precision
    out = {"draw_gap": 0.0, "weight_gap": 0.0, "row_gap": 0.0}
    with torch.no_grad():
        for u, draws, flow, log_w, row in runs:
            x_r, lw_r, (row_r, scale_r) = evaluate(target, kept["params"], kept["freqs"], u, draws,
                                        kept["real"], base, cfg.ode_steps)
            if prec is not None or fault is not None:
                flow, log_w, (row, _) = evaluate(target, kept["params"], kept["freqs"], u,
                                                 draws, kept["real"], prec or base,
                                                 cfg.ode_steps, fault)
            scale = float(x_r[torch.isfinite(x_r)].abs().max())
            out["draw_gap"] = max(out["draw_gap"], _gap(flow, x_r, scale))
            out["weight_gap"] = max(out["weight_gap"],
                                    _gap(log_w, lw_r, torch.clamp(lw_r.abs(), min=1.0)))
            for k in ROW:
                gap = abs(row[k] - row_r[k]) / scale_r[k]
                out["row_gap"] = max(out["row_gap"], gap if math.isfinite(gap) else math.inf)
    return out


def checked_runs(state: State):
    """``checked`` of the window's evaluations, drawn from the seed."""
    runs = state.kept["runs"]
    pick = random.Random(state.seed).sample(range(len(runs)),
                                            min(state.traffic["checked"], len(runs)))
    return [runs[i] for i in sorted(pick)]


def check(state: State, limits: dict) -> dict:
    return reference_readings(state, checked_runs(state), limits)
