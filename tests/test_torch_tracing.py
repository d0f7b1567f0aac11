"""The port's spans and counters (``mfm_tpu_torch/utils/profiling.py``) on
the CPU, at the benchmark tests' small sizes (2 seeds of 16 chains, d = 8,
2 ODE steps): off without a profiler, outputs unchanged under one, the span
tree and its counters, the clock shared with the profiler's events,
``spans.json``, and the benchmark's readers of them."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers.mfm import build_mfm
from mfm_tpu_torch.targets import PhiFour
from mfm_tpu_torch.utils import profiling

METRICS = Path(__file__).resolve().parents[1] / "cardbench" / "metrics"
S, B, D, ODE_STEPS = 2, 16, 8, 2
CFG = dict(example="phi-four", dim=D, num_chain=B, hidden_x=(16, 16), hidden_t=(16, 16),
           hidden_xt=(16, 16), fourier_dim=8, ode_steps=ODE_STEPS, mcmc_per_flow_steps=1.0,
           anneal_iter=4, num_anneal_temp=4, learning_iter=8, step_size=1e-3)
FIELDS = {"module": dict(field_precision="default", pallas_field=False),
          "kernel": dict(field_precision="highest", pallas_field=True)}
MCMC, FLOW = 1, 2  # one flow iteration every second


def _sweep(field: str):
    """(step_fn, carry, noise by count) of a 2-seed phi-four sweep."""
    torch.set_num_threads(1)
    cfg = MFMConfig(**CFG, **FIELDS[field])
    pieces = build_mfm(PhiFour(D), cfg, "cpu", [torch.Generator().manual_seed(s) for s in range(S)])
    gens = [torch.Generator().manual_seed(10 + s) for s in range(S)]
    carry = pieces.init_fn(torch.cat([PhiFour(D).init_positions(g, B) for g in gens]))
    noise = {c: pieces.draw_step_noise(gens, c) for c in (MCMC, FLOW)}
    return pieces.step_fn, carry, noise, cfg


def _steps(step_fn, carry, noise):
    """The outputs of an MCMC and then a flow iteration."""
    out = []
    for count in (MCMC, FLOW):
        carry, metrics = step_fn(carry, count, *noise[count])
        out.append((carry, metrics))
    return out


def _leaves(tree):
    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    return [v for v in leaves if isinstance(v, torch.Tensor)]


def _profiled(fn):
    """``fn()`` under a CPU profiler, the registry cleared first: (its
    output, the profile)."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module", params=sorted(FIELDS))
def sweep(request):
    return _sweep(request.param)


def test_off_records_nothing(sweep):
    step_fn, carry, noise, _ = sweep
    profiling.reset()
    _steps(step_fn, carry, noise)
    assert profiling.spans() == []
    assert not any(k in profiling.counters() for k in ("sync", "stages"))


def test_traced_outputs_are_bit_identical(sweep):
    step_fn, carry, noise, _ = sweep
    off = _steps(step_fn, carry, noise)
    on, _ = _profiled(lambda: _steps(step_fn, carry, noise))
    assert profiling.spans(), "the profiled steps recorded no span"
    for a, b in zip(_leaves(off), _leaves(on)):
        assert torch.equal(a, b)


def test_span_tree_and_counters(sweep):
    """The names and parents of the step's spans; a flow step's stages
    (two transports of ODE_STEPS RK4 steps), each with one field and one
    gate call; one host wait an iteration (the tempering check)."""
    step_fn, carry, noise, cfg = sweep
    assert cfg.iter_per_temp == 1
    _profiled(lambda: step_fn(carry, MCMC, *noise[MCMC]))
    mcmc = profiling.summarize()
    assert set(mcmc["spans"]) == {"step.mcmc"} | {f"step.mcmc/{p}" for p in
                                                  ("move", "fm_grad", "adamw", "temper")}
    assert mcmc["counters"]["sync"] == 1 and "stages" not in mcmc["counters"]

    _profiled(lambda: step_fn(carry, FLOW, *noise[FLOW]))
    flow = profiling.summarize()
    rows, stages = flow["spans"], 2 * ODE_STEPS * 4
    move = "step.flow/move"
    want = ({"step.flow"} | {f"step.flow/{p}" for p in ("move", "fm_grad", "adamw", "temper")}
            | {f"{move}/flow.{p}" for p in ("inverse", "forward", "target", "accept")}
            | {f"{move}/flow.{t}/stage.{p}" for t in ("inverse", "forward")
               for p in ("field", "gate", "divergence")})
    assert set(rows) == want
    assert flow["counters"]["stages"] == stages and flow["counters"]["sync"] == 1
    for part in ("field", "gate", "divergence"):
        assert sum(rows[f"{move}/flow.{t}/stage.{part}"]["count"]
                   for t in ("inverse", "forward")) == stages
    for t in ("inverse", "forward"):
        assert rows[f"{move}/flow.{t}"]["count"] == 1
    parents = {s.name: profiling.spans()[s.parent].name for s in profiling.spans()
               if s.parent >= 0}
    assert parents["move"] == "step.flow" and parents["flow.inverse"] == "move"
    assert parents["stage.gate"] in ("flow.inverse", "flow.forward")


def test_the_clock_is_the_profilers():
    """The profiler's events and the spans share ``time.time_ns()``: in an
    MCMC iteration only the flow-matching loss runs the net, and each
    ``aten::linear`` event the profiler records lies inside ``fm_grad``."""
    step_fn, carry, noise, _ = _sweep("module")
    _, prof = _profiled(lambda: step_fn(carry, MCMC, *noise[MCMC]))
    fm = [s for s in profiling.spans() if s.name == "fm_grad"]
    assert len(fm) == 1
    linear = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::linear"]
    assert linear
    for e in linear:
        assert fm[0].start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= fm[0].end_ns


def test_spans_json_self_time(tmp_path):
    step_fn, carry, noise, _ = _sweep("module")
    with profiling.trace(str(tmp_path), device="cpu"):
        _steps(step_fn, carry, noise)
    got = json.loads((tmp_path / "spans.json").read_text())
    assert (tmp_path / "trace.json").stat().st_size > 0
    rows = got["spans"]
    assert rows["step.mcmc"]["count"] == 1 and rows["step.flow"]["count"] == 1
    assert got["counters"]["sync"] == 2
    assert got["window_ms"] > 0 and "device" not in got  # no device split on the CPU
    for path, row in rows.items():
        children = sum(r["host_ms"] for p, r in rows.items()
                       if p.rsplit("/", 1)[0] == path and p != path)
        assert row["self_ms"] == pytest.approx(row["host_ms"] - children, abs=1e-6), path
        assert 0 <= row["self_ms"] <= row["host_ms"]


class _Event:
    """A CUDA event's stand-in: a time in ms."""

    def __init__(self, ms: float):
        self.ms = ms

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def _put(name, parent, t0_ms, t1_ms, device_ms=None):
    """Append a finished span to the registry; its index."""
    events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    profiling._SPANS.append(profiling.Span(name, parent, int(t0_ms * 1e6), int(t1_ms * 1e6),
                                           events))
    return len(profiling._SPANS) - 1


def _synthetic():
    """Two MCMC steps (move 1, fm_grad 5, adamw 3, temper 0.5 ms of host
    each) and a flow step of 4 stages (field 8, gate 0.5 ms of device each);
    a wait each step."""
    profiling.reset()
    t = 0.0
    for _ in range(2):
        step = _put("step.mcmc", -1, t, t + 10.0)
        for name, ms in (("move", 1.0), ("fm_grad", 5.0), ("adamw", 3.0), ("temper", 0.5)):
            _put(name, step, t, t + ms)
            t += ms
        t += 0.5
    step = _put("step.flow", -1, t, t + 40.0)
    move = _put("move", step, t, t + 38.0)
    inverse = _put("flow.inverse", move, t, t + 38.0)
    for _ in range(4):
        _put("stage.field", inverse, t, t + 1.0, device_ms=8.0)
        _put("stage.gate", inverse, t + 1.0, t + 1.5, device_ms=0.5)
        t += 2.0
    profiling._COUNTERS.update(sync=3, stages=4)


@pytest.mark.parametrize("name,value", [
    ("host_ms.mcmc.move", 1.0), ("host_ms.mcmc.fm_grad", 5.0), ("host_ms.mcmc.adamw", 3.0),
    ("syncs_per_iter.train", 1.0), ("stage_ms.field", 8.0), ("stage_ms.gate", 0.5)])
def test_readers(name, value):
    """Each reader's value from a synthetic registry; None from an empty one."""
    spec = importlib.util.spec_from_file_location(f"reader_{name}", METRICS / f"{name}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    try:
        _synthetic()
        assert reader.read({}) == pytest.approx(value, rel=1e-6)
    finally:
        profiling.reset()
    assert reader.read({}) is None
