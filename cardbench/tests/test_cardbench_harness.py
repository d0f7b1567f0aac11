"""CPU tests of the benchmark at small sizes: the result line, the window's
whole cycles, the counts, the imports, the control and the planted faults.

    python -m pytest cardbench/tests -q

The cells run here through the program's plain versions of its kernels;
the test marked ``cuda`` runs a cell on the card and skips without one.
"""

import ast
import json
import math
import time
from pathlib import Path

import pytest
import torch

from cardbench import harness
from cardbench.controls import readings
from cardbench.session import run_cell

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"hidden_x": [16, 16], "hidden_t": [16, 16], "hidden_xt": [16, 16], "fourier_dim": 8}
CELLS = {
    "phi_four.train_sweep10": {"config": {**SMALL, "num_chain": 16}, "traffic": {"seeds": 2}},
    "many_well.eval": {"config": {**SMALL, "num_chain": 16, "eval_iter": 8}},
}
SEED = 2**31 + 77  # seeds beyond 32 bits are taken whole


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell_run(request):
    torch.set_num_threads(2)
    name = request.param
    cell = harness.load_cell(name)
    result, lines = run_cell(cell, SEED, 0.5, False, "cpu", time.perf_counter(), CELLS[name])
    return name, cell, result, lines


def test_result_line(cell_run):
    name, cell, result, lines = cell_run
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["checks"]) == set(cell.limits)
    for value, limit in result["checks"].values():
        assert math.isfinite(value) and value <= limit
    assert lines[-1].endswith("correct: True")
    json.dumps(result)  # one JSON object


def test_window_holds_whole_units(cell_run):
    """A training window closes on whole 11-iteration cycles; an
    evaluation window counts whole evaluations."""
    name, cell, result, _ = cell_run
    unit = 11 if cell.traffic["kind"] == "train_sweep" else 1
    assert result["attempted"] >= unit and result["attempted"] % unit == 0


def test_train_window_opens_at_beta_one():
    cell = harness.load_cell("phi_four.train_sweep10")
    state = cell.kind.setup(cell, 5, "cpu", harness.Clock(time.perf_counter()),
                            CELLS["phi_four.train_sweep10"])
    assert state.box["count"] == 11
    assert bool((state.box["carry"].beta == 1.0).all())


@pytest.mark.parametrize("config,row_flops", [("phi_four", 163_840), ("many_well", 147_456)])
def test_row_flops_by_hand(config, row_flops):
    conf = harness.read_json(ROOT / "configs" / f"{config}.json")
    counts = harness.load_module(ROOT / "counts" / f"{config}.py", f"counts_{config}")
    traffic = {"seeds": 10}
    assert counts.work(conf, traffic)["row_flops"] == row_flops
    c = conf["config"]
    # by hand: x-trunk d->128->128, joint (128+128)->128->128, field head 128->d
    d = c["dim"]
    assert row_flops == 2 * (d * 128 + 128 * 128 + 256 * 128 + 128 * 128 + 128 * d)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def test_imports_by_whole_name():
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "mfm_tpu"}, path
        if "reference" in path.relative_to(ROOT).parts:
            assert "mfm_tpu_torch" not in tops, path
        if "tests" not in path.relative_to(ROOT).parts:  # this file names them
            text = path.read_text()
            for other in ("bench.py", "benchmarks/", "BENCH_"):
                assert other not in text, (path, other)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_and_faults_fail_their_limits(name):
    """The reference at the next precision below, and each fault planted in
    it, put in the program's place: each fails a limit."""
    cell = harness.load_cell(name)
    got = readings(cell, 3, "cpu", CELLS[name])
    assert harness.judge(got["sound"], cell.limits)[0]
    for side, values in got.items():
        if side != "sound":
            assert not harness.judge(values, cell.limits)[0], (side, values)


def _broken_train_step(monkeypatch, fault):
    """The program's training step broken underneath: ``half`` takes the
    loss over half of each batch, ``unchanged`` returns its state unchanged;
    with ``_late`` only after the first cycle, in the window."""
    from mfm_tpu_torch.drivers import mfm
    from mfm_tpu_torch.flows.losses import FMBatch

    fault, _, late = fault.partition("_")
    on = {"now": not late}
    build = mfm.build_mfm

    def broken(*args, **kw):
        pieces = build(*args, **kw)
        cycle = int(args[1].mcmc_per_flow_steps) + 1

        def step(carry, count, *noise):
            on["now"] = not late or count > cycle
            new, m = pieces.step_fn(carry, count, *noise)
            return (carry if fault == "unchanged" and on["now"] else new), m

        return pieces._replace(step_fn=step)

    monkeypatch.setattr(mfm, "build_mfm", broken)
    if fault == "half":
        whole = mfm.flow_matching_loss

        def half(apply_fn, batch):
            if not on["now"]:
                return whole(apply_fn, batch)
            keep = batch.times.shape[0] // 2
            part = FMBatch(batch.times[:keep], batch.points[:keep], batch.targets[:keep])
            return 2.0 * whole(apply_fn, part)

        monkeypatch.setattr(mfm, "flow_matching_loss", half)


def _broken_eval(monkeypatch, fault):
    from mfm_tpu_torch.drivers import eval as prog_eval
    from mfm_tpu_torch.drivers import mfm

    if fault == "answer":
        parts = mfm.sample_flow_parts

        def moved(*args, **kw):
            flow, exact, log_w = parts(*args, **kw)
            flow = flow.clone()
            flow[0] += 1.0
            return flow, exact, log_w

        monkeypatch.setattr(mfm, "sample_flow_parts", moved)
    else:  # the row over half of the draws
        whole = prog_eval.evaluate_samples

        def half(target, flow, exact, real=None, *a, **kw):
            keep = flow.shape[0] // 2
            return whole(target, flow[:keep], exact[:keep], real, *a, **kw)

        monkeypatch.setattr(prog_eval, "evaluate_samples", half)


@pytest.mark.parametrize("name,fault", [("phi_four.train_sweep10", "half"),
                                        ("phi_four.train_sweep10", "unchanged"),
                                        ("phi_four.train_sweep10", "half_late"),
                                        ("phi_four.train_sweep10", "unchanged_late"),
                                        ("many_well.eval", "half"),
                                        ("many_well.eval", "answer")])
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    """A whole run with the timed path broken underneath, past the look for
    a card: ``correct`` comes out false, also where the fault sets in only
    in the window (``_late``)."""
    cell = harness.load_cell(name)
    if name.startswith("phi_four"):
        _broken_train_step(monkeypatch, fault)
    else:
        _broken_eval(monkeypatch, fault)
    result, lines = run_cell(cell, SEED + 1, 0.5, False, "cpu", time.perf_counter(),
                             CELLS[name])
    assert result["correct"] is False, lines


def test_run_needs_a_card(capsys, monkeypatch):
    from cardbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "many_well.eval", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == ""


def test_parked_cells_load_by_name():
    """A cell left out of ``BENCHMARK.json`` is found in ``parked/``, and
    ``BENCHMARK.json``'s entries of a name come first."""
    bench = harness.read_json(ROOT.parent / "BENCHMARK.json")
    assert "many_well.eval" not in {w["name"] for w in bench["workloads"]}
    cell = harness.load_cell("many_well.eval")
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"eval_samples_per_s", "setup_s"}
    merged = harness.with_parked(bench)
    assert [w["name"] for w in merged["workloads"]].count("many_well.eval") == 1
    again = harness.with_parked(merged)
    assert len(again["per_layer"]) == len(merged["per_layer"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_on_the_card(capsys, name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cardbench import run

    assert run.main(["--workload", name, "--seed", "9", "--seconds", "2"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
