"""``chip_smoke.py``'s phases beside the main process: the bands (47-51)
and many-well's runs (10, 12, 27, 52) run in two processes of their own,
joined after phase 40. Without a card both workers fail, and the join must
fail the script with their output, leaving no worker behind."""

import importlib.util
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_the_phases_beside_are_the_bands_and_many_well():
    smoke = _smoke()
    assert smoke.BESIDE == ("bands", "many-well")
    labels = [label.split()[0] for _, label, _ in smoke.MANY_WELL_PHASES]
    assert labels == ["10", "12", "27"]
    assert all("many-well" in argv for argv, _, _ in smoke.MANY_WELL_PHASES)


def test_a_failing_worker_fails_the_join(tmp_path, capsys, monkeypatch):
    smoke = _smoke()
    monkeypatch.setattr(smoke, "fail", lambda msg: sys.exit(f"FAIL: {msg}"))
    monkeypatch.setattr("atexit.register", lambda fn: fn)
    monkeypatch.setattr("signal.signal", lambda *a: None)
    beside = smoke.start_beside(str(tmp_path))
    with pytest.raises(SystemExit, match="the phases beside: bands exited"):
        smoke.join_beside(beside, [])
    assert all(p.poll() not in (None, 0) for p in beside["procs"].values())
    # each worker's own refusal is echoed at the join
    assert capsys.readouterr().err.count("no CUDA device") == 2
