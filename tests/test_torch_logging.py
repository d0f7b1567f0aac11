"""The port's ``MetricLogger`` against the reference's
(``mfm_tpu/utils/logging.py:21-157``, without ``log_figures``): the same
calls on the same inputs write the same JSONL records, field for field (the
``_t`` timestamps aside, whose values are wall-clock), and log the same
lines. Without wandb installed, ``--wandb`` warns and keeps the JSONL.
``primary_only`` reads ``torch.distributed``: every process but rank 0 of
an initialised group writes nothing.
"""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from mfm_tpu.utils.logging import MetricLogger as JLogger
from mfm_tpu_torch.utils.logging import MetricLogger

CHUNKS = [
    {"loss": 1.25, "learning_rate": 1e-3, "acceptance_mean": 0.5, "iter": 4, "train_time": 0.1},
    {"loss": 0.75, "learning_rate": 5e-4, "acceptance_mean": 0.625, "iter": 8, "tag": "x"},
]
SUMMARY = {"metrics_kernel": "torch", "logpdf": -3.5, "stein_u": 0.25, "is_unique": 7,
           "is_ess": None}
PER_ITER = {"loss": np.linspace(1.0, 2.0, 5, dtype=np.float32),
            "beta": np.array([0.1, 0.2, 0.3, 0.4, 1.0], np.float32)}


def _drive(cls, run_dir, per_iter):
    log = cls(run_dir=str(run_dir), run_name="4-mode-seed0", primary_only=False)
    for m in CHUNKS:
        log.log(dict(m))
    log.summary(dict(SUMMARY))
    log.log_per_iteration(per_iter)
    log.finish()
    return [json.loads(line) for line in (run_dir / "4-mode-seed0.jsonl").read_text().splitlines()]


def _strip_time(records):
    return [{k: ("t" if k == "_t" else v) for k, v in r.items()} for r in records]


def test_records_match_the_reference(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    ref = _drive(JLogger, tmp_path / "ref", PER_ITER)
    ref_lines = [r.getMessage() for r in caplog.records if r.name == "mfm_tpu"]
    caplog.clear()
    mine = _drive(MetricLogger, tmp_path / "port",
                  {k: torch.from_numpy(v) for k, v in PER_ITER.items()})
    my_lines = [r.getMessage() for r in caplog.records if r.name == "mfm_tpu_torch"]
    assert _strip_time(mine) == _strip_time(ref)
    assert [list(r) for r in mine] == [list(r) for r in ref]  # field order too
    assert len(mine) == len(CHUNKS) + 1 + 5
    assert my_lines == ref_lines and len(my_lines) == len(CHUNKS) + 2


def test_appends_and_no_run_dir(tmp_path):
    """A second logger of the same run appends; without a run dir nothing is
    written."""
    for _ in range(2):
        log = MetricLogger(run_dir=str(tmp_path), run_name="r")
        log.log({"loss": 1.0})
        log.finish()
    assert len((tmp_path / "r.jsonl").read_text().splitlines()) == 2
    log = MetricLogger(run_dir=None)
    log.log({"loss": 1.0})
    log.summary({"a": 1.0})
    log.finish()


def test_wandb_missing_warns_and_keeps_jsonl(tmp_path, caplog, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # importing it fails
    log = MetricLogger(run_dir=str(tmp_path), run_name="w", use_wandb=True)
    log.log({"loss": 2.0})
    log.finish()
    assert "wandb requested but not installed; using JSONL only" in caplog.text
    assert json.loads((tmp_path / "w.jsonl").read_text())["loss"] == 2.0


@pytest.mark.parametrize("rank,world,writes", [(0, 2, True), (1, 2, False), (1, 1, True)])
def test_primary_only_reads_torch_distributed(tmp_path, monkeypatch, rank, world, writes):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    log = MetricLogger(run_dir=str(tmp_path), run_name="p")
    log.log({"loss": 1.0})
    log.finish()
    assert log.enabled == writes and (tmp_path / "p.jsonl").exists() == writes
    forced = MetricLogger(run_dir=str(tmp_path), run_name="q", primary_only=False)
    assert forced.enabled
    forced.finish()
