"""Seed replication across processes (``mfm_tpu_torch.parallel``): the
helpers against the reference's, and a two-process gloo run of
``python -m mfm_tpu_torch.parallel.run_seeds --device cpu`` against the
same seeds run one after another in this process.

Both ranks print the same aggregate. Its metric columns (logpdf*, KSD-U*,
MMD*; not train_time, a clock) equal this process's ``aggregate_row`` of
the two seeds: the same code on the same CPU, one thread a process, so
equal bits, rounded to the 6 decimals the JSON line carries.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mfm_tpu.parallel import distributed as jdist
from mfm_tpu_torch.parallel import distributed as pdist
from mfm_tpu_torch.parallel import run_seeds
from mfm_tpu_torch.targets import four_mode_mixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n_proc", [1, 2, 3])
def test_local_seeds_and_aggregate_match_reference(n_proc):
    seeds = [i**10 for i in range(10)]
    for pid in range(n_proc):
        if len(seeds) % n_proc:
            with pytest.raises(ValueError, match="split evenly"):
                pdist.local_seeds(seeds, pid, n_proc)
            with pytest.raises(ValueError):
                jdist.local_seeds(seeds, pid, n_proc)
        else:
            assert pdist.local_seeds(seeds, pid, n_proc) == jdist.local_seeds(seeds, pid, n_proc)
    rows = np.random.default_rng(n_proc).standard_normal((6, 4))
    for got, ref in zip(pdist.aggregate_row(rows), jdist.aggregate_row(rows)):
        np.testing.assert_allclose(got, ref, rtol=1e-12)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_agree_with_one():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.parallel.run_seeds", "--device", "cpu",
         "--num-processes", "2", "--num-seeds", "2", "--learning-iter", "10",
         "--coordinator", f"localhost:{_free_port()}"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["process_id"] for r in lines] == [0, 1]
    assert [r["local_seeds"] for r in lines] == [[0], [1]]
    assert all(r["total_rows"] == 2 and r["world_size"] == 2 and r["device"] == "cpu"
               for r in lines)
    assert lines[0]["aggregate_mean"] == lines[1]["aggregate_mean"]
    assert lines[0]["aggregate_ci95"] == lines[1]["aggregate_ci95"]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        target = four_mode_mixture("cpu")
        rows = [run_seeds.seed_row(target, s, 10, "cpu") for s in (0, 1)]
    finally:
        torch.set_num_threads(threads)
    mean, ci = pdist.aggregate_row(rows)
    metric = slice(0, 3)  # not train_time
    np.testing.assert_allclose(lines[0]["aggregate_mean"][metric], mean[metric], atol=1e-6)
    np.testing.assert_allclose(lines[0]["aggregate_ci95"][metric], ci[metric], atol=1e-6)
    assert run_seeds.COLUMNS[3] == "train_time"
