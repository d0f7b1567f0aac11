"""The port's metric row against the reference's over seeds: both packages
run on the CPU at one reduced 4-mode configuration (the same overrides,
five seeds each), ``aggregate_seeds`` on both sides, and the port's mean of
logpdf*, KSD-U*, MMD* and the IS estimate of log Z must lie within the
reference's +-1.96 sigma band widened by the port's own.

The random streams of the two packages differ (threefry against
torch.Generator), so this is a comparison of distributions over seeds, not
of values: it can show a fault in the statistics of a whole run (training,
tempering, flow moves, IS correction, eval), which the twelve replayed
steps of tests/test_torch_slice.py cannot. The rows are printed (run with
``-s``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_seed_band.py -m slow -s
"""

import math

import jax
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu import config as jcfg
from mfm_tpu.drivers import evaluate_samples as j_evaluate
from mfm_tpu.drivers import run_mfm as j_run_mfm
from mfm_tpu.drivers import sample_flow as j_sample_flow
from mfm_tpu.drivers.eval import aggregate_seeds as j_aggregate
from mfm_tpu_torch import config as pcfg
from mfm_tpu_torch.drivers import aggregate_seeds, evaluate_samples, run_mfm, sample_flow
from mfm_tpu_torch.drivers.mfm import make_generator

SEEDS = (0, 1, 2, 3, 4)
OVERRIDES = dict(
    num_chain=64, hidden_x=(32, 32), hidden_t=(32, 32), hidden_xt=(32, 32), fourier_dim=16,
    ode_steps=8, learning_iter=300, chunk_size=300, eval_iter=8,
)
COLUMNS = ("logpdf_star", "stein_u_star", "mmd_star", "is_log_z", "logpdf", "stein_u", "mmd")
HELD = COLUMNS[:4]


def _reference_row(seed):
    cfg = jcfg.preset("4-mode", seed=seed, **OVERRIDES)
    target = jt.four_mode_mixture()
    key = jax.random.PRNGKey(seed)
    n = cfg.eval_iter * cfg.num_chain
    real = target.sample(jax.random.fold_in(key, 1000), (n,))
    run = j_run_mfm(target, cfg)
    flow, exact, log_w = j_sample_flow(run, jax.random.fold_in(key, 999), n, target)
    m = j_evaluate(target, flow, exact, real)
    m["is_log_z"] = float(jax.scipy.special.logsumexp(log_w)) - math.log(n)
    return [float(m[c]) for c in COLUMNS]


def _port_row(seed):
    cfg = pcfg.preset("4-mode", seed=seed, **OVERRIDES)
    target = pt.four_mode_mixture()
    n = cfg.eval_iter * cfg.num_chain
    real = target.sample(make_generator("cpu", seed, 1000), (n,))
    run = run_mfm(target, cfg, "cpu")
    flow, exact, log_w = sample_flow(run, n, target, make_generator("cpu", seed, 999))
    m = evaluate_samples(target, flow, exact, real)
    m["is_log_z"] = float(torch.logsumexp(log_w, 0)) - math.log(n)
    return [float(m[c]) for c in COLUMNS]


@pytest.mark.slow
def test_port_metric_row_lies_in_the_reference_seed_band():
    torch.set_num_threads(2)
    ref = j_aggregate([_reference_row(s) for s in SEEDS])
    got = aggregate_seeds([_port_row(s) for s in SEEDS])
    print()
    for i, c in enumerate(COLUMNS):
        print(f"{c:13s} reference {ref['mean'][i]: .4e} +- {ref['ci95'][i]:.3e}   "
              f"port {got['mean'][i]: .4e} +- {got['ci95'][i]:.3e}")
    assert np.all(np.isfinite(ref["mean"])) and np.all(np.isfinite(got["mean"]))
    for i, c in enumerate(COLUMNS):
        if c in HELD:
            gap, band = abs(got["mean"][i] - ref["mean"][i]), ref["ci95"][i] + got["ci95"][i]
            assert gap <= band, f"{c}: port {got['mean'][i]} reference {ref['mean'][i]} band {band}"
