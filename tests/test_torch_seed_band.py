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

The second half holds the port to the committed reference band
(tools/seed_band_reference.json, made by tools/seed_band_reference.py):
the reference's rows over the CLI's 10 replication seeds for five bands,
which chip_smoke.py's phases 47-51 hold the card's sweeps to. Its fast
tests check the file, the bands' configs in both packages and the bands
chip_smoke.py drives; its slow tests run the port over the 10 seeds on the
CPU against each band (chip_smoke.py's rule) and regenerate seed 0 of each band
from mfm_tpu (rtol 1e-4, for XLA CPU builds on other hosts).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_seed_band.py -m slow -s
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

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
from mfm_tpu_torch import cli as pcli
from mfm_tpu_torch import config as pcfg
from mfm_tpu_torch.drivers import aggregate_seeds, evaluate_samples, run_mfm, sample_flow
from mfm_tpu_torch.drivers.mfm import ess_of, make_generator

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


# ---------------------------------------------------------------------------
# The committed reference band (tools/seed_band_reference.json): mfm_tpu's
# rows over the CLI's 10 replication seeds for five bands, which
# chip_smoke.py's band phases hold the card's sweeps to.

ROOT = Path(__file__).resolve().parents[1]
BAND_FILE = ROOT / "tools" / "seed_band_reference.json"
BAND_NAMES = ("4-mode", "gaussian-mixture", "phi-four", "phi-four-fused", "pines")
REPLICATION_SEEDS = [i**10 for i in range(10)]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _bands():
    return json.loads(BAND_FILE.read_text())["bands"]


def _tuples(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def test_reference_band_file_holds_five_bands_of_ten_finite_rows():
    data = json.loads(BAND_FILE.read_text())
    assert sorted(data["bands"]) == sorted(BAND_NAMES)
    for name, band in data["bands"].items():
        assert band["seeds"] == REPLICATION_SEEDS, name
        assert [r["seed"] for r in band["rows"]] == REPLICATION_SEEDS, name
        cols = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star",
                "stein_v_star", "mmd_star", "is_log_z", "is_ess", "is_unique",
                "stein_u_f64", "stein_u_star_f64", "seconds")
        assert all(math.isfinite(r[c]) for r in band["rows"] for c in cols), name
        assert band["reduced"] and band["jax_version"], name
        assert set(band["held"]) <= set(cols), name
    many_well = data["many_well"]
    assert many_well["seeds"] == REPLICATION_SEEDS
    assert [r["seed"] for r in many_well["rows"]] == REPLICATION_SEEDS


@pytest.mark.parametrize("name", BAND_NAMES)
def test_band_overrides_give_equal_configs_in_both_packages(name):
    band = _bands()[name]
    tool = _load("seed_band_reference", ROOT / "tools" / "seed_band_reference.py")
    example, overrides = tool.overrides_of(name)
    assert (band["example"], _tuples(band["overrides"])) == (example, overrides)
    ref = dataclasses.asdict(jcfg.preset(example, **overrides))
    port = dataclasses.asdict(pcfg.preset(example, **_tuples(band["overrides"])))
    assert _tuples(port) == _tuples(ref)
    # the card's run: the same overrides through the CLI's --set parser,
    # and only the port's own additions on top (pallas_field for K1)
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    flags = smoke.set_flags({**band["overrides"], **band["port_overrides"]})
    assert pcli._parse_set(flags[1::2]) == {**overrides, **band["port_overrides"]}
    assert set(band["port_overrides"]) <= {"pallas_field"}


def test_band_names_are_the_ones_chip_smoke_drives():
    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    assert sorted(smoke.BAND_KERNELS) == sorted(_bands())
    assert Path(smoke.BAND_FILE) == BAND_FILE
    for band in _bands().values():
        assert set(band["held"]) <= set(smoke.BAND_COLUMNS)
        assert all(c in r for c in smoke.BAND_REFERENCE.values() for r in band["rows"])


def _port_band_row(band, seed):
    cfg = pcfg.preset(band["example"], seed=seed,
                      **_tuples({**band["overrides"], **band["port_overrides"]}))
    target = pcli.make_target(band["example"], "cpu")
    n = cfg.eval_iter * cfg.num_chain
    real = target.sample(make_generator("cpu", seed, 1000), (n,)) if target.can_sample else None
    run = run_mfm(target, cfg, "cpu")
    flow, exact, log_w = sample_flow(run, n, target, make_generator("cpu", seed, 999))
    m = evaluate_samples(target, flow, exact, real)
    m["is_log_z"] = float(torch.logsumexp(log_w, 0)) - math.log(n)
    m["is_ess"] = float(ess_of(log_w))
    return m


@pytest.mark.slow
@pytest.mark.parametrize("name", BAND_NAMES)
def test_port_on_the_cpu_lies_in_the_committed_band(name):
    """chip_smoke.py's rule: within ci95_ref + ci95_port and within its
    limit of standard errors of the difference. On the CPU the port's KSD is
    the plain fp32 statistic, the reference's own arithmetic, so it is held
    to the reference's fp32 columns (the card's K2a to the float64 ones)."""
    torch.set_num_threads(2)
    limit = _load("chip_smoke", ROOT / "chip_smoke.py").BAND_SE_LIMIT
    band = _bands()[name]
    port = [_port_band_row(band, s) for s in REPLICATION_SEEDS]
    held = band["held"]
    ref = j_aggregate([[r[c] for c in held] for r in band["rows"]])
    got = aggregate_seeds([[m[c] for c in held] for m in port])
    print(f"\n{name}: is_ess reference {np.mean([r['is_ess'] for r in band['rows']]):.3f} "
          f"port {np.mean([m['is_ess'] for m in port]):.3f}")
    n = len(REPLICATION_SEEDS)
    se = np.sqrt((ref["ci95"] / 1.96) ** 2 / n + (got["ci95"] / 1.96) ** 2 / n)
    gap = np.abs(got["mean"] - ref["mean"])
    for i, c in enumerate(held):
        print(f"{c:13s} reference {ref['mean'][i]: .4e} +- {ref['ci95'][i]:.3e}   "
              f"port {got['mean'][i]: .4e} +- {got['ci95'][i]:.3e}   "
              f"{gap[i] / se[i]:.2f} standard errors")
    assert np.all(np.isfinite(got["mean"])) and np.all(np.isfinite(ref["mean"]))
    for i, c in enumerate(held):
        width = ref["ci95"][i] + got["ci95"][i]
        assert gap[i] <= width and gap[i] <= limit * se[i], (
            f"{c}: port {got['mean'][i]} reference {ref['mean'][i]} band {width} "
            f"standard error {se[i]}")


@pytest.mark.slow
@pytest.mark.parametrize("name", BAND_NAMES)
def test_reference_band_regenerates_seed_zero(name):
    tool = _load("seed_band_reference", ROOT / "tools" / "seed_band_reference.py")
    row = tool.reference_row(name, 0)
    (committed,) = [r for r in _bands()[name]["rows"] if r["seed"] == 0]
    for c in tool.COLUMNS:
        np.testing.assert_allclose(row[c], committed[c], rtol=1e-4, err_msg=c)
