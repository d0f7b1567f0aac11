"""The end-of-run figures (``mfm_tpu_torch.drivers.plots``,
``MetricLogger.log_figures``, the CLI's ``--plots``) against the
reference's.

The same arrays go into both packages' figure functions, and what each
figure plots is compared: every line's xy-data and the contour grid's
values, at 1e-6; the progression's snapshots, through both transports on
the same ``u`` and the reference's parameters converted, at 1e-5 (fp32
through 8 RK4 steps). ``log_figures`` writes the same file names.
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.drivers import plots as jplots
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.utils.logging import MetricLogger as JLogger
from mfm_tpu_torch.config import preset
from mfm_tpu_torch.drivers import plots as pplots
from mfm_tpu_torch.flows import make_transport, module_tangent_field
from mfm_tpu_torch.utils.logging import MetricLogger
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)
plt = pytest.importorskip("matplotlib.pyplot")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.get_lines()]


def _same_lines(pfig, jfig, tol=1e-6):
    got, ref = _lines(pfig), _lines(jfig)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)
    assert [ax.get_title() for ax in pfig.axes] == [ax.get_title() for ax in jfig.axes]


def _samples(n=300, d=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((6.0 * rng.standard_normal((n, d))).astype(np.float32) for _ in range(2))


def test_pair_scatter_and_contours_match():
    fs, es = _samples()
    lim, width, levels = (-16.0, 16.0), 40, 10
    (jfig,) = jplots.pair_scatter(fs, es, lim=lim, log_prob_fn=jt.four_mode_mixture().log_prob,
                                  grid_width=width, levels=levels)
    (pfig,) = pplots.pair_scatter(tt(fs), tt(es), lim=lim,
                                  log_prob_fn=pt.four_mode_mixture().log_prob,
                                  grid_width=width, levels=levels)
    _same_lines(pfig, jfig)
    # the contour grid: the reference's own lines (plots.py:29-32)
    grid = jnp.linspace(lim[0], lim[1], width)
    xx, yy = jnp.meshgrid(grid, grid, indexing="ij")
    pts = jnp.stack([xx.ravel(), yy.ravel()], axis=1)
    vals = jnp.maximum(jt.four_mode_mixture().log_prob(pts), -1000.0).reshape(width, width)
    pxx, pyy, pvals = pplots.contour_grid(pt.four_mode_mixture().log_prob, lim, width)
    np.testing.assert_allclose(pxx, np.asarray(xx), atol=1e-6)
    np.testing.assert_allclose(pyy, np.asarray(yy), atol=1e-6)
    np.testing.assert_allclose(pvals, np.asarray(vals), rtol=1e-6, atol=1e-6)
    for pax, jax_ in zip(pfig.axes, jfig.axes):
        (pc,), (jc,) = pax.collections, jax_.collections
        np.testing.assert_allclose(pc.levels, jc.levels, rtol=1e-6)
    # d > 2: one figure a pair, no contours
    fs8, es8 = _samples(50, 8, 1)
    pfigs = pplots.pair_scatter(tt(fs8), tt(es8), max_dims=4)
    jfigs = jplots.pair_scatter(fs8, es8, max_dims=4)
    assert len(pfigs) == len(jfigs) == 4
    for p, j in zip(pfigs, jfigs):
        _same_lines(p, j)
        assert not any(ax.collections for ax in p.axes)


def test_phi_four_fields_match():
    fs, es = _samples(20, 16, 2)
    _same_lines(pplots.phi_four_fields(tt(fs), tt(es)), jplots.phi_four_fields(fs, es))


def _flows(width=16, steps=8):
    """A perturbed 2-D field in both packages (the reference's parameters
    converted) and their transports."""
    jnet, jparams, freqs = flax_field(jax.random.PRNGKey(3), dim=2, width=width, fourier=8,
                                      perturb=0.1)
    pnet, pparams = torch_field(jparams, freqs, dim=2, width=width)
    jtr = j_transport(jnet.apply, "exact", n_steps=steps)
    ptr = make_transport(module_tangent_field(pnet), "exact", n_steps=steps)
    return jtr, jparams, ptr, pparams


def test_flow_progression_matches():
    jtr, jparams, ptr, pparams = _flows()
    u = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (64, 2)))
    jfig = jplots.flow_progression(jtr, jparams, jnp.asarray(u))
    pfig = pplots.flow_progression(ptr, pparams, tt(u))
    _same_lines(pfig, jfig, 1e-5)
    np.testing.assert_allclose(_lines(pfig)[0], u, atol=1e-6)  # t = 0 is u itself
    x1 = npy(ptr.forward(pparams, tt(u))[0])
    np.testing.assert_allclose(_lines(pfig)[-1], x1, atol=1e-5)  # t = 1 the forward map


@pytest.mark.parametrize("example", ["4-mode", "phi-four"])
def test_run_figures_and_log_figures_match(example, tmp_path):
    """The figure set by name, each figure's data, and the PNGs that
    ``log_figures`` writes: the same names in both packages."""
    cfg = preset(example)
    cfg.grid_width = 30
    jtarget = jt.four_mode_mixture() if example == "4-mode" else jt.PhiFour(64)
    ptarget = pt.four_mode_mixture() if example == "4-mode" else pt.PhiFour(64)
    fs, es = _samples(200, ptarget.dim, 3)
    jrun = prun = None
    u = None
    if example == "4-mode":
        jtr, jparams, ptr, pparams = _flows()
        jref = jt.IndepGaussian(2)
        jrun = SimpleNamespace(transport=jtr, ref_dist=jref, train=SimpleNamespace(params=jparams))
        prun = SimpleNamespace(transport=ptr, ref_dist=pt.IndepGaussian(2),
                               train=SimpleNamespace(params=pparams))
        key = jax.random.PRNGKey(5)
        u = tt(jref.sample(key, (min(1024, fs.shape[0]),)))  # the reference's draw
    jfigs = jplots.make_run_figures(jtarget, cfg, fs, es, run=jrun, key=jax.random.PRNGKey(5)
                                    if jrun else None)
    pfigs = pplots.make_run_figures(ptarget, cfg, tt(fs), tt(es), run=prun, noise=u)
    assert sorted(pfigs) == sorted(jfigs)
    for name in jfigs:
        jl = jfigs[name] if isinstance(jfigs[name], list) else [jfigs[name]]
        pl = pfigs[name] if isinstance(pfigs[name], list) else [pfigs[name]]
        assert len(pl) == len(jl)
        for p, j in zip(pl, jl):
            _same_lines(p, j, 1e-5)
    jpaths = JLogger(run_dir=str(tmp_path / "j"), run_name="r", stdout_every=0).log_figures(jfigs)
    ppaths = MetricLogger(run_dir=str(tmp_path / "p"), run_name="r",
                          stdout_every=0).log_figures(pfigs)
    rel = lambda paths, root: sorted(os.path.relpath(p, root) for p in paths)
    assert rel(ppaths, tmp_path / "p") == rel(jpaths, tmp_path / "j")
    assert all(os.path.getsize(p) > 0 for p in ppaths)


_TINY = [
    "--example", "4-mode", "--device", "cpu", "--seed", "0", "--learning-iter", "8",
    "--num-chain", "8", "--ode-steps", "2", "--chunk-size", "4", "--mcmc-per-flow-steps", "3",
    "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)",
    "--set", "fourier_dim=4", "--set", "eval_iter=4", "--set", "grid_width=20",
]


def test_cli_plots_writes_the_figures(tmp_path):
    from mfm_tpu_torch import cli

    (row,) = cli.main(_TINY + ["--plots", "--run-dir", str(tmp_path)])
    names = sorted(os.listdir(tmp_path / "4-mode-seed0_figs"))
    assert names == ["pairs_0.png", "progression_0.png"] and np.isfinite(row["logpdf"])


def test_cli_plots_refused_before_training_without_matplotlib(monkeypatch, tmp_path):
    from mfm_tpu_torch import cli

    def no_training(*a, **kw):
        raise AssertionError("trained before refusing --plots")

    monkeypatch.setattr(cli, "run_mfm", no_training)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # importing it fails
    with pytest.raises(SystemExit, match="--plots needs matplotlib"):
        cli.main(_TINY + ["--plots", "--run-dir", str(tmp_path)])
