"""The sampling extensions (``mfm_tpu_torch.drivers.mfm``): MALA move
correction, the move-corrected flow sampling, and the defensive mixture,
against ``mfm_tpu.drivers.mfm`` under replayed keys; the port's deliberate
divergences from the reference (ADVICE.md round 5); and the CLI's rows for
the new flags at a tiny size on the CPU.

Tolerances: 1e-4 (six MALA moves with dual averaging, which feeds each
fp32 difference into the next step size; a transport of 4 RK4 steps).
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.drivers import mfm as jmfm
from mfm_tpu.flows import make_transport as j_make_transport
from mfm_tpu_torch.drivers import mfm as pmfm
from mfm_tpu_torch.flows import make_transport, module_tangent_field
from mfm_tpu_torch.kernels import mala
from torch_parity import cli_run_dir, flax_field, npy, torch_field, tt  # noqa: F401

N = 64


def _moves(key, n_moves, n=N, d=2):
    out = []
    for k in jax.random.split(key, n_moves):
        kn, ka = jax.random.split(k)
        out.append(mala.MalaNoise(tt(jax.random.normal(kn, (n, d))),
                                  tt(jax.random.uniform(ka, (n,)))))
    return out


@pytest.mark.parametrize("example", ["4-mode", "phi-four"])
def test_mala_move_correct_matches_reference(example):
    """Six moves: three adapting by dual averaging, three at the frozen
    averaged step; on 4-mode (autodiff score) and PhiFour(8) (K3's plain
    version)."""
    if example == "4-mode":
        jtarget, ptarget, d, step = jt.four_mode_mixture(), pt.four_mode_mixture(), 2, 0.5
        x = np.asarray(8.0 * jnp.sign(jax.random.normal(jax.random.PRNGKey(0), (N, 2)))
                       + jax.random.normal(jax.random.PRNGKey(1), (N, 2)))
    else:
        jtarget, ptarget, d, step = jt.PhiFour(8), pt.PhiFour(8), 8, 1e-3
        x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (N, 8), minval=-1, maxval=1))
    key = jax.random.PRNGKey(2)
    ref = jmfm.mala_move_correct(jnp.asarray(x), jtarget, key, n_moves=6, init_step=step)
    got = pmfm.mala_move_correct(tt(x), ptarget, _moves(key, 6, d=d), init_step=step)
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-4, atol=1e-4)
    assert float(torch.max(torch.abs(got - tt(x)))) > 1e-3, "the moves moved"


def _flows(d=2):
    """A perturbed flax field on 4-mode and its port, each as a transport
    (exact divergence, 4 RK4 steps) with a duck-typed run."""
    net, params, freqs = flax_field(jax.random.PRNGKey(7), dim=d, width=16, fourier=8)
    jtr = j_make_transport(net.apply, divergence="exact", n_steps=4, method="rk4")
    pnet, pparams = torch_field(params, freqs, dim=d, width=16)
    ptr = make_transport(module_tangent_field(pnet), divergence="exact", n_steps=4,
                         method="rk4")
    return jtr, params, ptr, pparams


def test_sample_flow_move_matches_reference():
    """The reference's sample_flow_move on a duck-typed run against the
    port's parts under its key splits: IS resampling, then moves."""
    jtr, jparams, ptr, pparams = _flows()
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    jref, pref = jt.IndepGaussian(2, var=25.0), pt.IndepGaussian(2, var=25.0)
    run = types.SimpleNamespace(transport=jtr, train=types.SimpleNamespace(params=jparams),
                                ref_dist=jref)
    key = jax.random.PRNGKey(3)
    moved, exact, log_w = jmfm.sample_flow_move(run, key, N, jtarget, n_moves=6, init_step=0.5)
    key_is, key_moves = jax.random.split(key)
    k_ref, _, k_choice = jax.random.split(key_is, 3)
    u = tt(jref.sample(k_ref, (N,)))
    _, pexact, plog_w = pmfm.sample_flow_parts(
        ptr, pparams, pref, ptarget, u, gumbel=tt(jax.random.gumbel(k_choice, (N, N))))
    np.testing.assert_allclose(npy(pexact), np.asarray(exact), atol=1e-4)
    np.testing.assert_allclose(npy(plog_w), np.asarray(log_w), rtol=1e-4, atol=1e-4)
    pmoved = pmfm.mala_move_correct(pexact, ptarget, _moves(key_moves, 6), init_step=0.5)
    np.testing.assert_allclose(npy(pmoved), np.asarray(moved), rtol=1e-4, atol=1e-4)

    # the port's own entry draws from a generator: same shapes, the middle
    # set is the IS-resampled one and the moves move it
    prun = types.SimpleNamespace(transport=ptr, train=types.SimpleNamespace(params=pparams),
                                 ref_dist=pref)
    m, e, lw = pmfm.sample_flow_move(prun, N, ptarget, torch.Generator().manual_seed(0),
                                     n_moves=4, init_step=0.5)
    assert m.shape == e.shape == (N, 2) and lw.shape == (N,)
    assert torch.unique(m, dim=0).shape[0] > torch.unique(e, dim=0).shape[0]


@pytest.mark.parametrize("alpha", [0.9, 0.75])
def test_sample_flow_defensive_parts_matches_reference(alpha):
    jtr, jparams, ptr, pparams = _flows()
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    jref, pref = jt.IndepGaussian(2, var=25.0), pt.IndepGaussian(2, var=25.0)
    jdef, pdef = jt.IndepGaussian(2, var=4.0), pt.IndepGaussian(2, var=4.0)
    key = jax.random.PRNGKey(4)
    x, exact, log_w = jmfm.sample_flow_defensive_parts(jtr, jparams, jref, key, N, jtarget,
                                                       jdef, alpha=alpha)
    n_flow, n_def = pmfm.defensive_split(N, alpha)
    assert n_def == int(round((1 - alpha) * N)) > 0
    k_ref, _, k_def, _, k_choice = jax.random.split(key, 5)
    px, pexact, plog_w = pmfm.sample_flow_defensive_parts(
        ptr, pparams, pref, ptarget, tt(jref.sample(k_ref, (n_flow,))),
        tt(jdef.sample(k_def, (n_def,))), pdef,
        gumbel=tt(jax.random.gumbel(k_choice, (N, N))))
    np.testing.assert_allclose(npy(px), np.asarray(x), atol=1e-4)
    np.testing.assert_allclose(npy(plog_w), np.asarray(log_w), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(npy(pexact), np.asarray(exact), atol=1e-4)


def test_defensive_divergences_raise():
    """ADVICE.md round 5, kept out of the port: a reference whose log_prob
    is not normalised (flat; a prior not declared normalised) and a split
    that leaves no flow draw are refused; the Gaussian references, the
    phi^4 base (it carries its log-determinant) and the Cox prior (its
    log_prior carries its normaliser) run."""
    for ref in (pt.FlatDistribution(2), pt.PriorReference(_NoNormPrior())):
        with pytest.raises(ValueError, match="normalised"):
            pmfm.check_normalised(ref)
    for ref in (pt.IndepGaussian(2), pt.PhiFourBase(8), pt.four_mode_mixture(),
                pt.PriorReference(pt.LogGaussianCoxPines(1600))):
        pmfm.check_normalised(ref)
    # PhiFourBase.log_prob integrates to 1: the Gaussian with its precision's
    # log-determinant, checked on a 2-site lattice by quadrature
    base = pt.PhiFourBase(2)
    g = torch.linspace(-3, 3, 601, dtype=torch.float64)
    xx, yy = torch.meshgrid(g, g, indexing="ij")
    lp = base.log_prob(torch.stack([xx, yy], -1).reshape(-1, 2).float()).double()
    assert abs(float(torch.exp(lp).sum()) * float(g[1] - g[0]) ** 2 - 1.0) < 1e-3
    with pytest.raises(ValueError, match="n_flow < 1"):
        pmfm.defensive_split(100, 0.004)
    with pytest.raises(ValueError, match=r"\(0, 1\]"):
        pmfm.defensive_split(100, 0.0)
    assert pmfm.defensive_split(100, 1.0) == (100, 0)
    assert pmfm.defensive_split(100, 0.006) == (1, 99)


class _NoNormPrior(pt.IndepGaussian):
    """A target with a prior sampler that does not declare its prior
    normalised."""

    def __init__(self):
        super().__init__(2)

    def prior_sample(self, generator, shape=()):
        return self.sample(generator, shape)


TINY = ["--device", "cpu", "--seed", "0", "--learning-iter", "8", "--num-chain", "8",
        "--ode-steps", "2", "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)",
        "--set", "hidden_xt=(8,)", "--set", "fourier_dim=4", "--set", "eval_iter=4"]


@pytest.mark.parametrize("extra,keys", [
    (["--do-fab"], ("final_loss", "mean_accept", "log_z_alpha2", "log_z_is", "is_ess_frac")),
    (["--do-flowmc"], ("mean_accept", "log_z_is", "is_ess_frac")),
    (["--do-dds"], ("final_loss", "log_z_is", "is_ess_frac")),
    (["--move-correct", "10"], ()),
    (["--defensive-alpha", "0.9"], ("defensive_n_flow",)),
    (["--flow-smc", "2", "--move-correct", "10"], ("flow_smc_log_z",)),
], ids=["fab", "flowmc", "dds", "move", "defensive", "flow-smc-move"])
def test_cli_rows(extra, keys):
    from mfm_tpu_torch import cli

    (m,) = cli.main(["--example", "4-mode", *TINY, *extra])
    row = [m[k] for k in ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star",
                          "stein_v_star", "mmd_star", "train_time", "is_ess")]
    assert all(math.isfinite(v) for v in row), row
    assert all(k in m and math.isfinite(m[k]) for k in keys)
    if extra[0] == "--defensive-alpha":
        assert m["defensive_n_flow"] == 29  # 32 - round(0.1 * 32)


def test_cli_defensive_row_is_the_flow_share(monkeypatch):
    """The non-star row under --defensive-alpha is computed on the flow's
    draws only (the reference computes it on the whole mixture)."""
    from mfm_tpu_torch import cli

    seen = {}
    real = cli.evaluate_samples

    def spy(target, flow, exact, real_samples=None, **kw):
        seen["flow"], seen["exact"] = flow.shape[0], exact.shape[0]
        return real(target, flow, exact, real_samples, **kw)

    monkeypatch.setattr(cli, "evaluate_samples", spy)
    cli.main(["--example", "4-mode", *TINY, "--defensive-alpha", "0.75"])
    assert seen == {"flow": 24, "exact": 32}


@pytest.mark.parametrize("argv,match", [
    (["--defensive-alpha", "0.9", "--flow-smc", "2"], "defensive-alpha"),
    (["--defensive-alpha", "0.9", "--move-correct", "5"], "defensive-alpha"),
    (["--defensive-alpha", "0.9", "--do-smc"], "defensive-alpha"),
    (["--defensive-alpha", "0.9", "--do-flowmc"], "defensive-alpha"),
    (["--defensive-alpha", "0.001", "--num-chain", "8", "--set", "eval_iter=4"], "n_flow < 1"),
    (["--defensive-alpha", "1.5"], r"\(0, 1\]"),
    (["--defensive-alpha", "0.9", "--set", "ref_dist=flat"], "normalised"),
    (["--flow-smc", "2", "--do-fab"], "flow-smc"),
    (["--vmap-seeds", "--check"], "--check"),
    (["--vmap-seeds", "--defensive-alpha", "0.9"], "defensive-alpha"),
    (["--vmap-seeds", "--full-metrics"], "full-metrics"),
    (["--vmap-seeds", "--move-correct", "5"], "move-correct"),
    (["--vmap-seeds", "--flow-smc", "2"], "flow-smc"),
    (["--vmap-seeds", "--do-dds"], "do-dds"),
], ids=["flow-smc", "move", "smc", "flowmc", "no-flow-draw", "range", "flat", "flow-smc-fab",
        "vmap-check", "vmap-defensive", "vmap-full-metrics", "vmap-move", "vmap-flow-smc",
        "vmap-dds"])
def test_cli_refuses_conflicts(argv, match):
    from mfm_tpu_torch import cli

    with pytest.raises(SystemExit, match=match):
        cli.main(["--example", "4-mode", "--device", "cpu", *argv])
