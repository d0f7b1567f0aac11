"""Port parity: targets (mfm_tpu_torch.targets vs mfm_tpu.targets).

Tolerances: float32 on both sides, same formulas, elementwise with short
reductions -> rtol 1e-5 (atol 1e-5 where values cross zero). Scores come
from autodiff on both sides (jax.grad vs torch.func.grad).

The funnel and many-well samplers take the reference's own noise. The
many-well x1 is an inverse CDF from an 8193-point fp32 table: where the
density is low a cell's CDF step is a few ulps, so x1 follows the table's
last bits, and the two packages' tables differ there by an exp
implementation (2e-7 of the CDF). So: on the reference's table the port's
x1 is held to 1e-5 absolute for every draw; on its own table, to 8 cells
of 7 / 8192 for every draw (between the wells a cell is worth 7e-8 of the
CDF) and to 1e-5 for all but 1 in 200.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from torch_parity import npy, tt

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-5


def _pairs():
    return [
        ("4-mode", jt.four_mode_mixture(), pt.four_mode_mixture(), 2, 4.0),
        ("16-mode", jt.random_mixture(), pt.random_mixture(), 2, 6.0),
        ("phi4-dirichlet", jt.PhiFour(8), pt.PhiFour(8), 8, 1.0),
        ("phi4-pbc-tilt",
         jt.PhiFour(8, bc=("pbc", 0.0), tilt={"val": 0.3, "lambda": 2.0}),
         pt.PhiFour(8, bc=("pbc", 0.0), tilt={"val": 0.3, "lambda": 2.0}), 8, 1.0),
        ("stdgauss", jt.IndepGaussian(3), pt.IndepGaussian(3), 3, 1.0),
        ("widegauss", jt.IndepGaussian(3, var=5.0), pt.IndepGaussian(3, var=5.0), 3, 2.0),
        ("bimodal", jt.GaussianMixture(), pt.bimodal_mixture(), 2, 3.0),
        ("flat", jt.FlatDistribution(3), pt.FlatDistribution(3), 3, 1.0),
        ("funnel", jt.Funnel(10), pt.Funnel(10), 10, 1.0),
        ("funnel-4", jt.Funnel(4, sigma_v=2.0), pt.Funnel(4, sigma_v=2.0), 4, 1.5),
        ("many-well", jt.ManyWell(32), pt.ManyWell(32), 32, 1.2),
        ("many-well-4", jt.ManyWell(4), pt.ManyWell(4), 4, 1.7),
        ("geometric-4-mode", jt.GeometricPath(jt.four_mode_mixture()),
         pt.GeometricPath(pt.four_mode_mixture()), 2, 4.0),
    ]


@pytest.mark.parametrize("case", _pairs(), ids=lambda c: c[0])
def test_log_prob_score_tempered(case):
    _, jtarget, ptarget, d, scale = case
    x = scale * np.random.default_rng(0).standard_normal((16, d)).astype(np.float32)
    np.testing.assert_allclose(
        npy(ptarget.log_prob(tt(x))), np.asarray(jtarget.log_prob(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL,
    )
    np.testing.assert_allclose(
        npy(ptarget.score(tt(x))), np.asarray(jtarget.score(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL,
    )
    beta = 0.37
    jv, jg = jtarget.tempered_value_and_score(jnp.asarray(x), beta)
    pv, pg = ptarget.tempered_value_and_score(tt(x), torch.tensor(beta))
    np.testing.assert_allclose(npy(pv), np.asarray(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(pg), np.asarray(jg), rtol=RTOL, atol=ATOL)
    v, g = ptarget.value_and_score(tt(x))
    np.testing.assert_allclose(npy(v), npy(ptarget.log_prob(tt(x))), rtol=RTOL)
    np.testing.assert_allclose(npy(g), npy(ptarget.score(tt(x))), rtol=RTOL)


def test_random_mixture_table_matches_jax_draw():
    """The tabled 16-mode mixture is exactly what PRNGKey(0) draws."""
    j, p = jt.random_mixture(), pt.random_mixture()
    for name in ("modes", "covs", "weights"):
        np.testing.assert_array_equal(npy(getattr(p, name)), np.asarray(getattr(j, name)))


def test_samplers_and_init_positions():
    """Exact samplers draw from the same law (moments), init ranges match."""
    gen = torch.Generator().manual_seed(0)
    s = pt.four_mode_mixture().sample(gen, (20000,))
    assert s.shape == (20000, 2)
    np.testing.assert_allclose(npy(s.abs().mean(0)), [8.0, 8.0], atol=0.1)
    np.testing.assert_allclose(npy(s.std(0)), [np.sqrt(65.0)] * 2, atol=0.1)
    g = pt.IndepGaussian(3, var=5.0).sample(gen, (20000,))
    np.testing.assert_allclose(npy(g.var(0)), [5.0] * 3, rtol=0.05)
    init = pt.PhiFour(8).init_positions(gen, 64)
    assert init.shape == (64, 8) and float(init.min()) >= -1 and float(init.max()) <= 1
    assert pt.four_mode_mixture().can_sample and not pt.PhiFour(8).can_sample


def test_make_ref_dist():
    assert isinstance(pt.make_ref_dist("stdgauss", 3), pt.IndepGaussian)
    # 'prior' wraps the run's target, which (dim, device) cannot give
    with pytest.raises(ValueError, match="PriorReference"):
        pt.make_ref_dist("prior", 3)
    with pytest.raises(ValueError, match="unknown reference"):
        pt.make_ref_dist("no-such", 3)
    with pytest.raises(NotImplementedError, match="no prior sampler"):
        pt.PriorReference(pt.four_mode_mixture())
    with pytest.raises(ValueError, match="even"):
        pt.ManyWell(5)
    with pytest.raises(ValueError, match="perfect square"):
        pt.LogGaussianCoxPines(10)


@pytest.mark.parametrize("beta", [0.0, 0.3, 1.0])
def test_geometric_path_over_a_mixture(beta):
    """The bridge N(0, I)^(1 - beta) p^beta: tempered value and score, the
    re-split lik/prior, and what passes through to the wrapped target."""
    j, p = jt.GeometricPath(jt.four_mode_mixture()), pt.GeometricPath(pt.four_mode_mixture())
    x = 5.0 * np.random.default_rng(3).standard_normal((16, 2)).astype(np.float32)
    jv, jg = j.tempered_value_and_score(jnp.asarray(x), beta)
    pv, pg = p.tempered_value_and_score(tt(x), torch.tensor(beta))
    np.testing.assert_allclose(npy(pv), np.asarray(jv), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(npy(pg), np.asarray(jg), rtol=RTOL, atol=ATOL)
    for name in ("log_lik", "log_prior", "log_prob"):
        np.testing.assert_allclose(
            npy(getattr(p, name)(tt(x))), np.asarray(getattr(j, name)(jnp.asarray(x))),
            rtol=RTOL, atol=ATOL, err_msg=name,
        )
    assert p.can_sample and p.dim == 2
    gen = torch.Generator().manual_seed(0)
    assert p.sample(gen, (5,)).shape == (5, 2)
    init = p.init_positions(gen, 4000)  # N(0, I), not the mixture's own start
    np.testing.assert_allclose(npy(init.std(0)), [1.0, 1.0], atol=0.05)


def test_funnel_sampler_with_the_reference_noise():
    j, p = jt.Funnel(10), pt.Funnel(10)
    key = jax.random.PRNGKey(8)
    key_v, key_x = jax.random.split(key)  # the reference's split
    ref = j.sample(key, (500,))
    got = p.sample_from_noise(
        tt(jax.random.normal(key_v, (500, 1))), tt(jax.random.normal(key_x, (500, 9)))
    )
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    own = p.sample(torch.Generator().manual_seed(0), (20000,))
    assert own.shape == (20000, 10) and p.can_sample
    np.testing.assert_allclose(float(own[:, -1].std()), 3.0, rtol=0.05)


def test_many_well_sampler_with_the_reference_noise():
    j, p = jt.ManyWell(32), pt.ManyWell(32)
    n = 4000
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)  # the reference's split
    u, z = tt(jax.random.uniform(k1, (n, 16))), tt(jax.random.normal(k2, (n, 16)))
    ref = np.asarray(j.sample(key, (n,)))
    jgrid, jcdf = j._x1_cdf_grid()
    pgrid, pcdf = p._x1_cdf_grid()
    np.testing.assert_array_equal(npy(pgrid), np.asarray(jgrid))
    np.testing.assert_allclose(npy(pcdf), np.asarray(jcdf), atol=5e-7)
    on_ref_table = p.sample_from_noise(u, z, table=(tt(jgrid), tt(jcdf)))
    np.testing.assert_allclose(npy(on_ref_table), ref, atol=1e-5)
    diff = np.abs(npy(p.sample_from_noise(u, z)) - ref)
    assert diff.max() <= 8 * 7.0 / 8192 and np.mean(diff > 1e-5) < 0.005
    own = p.sample(torch.Generator().manual_seed(0), (n,))
    assert own.shape == (n, 32)
    x1 = npy(own).reshape(n, 16, 2)[..., 0]
    assert 1.5 < np.abs(x1).mean() < 1.9 and 0.55 < np.mean(x1 > 0) < 0.95  # both wells
