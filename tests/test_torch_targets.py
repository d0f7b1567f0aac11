"""Port parity: targets (mfm_tpu_torch.targets vs mfm_tpu.targets).

Tolerances: float32 on both sides, same formulas, elementwise with short
reductions -> rtol 1e-5 (atol 1e-5 where values cross zero). Scores come
from autodiff on both sides (jax.grad vs torch.func.grad).
"""

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
    with pytest.raises(NotImplementedError, match="not ported"):
        pt.make_ref_dist("phifour", 3)
