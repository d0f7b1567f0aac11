"""Port parity: the log-Gaussian Cox target on the pines data
(mfm_tpu_torch.targets.cox against mfm_tpu.targets.cox), both
parameterisations.

The host construction is the same float64 numpy code, so the fp32 arrays
must be equal bit for bit. Densities are fp32 sums of d terms and one
(d, d) product on both sides: values to rtol 1e-5 (1e-4 at d = 1600, where
the quadratic form adds 2.6e6 products of large entries of both signs),
scores to 1e-4 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

from mfm_tpu.targets.cox import _DATA_PATH as J_DATA
from mfm_tpu.targets.cox import LogGaussianCoxPines as JCox
from mfm_tpu_torch.targets.base import PriorReference
from mfm_tpu_torch.targets.cox import _DATA_PATH as P_DATA
from mfm_tpu_torch.targets.cox import LogGaussianCoxPines as PCox
from mfm_tpu_torch.utils.convert import COX_ARRAYS, COX_SCALARS, cox_state_from_reference
from torch_parity import npy, tt

torch.set_num_threads(1)

CASES = [(16, False), (16, True), (64, False), (64, True)]
_built = {}


def _pair(dim, whitened):
    if (dim, whitened) not in _built:
        _built[dim, whitened] = JCox(dim, whitened=whitened), PCox(dim, whitened=whitened)
    return _built[dim, whitened]


def _points(dim, whitened, n=12, seed=0):
    """Points where a chain lives: near the prior mean in the latent
    parameterisation, near 0 in the whitened one."""
    z = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return 0.7 * z if whitened else 0.7 * z + np.float32(np.log(126.0) - 0.955)


def _state(j):
    out = {n: np.asarray(getattr(j, n)) for n in COX_ARRAYS}
    out.update({n: getattr(j, n) for n in COX_SCALARS})
    return out


def _close_scores(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(npy(got), ref, rtol=0, atol=rel * np.abs(ref).max())


def test_data_file_is_a_byte_copy():
    with open(J_DATA, "rb") as a, open(P_DATA, "rb") as b:
        assert a.read() == b.read()
    assert "mfm_tpu_torch" in P_DATA


@pytest.mark.parametrize("dim,whitened", CASES)
def test_host_matrices_are_bit_equal(dim, whitened):
    j, p = _pair(dim, whitened)
    diffs = cox_state_from_reference(p, _state(j))
    assert set(diffs) == set(COX_ARRAYS + COX_SCALARS)
    assert all(v == 0.0 for v in diffs.values()), diffs
    assert p._chol.dtype == torch.float32 and p._prec.shape == (dim, dim)


@pytest.mark.parametrize("dim,whitened", CASES)
def test_densities_match(dim, whitened):
    j, p = _pair(dim, whitened)
    x = _points(dim, whitened)
    jx, px = jnp.asarray(x), tt(x)
    for name in ("log_lik", "log_prior", "log_prob"):
        np.testing.assert_allclose(
            npy(getattr(p, name)(px)), np.asarray(getattr(j, name)(jx)), rtol=1e-5, err_msg=name
        )
    # a single point (d,) as well as a batch
    np.testing.assert_allclose(float(p.log_prob(px[0])), float(j.log_prob(jx[0])), rtol=1e-5)
    np.testing.assert_allclose(npy(p._whiten(px)), np.asarray(j._whiten(jx)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(npy(p._whiten(px[0])), np.asarray(j._whiten(jx[0])), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(npy(p._unwhiten(px)), np.asarray(j._unwhiten(jx)), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("beta", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("dim,whitened", CASES)
def test_tempered_value_and_score_match(dim, whitened, beta):
    j, p = _pair(dim, whitened)
    x = _points(dim, whitened, seed=1)
    jv, jg = j.tempered_value_and_score(jnp.asarray(x), beta)
    pv, pg = p.tempered_value_and_score(tt(x), torch.tensor(beta))
    np.testing.assert_allclose(npy(pv), np.asarray(jv), rtol=1e-5)
    _close_scores(pg, jg)
    if beta == 1.0:
        _close_scores(p.score(tt(x)), j.score(jnp.asarray(x)))
        v, g = p.value_and_score(tt(x))
        np.testing.assert_allclose(npy(v), npy(p.log_prob(tt(x))), rtol=1e-5)
        np.testing.assert_array_equal(npy(g), npy(p.score(tt(x))))


@pytest.mark.parametrize("dim,whitened", CASES)
def test_analytic_score_is_the_gradient_of_log_prob(dim, whitened):
    """Against torch.func.grad of the solve-free density written beside it."""
    _, p = _pair(dim, whitened)
    x = tt(_points(dim, whitened, seed=2))
    auto = grad(lambda v: p.log_prob(v).sum())(x)
    _close_scores(p.score(x), npy(auto))
    # and of the tempered density
    beta = torch.tensor(0.4)
    auto = grad(lambda v: p.tempered_log_prob(v, beta).sum())(x)
    _close_scores(p.tempered_value_and_score(x, beta)[1], npy(auto))


@pytest.mark.parametrize("dim,whitened", CASES)
def test_score_tangents_match_jax_jvp(dim, whitened):
    """What the transport's score gate needs: jvp and vmap(jvp) of score."""
    j, p = _pair(dim, whitened)
    x = _points(dim, whitened, seed=3)
    e = np.random.default_rng(4).standard_normal((3,) + x.shape).astype(np.float32)
    ref = jax.vmap(lambda t: jax.jvp(j.score, (jnp.asarray(x),), (t,))[1])(jnp.asarray(e))
    one = jvp(p.score, (tt(x),), (tt(e[0]),))[1]
    many = vmap(lambda t: jvp(p.score, (tt(x),), (t,))[1])(tt(e))
    _close_scores(one, ref[0])
    _close_scores(many, ref)


@pytest.mark.parametrize("dim,whitened", CASES)
def test_prior_sample_and_reference(dim, whitened):
    """prior_sample from the reference's own normals; PriorReference over
    the target: log_prob, sample and gaussian_mean."""
    from mfm_tpu.targets.base import PriorReference as JPrior

    j, p = _pair(dim, whitened)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, (7, dim))
    draw = j.prior_sample(key, (7,))
    np.testing.assert_allclose(npy(p.prior_from_noise(tt(eps))), np.asarray(draw), rtol=1e-5,
                               atol=1e-5)
    own = p.prior_sample(torch.Generator().manual_seed(0), (5,))
    assert own.shape == (5, dim) and p.init_positions(torch.Generator(), 3).shape == (3, dim)
    jref, pref = JPrior(j), PriorReference(p)
    np.testing.assert_allclose(npy(pref.log_prob(tt(draw))), np.asarray(jref.log_prob(draw)),
                               rtol=1e-5)
    assert pref.gaussian_mean == jref.gaussian_mean == p.prior_gaussian_mean
    assert pref.sample(torch.Generator().manual_seed(1), (4,)).shape == (4, dim)
    assert pref.dim == dim and pref.can_sample and not p.can_sample


def test_full_size_matrices_value_and_score():
    """d = 1600, the size the pines example runs at."""
    j, p = JCox(1600), PCox(1600)
    diffs = cox_state_from_reference(p, _state(j))
    assert all(v == 0.0 for v in diffs.values()), diffs
    x = _points(1600, False, n=4, seed=6)
    jv, jg = j.value_and_score(jnp.asarray(x))
    pv, pg = p.value_and_score(tt(x))
    np.testing.assert_allclose(npy(pv), np.asarray(jv), rtol=1e-4)
    _close_scores(pg, jg)


def test_state_can_be_loaded_from_the_reference():
    """``load=True`` replaces the port's arrays by the given ones."""
    j, _ = _pair(16, False)
    p = PCox(16)
    state = _state(j)
    state["_counts"] = state["_counts"] + 1.0
    diffs = cox_state_from_reference(p, state, load=True)
    assert diffs["_counts"] == 1.0 and diffs["_chol"] == 0.0
    np.testing.assert_array_equal(npy(p._counts), state["_counts"])
    with pytest.raises(ValueError, match="shape"):
        cox_state_from_reference(PCox(64), state)


def test_overflow_is_left_to_reject():
    """exp(f) overflows for a chain far out: the value is -inf or nan, not
    clamped (the MH accept rejects it)."""
    _, p = _pair(16, False)
    v, g = p.value_and_score(torch.full((1, 16), 100.0))
    assert not bool(torch.isfinite(v).any()) and not bool(torch.isfinite(g).all())
