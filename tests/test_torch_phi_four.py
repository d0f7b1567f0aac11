"""Port parity: kernel K3's plain version (ops.phi_four), the K3-backed
PhiFour target with its analytic derivatives, PhiFourBase and the
reference registry, against mfm_tpu.

K3's plain version is held to ``mfm_tpu.ops.phi_four_log_lik``, the Pallas
kernel itself (interpret mode off a TPU, as tests/test_ops_pallas.py runs
it); the target's score and its derivatives to autodiff of the reference
target (jax.grad, jax.jvp, jax.hessian).

Tolerances: rtol 1e-5 on values and scores -- fp32 on both sides, the same
stencil summed in another order (values are O(1e3), so atol is 1e-3 where
a score entry can cross zero). Derivatives (H e) to 1e-5 relative to their
largest entry: the port's is analytic, the reference's autodiff, both fp32.
PhiFourBase to rtol 1e-5, with an atol of 1e-6 of its normalising
constant: the port builds the precision and its log-determinant in float64
and rounds once, the reference computes them in float32, and at d=64 the
log-determinant is ~380 against log-densities that cross zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacrev, jvp, vmap

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.ops import phi_four_log_lik
from mfm_tpu_torch.config import preset
from mfm_tpu_torch.ops import phi_four as K3
from torch_parity import cli_run_dir, npy, tt  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3
TILT = {"val": 0.3, "lambda": 2.0}


def _x(shape, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,d,pbc,bc_value", [
    (37, 64, False, 0.0),  # the JAX package's own test shapes
    (16, 32, True, 0.0),
    (20, 16, False, 0.5),
    (5, 1, False, -0.3),   # one site: both ends are the boundary
])
def test_plain_matches_pallas_kernel(B, d, pbc, bc_value):
    x = _x((B, d), seed=d)
    ref = phi_four_log_lik(jnp.asarray(x), pbc=pbc, bc_value=bc_value, tile=256)
    value, score = K3.phi_four_value_and_score_plain(tt(x), 0.1, 20.0, pbc, bc_value)
    np.testing.assert_allclose(npy(value), np.asarray(ref), rtol=RTOL)
    value_only, none = K3.phi_four_value_and_score(tt(x), 0.1, 20.0, pbc, bc_value, False)
    assert none is None and torch.equal(value_only, value)


def _targets(bc, tilt):
    return (jt.PhiFour(8, bc=bc, tilt=tilt), pt.PhiFour(8, bc=bc, tilt=tilt))


CASES = [
    (("dirichlet", 0.0), None),
    (("dirichlet", 0.5), TILT),
    (("pbc", 0.0), None),
    (("pbc", 0.0), TILT),
]
IDS = ["dirichlet", "dirichlet-bc-tilt", "pbc", "pbc-tilt"]


@pytest.mark.parametrize("bc,tilt", CASES, ids=IDS)
def test_value_and_score_match_reference(bc, tilt):
    jtarget, ptarget = _targets(bc, tilt)
    x = _x((16, 8), scale=1.5)
    jx = jnp.asarray(x)
    ref_v = np.asarray(jtarget.log_lik(jx))
    ref_s = np.asarray(jax.vmap(jax.grad(jtarget.log_lik))(jx))
    np.testing.assert_allclose(npy(ptarget.log_lik(tt(x))), ref_v, rtol=RTOL)
    np.testing.assert_allclose(npy(ptarget.score(tt(x))), ref_s, rtol=RTOL, atol=ATOL)
    v, s = ptarget.value_and_score(tt(x))
    np.testing.assert_allclose(npy(v), ref_v, rtol=RTOL)
    np.testing.assert_allclose(npy(s), ref_s, rtol=RTOL, atol=ATOL)
    # the tempering beta scales value and score outside; the lattice's
    # beta=20 is K3's own argument
    jv, jg = jtarget.tempered_value_and_score(jx, 0.37)
    pv, pg = ptarget.tempered_value_and_score(tt(x), torch.tensor(0.37))
    np.testing.assert_allclose(npy(pv), np.asarray(jv), rtol=RTOL)
    np.testing.assert_allclose(npy(pg), np.asarray(jg), rtol=RTOL, atol=ATOL)
    # a single row and a leading batch shape go through the same op
    np.testing.assert_allclose(npy(ptarget.score(tt(x[0]))), ref_s[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        npy(ptarget.log_lik(tt(x.reshape(2, 8, 8)))), ref_v.reshape(2, 8), rtol=RTOL
    )


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(npy(got), ref, atol=1e-5 * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("bc,tilt", CASES, ids=IDS)
def test_score_tangents_match_reference(bc, tilt):
    """The transport's vmap(jvp(score)) over the basis and over random
    tangents, and reverse mode (jacrev), against jax.jvp of the reference
    score and jax.hessian of its log-likelihood."""
    jtarget, ptarget = _targets(bc, tilt)
    x = _x((16, 8), seed=1, scale=1.5)
    basis = np.broadcast_to(np.eye(8, dtype=np.float32)[:, None, :], (8, 16, 8))
    rand = _x((5, 16, 8), seed=2)
    for ex in (basis, rand):
        ref = np.stack([
            np.asarray(jax.jvp(jtarget.score, (jnp.asarray(x),), (jnp.asarray(e),))[1])
            for e in ex
        ])
        got = vmap(lambda e: jvp(ptarget.score, (tt(x),), (e,))[1])(tt(np.array(ex)))
        _close(got, ref)
    ref_h = np.asarray(jax.vmap(jax.hessian(jtarget.log_lik))(jnp.asarray(x)))
    _close(vmap(jacrev(ptarget.score))(tt(x)), ref_h)


@pytest.mark.parametrize("bc,tilt", CASES, ids=IDS)
def test_second_derivative_through_log_lik_sees_the_hessian(bc, tilt):
    """log_lik's derivative calls the score Function, so forward over
    reverse (and reverse over reverse) through log_lik gives the Hessian.
    A backward that returned a saved score would give 0 here."""
    jtarget, ptarget = _targets(bc, tilt)
    x = _x((16, 8), seed=3, scale=1.5)
    e = _x((16, 8), seed=4)
    ref_h = np.asarray(jax.vmap(jax.hessian(jtarget.log_lik))(jnp.asarray(x)))
    ref_he = np.einsum("bij,bj->bi", ref_h, e)
    total = lambda v: ptarget.log_lik(v).sum()
    _close(jvp(grad(total), (tt(x),), (tt(e),))[1], ref_he)
    _close(vmap(hessian(ptarget.log_lik))(tt(x)), ref_h)
    _close(vmap(jacrev(jacrev(ptarget.log_lik)))(tt(x)), ref_h)
    xg = tt(x).requires_grad_()
    (g,) = torch.autograd.grad(ptarget.log_lik(xg).sum(), xg, create_graph=True)
    (he,) = torch.autograd.grad((g * tt(e)).sum(), xg)
    _close(he, ref_he)


def test_cpu_tensors_take_the_plain_version():
    target = pt.PhiFour(8)
    before = K3.phi_four_value_and_score.launches
    x = tt(_x((4, 8)))
    target.value_and_score(x)
    target.log_lik(x)
    vmap(lambda e: jvp(target.score, (x,), (e,))[1])(torch.eye(8)[:, None, :].expand(8, 4, 8))
    assert K3.phi_four_value_and_score.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        K3.phi_four_value_and_score(torch.empty(4, 8, device="meta"))


@pytest.mark.parametrize("prior_type,dim,dim_phys", [
    ("coupled", 8, 1),
    ("coupled", 64, 1),
    ("coupled_pbc", 8, 1),
    ("coupled_pbc", 4, 2),  # 2-D: a torus of dim // dim_phys sites a side
])
def test_phi_four_base_matches_reference(prior_type, dim, dim_phys):
    jbase = jt.PhiFourBase(dim, prior_type=prior_type, dim_phys=dim_phys)
    pbase = pt.PhiFourBase(dim, prior_type=prior_type, dim_phys=dim_phys)
    np.testing.assert_allclose(npy(pbase.prec), np.asarray(jbase.prec), rtol=RTOL)
    x = _x((12, dim), scale=0.1)
    norm = abs(float(jbase._neg_logdet_prec)) + dim * np.log(2 * np.pi)
    np.testing.assert_allclose(
        npy(pbase.log_prob(tt(x))), np.asarray(jbase.log_prob(jnp.asarray(x))), rtol=RTOL,
        atol=1e-6 * norm,
    )
    # the sampler with its noise injected: the port's draw is eps @ chol_cov^T
    # for the standard normals its generator gives
    draw = pbase.sample(torch.Generator().manual_seed(5), (7,))
    eps = torch.randn((7, dim), generator=torch.Generator().manual_seed(5))
    ref = jnp.einsum("ij,...j->...i", jbase.chol_cov, jnp.asarray(npy(eps)),
                     precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(npy(draw), np.asarray(ref), rtol=1e-4, atol=1e-6)
    # and the draws have the model's covariance
    big = pbase.sample(torch.Generator().manual_seed(6), (20000,)).double()
    cov = npy(big.T @ big / big.shape[0])
    np.testing.assert_allclose(cov, np.linalg.inv(np.asarray(jbase.prec, np.float64)),
                               atol=0.05 * float(np.abs(cov).max()))


def test_make_ref_dist_builds_every_ported_reference():
    assert isinstance(pt.make_ref_dist("phifour", 8), pt.PhiFourBase)
    assert isinstance(pt.make_ref_dist("flat", 3), pt.FlatDistribution)
    assert pt.make_ref_dist("bimodal", 2).n_modes == 2
    assert pt.make_ref_dist("phifour", 8).can_sample
    assert not pt.make_ref_dist("flat", 3).can_sample
    with pytest.raises(ValueError, match="unknown"):
        pt.make_ref_dist("nope", 3)


TINY = ["--device", "cpu", "--seed", "0", "--learning-iter", "12", "--num-chain", "8",
        "--ode-steps", "2", "--chunk-size", "6", "--set", "hidden_x=(8,)",
        "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)", "--set", "fourier_dim=4"]


@pytest.mark.parametrize("extra", [[], ["--ref-dist", "phifour"]], ids=["shipped", "phifour-ref"])
def test_cli_runs_phi_four_as_shipped(extra):
    """The phi-four preset with no --set: the bf16 field, PhiFour on K3's
    plain version; and with the phifour reference."""
    from mfm_tpu_torch import cli

    assert preset("phi-four").field_precision == "default"
    (m,) = cli.main(["--example", "phi-four", *TINY, *extra])
    assert all(np.isfinite(m[k]) for k in ("logpdf", "stein_u", "stein_v", "logpdf_star",
                                            "train_time"))
    assert 1.0 <= m["is_ess"] <= 8 + 1e-3
