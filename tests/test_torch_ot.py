"""Port parity: the minibatch optimal-transport coupling of the
conditional flow-matching loss (flows.losses: ``sinkhorn_plan``,
``ot_pair``, ``cond_fm_sample`` with ``ot_u``) against mfm_tpu's.

The plan is 50 log-domain Sinkhorn sweeps in fp32 on both sides: 1e-5 of
its largest entry. ``jax.random.choice(key, B*B, (B,), p=p)`` is the
inverse CDF of p at ``1 - uniform(key, (B,))``; the port takes those
uniforms, so the chosen pairs must be the same indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.flows.losses import flow_matching_loss as j_loss
from mfm_tpu.flows.losses import ot_pair as j_ot_pair
from mfm_tpu.flows.losses import sinkhorn_plan as j_sinkhorn
from mfm_tpu_torch.flows import cond_fm_sample, flow_matching_loss, ot_pair, sinkhorn_plan
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

D, W, F, B = 4, 16, 8, 32


def _clouds(seed, d=D, n=B):
    rng = np.random.default_rng(seed)
    x1 = (rng.standard_normal((n, d)) * 0.7 + rng.choice([-2.0, 2.0], (n, 1))).astype(np.float32)
    return x1, rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("n,epsilon", [(32, None), (17, None), (32, 4.0)])
def test_sinkhorn_plan_matches(n, epsilon):
    x1, x0 = _clouds(0, n=n)
    cost = ((x1[:, None, :] - x0[None, :, :]) ** 2).sum(-1)
    ref = np.asarray(j_sinkhorn(jnp.asarray(cost), epsilon=epsilon))
    got = npy(sinkhorn_plan(tt(cost), epsilon=epsilon))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * ref.max())
    # the last sweep fixes the columns; the rows have converged to 1e-2 of 1/n
    np.testing.assert_allclose(got.sum(0), np.full(n, 1.0 / n), rtol=1e-5)
    np.testing.assert_allclose(got.sum(1), np.full(n, 1.0 / n), rtol=1e-2)
    assert got.min() >= 0.0


def test_ot_pair_picks_the_same_pairs():
    x1, x0 = _clouds(1)
    key = jax.random.PRNGKey(2)
    j1, j0 = j_ot_pair(key, jnp.asarray(x1), jnp.asarray(x0))
    p1, p0 = ot_pair(tt(x1), tt(x0), tt(jax.random.uniform(key, (B,))))
    np.testing.assert_array_equal(npy(p1), np.asarray(j1))
    np.testing.assert_array_equal(npy(p0), np.asarray(j0))
    # the coupling shortens the pairs: that is what it is for
    assert float(((p1 - p0) ** 2).sum(-1).mean()) < float(((x1 - x0) ** 2).sum(-1).mean())


@pytest.mark.parametrize("conditional", [True, False])
def test_loss_with_ot_coupling_matches(conditional):
    """ot_coupling makes the path conditional whatever ``conditional`` says."""
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), D, W, F, "relu", jtarget.score)
    net_p, pparams = torch_field(params, freqs, D, W, "relu", ptarget.score)
    samples = np.random.default_rng(3).uniform(-1, 1, (B, D)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jt.IndepGaussian(D)
    jl, jg = jax.value_and_grad(
        lambda p: j_loss(p, net_j.apply, key, jnp.asarray(samples), 1e-4,
                         ref_sampler=ref.sample, conditional=conditional, ot_coupling=True)
    )(params)
    k_t, k_ref, k_eps, k_ot = jax.random.split(key, 4)
    batch = cond_fm_sample(
        tt(samples), tt(jax.random.uniform(k_t, (B,))), tt(ref.sample(k_ref, (B,))),
        tt(jax.random.normal(k_eps, (B, D))), 1e-4, ot_u=tt(jax.random.uniform(k_ot, (B,))),
    )
    pg, pl = grad_and_value(
        lambda p: flow_matching_loss(lambda x, t: functional_call(net_p, p, (x, t)), batch)
    )(pparams)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, jg)).items():
        r = npy(v)
        np.testing.assert_allclose(npy(pg[k]), r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(r).max())), err_msg=k)
