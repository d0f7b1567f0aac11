"""Port parity: flow-matching losses and gradients (flows.losses) and the
hand-written AdamW (flows.train) against mfm_tpu's.

Noise is replayed from JAX's keys (losses.py:97-102). Tolerances: the loss
is a sum of B*d squared residuals in fp32 -> rtol 1e-5; gradients are sums
over the batch of products -> 1e-4 relative to the largest entry; AdamW
parameters after several steps (updates clipped at 1e-3 * lr scale) ->
atol 1e-6.
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
from mfm_tpu.flows.train import make_lr_schedule as j_schedule
from mfm_tpu.flows.train import make_optimizer as j_optimizer
from mfm_tpu_torch.flows import cond_fm_sample, flow_matching_loss, fm_sample
from mfm_tpu_torch.flows.train import (
    AdamWFiniteState,
    adamw_finite,
    decay_mask,
    make_lr_schedule,
)
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

D, W, F, B = 4, 16, 8, 32


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close_dict(port: dict, ref: dict, rel=1e-4):
    for k, v in ref.items():
        r = npy(v)
        np.testing.assert_allclose(
            npy(port[k]), r, rtol=rel, atol=rel * max(1.0, float(np.abs(r).max())), err_msg=k
        )


@pytest.mark.parametrize("conditional", [True, False])
def test_loss_and_grads_match(conditional):
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), D, W, F, "relu", jtarget.score)
    net_p, pparams = torch_field(params, freqs, D, W, "relu", ptarget.score)
    samples = np.random.default_rng(0).uniform(-1, 1, (B, D)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = jt.IndepGaussian(D)
    jl, jg = jax.value_and_grad(
        lambda p: j_loss(p, net_j.apply, key, jnp.asarray(samples), 1e-4,
                         ref_sampler=ref.sample, conditional=conditional)
    )(params)
    if conditional:
        k_t, k_ref, k_eps, _ = jax.random.split(key, 4)
        batch = cond_fm_sample(
            tt(samples), tt(jax.random.uniform(k_t, (B,))), tt(ref.sample(k_ref, (B,))),
            tt(jax.random.normal(k_eps, (B, D))), 1e-4,
        )
    else:
        k_t, k_eps = jax.random.split(key)
        batch = fm_sample(
            tt(samples), tt(jax.random.uniform(k_t, (B,))),
            tt(jax.random.normal(k_eps, (B, D))), 1e-4,
        )
    pg, pl = grad_and_value(
        lambda p: flow_matching_loss(lambda x, t: functional_call(net_p, p, (x, t)), batch)
    )(pparams)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _assert_close_dict(pg, params_from_flax(_tree_np(jg)))


def test_lr_schedule_and_decay_mask():
    for warm in (0, 3):
        js, ps = j_schedule(20, warm, 1e-3), make_lr_schedule(20, warm, 1e-3)
        for c in range(0, 25):
            np.testing.assert_allclose(
                float(ps(torch.tensor(c, dtype=torch.int32))), float(js(c)), rtol=1e-6, atol=1e-12
            )
    mask = decay_mask({"x_trunk.0.weight": 0, "x_trunk.0.bias": 0, "ln.scale": 0})
    assert mask == {"x_trunk.0.weight": True, "x_trunk.0.bias": False, "ln.scale": False}


@pytest.mark.parametrize("patience", [10, 1])
def test_adamw_finite_matches_over_steps(patience):
    """Six steps; steps 3 and 4 carry a NaN gradient (skipped, counted; with
    patience 1 the second one poisons the update)."""
    _, params, freqs = flax_field(jax.random.PRNGKey(2), D, W, F)
    _, pparams = torch_field(params, freqs, D, W)
    lr_j, lr_p = j_schedule(10, 2, 1e-2), make_lr_schedule(10, 2, 1e-2)
    tx_j = j_optimizer(lr_j, nonfinite_patience=patience, gradient_clip=1e-3)
    tx_p = adamw_finite(lr_p, nonfinite_patience=patience, gradient_clip=1e-3)
    sj, sp = tx_j.init(params), tx_p.init(pparams)
    rng = np.random.default_rng(3)
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params
        )
        if step in (3, 4):
            grads["params"]["x_trunk"]["Dense_1"]["bias"] = (
                grads["params"]["x_trunk"]["Dense_1"]["bias"].at[0].set(jnp.nan)
            )
        uj, sj = tx_j.update(grads, sj, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, uj)
        up, sp = tx_p.update(params_from_flax(_tree_np(grads)), sp, pparams)
        pparams = {k: v + up[k] for k, v in pparams.items()}
        assert int(sp.count) == int(sj.count)
        assert int(sp.notfinite_count) == int(sj.notfinite_count)
        ref = params_from_flax(_tree_np(params))
        for k, v in ref.items():
            np.testing.assert_allclose(npy(pparams[k]), npy(v), atol=1e-6, err_msg=f"{step} {k}")
        _assert_close_dict(sp.mu, params_from_flax(_tree_np(sj.mu)))
        _assert_close_dict(sp.nu, params_from_flax(_tree_np(sj.nu)))
    assert isinstance(sp, AdamWFiniteState)
    poisoned = any(bool(torch.isnan(v).any()) for v in pparams.values())
    assert poisoned == (patience == 1)
