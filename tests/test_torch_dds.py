"""DDS (``mfm_tpu_torch.drivers.dds``) against ``mfm_tpu.drivers.dds``:
the schedule, one step, a rollout and the loss under the reference's
replayed draws (its closures reached through
``torch_parity.capture_chunked_scan``), the checkpointed gradient against
the plain one, two training iterations, the reference's invariants, and a
gradient step on phi-four, whose score the net takes on a detached input
(never through the forward-only fused score gate).

Tolerances: one step and a rollout 1e-5 relative to the largest entry;
the loss and its gradient 1e-4 (a backward pass through every step); two
iterations 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

import mfm_tpu.drivers.dds as jdds
import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu_torch.drivers import dds as pdds
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import capture_chunked_scan, closure_vars, npy, tt

KW = dict(batch_size=16, n_steps=10, sigma=2.0, learning_rate=3e-3, hidden=(16,))


def _setup(monkeypatch, jtarget, ptarget, n_iter=2, **kw):
    kw = {**KW, **kw}
    train, (jparams, jopt, jema), keys = capture_chunked_scan(
        jdds, monkeypatch, jdds.run_dds, jtarget, seed=0, n_iter=n_iter, **kw)
    names = closure_vars(train)
    names.update(closure_vars(names["loss_fn"]))
    names.update(closure_vars(names["rollout"]))
    pieces = pdds.build_dds(ptarget, 0, n_iter, device="cpu", **kw)
    k_net, _ = jax.random.split(jax.random.PRNGKey(0))
    freqs = jax.random.normal(jax.random.split(k_net)[0], (128,))
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams), np.asarray(freqs))
    pieces.net.load_state_dict(state)
    params = {k: v for k, v in state.items() if k != "fourier_freqs"}
    assert set(params) == set(pieces.params)
    return names, jparams, keys, pieces, params


def _noise(key, batch=16, d=2, n_steps=10):
    k0, keps = jax.random.split(key)
    return pdds.DDSNoise(tt(jax.random.normal(k0, (batch, d))),
                         tt(jax.random.normal(keps, (n_steps, batch, d))))


def _perturbed(jparams, scale=0.05):
    key = jax.random.PRNGKey(5)
    return jax.tree_util.tree_map(
        lambda p: p + scale * jax.random.normal(jax.random.fold_in(key, p.size), p.shape),
        jparams)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(npy(got) - ref))) / max(float(np.max(np.abs(ref))), 1e-30)


def test_cos_sq_betas_match_reference():
    for n in (1, 2, 50, 100):
        np.testing.assert_allclose(npy(pdds.cos_sq_betas(n)), np.asarray(jdds.cos_sq_betas(n)),
                                   rtol=1e-6, atol=1e-9)
    b = pdds.cos_sq_betas(50)
    assert float(b[0]) == pytest.approx(0.3) and float(b[-1]) == pytest.approx(1e-3)
    assert bool(torch.all(b[:-1] >= b[1:]))


def test_step_rollout_and_loss_match_reference(monkeypatch):
    """On a Gaussian target: 4-mode's score flips sign across a mode
    boundary within ~1e-3 (responsibilities exp(16 x)), so a chain near it
    turns fp32 noise into visible differences within a few steps, in either
    package; one step on 4-mode is held below."""
    names, jparams, _, pieces, _ = _setup(monkeypatch, jt.IndepGaussian(2, var=3.0),
                                          pt.IndepGaussian(2, var=3.0))
    jparams = _perturbed(jparams)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    key = jax.random.PRNGKey(1)
    x = np.asarray(3.0 * jax.random.normal(key, (16, 2)))
    lw = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (16,)))
    eps = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (16, 2)))
    beta, t = np.float32(0.2), np.float32(0.3)
    jx, jlw = names["step_k"](jparams, x, lw, beta, t, eps)
    px, plw = pieces.step_k(params, tt(x), tt(lw), torch.tensor(beta), torch.tensor(t), tt(eps))
    assert _rel(px, jx) <= 1e-5 and _rel(plw, jlw) <= 1e-5

    jx, jlw = names["rollout"](jparams, key)
    with torch.no_grad():
        px, plw = pieces.rollout(params, _noise(key))
    assert _rel(px, jx) <= 1e-5 and _rel(plw, jlw) <= 1e-5

    (jloss, _), jgrad = jax.value_and_grad(names["loss_fn"], has_aux=True)(jparams, key)
    ploss, plw, pgrad = pieces.loss_and_grad(params, _noise(key))
    assert _rel(ploss, jloss) <= 1e-5
    jg = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    scale = max(float(v.abs().max()) for v in jg.values())
    for k, g in pgrad.items():
        assert float((g - jg[k]).abs().max()) <= 1e-4 * scale, k
    # the checkpointed gradient is the plain one
    loss2, lw2, grad2 = pieces.loss_and_grad(params, _noise(key), remat=False)
    assert torch.equal(ploss, loss2) and torch.equal(plw, lw2)
    for k in pgrad:
        assert torch.equal(pgrad[k], grad2[k]), k


def test_two_iterations_match_reference(monkeypatch):
    jtarget = jt.four_mode_mixture()
    names, _, keys, pieces, params = _setup(monkeypatch, jtarget, pt.four_mode_mixture())
    res = jdds.run_dds(jtarget, seed=0, n_iter=2, **KW)
    carry = pieces.init_carry(params)
    losses, log_zs = [], []
    for k in keys:
        carry, (loss, log_z) = pieces.train_step(carry, _noise(k))
        losses.append(float(loss))
        log_zs.append(float(log_z))
    np.testing.assert_allclose(losses, np.asarray(res.losses), rtol=1e-4)
    np.testing.assert_allclose(log_zs, np.asarray(res.log_z), rtol=1e-4, atol=1e-4)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, res.params))
    scale = max(float(v.abs().max()) for v in ref.values())
    for k, v in carry.params.items():
        assert float((v - ref[k]).abs().max()) <= 1e-4 * scale, k


def test_one_step_on_four_mode_matches_reference(monkeypatch):
    names, jparams, _, pieces, _ = _setup(monkeypatch, jt.four_mode_mixture(),
                                          pt.four_mode_mixture())
    jparams = _perturbed(jparams)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    key = jax.random.PRNGKey(1)
    x = np.asarray(6.0 * jax.random.normal(key, (16, 2)))
    lw = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (16,)))
    eps = np.asarray(jax.random.normal(jax.random.fold_in(key, 2), (16, 2)))
    beta, t = np.float32(0.2), np.float32(0.3)
    jx, jlw = names["step_k"](jparams, x, lw, beta, t, eps)
    px, plw = pieces.step_k(params, tt(x), tt(lw), torch.tensor(beta), torch.tensor(t), tt(eps))
    assert _rel(px, jx) <= 1e-5 and _rel(plw, jlw) <= 1e-5


def test_init_weights_telescope_to_the_terminal_ratio():
    """The reference's invariant (tests/test_dds.py): at init the control
    is zero, so log w == log pi(x_K) - log N(x_K; 0, sigma^2 I)."""
    target = pt.four_mode_mixture()
    res = pdds.run_dds(target, seed=0, n_iter=1, device="cpu", batch_size=64, n_steps=30,
                       sigma=2.0, learning_rate=0.0)
    x, log_w = res.sample_fn(res.params, [res.draw_noise(torch.Generator().manual_seed(3))])
    ref = -0.5 * torch.sum(x * x, -1) / 4.0 - np.log(2 * np.pi) - 2 * np.log(2.0)
    assert float(torch.max(torch.abs(log_w - (target.log_prob(x) - ref)))) < 5e-3


def test_gradient_step_on_phi_four_matches_reference(monkeypatch):
    """phi-four (d=8): the net gates the detached K3-backed score (its plain
    version here); the gradient is in the parameters only, and the fused
    score gate, which refuses autograd, is never reached."""
    jtarget, ptarget = jt.PhiFour(8), pt.PhiFour(8)
    names, jparams, keys, pieces, params = _setup(
        monkeypatch, jtarget, ptarget, n_iter=1, sigma=1.0, learning_rate=1e-3)
    jparams = _perturbed(jparams, 0.02)
    params = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    key = keys[0]
    (jloss, _), jgrad = jax.value_and_grad(names["loss_fn"], has_aux=True)(jparams, key)

    def no_gate(*args, **kwargs):
        raise AssertionError("DDS reached the fused score gate")

    monkeypatch.setattr(ptarget, "score_gate", no_gate)
    noise = _noise(key, d=8)
    noise = pdds.DDSNoise(noise.x0, noise.eps)
    ploss, _, pgrad = pieces.loss_and_grad(params, noise)
    assert _rel(ploss, jloss) <= 1e-5
    jg = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrad))
    scale = max(float(v.abs().max()) for v in jg.values())
    assert scale > 0 and float(pgrad["gate_head.weight"].abs().max()) > 0
    for k, g in pgrad.items():
        assert float((g - jg[k]).abs().max()) <= 1e-4 * scale, k
    carry, (loss, _) = pieces.train_step(pieces.init_carry(params), noise)
    assert torch.isfinite(loss) and all(torch.isfinite(v).all() for v in carry.params.values())


def test_dds_baseline_schema():
    from mfm_tpu_torch.config import preset

    cfg = preset("4-mode", learning_iter=2, num_chain=16, eval_iter=2, hidden_xt=(8,))
    assert pdds.dds_sigma(cfg) == 1.0 and pdds.dds_sigma(preset("funnel")) == 1.0
    res = pdds.dds_baseline(pt.four_mode_mixture(), cfg, seed=0, device="cpu")
    assert res.flow_samples.shape == res.exact_samples.shape == (32, 2)
    assert set(res.extras) == {"final_loss", "log_z_is", "is_ess_frac"}
    assert all(np.isfinite(v) for v in res.extras.values())
