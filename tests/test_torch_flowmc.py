"""flowMC (``mfm_tpu_torch.drivers.flowmc``) against
``mfm_tpu.drivers.flowmc``: the local, global and training rounds and two
whole loops under the reference's replayed keys (its pieces reached through
``torch_parity.capture_chunked_scan``), and the reference's invariant.

Tolerances: one round 1e-5 relative to the largest entry; two loops 1e-4
(Adam carries each difference forward); parameters compared by the flow's
log q on fresh points, as in ``test_torch_fab.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mfm_tpu.drivers.flowmc as jflowmc
import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu_torch.drivers import flowmc as pflowmc
from mfm_tpu_torch.flows.train import AdamState
from mfm_tpu_torch.kernels import ChainState, mala
from mfm_tpu_torch.utils.convert import coupling_params_from_flax
from torch_parity import capture_chunked_scan, closure_vars, npy, tt

KW = dict(n_chain=16, n_local_steps=3, n_global_steps=2, n_epochs=2, step_size=0.3,
          learning_rate=3e-3, n_layers=2, hidden=(16,), base_scale=6.0)


def _conv(tree):
    return coupling_params_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def _setup(monkeypatch, perturb=0.0):
    """Both packages' pieces and the reference's initial carry (params
    perturbed by ``perturb``) in both forms."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    run, jcarry, keys = capture_chunked_scan(jflowmc, monkeypatch, jflowmc.run_flowmc,
                                             jtarget, seed=0, n_loop=2, **KW)
    names = closure_vars(closure_vars(run)["one_loop"])
    names["one_loop"] = closure_vars(run)["one_loop"]
    if perturb:
        key = jax.random.PRNGKey(11)
        jcarry = jcarry._replace(params=jax.tree_util.tree_map(
            lambda p: p + perturb * jax.random.normal(jax.random.fold_in(key, p.size), p.shape),
            jcarry.params))
    pieces = pflowmc.build_flowmc(ptarget, seed=0, device="cpu", **KW)
    s = jcarry.states
    adam_state = jcarry.opt_state[0]
    carry = pflowmc.FlowMCCarry(
        ChainState(tt(s.position), tt(s.logdensity), tt(s.logdensity_grad)),
        _conv(jcarry.params),
        AdamState(torch.tensor(int(adam_state.count), dtype=torch.int32), _conv(adam_state.mu),
                  _conv(adam_state.nu)),
        tt(jcarry.buf), int(jcarry.buf_len), int(jcarry.buf_ptr))
    return names, jcarry, keys, pieces, carry


def _local_noise(key, n, n_chain=16, d=2):
    out = []
    for k in jax.random.split(key, n):
        kn, ka = jax.random.split(k)
        out.append(mala.MalaNoise(tt(jax.random.normal(kn, (n_chain, d))),
                                  tt(jax.random.uniform(ka, (n_chain,)))))
    return out


def _global_noise(key, n, n_chain=16, d=2):
    eps, us = [], []
    for k in jax.random.split(key, n):
        kp, ku = jax.random.split(k)
        eps.append(jax.random.normal(kp, (n_chain, d)))
        us.append(jax.random.uniform(ku, (n_chain,)))
    return tt(jnp.stack(eps)), tt(jnp.stack(us))


def _train_idx(key, n, buf_len, batch=16):
    return torch.stack([torch.from_numpy(np.array(jax.random.randint(k, (batch,), 0, buf_len)))
                        for k in jax.random.split(key, n)]).long()


def _loop_noise(key, buf_len):
    k_loc, k_tr, k_gl = jax.random.split(key, 3)
    return pflowmc.FlowMCLoopNoise(_local_noise(k_loc, 3),
                                   _train_idx(k_tr, 2, min(buf_len + 16, 64)),
                                   *_global_noise(k_gl, 2))


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float64)
    err = float(np.max(np.abs(npy(got) - ref))) / max(float(np.max(np.abs(ref))), 1e-30)
    assert err <= tol, err


def test_rounds_match_reference(monkeypatch):
    names, jcarry, _, pieces, carry = _setup(monkeypatch, perturb=0.05)
    assert pieces.cap == int(jcarry.buf.shape[0]) == 64
    # local: three MALA steps
    key = jax.random.PRNGKey(1)
    js, jacc = names["local_round"](jcarry.states, key)
    ps, pacc = pieces.local_round(carry.states, _local_noise(key, 3))
    for got, ref in zip(ps, js):
        _close(got, ref, 1e-5)
    np.testing.assert_allclose(float(pacc), float(jacc), atol=1e-6)
    # global: two independence-MH moves through the (perturbed) flow
    key = jax.random.PRNGKey(2)
    js, jacc = names["global_round"](jcarry.params, jcarry.states, key)
    ps, pacc = pieces.global_round(carry.params, carry.states, *_global_noise(key, 2))
    for got, ref in zip(ps, js):
        _close(got, ref, 1e-5)
    np.testing.assert_allclose(float(pacc), float(jacc), atol=1e-6)
    assert 0.0 < float(pacc) < 1.0
    # training: two NLL epochs on minibatches of the filled prefix
    key = jax.random.PRNGKey(3)
    jc2, jl = names["train_round"](jcarry, key)
    pc2, pl = pieces.train_round(carry, _train_idx(key, 2, int(jcarry.buf_len)))
    _close(pl, jl, 1e-5)
    pts = np.asarray(6.0 * jax.random.normal(jax.random.PRNGKey(4), (64, 2)))
    jflow = closure_vars(names["train_round"])["flow"]
    _close(pieces.flow.log_prob(pc2.params, tt(pts)), jflow.log_prob(jc2.params, pts), 1e-5)


def test_two_loops_match_reference(monkeypatch):
    names, jcarry, keys, pieces, carry = _setup(monkeypatch)
    for key in keys:
        jcarry, (jpos, jl, jg, jloss) = names["one_loop"](jcarry, key)
        carry, (ppos, pl, pg, ploss) = pieces.one_loop(carry, _loop_noise(key, carry.buf_len))
        _close(ppos, jpos, 1e-4)
        np.testing.assert_allclose(float(pl), float(jl), atol=1e-4)
        np.testing.assert_allclose(float(pg), float(jg), atol=1e-4)
        _close(ploss, jloss, 1e-4)
        assert carry.buf_len == int(jcarry.buf_len) and carry.buf_ptr == int(jcarry.buf_ptr)
    _close(carry.buf, jcarry.buf, 1e-4)
    pts = np.asarray(6.0 * jax.random.normal(jax.random.PRNGKey(4), (64, 2)))
    jflow = closure_vars(names["train_round"])["flow"]
    _close(pieces.flow.log_prob(carry.params, tt(pts)), jflow.log_prob(jcarry.params, pts), 1e-4)


def test_global_moves_accept_all_under_identity_flow_on_matched_target():
    """The reference's invariant (tests/test_flowmc.py): target == base and
    an untrained flow make every global proposal exact, so every move is
    accepted."""
    res = pflowmc.run_flowmc(pt.IndepGaussian(4), seed=0, n_loop=2, device="cpu",
                             n_chain=32, n_local_steps=1, n_global_steps=3, n_epochs=0,
                             n_layers=2, hidden=(16,), learning_rate=0.0)
    assert torch.allclose(res.global_accept, torch.ones(2))
    assert res.positions.shape == (2, 32, 4) and res.losses.shape == (2, 0)


def test_flowmc_baseline_schema_and_depth():
    from mfm_tpu_torch.config import preset

    cfg = preset("4-mode", learning_iter=4, num_chain=16, eval_iter=2, hidden_xt=(8,),
                 mcmc_per_flow_steps=2.0)
    assert pflowmc.flowmc_n_layers(cfg) == len(cfg.hidden_x) + len(cfg.hidden_t) + 4
    cfg.flowmc_n_layers = 2
    res = pflowmc.flowmc_baseline(pt.four_mode_mixture(), cfg, seed=0, device="cpu")
    assert res.flow_samples.shape == res.exact_samples.shape == (32, 2)
    assert res.extras["local_accs"].shape == res.extras["global_accs"].shape == (2,)
    assert res.extras["loss_vals"].shape == (2, 2)
    assert np.isfinite(res.extras["log_z_is"]) and 0 < res.extras["is_ess_frac"] <= 1
