"""FAB (``mfm_tpu_torch.drivers.fab``) against ``mfm_tpu.drivers.fab``.

The reference's pieces are closures inside ``run_fab``; the test reaches
them by stopping its run at ``host_chunked_scan`` (``torch_parity.
capture_chunked_scan``) and reading the closures' free variables, so both
packages run the same inputs through the same-named pieces. Noise is
replayed from the reference's key splits.

Tolerances: single pieces 1e-5 relative to the largest entry (fp32, the
same operations in another order); the whole driver over three epochs 1e-4
(Adam and the Robbins-Monro step sizes feed each difference forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import mfm_tpu.drivers.fab as jfab
import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.flows.coupling import make_coupling_flow as j_make_flow
from mfm_tpu_torch.drivers import fab as pfab
from mfm_tpu_torch.flows.train import AdamState
from mfm_tpu_torch.utils.convert import coupling_params_from_flax
from torch_parity import capture_chunked_scan, closure_vars, npy, tt

EXAMPLES = ["4-mode", "gaussian-mixture", "phi-four", "pines", "funnel", "many-well", "gmm_v1"]


@pytest.mark.parametrize("example", EXAMPLES)
def test_config_matches_reference(example):
    assert pfab.load_fab_config(example) == jfab.load_fab_config(example)


def test_yaml_reader_matches_safe_load_on_every_file():
    files = sorted(pfab.CONFIG_DIR.rglob("*.yaml"))
    assert len(files) >= 9
    for f in files:
        text = f.read_text()
        assert pfab.read_yaml(text) == yaml.safe_load(text), f
    # PyYAML's float needs a signed exponent: cox.yaml's 1.0e4 is a string
    assert pfab.load_fab_config("pines")["training"]["n_epoch"] == "1.0e4"
    for text in ("a: 1.0e+4\nb: [1, -2, 0.5]\nc: ~\nd: 'x # y'  # z\ne:\n  - 1\n  - k: v\n    j: 2\n",
                 "x: .inf\ny: -.5\nz: 0x1f\nw: 017\nv: yes\nu: 1e5\n"):
        assert pfab.read_yaml(text) == yaml.safe_load(text)


def test_non_integer_epochs_are_refused_by_name():
    with pytest.raises(ValueError, match="training.n_epoch"):
        pfab.build_fab(pt.PhiFour(8), "pines", device="cpu")
    with pytest.raises(ValueError, match="training.batch_size"):
        pfab.build_fab(pt.four_mode_mixture(), "4-mode", n_epoch=2,
                       overrides={"training": {"batch_size": 16.0}}, device="cpu")


# --- the pieces --------------------------------------------------------------

SMALL = dict(n_epoch=3, batch_size=16,
             overrides={"flow": {"conditioner_mlp_units": [16], "n_layers": 2}})


def _reference(monkeypatch, jtarget, example, **kw):
    """The reference's closures of one run (stopped before its epochs) and
    its post-prefill carry."""
    train, carry, keys = capture_chunked_scan(jfab, monkeypatch, jfab.run_fab, jtarget,
                                              example, seed=0, **kw)
    it = closure_vars(train)["train_iter"]
    names = closure_vars(it)
    ais = names["ais_forward"]
    names.update(closure_vars(ais))
    names.update(closure_vars(names["transition"]))
    names["train_iter"] = it
    return names, carry, keys


def _port_carry(pieces, jcarry):
    """The reference's carry in the port's form."""
    conv = lambda tree: {k: v for k, v in coupling_params_from_flax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}
    adam_state = jcarry.opt_state[0]
    return pfab.FABCarry(
        params=conv(jcarry.params),
        opt_state=AdamState(torch.tensor(int(adam_state.count), dtype=torch.int32),
                            conv(adam_state.mu), conv(adam_state.nu)),
        grad_norm_ema=tt(jcarry.grad_norm_ema), step_sizes=tt(jcarry.step_sizes),
        buf_x=tt(jcarry.buf_x), buf_log_w=tt(jcarry.buf_log_w), buf_log_q=tt(jcarry.buf_log_q),
        buf_ptr=int(jcarry.buf_ptr), step=int(jcarry.step),
    )


def _ais_noise(key, batch, d, K, n_outer):
    """The draws of the reference's ais_forward from ``key``."""
    k0, krest = jax.random.split(key)
    moves, us = [], []
    for ks in jax.random.split(krest, K + 1):
        mj, uj = [], []
        for k in jax.random.split(ks, n_outer):
            km, ku = jax.random.split(k)
            mj.append(jax.random.normal(km, (batch, d)))
            uj.append(jax.random.uniform(ku, (batch,)))
        moves.append(jnp.stack(mj))
        us.append(jnp.stack(uj))
    return pfab.AISNoise(tt(jax.random.normal(k0, (batch, d))), tt(jnp.stack(moves)),
                         tt(jnp.stack(us)))


def _iter_noise(key, pieces, d, K, n_outer, n_updates=4):
    k_ais, k_buf = jax.random.split(key)
    gumbels = [tt(jax.random.gumbel(k, (pieces.batch, pieces.cap)))
               for k in jax.random.split(k_buf, n_updates)] if pieces.use_buffer else []
    return pfab.FABIterNoise(_ais_noise(k_ais, pieces.batch, d, K, n_outer), gumbels)


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    got = npy(got).astype(np.float64)
    scale = max(float(np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0)), 1e-30)
    same_inf = np.array_equal(np.isfinite(got), np.isfinite(ref))
    return float(np.max(np.abs(got - ref)[np.isfinite(ref)], initial=0.0)) / scale, same_inf


def _close(got, ref, tol):
    err, same_inf = _rel(got, ref)
    assert same_inf and err <= tol, (err, same_inf)


def _close_params(params, jtree, tol):
    """Every parameter within ``tol`` of the largest parameter entry (a
    zero-initialised bias holds a few Adam steps of ~lr, whose size in the
    eps regime of a near-zero gradient is fp32 noise)."""
    ref = coupling_params_from_flax(jax.tree_util.tree_map(np.asarray, jtree))
    scale = max(float(np.max(np.abs(v.numpy()))) for v in ref.values())
    for k, v in params.items():
        err = float(np.max(np.abs(npy(v) - ref[k].numpy())))
        assert err <= tol * scale, (k, err, scale)


@pytest.mark.parametrize("example,op", [("4-mode", "hmc"), ("gmm_v1", "metropolis")])
def test_log_gamma_transition_and_ais_forward(monkeypatch, example, op):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    names, jcarry, _ = _reference(monkeypatch, jtarget, example, **SMALL)
    pieces = pfab.build_fab(ptarget, example, device="cpu", **SMALL)
    carry = _port_carry(pieces, jcarry)
    K, n_outer = len(np.asarray(names["betas"])) - 1, names["n_outer"]
    np.testing.assert_allclose(npy(torch.linspace(0.0, 1.0, K + 2)[1:]),
                               np.asarray(names["betas"]), rtol=1e-6)
    x = np.asarray(6.0 * jax.random.normal(jax.random.PRNGKey(1), (16, 2)))
    beta = np.float32(0.4)
    _close(pieces.log_gamma(carry.params, torch.tensor(beta), tt(x)),
           names["log_gamma"](jcarry.params, beta, jnp.asarray(x)), 1e-5)

    # one transition (the reference's ``op``) at beta 0.4
    key = jax.random.PRNGKey(2)
    step = np.float32(2.4 if op == "hmc" else 2.0)
    jx, jacc = names["transition"](jcarry.params, beta, step, key, jnp.asarray(x))
    moves, us = [], []
    for k in jax.random.split(key, n_outer):
        km, ku = jax.random.split(k)
        moves.append(tt(jax.random.normal(km, (16, 2))))
        us.append(tt(jax.random.uniform(ku, (16,))))
    px, pacc = pieces.transition(carry.params, torch.tensor(beta), torch.tensor(step), tt(x),
                                 torch.stack(moves), torch.stack(us))
    _close(px, jx, 1e-5)
    np.testing.assert_allclose(float(pacc), float(jacc), atol=1e-6)
    assert 0.0 < float(pacc) < 1.0, "some proposals accepted, some not"

    # a whole AIS pass: positions, weights, acceptance, tuned step sizes
    key = jax.random.PRNGKey(3)
    jout = names["ais_forward"](jcarry.params, jcarry.step_sizes, key)
    pout = pieces.ais_forward(carry.params, carry.step_sizes,
                              _ais_noise(key, 16, 2, K, n_outer))
    for got, ref in zip(pout, jout):
        _close(got, ref, 1e-5)


def test_buffer_update_and_gradient_step(monkeypatch):
    """One epoch: AIS, the buffer insert, four prioritised updates on a
    replayed Gumbel (priorities set, not added); then grad_update with the
    skip and the clip firing."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    names, jcarry, _ = _reference(monkeypatch, jtarget, "4-mode", **SMALL)
    pieces = pfab.build_fab(ptarget, "4-mode", device="cpu", **SMALL)
    carry = _port_carry(pieces, jcarry)
    assert carry.buf_ptr == 16 and pieces.cap == int(jcarry.buf_x.shape[0])

    key = jax.random.PRNGKey(4)
    jc2, (jloss, jacc, jlz) = names["train_iter"](jcarry, key)
    pc2, (ploss, pacc, plz) = pieces.train_iter(carry, _iter_noise(key, pieces, 2, 4, 1))
    for got, ref in ((ploss, jloss), (pacc, jacc), (plz, jlz), (pc2.buf_x, jc2.buf_x),
                     (pc2.buf_log_w, jc2.buf_log_w), (pc2.buf_log_q, jc2.buf_log_q),
                     (pc2.step_sizes, jc2.step_sizes), (pc2.grad_norm_ema, jc2.grad_norm_ema)):
        _close(got, ref, 1e-5)
    assert pc2.buf_ptr == int(jc2.buf_ptr) and pc2.step == int(jc2.step) == 4
    _close_params(pc2.params, jc2.params, 1e-5)

    # grad_update on a batch: ema tiny -> skipped (zero gradient, Adam still
    # steps); ema a little under the norm -> clipped
    x = jnp.asarray(jc2.buf_x[:16])
    w = jnp.full((16,), 1.0 / 16)
    lqo = jnp.asarray(jc2.buf_log_q[:16]) + 0.3
    grad_update = closure_vars(names["train_iter"])["grad_update"]
    loss_fn = closure_vars(grad_update)["loss_fn"]
    _, g = jax.value_and_grad(loss_fn, has_aux=True)(jc2.params, x, w, lqo)
    norm = float(jfab.optax.global_norm(g))
    for ema in (1e-6, 0.3 * norm):
        jcur = jc2._replace(grad_norm_ema=jnp.float32(ema))
        pcur = pc2._replace(grad_norm_ema=torch.tensor(ema, dtype=torch.float32))
        jnew, jl, jlq = grad_update(jcur, x, w, lqo)
        pnew, pl, plq = pieces.grad_update(pcur, tt(x), tt(w), tt(lqo))
        _close(pl, jl, 1e-5)
        _close(plq, jlq, 1e-5)
        _close(pnew.grad_norm_ema, jnew.grad_norm_ema, 1e-5)
        assert int(pnew.opt_state.count) == int(jnew.opt_state[0].count) == 5
        _close_params(pnew.params, jnew.params, 1e-5)
        moved = max(float((v - pc2.params[k]).abs().max()) for k, v in pnew.params.items())
        assert moved > 0.0  # a skipped step still moves by Adam's momentum


def test_three_epochs_match_reference(monkeypatch):
    """The whole driver, d=2, batch 16, 16-wide conditioners: the prefill
    and three epochs under the reference's keys."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    kw = dict(n_epoch=3, batch_size=16, overrides={"flow": {"conditioner_mlp_units": [16]}})
    res = jfab.run_fab(jtarget, "4-mode", seed=0, **kw)
    pieces = pfab.build_fab(ptarget, "4-mode", device="cpu", **kw)
    key_flow, key_run = jax.random.split(jax.random.PRNGKey(0))
    flow_kw = dict(n_layers=4, hidden=(16,), transform_type="spline", n_bins=8,
                   spline_range=(-16.0, 16.0), act_norm=False, base_scale=8.0)
    _, jparams = j_make_flow(key_flow, 2, **flow_kw)
    carry = pieces.init_carry(coupling_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    k_pre, k_train = jax.random.split(key_run)
    for k in jax.random.split(k_pre, pieces.min_batches):
        carry = pieces.prefill_one(carry, _ais_noise(k, 16, 2, 4, 1))
    losses, accs, log_zs = [], [], []
    for k in jax.random.split(k_train, 3):
        carry, (loss, acc, log_z) = pieces.train_iter(carry, _iter_noise(k, pieces, 2, 4, 1))
        losses.append(float(loss))
        accs.append(float(acc))
        log_zs.append(float(log_z))
    np.testing.assert_allclose(losses, np.asarray(res.losses), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(accs, np.asarray(res.accept), atol=1e-4)
    np.testing.assert_allclose(log_zs, np.asarray(res.log_z_alpha2), rtol=1e-4, atol=1e-4)
    # the trained flows as functions: log q on fresh points
    pts = np.asarray(8.0 * jax.random.normal(jax.random.PRNGKey(9), (256, 2)))
    jflow, _ = j_make_flow(key_flow, 2, **flow_kw)
    _close(pieces.flow.log_prob(carry.params, tt(pts)), jflow.log_prob(res.params, pts), 1e-4)
    # and entry by entry, 1e-4 of the largest, except where Adam runs in its
    # eps regime (sqrt(nu) < eps: a gradient at fp32 noise, 1e-8, whose
    # normalised step m / (sqrt(v) + eps) is any sign): there each of the 12
    # steps moves an entry by at most the learning rate
    ref = coupling_params_from_flax(jax.tree_util.tree_map(np.asarray, res.params))
    scale = max(float(np.max(np.abs(v.numpy()))) for v in ref.values())
    max_move = 12 * 2e-4 * 1.1
    for k, v in carry.params.items():
        err = np.abs(npy(v) - ref[k].numpy())
        noise = np.sqrt(npy(carry.opt_state.nu[k])) < 1e-8
        assert float(np.max(err[~noise], initial=0.0)) <= 1e-4 * scale, k
        assert float(np.max(err[noise], initial=0.0)) <= max_move, k


def test_ais_weights_zero_when_target_equals_base():
    """The reference's invariant (tests/test_fab.py): an identity flow with
    target == base makes every AIS increment, and the alpha=2 estimate, 0."""
    res = pfab.run_fab(
        pt.IndepGaussian(4), "4-mode", seed=0, n_epoch=1, batch_size=32,
        overrides={"fab": {"buffer": {"with_buffer": False}}, "flow": {"base_scale": 1.0}},
        device="cpu")
    assert abs(float(res.log_z_alpha2[0])) < 1e-3


def test_fab_baseline_schema():
    from mfm_tpu_torch.config import preset

    cfg = preset("4-mode", learning_iter=3, num_chain=16, eval_iter=2,
                 hidden_xt=(8,))
    res = pfab.fab_baseline(pt.four_mode_mixture(), cfg, seed=0, device="cpu")
    assert res.flow_samples.shape == res.exact_samples.shape == (32, 2)
    assert set(res.extras) == {"final_loss", "mean_accept", "log_z_alpha2", "log_z_is",
                               "is_ess_frac"}
    assert all(np.isfinite(v) for v in res.extras.values())
    assert 0.0 < res.extras["is_ess_frac"] <= 1.0 and res.train_time > 0
