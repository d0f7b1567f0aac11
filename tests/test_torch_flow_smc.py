"""Port parity for flow-annealed SMC: ``flows/pullback.py`` and
``drivers/flow_smc.py`` against ``mfm_tpu``'s, on 4-mode with a converted
flax field (widths 16, every parameter perturbed).

- ``FlowPullbackTarget``: ell, and the tempered value and score (one
  forward transport and one reverse pass), exact and Hutchinson (one fixed
  Gaussian probe) divergence. At 'highest' the JAX package's own net, 1e-4
  relative to the largest entry; at 'default' (bf16 operands) the bf16
  twin of ``tests/test_torch_precision.py`` inside the JAX transport, 2e-3
  as the gradient there (a flipped bf16 rounding; JAX's transpose rounds
  each cotangent product to bf16, the port's fp32 backward does not).
- Two replayed ``run_flow_smc`` steps with latent MALA (Hutchinson) and
  with TESS (exact), the reference's draws replayed from its keys
  (flow_smc.py:232-236,316-336; tempered.py:125; mala.py:61): weights,
  latent particles, lambda, log Z, acceptance and the pushed samples to
  1e-4.
- The refusals: ``phi_four_score_gate`` and its plain version under
  ``torch.autograd`` and ``torch.func.grad``; a gradient inner kernel on
  the fused field or on PhiFour's forward-only gate, by name and before any
  transport; TESS runs there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.config import MFMConfig as JConfig
from mfm_tpu.drivers.flow_smc import run_flow_smc as j_run_flow_smc
from mfm_tpu.flows import make_transport as j_make_transport
from mfm_tpu.flows.pullback import FlowPullbackTarget as JPullback
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers.flow_smc import (
    FlowSMCStepNoise,
    TESSNoise,
    build_flow_smc,
    run_flow_smc,
)
from mfm_tpu_torch.drivers.mfm import build_mfm
from mfm_tpu_torch.flows import make_transport, module_tangent_field
from mfm_tpu_torch.flows.pullback import FlowPullbackTarget
from mfm_tpu_torch.flows.vector_field import field_params
from mfm_tpu_torch.kernels.mala import MalaNoise
from mfm_tpu_torch.ops.phi_four import phi_four_score_gate, phi_four_score_gate_plain
from mfm_tpu_torch.smc.tempered import SMCStepNoise
from test_torch_precision import _twin
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)
D, W, F, N = 2, 16, 8, 16
N_STEPS = 2


def _field(precision, act="tanh"):
    """The JAX apply (package net, or the bf16 twin) and the port's net
    carrying the same parameters, both with 4-mode's score gate."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), D, W, F, act, jtarget.score,
                                      perturb=0.05, gate_perturb=0.01)
    net_p, pparams = torch_field(params, freqs, D, W, act, ptarget.score,
                                 precision=precision)
    if precision == "highest":
        apply = net_j.apply
    else:
        jact = jnp.tanh if act == "tanh" else jax.nn.relu
        apply = lambda p, x, t: _twin(p, freqs, x, t, jact, jtarget.score)
    return jtarget, ptarget, apply, params, net_p, pparams


def _rel_close(got, ref, rel):
    np.testing.assert_allclose(got, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("divergence", ["exact", "hutchinson"])
@pytest.mark.parametrize("precision,rel", [("highest", 1e-4), ("default", 2e-3)])
def test_pullback_value_and_score_match_reference(precision, rel, divergence):
    jtarget, ptarget, apply, params, net_p, pparams = _field(precision)
    jtr = j_make_transport(apply, divergence=divergence, n_steps=3)
    ptr = make_transport(module_tangent_field(net_p), divergence=divergence, n_steps=3)
    key = jax.random.PRNGKey(1)
    u = 1.5 * jax.random.normal(jax.random.PRNGKey(2), (N, D))
    probes = {N: tt(jax.random.normal(key, (N, D)))} if divergence == "hutchinson" else None
    jpb = JPullback(jtarget, jtr, params, jt.IndepGaussian(D), key)
    ppb = FlowPullbackTarget(ptarget, ptr, pparams, pt.IndepGaussian(D), probes)
    _rel_close(npy(ppb.log_lik(tt(u))), np.asarray(jax.jit(jpb.log_lik)(u)), rel)
    jv, jg = jax.jit(jpb.tempered_value_and_score)(u, 0.3)
    pv, pg = ppb.tempered_value_and_score(tt(u), torch.tensor(0.3))
    _rel_close(npy(pv), np.asarray(jv), rel)
    _rel_close(npy(pg), np.asarray(jg), rel)
    _rel_close(npy(ppb.tempered_log_prob(tt(u), 0.3)), np.asarray(jv), rel)
    assert not pg.requires_grad and pg.shape == (N, D)


def _mala_moves(key, n_moves):
    out = []
    for k in jax.random.split(key, n_moves):
        kn, ka = jax.random.split(k)
        out.append(MalaNoise(tt(jax.random.normal(kn, (N, D))), tt(jax.random.uniform(ka, (N,)))))
    return out


def _tess_moves(key, n_moves, ref):
    out = []
    for k in jax.random.split(key, n_moves):
        key_nu, key_y, key_theta, key_loop = jax.random.split(k, 4)
        rows = []
        for _ in range(30):
            key_loop, sub = jax.random.split(key_loop)
            rows.append(jax.random.uniform(sub, (N,)))
        out.append(TESSNoise(tt(ref.sample(key_nu, (N,))), tt(jax.random.uniform(key_y, (N,))),
                             tt(jax.random.uniform(key_theta, (N,))), tt(jnp.stack(rows))))
    return out


@pytest.mark.parametrize("inner,divergence", [("mala", "hutchinson"), ("tess", "exact")])
def test_flow_smc_steps_match_reference(inner, divergence):
    jtarget, ptarget, apply, params, net_p, pparams = _field("highest")
    jtr = j_make_transport(apply, divergence=divergence, n_steps=3)
    ptr = make_transport(module_tangent_field(net_p), divergence=divergence, n_steps=3)
    cfg_kw = dict(example="4-mode", dim=D, num_chain=N, step_size=0.1, alpha=0.7)
    jref = jt.IndepGaussian(D)
    key = jax.random.PRNGKey(3)
    res = j_run_flow_smc(jtarget, JConfig(**cfg_kw), jtr, params, jref, key=key,
                         n_particles=N, n_steps=N_STEPS, inner_kernel=inner)

    pieces = build_flow_smc(ptarget, MFMConfig(**cfg_kw), ptr, pparams, pt.IndepGaussian(D),
                            n_particles=N, inner_kernel=inner)
    key_init, key_run, key_push = jax.random.split(key, 3)
    carry = pieces.init_fn(tt(jref.sample(key_init, (N,))))
    log_z, accs = torch.zeros(()), []
    for k in jax.random.split(key_run, N_STEPS):
        key_probe, key_smc = jax.random.split(k)
        key_update, key_resample = jax.random.split(key_smc)
        moves = (_mala_moves(key_update, 1) if inner == "mala"
                 else _tess_moves(key_update, 1, jref))
        probes = ({N: tt(jax.random.normal(key_probe, (N, D)))}
                  if divergence == "hutchinson" else None)
        noise = FlowSMCStepNoise(probes, SMCStepNoise(tt(jax.random.uniform(key_resample, ())),
                                                      moves))
        carry, info, acc = pieces.step_fn(carry, noise)
        log_z, accs = log_z + info.log_likelihood_increment, accs + [float(acc)]
    state = carry[0]
    probe = tt(jax.random.normal(key_push, (N, D))) if divergence == "hutchinson" else None
    samples, _ = ptr.forward(pparams, state.particles, probe)
    assert 0.0 < float(res.lmbda) <= 1.0
    np.testing.assert_allclose(float(state.lmbda), float(res.lmbda), atol=1e-4)
    np.testing.assert_allclose(float(log_z), float(res.log_z), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(npy(state.weights), np.asarray(res.weights), atol=1e-4)
    np.testing.assert_allclose(npy(state.particles), np.asarray(res.latent), atol=1e-4)
    np.testing.assert_allclose(npy(samples), np.asarray(res.samples), atol=1e-4)
    np.testing.assert_allclose(accs, np.asarray(res.acceptance), atol=1e-4)


def test_run_flow_smc_runs_and_reports():
    _, ptarget, _, _, net_p, pparams = _field("highest")
    ptr = make_transport(module_tangent_field(net_p), divergence="hutchinson", n_steps=2)
    cfg = MFMConfig(example="4-mode", dim=D, num_chain=N, step_size=0.1, waste_free_p=4)
    r = run_flow_smc(ptarget, cfg, ptr, pparams, pt.IndepGaussian(D),
                     torch.Generator().manual_seed(0), n_steps=2)
    assert r.samples.shape == (N, D) and r.acceptance.shape == (2,)
    assert abs(float(r.weights.sum()) - 1.0) < 1e-5 and 0 < float(r.ess_fraction) <= 1.0
    assert np.isfinite(float(r.log_z)) and r.train_time > 0


def _gate_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.rand((4, 8), generator=g).requires_grad_(requires_grad)
    gate, field = 0.1 * torch.randn((4, 8), generator=g), torch.zeros(4, 8)
    ex, dfield = torch.randn((2, 4, 8), generator=g), torch.zeros(2, 4, 8)
    return x, gate, field, ex, dfield


@pytest.mark.parametrize("fn", [phi_four_score_gate, phi_four_score_gate_plain],
                         ids=["wrapper", "plain"])
def test_score_gate_refuses_autograd(fn):
    """The gate writes in place (the kernel through raw pointers): both
    gradient routes are refused, and a forward call still runs."""
    x, gate, field, ex, dfield = _gate_inputs(True)
    with pytest.raises(ValueError, match="requires grad"):
        fn(x, gate, field, ex, dfield)
    x2 = x.detach()
    with pytest.raises(ValueError, match="requires grad"):
        grad(lambda y: fn(y, gate, field.clone(), ex, dfield.clone())[0].sum())(x2)
    out, dout = fn(x2, gate, field, ex, dfield)
    assert torch.isfinite(out).all() and torch.isfinite(dout).all()


class _NoTransport:
    """A transport that fails if it is run at all."""

    def forward(self, *a, **k):
        raise AssertionError("a transport ran before the refusal")

    probe_shape = staticmethod(lambda B, d: None)
    probe_dist = "gaussian"


@pytest.mark.parametrize("case", ["pallas_field", "phi-four"])
def test_gradient_kernels_refused_before_any_transport(case):
    if case == "pallas_field":
        target, cfg = pt.four_mode_mixture(), MFMConfig(example="4-mode", pallas_field=True)
        match = "pallas_field"
    else:
        target, cfg = pt.PhiFour(4), MFMConfig(example="phi-four", dim=4)
        match = "PhiFour.*forward-only"
    for inner in ("mala", "hmc", "nuts"):
        with pytest.raises(ValueError, match=match):
            run_flow_smc(target, cfg, _NoTransport(), {}, pt.IndepGaussian(target.dim),
                         torch.Generator(), n_particles=8, n_steps=1, inner_kernel=inner)


@pytest.mark.parametrize("case", ["pallas_field", "phi-four"])
def test_tess_runs_where_gradients_are_refused(case):
    small = dict(num_chain=8, hidden_x=(8,), hidden_t=(8,), hidden_xt=(8,), fourier_dim=4,
                 ode_steps=2)
    if case == "pallas_field":
        target = pt.four_mode_mixture()
        cfg = MFMConfig(example="4-mode", dim=2, pallas_field=True, **small)
    else:
        target = pt.PhiFour(4)
        cfg = MFMConfig(example="phi-four", dim=4, step_size=1e-3, **small)
    pieces = build_mfm(target, cfg, "cpu", torch.Generator().manual_seed(0))
    r = run_flow_smc(target, cfg, pieces.transport, field_params(pieces.net),
                     pieces.ref_dist, torch.Generator().manual_seed(1), n_steps=2,
                     inner_kernel="tess")
    assert torch.isfinite(r.samples).all() and 0.0 < float(r.lmbda) <= 1.0
