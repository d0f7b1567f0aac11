"""Port parity: ODE integrators (flows.ode) and the CNF transport
(flows.cnf) against mfm_tpu's, both through the nn.Module with
torch.func.jvp and through K1's tangent-field path (its plain version on
the CPU), with a score gate whose derivative matters.

Tolerance: atol 1e-4 -- fp32, a few RK4 steps of fields evaluated with
sums in another order; the logdet accumulates d divergence terms per
stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.flows.ode import odeint_grid as j_odeint
from mfm_tpu_torch.flows import (
    kernel_tangent_field,
    make_transport,
    module_tangent_field,
)
from mfm_tpu_torch.flows.ode import odeint_grid as p_odeint
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

ATOL = 1e-4
D, W, F, B = 4, 16, 8, 16


@pytest.mark.parametrize("method", ["rk4", "heun", "euler"])
def test_odeint_grid_matches(method):
    A = np.array([[0.3, 0.8, 0.0], [-0.5, -0.1, 0.2], [0.1, 0.0, 0.4]], np.float32)
    y0 = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)

    def jf(y, t):
        x, s = y
        return jnp.sin(t) * x @ A.T, jnp.sum(x, -1) * t

    def pf(y, t):
        x, s = y
        return np.sin(t) * x @ tt(A).T, torch.sum(x, -1) * t

    jx, js = j_odeint(jf, (jnp.asarray(y0), jnp.zeros(5)), 0.0, 1.0, 5, method)
    px, ps = p_odeint(pf, (tt(y0), torch.zeros(5)), 0.0, 1.0, 5, method)
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(npy(ps), np.asarray(js), atol=1e-5)


def _fields(score_clip):
    """The flax net (reference) and the port's net on the same parameters,
    with the phi-four score gate; the gate head is perturbed enough that
    gate * dscore/dx moves the logdet."""
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(7), D, W, F, "tanh", jtarget.score, score_clip, gate_perturb=0.01
    )
    net_p, pparams = torch_field(params, freqs, D, W, "tanh", ptarget.score, score_clip)
    return net_j, params, net_p, pparams


def _without_gate(pparams):
    """The parameters with the gate head zeroed: the gate, and so the whole
    score-gate term, is exactly 0."""
    return {k: torch.zeros_like(v) if k.startswith("gate_head") else v for k, v in pparams.items()}


@pytest.mark.parametrize("path", ["module", "kernel"])
@pytest.mark.parametrize("score_clip", [None, 2.0])
def test_exact_transport_matches(path, score_clip):
    net_j, params, net_p, pparams = _fields(score_clip)
    bind = module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)
    jtr = j_transport(net_j.apply, divergence="exact", n_steps=3)
    ptr = make_transport(bind, divergence="exact", n_steps=3)
    u = np.random.default_rng(1).uniform(-1, 1, (B, D)).astype(np.float32)
    jx, jld = jtr.forward(params, jnp.asarray(u))
    px, pld = ptr.forward(pparams, tt(u))
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=ATOL)
    np.testing.assert_allclose(npy(pld), np.asarray(jld), atol=ATOL)
    ju, jild = jtr.inverse(params, jx)
    pu, pild = ptr.inverse(pparams, px)
    np.testing.assert_allclose(npy(pu), np.asarray(ju), atol=ATOL)
    np.testing.assert_allclose(npy(pild), np.asarray(jild), atol=ATOL)
    # the score-gate term is not negligible here (else this test is blind)
    no_gate = make_transport(
        kernel_tangent_field(net_p), divergence="exact", n_steps=3
    )
    _, pld0 = no_gate.forward(_without_gate(pparams), tt(u))
    assert float(torch.max(torch.abs(pld0 - pld))) > 100 * ATOL


@pytest.mark.parametrize("path", ["module", "kernel"])
@pytest.mark.parametrize("num_probes,probe_dist", [(1, "gaussian"), (3, "rademacher")])
def test_hutchinson_transport_matches(path, num_probes, probe_dist):
    """The same probes JAX draws from its key, handed to the port."""
    net_j, params, net_p, pparams = _fields(None)
    bind = module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)
    kw = dict(divergence="hutchinson", n_steps=3, num_probes=num_probes, probe_dist=probe_dist)
    jtr, ptr = j_transport(net_j.apply, **kw), make_transport(bind, **kw)
    u = np.random.default_rng(2).uniform(-1, 1, (B, D)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    shape = (B, D) if num_probes == 1 else (num_probes, B, D)
    assert ptr.probe_shape(B, D) == shape
    if probe_dist == "rademacher":
        probe = jax.random.rademacher(key, shape, jnp.int8).astype(jnp.float32)
    else:
        probe = jax.random.normal(key, shape, jnp.float32)
    jx, jld = jtr.forward(params, jnp.asarray(u), key)
    px, pld = ptr.forward(pparams, tt(u), tt(probe))
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=ATOL)
    np.testing.assert_allclose(npy(pld), np.asarray(jld), atol=ATOL)
    ju, jild = jtr.inverse(params, jx, key)
    pu, pild = ptr.inverse(pparams, px, tt(probe))
    np.testing.assert_allclose(npy(pu), np.asarray(ju), atol=ATOL)
    np.testing.assert_allclose(npy(pild), np.asarray(jild), atol=ATOL)


SLICE_D = 64  # the phi-four slice's dimension


def _slice_dim_fields(gate_perturb, score_clip=None):
    """Narrow nets at d=64 with the phi-four score gate (its Hessian
    diagonal is ~2 * beta * a * d = 256, so the gate term dominates)."""
    jtarget, ptarget = jt.PhiFour(SLICE_D), pt.PhiFour(SLICE_D)
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(11), SLICE_D, W, F, "tanh", jtarget.score, score_clip,
        gate_perturb=gate_perturb,
    )
    net_p, pparams = torch_field(params, freqs, SLICE_D, W, "tanh", ptarget.score, score_clip)
    return net_j, params, net_p, pparams


@pytest.mark.parametrize("path", ["module", "kernel"])
def test_exact_transport_matches_at_slice_dimension(path):
    """Forward logdet at d=64 against the reference, with a gate whose
    divergence term moves the logdet by far more than the tolerance."""
    net_j, params, net_p, pparams = _slice_dim_fields(gate_perturb=2e-3)
    bind = module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)
    u = np.random.default_rng(4).uniform(-1, 1, (8, SLICE_D)).astype(np.float32)
    jx, jld = j_transport(net_j.apply, divergence="exact", n_steps=2).forward(
        params, jnp.asarray(u)
    )
    px, pld = make_transport(bind, divergence="exact", n_steps=2).forward(pparams, tt(u))
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=ATOL)
    # 8 stages x 64 diagonal terms of up to ~|gate| * 256 each: rtol 1e-4
    # is fp32 reordering of that sum
    np.testing.assert_allclose(npy(pld), np.asarray(jld), rtol=1e-4, atol=ATOL)
    no_gate = make_transport(bind, divergence="exact", n_steps=2)
    _, pld0 = no_gate.forward(_without_gate(pparams), tt(u))
    assert float(torch.max(torch.abs(pld0 - pld))) > 100 * ATOL


@pytest.mark.parametrize("path", ["module", "kernel"])
@pytest.mark.parametrize("score_clip", [None, 60.0])
def test_exact_divergence_is_the_jacobian_trace(path, score_clip):
    """div v from the tangent field == trace of the autograd Jacobian of the
    whole field (score gate and clip included) at d=64: a witness of the
    logdet that shares no code with the divergence."""
    from torch.func import functional_call, jacrev, vmap

    from mfm_tpu_torch.flows.cnf import exact_divergence

    _, _, net_p, pparams = _slice_dim_fields(gate_perturb=0.05, score_clip=score_clip)
    bind = module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)
    rng = np.random.default_rng(5)
    x = tt(rng.uniform(-1, 1, (6, SLICE_D)).astype(np.float32))
    t = tt(rng.uniform(size=6).astype(np.float32))
    with torch.no_grad():
        _, div = exact_divergence(bind(pparams), x, t)
    jac = vmap(jacrev(lambda xi, ti: functional_call(net_p, pparams, (xi, ti))))(x, t)
    trace = torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1).detach()
    if score_clip is not None:  # the clip is active somewhere, else this case is blind
        assert bool((torch.abs(net_p.score_fn(x)) > score_clip).any())
    # fp32 sums of 64 terms of size up to ~|gate| * 256 in another order
    np.testing.assert_allclose(npy(div), npy(trace), rtol=1e-4, atol=1e-3)


def test_hutchinson_needs_a_probe_and_unported_modes_raise():
    _, _, net_p, pparams = _fields(None)
    tr = make_transport(module_tangent_field(net_p), divergence="hutchinson", n_steps=2)
    with pytest.raises(ValueError, match="probe"):
        tr.forward(pparams, torch.zeros(2, D))
    # every mode of the reference is there now; an unknown one raises
    assert make_transport(module_tangent_field(net_p), divergence="exact_disc").forward_traj
    with pytest.raises(ValueError, match="unknown divergence"):
        make_transport(module_tangent_field(net_p), divergence="exact_cont")
