"""Port parity: the flow remainder of flows.ode and flows.cnf against
mfm_tpu's: the ``exact_disc`` transport (the exact log-Jacobian of the
discrete integrator map), ``forward_traj`` / ``odeint_grid_save`` and the
adaptive ``odeint_dopri5`` oracle.

The port has no ``linearize``: it pushes the d basis tangents through the
RK4/Heun/Euler map itself and takes ``slogdet`` of the assembled Jacobian;
the reference linearises the whole map. Tolerance 1e-4 absolute, as the
other transports (fp32, a few steps, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.flows.ode import odeint_dopri5 as j_dopri5
from mfm_tpu.flows.ode import odeint_grid_save as j_grid_save
from mfm_tpu_torch.flows import (
    kernel_tangent_field,
    make_transport,
    module_tangent_field,
    odeint_dopri5,
    odeint_grid,
    odeint_grid_save,
)
from mfm_tpu_torch.flows.cnf import EXACT_DISC_MAX_D
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

ATOL = 1e-4
D, W, F, B = 4, 16, 8, 16
SAVE_TS = [0.0, 0.25, 0.5, 0.75, 1.0]  # the reference's five save points


def _fields(gated: bool):
    """The flax net and the port's on the same parameters, with the
    phi-four score gate (a perturbed gate head) or without any score."""
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(7), D, W, F, "tanh", jtarget.score if gated else None,
        gate_perturb=0.01,
    )
    net_p, pparams = torch_field(params, freqs, D, W, "tanh", ptarget.score if gated else None)
    return net_j, params, net_p, pparams


def _bind(net_p, path):
    return module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)


@pytest.mark.parametrize("gated", [False, True], ids=["no-score", "score-gate"])
@pytest.mark.parametrize("path", ["module", "kernel"])
@pytest.mark.parametrize("method", ["rk4", "heun", "euler"])
def test_exact_disc_matches(method, path, gated):
    net_j, params, net_p, pparams = _fields(gated)
    kw = dict(divergence="exact_disc", n_steps=3, method=method)
    jtr, ptr = j_transport(net_j.apply, **kw), make_transport(_bind(net_p, path), **kw)
    u = np.random.default_rng(1).uniform(-1, 1, (B, D)).astype(np.float32)
    jx, jld = jtr.forward(params, jnp.asarray(u))
    px, pld = ptr.forward(pparams, tt(u))
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=ATOL)
    np.testing.assert_allclose(npy(pld), np.asarray(jld), atol=ATOL)
    ju, jild = jtr.inverse(params, jx)
    pu, pild = ptr.inverse(pparams, px)
    np.testing.assert_allclose(npy(pu), np.asarray(ju), atol=ATOL)
    np.testing.assert_allclose(npy(pild), np.asarray(jild), atol=ATOL)
    assert float(np.abs(np.asarray(jld)).max()) > 100 * ATOL  # not a blind case
    assert ptr.probe_shape(B, D) is None  # no probes: draw_probe gives None


@pytest.mark.parametrize("path", ["module", "kernel"])
def test_exact_disc_meets_the_exact_divergence_on_a_fine_grid(path):
    """The continuous logdet and the discrete map's differ by O(h^4): at 40
    RK4 steps they agree to 1e-4, at 2 steps they do not (the case sees the
    difference it is about)."""
    _, _, net_p, pparams = _fields(True)
    u = tt(np.random.default_rng(2).uniform(-1, 1, (B, D)).astype(np.float32))
    bind = _bind(net_p, path)
    gap = {}
    for n in (2, 40):
        _, ld_c = make_transport(bind, divergence="exact", n_steps=n).forward(pparams, u)
        _, ld_d = make_transport(bind, divergence="exact_disc", n_steps=n).forward(pparams, u)
        gap[n] = float(torch.max(torch.abs(ld_c - ld_d)))
    assert gap[40] <= 1e-4 < gap[2], gap


def test_exact_disc_is_the_jacobian_of_the_map():
    """Against slogdet of the autograd Jacobian of the whole discrete map."""
    from torch.func import functional_call, jacrev, vmap

    _, _, net_p, pparams = _fields(True)
    u = tt(np.random.default_rng(3).uniform(-1, 1, (5, D)).astype(np.float32))

    def one_map(ui):
        field = lambda x, t: functional_call(net_p, pparams, (x[None], torch.full((1,), t)))[0]
        return odeint_grid(field, ui, 0.0, 1.0, 3, "rk4")

    ref = torch.linalg.slogdet(vmap(jacrev(one_map))(u))[1]
    tr = make_transport(module_tangent_field(net_p), divergence="exact_disc", n_steps=3)
    np.testing.assert_allclose(npy(tr.forward(pparams, u)[1]), npy(ref.detach()), atol=ATOL)


def test_exact_disc_refuses_large_d():
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), EXACT_DISC_MAX_D + 1, 8, 4)
    net_p, pparams = torch_field(params, freqs, EXACT_DISC_MAX_D + 1, 8)
    tr = make_transport(module_tangent_field(net_p), divergence="exact_disc", n_steps=1)
    with pytest.raises(ValueError, match="exact_disc"):
        tr.forward(pparams, torch.zeros(2, EXACT_DISC_MAX_D + 1))


@pytest.mark.parametrize("divergence", ["exact", "hutchinson", "exact_disc"])
def test_forward_traj_matches(divergence):
    net_j, params, net_p, pparams = _fields(True)
    kw = dict(divergence=divergence, n_steps=8)
    jtr, ptr = j_transport(net_j.apply, **kw), make_transport(module_tangent_field(net_p), **kw)
    u = np.random.default_rng(4).uniform(-1, 1, (B, D)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    probe = tt(jax.random.normal(key, (B, D))) if divergence == "hutchinson" else None
    jxs = jtr.forward_traj(params, jnp.asarray(u), SAVE_TS, key)
    pxs = ptr.forward_traj(pparams, tt(u), SAVE_TS, probe)
    assert pxs.shape == (len(SAVE_TS), B, D)
    np.testing.assert_allclose(npy(pxs), np.asarray(jxs), atol=ATOL)
    np.testing.assert_array_equal(npy(pxs[0]), u)
    # 2 steps a segment x 4 segments is the plain 8-step grid
    np.testing.assert_allclose(npy(pxs[-1]), npy(ptr.forward(pparams, tt(u), probe)[0]), atol=1e-5)


@pytest.mark.parametrize("method", ["rk4", "heun", "euler"])
def test_odeint_grid_save_matches(method):
    A = np.array([[0.3, 0.8, 0.0], [-0.5, -0.1, 0.2], [0.1, 0.0, 0.4]], np.float32)
    y0 = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    jf = lambda y, t: (jnp.sin(t) * y[0] @ A.T, jnp.sum(y[0], -1) * t)
    pf = lambda y, t: (np.sin(t) * y[0] @ tt(A).T, torch.sum(y[0], -1) * t)
    jx, js = j_grid_save(jf, (jnp.asarray(y0), jnp.zeros(5)), SAVE_TS, 10, method)
    px, ps = odeint_grid_save(pf, (tt(y0), torch.zeros(5)), SAVE_TS, 10, method)
    assert px.shape == (5, 5, 3) and ps.shape == (5, 5)
    np.testing.assert_allclose(npy(px), np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(npy(ps), np.asarray(js), atol=1e-5)


def test_odeint_dopri5_matches_on_a_linear_field():
    A = np.array([[0.0, 1.0, 0.0], [-2.0, -0.1, 0.3], [0.2, 0.0, -0.5]], np.float32)
    y0 = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    jf = lambda y, t: (y[0] @ A.T, jnp.sum(y[0], -1))
    pf = lambda y, t: (y[0] @ tt(A).T, torch.sum(y[0], -1))
    jx, js = j_dopri5(jf, (jnp.asarray(y0), jnp.zeros(4)), 0.0, 1.0)
    px, ps = odeint_dopri5(pf, (tt(y0), torch.zeros(4)), 0.0, 1.0)
    np.testing.assert_allclose(npy(px), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(npy(ps), np.asarray(js), rtol=1e-5, atol=1e-6)
    # the closed form: y(1) = expm(A) y0
    import scipy.linalg

    exact = y0.astype(np.float64) @ scipy.linalg.expm(A.astype(np.float64)).T
    np.testing.assert_allclose(npy(px), exact, rtol=1e-4, atol=1e-5)
    # a bare tensor state as well as a tuple
    single = odeint_dopri5(lambda y, t: y @ tt(A).T, tt(y0), 0.0, 1.0)
    np.testing.assert_array_equal(npy(single), npy(odeint_dopri5(
        lambda y, t: (y[0] @ tt(A).T,), (tt(y0),), 0.0, 1.0)[0]))


def test_odeint_dopri5_meets_the_fixed_grid_on_the_flow():
    """The oracle's use: the transport's 24-step RK4 grid against it."""
    from torch.func import functional_call

    _, _, net_p, pparams = _fields(True)
    u = tt(np.random.default_rng(6).uniform(-1, 1, (B, D)).astype(np.float32))
    with torch.no_grad():
        field = lambda x, t: functional_call(net_p, pparams, (x, torch.full((B,), float(t))))
        fine = odeint_dopri5(field, u, 0.0, 1.0, rtol=1e-6, atol=1e-6)
        grid = odeint_grid(field, u, 0.0, 1.0, 24, "rk4")
    np.testing.assert_allclose(npy(grid), npy(fine), atol=1e-4)
    assert float(torch.max(torch.abs(fine - u))) > 1e-2  # the flow moves the points
