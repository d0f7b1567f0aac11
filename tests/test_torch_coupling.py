"""The coupling flow (``mfm_tpu_torch.flows.coupling``) against
``mfm_tpu.flows.coupling``: the spline both ways, the stack with perturbed
flax parameters carried across, gradients, identity at init.

Tolerances: the spline and its round trip 1e-5 relative to the largest
entry (|y| <= 9.5, |log-det| <= 6 here),
and no further from its float64 evaluation than the reference is: a narrow
bin divides by its width, so an fp32 knot a few ulps off (the knots are a
cumsum, summed in another order by XLA) moves y by ~1e-5 in both packages
alike; the stack 1e-5 relative to each output's largest entry (the same
operations, fp32 GEMMs in another order); gradients 1e-4 relative (a
backward pass through up to four layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.flows import coupling as jc
from mfm_tpu_torch.flows import coupling as pc
from mfm_tpu_torch.utils.convert import coupling_params_from_flax
from torch_parity import npy, tt

N_BINS, LO, HI = 8, -4.0, 4.0


def _raw_and_points():
    """Raw spline parameters and points inside the box, on its knots and
    outside it."""
    rng = np.random.default_rng(0)
    B, d = 64, 3
    raw = rng.normal(size=(B, d, 3 * N_BINS - 1)).astype(np.float32)
    x = rng.uniform(-3.9, 3.9, size=(B, d)).astype(np.float32)
    xk, yk, _ = jc._spline_params(jnp.asarray(raw), N_BINS, LO, HI)
    x[:8, 0] = np.asarray(xk)[:8, 0, 3]  # on an interior knot
    x[8:16, 1] = np.asarray(yk)[8:16, 1, 5]  # on a knot of the inverse
    x[16:20] = [[-7.0, 4.0, 9.5]] * 4  # outside, and on the boundary
    x[20:24] = [[-4.0, 3.9999995, -3.9999995]] * 4  # inside the clip margin
    return raw, x


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_rq_spline_matches_reference(direction):
    raw, x = _raw_and_points()
    jfn = getattr(jc, f"rq_spline_{direction}")
    pfn = getattr(pc, f"rq_spline_{direction}")
    jy, jld = jfn(jnp.asarray(x), jnp.asarray(raw), N_BINS, LO, HI)
    py, pld = pfn(tt(x), tt(raw), N_BINS, LO, HI)
    y64, ld64 = pfn(torch.tensor(x, dtype=torch.float64), torch.tensor(raw, dtype=torch.float64),
                    N_BINS, LO, HI)
    for got, ref, exact in ((py, jy, y64), (pld, jld, ld64)):
        assert _rel(got, ref) <= 1e-5
        err, ref_err = (float(np.max(np.abs(np.asarray(a, np.float64) - npy(exact))))
                        for a in (npy(got), ref))
        assert err <= 1.5 * ref_err + 1e-5 * float(exact.abs().max()), (err, ref_err)
    # the bin search counts knots at or below the point, as the reference
    xk, yk, _ = pc._spline_params(tt(raw), N_BINS, LO, HI)
    knots = xk if direction == "forward" else yk
    xc = torch.clamp(tt(x), LO + 1e-6, HI - 1e-6)
    ref_idx = jnp.sum((jnp.clip(x, LO + 1e-6, HI - 1e-6)[..., None]
                       >= np.asarray(knots)[..., 1:-1]).astype(jnp.int32), -1)
    np.testing.assert_array_equal(npy(pc._bin(xc, knots))[..., 0], np.asarray(ref_idx))


def test_rq_spline_round_trip_and_gradient_outside_the_box():
    raw, x = _raw_and_points()
    raw_t = tt(raw).requires_grad_(True)
    xt = tt(x).requires_grad_(True)
    y, ld = pc.rq_spline_forward(xt, raw_t, N_BINS, LO, HI)
    back, ld_inv = pc.rq_spline_inverse(y, raw_t, N_BINS, LO, HI)
    jy, jld = jc.rq_spline_forward(jnp.asarray(x), jnp.asarray(raw), N_BINS, LO, HI)
    jback, jld_inv = jc.rq_spline_inverse(jy, jnp.asarray(raw), N_BINS, LO, HI)
    assert _rel(back, x) <= 1e-5
    # as close to the identity as the reference's own round trip (the
    # log-dets cancel to fp32 rounding, ~8e-5 in both at the clip margin)
    assert float(np.max(np.abs(npy(back) - x))) <= 1.5 * float(np.max(np.abs(jback - x))) + 1e-6
    ld_err = float(torch.max(torch.abs(ld + ld_inv)).detach())
    assert ld_err <= 1.5 * float(np.max(np.abs(jld + jld_inv))) + 6e-5
    # outside [lo, hi] the layer is the identity; the clip keeps the untaken
    # branch finite, so the gradient there is finite too (x: exactly 1)
    gx, graw = torch.autograd.grad((y.sum() + ld.sum() + back.sum()), (xt, raw_t))
    assert torch.isfinite(gx).all() and torch.isfinite(graw).all()
    outside = (xt.abs() > HI).detach()
    assert outside.any()
    np.testing.assert_allclose(npy(gx[outside]), 2.0)  # y and back, both identity there
    # against jax.grad off the knots (rows 16 on: outside the box, the clip
    # margin, inside): on a knot the parameter gradient is one-sided, and an
    # ulp in the knot picks the side
    raw, x = raw[16:], x[16:]
    jg = jax.grad(lambda r, v: (jc.rq_spline_forward(v, r, N_BINS, LO, HI)[0].sum()
                                + jc.rq_spline_forward(v, r, N_BINS, LO, HI)[1].sum()),
                  argnums=(0, 1))(jnp.asarray(raw), jnp.asarray(x))
    pr, px = tt(raw).requires_grad_(True), tt(x).requires_grad_(True)
    y2, ld2 = pc.rq_spline_forward(px, pr, N_BINS, LO, HI)
    g_raw, g_x = torch.autograd.grad(y2.sum() + ld2.sum(), (pr, px))
    scale = lambda a: max(float(np.max(np.abs(a))), 1.0)
    np.testing.assert_allclose(npy(g_raw), np.asarray(jg[0]), atol=1e-4 * scale(jg[0]))
    np.testing.assert_allclose(npy(g_x), np.asarray(jg[1]), atol=1e-4 * scale(jg[1]))


def _flows(transform_type, act_norm, dim=5, n_layers=3, hidden=(16, 16), base_scale=1.5,
           perturb=0.1):
    """Both packages' flows, the flax parameters perturbed (the zero heads
    would hide the conditioner) and carried into the port."""
    key = jax.random.PRNGKey(3)
    jflow, jparams = jc.make_coupling_flow(
        key, dim, n_layers=n_layers, hidden=hidden, transform_type=transform_type,
        n_bins=N_BINS, spline_range=(LO, HI), act_norm=act_norm, base_scale=base_scale)

    def bump(path, p):
        return p + perturb * jax.random.normal(jax.random.fold_in(key, p.size), p.shape)

    jparams = jax.tree_util.tree_map_with_path(bump, jparams)
    pflow, pparams = pc.make_coupling_flow(
        dim, n_layers, hidden, transform_type, N_BINS, (LO, HI), act_norm, base_scale)
    state = coupling_params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(state) == set(pparams)
    pflow.module.load_state_dict(state)
    pparams = {k: v.detach().clone() for k, v in pflow.module.named_parameters()}
    return jflow, jparams, pflow, pparams


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(npy(got) - ref)) / max(np.max(np.abs(ref)), 1e-30))


CASES = [("real_nvp", False), ("real_nvp", True), ("spline", False), ("spline", True)]


@pytest.mark.parametrize("transform_type,act_norm", CASES)
def test_coupling_stack_matches_reference(transform_type, act_norm):
    jflow, jparams, pflow, pparams = _flows(transform_type, act_norm)
    x = np.asarray(1.5 * jax.random.normal(jax.random.PRNGKey(4), (32, 5)))
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (32, 5)))
    for jout, pout in (
        (jflow.forward(jparams, jnp.asarray(x)), pflow.forward(pparams, tt(x))),
        (jflow.inverse(jparams, jnp.asarray(x)), pflow.inverse(pparams, tt(x))),
    ):
        assert _rel(pout[0], jout[0]) <= 1e-5 and _rel(pout[1], jout[1]) <= 1e-5
    assert _rel(pflow.log_prob(pparams, tt(x)), jflow.log_prob(jparams, jnp.asarray(x))) <= 1e-5
    # sample_and_log_prob from the same base draw as jax.random.normal(key)
    jx, jlq = jflow.sample_and_log_prob(jparams, jax.random.PRNGKey(5), 32)
    px, plq = pflow.sample_and_log_prob(pparams, tt(eps))
    assert _rel(px, jx) <= 1e-5 and _rel(plq, jlq) <= 1e-5
    np.testing.assert_allclose(npy(pflow.sample(pparams, tt(eps))), npy(px))
    # the flow's own round trip and density consistency
    back = pflow.inverse(pparams, px)[0]
    np.testing.assert_allclose(npy(back), 1.5 * eps, atol=1e-4)
    np.testing.assert_allclose(npy(pflow.log_prob(pparams, px)), npy(plq), atol=1e-3)


@pytest.mark.parametrize("transform_type,act_norm", [("real_nvp", True), ("spline", True)])
def test_coupling_gradients_match_reference(transform_type, act_norm):
    """The gradient of sum(log_prob) in every parameter and in x."""
    jflow, jparams, pflow, pparams = _flows(transform_type, act_norm)
    x = np.asarray(1.5 * jax.random.normal(jax.random.PRNGKey(6), (32, 5)))
    jgp, jgx = jax.grad(lambda p, v: jflow.log_prob(p, v).sum(), argnums=(0, 1))(
        jparams, jnp.asarray(x))
    xt = tt(x).requires_grad_(True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in pparams.items()}
    grads = torch.autograd.grad(pflow.log_prob(leaves, xt).sum(), [xt, *leaves.values()])
    assert _rel(grads[0], jgx) <= 1e-4
    jg_state = coupling_params_from_flax(jax.tree_util.tree_map(np.asarray, jgp))
    for (name, _), g in zip(leaves.items(), grads[1:]):
        assert _rel(g, jg_state[name].numpy()) <= 1e-4, name


@pytest.mark.parametrize("transform_type,act_norm", CASES)
def test_untrained_flow_is_the_identity(transform_type, act_norm):
    flow, params = pc.make_coupling_flow(
        4, 3, (8,), transform_type, N_BINS, (LO, HI), act_norm, base_scale=2.0,
        generator=torch.Generator().manual_seed(0))
    assert any(float(v.abs().max()) > 0 for k, v in params.items() if "hidden" in k)
    u = 3.0 * torch.randn(16, 4, generator=torch.Generator().manual_seed(1))
    x, ld = flow.forward(params, u)
    np.testing.assert_allclose(npy(x), npy(u), atol=1e-5)
    np.testing.assert_allclose(npy(ld), 0.0, atol=1e-5)
    np.testing.assert_allclose(npy(flow.log_prob(params, u)),
                               npy(pc.normal_logpdf(u, 2.0)), atol=1e-5)


def test_hidden_init_is_truncated_lecun_normal():
    _, params = pc.make_coupling_flow(64, 2, (512,), "spline",
                                      generator=torch.Generator().manual_seed(0))
    w = params["conditioners.0.hidden.0.weight"]
    bound = 2.0 * np.sqrt(1.0 / 64) / 0.87962566103423978
    assert float(w.abs().max()) <= bound + 1e-6
    np.testing.assert_allclose(float(w.var()), 1.0 / 64, rtol=0.05)
    assert float(params["conditioners.0.head.weight"].abs().max()) == 0.0
