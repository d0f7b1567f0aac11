"""Port parity: the standalone TESS and CIS kernels (kernels/tess.py,
kernels/cis.py) and the sampler loop (kernels/base.py) against mfm_tpu's.

JAX's own draws are replayed: each test splits the key as the reference
kernel does and hands the port the draws as its noise tuple (TESS: the
momentum, the slice height, the first angle and one row of uniforms a
shrink trip, each trip's from the next split of the loop key; CIS: the
fresh candidates and the Gumbel noise of ``jax.random.categorical``).

Tolerances: 1e-5 with the identity or an affine flow (the same fp32
elementwise arithmetic); 1e-4 through a CNF transport (4 RK4 steps of a
field evaluated with sums in another order; the logdet sums d divergence
terms a stage). The integer shrink counts and the chosen candidates are
held exactly. The statistical tests are the reference's
(tests/test_kernels_extra.py) on torch alone, at its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.kernels import cis as jcis, tess as jtess
from mfm_tpu_torch.flows import make_transport, module_tangent_field
from mfm_tpu_torch.kernels import SamplingAlgorithm, cis, inference_loop, tess
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)


def tess_noise(key, B, d, max_subiter=100) -> tess.TESSNoise:
    """The draws the reference's TESS kernel takes from ``key``
    (mfm_tpu/kernels/tess.py:172-207)."""
    key_mom, key_y, key_theta, key_loop = jax.random.split(key, 4)

    def trip(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, (B,))

    _, shrink = jax.lax.scan(trip, key_loop, None, length=max_subiter)
    return tess.TESSNoise(tt(jax.random.normal(key_mom, (B, d))),
                          tt(jax.random.uniform(key_y, (B,))),
                          tt(jax.random.uniform(key_theta, (B,))), tt(shrink))


def cis_noise(key, B, N, d) -> cis.CISNoise:
    """The draws of the reference's CIS kernel (mfm_tpu/kernels/cis.py:55-73):
    categorical(key_pick, log_w, axis=1) is argmax(gumbel(key_pick, (B, N+1))
    + log_w)."""
    key_gen, key_pick = jax.random.split(key)
    return cis.CISNoise(tt(jax.random.normal(key_gen, (B, N, d))),
                        tt(jax.random.gumbel(key_pick, (B, N + 1))))


def identity_pair():
    return (lambda u: (u, jnp.zeros(u.shape[:1], u.dtype)),
            lambda u: (u, torch.zeros(u.shape[:1], dtype=u.dtype)))


def affine_pair():
    ld = 2.0 * float(np.log(np.float32(2.0)))
    return (lambda u: (2.0 * u + 0.5, jnp.full(u.shape[:1], ld, u.dtype)),
            lambda u: (2.0 * u + 0.5, torch.full(u.shape[:1], ld, dtype=u.dtype)))


def transport_pair(d):
    """A CNF flow (widths 8, F = 4, 4 RK4 steps, exact divergence) in both
    packages on the same parameters."""
    net_j, params, freqs = flax_field(jax.random.PRNGKey(3), d, 8, 4, "tanh")
    net_p, pparams = torch_field(params, freqs, d, 8, "tanh")
    jtr = j_transport(net_j.apply, divergence="exact", n_steps=4)
    ptr = make_transport(module_tangent_field(net_p), divergence="exact", n_steps=4)
    return (lambda u: jtr.forward(params, u)), (lambda u: ptr.forward(pparams, u))


FLOWS = {"identity": (identity_pair, 1e-5), "affine": (affine_pair, 1e-5),
         "transport": (lambda: transport_pair(2), 1e-4)}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_tess_step_matches(flow):
    make, tol = FLOWS[flow]
    jflow, pflow = make()
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    B, d = 16, 2
    u0 = np.random.default_rng(0).standard_normal((B, d)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    js, ji = jtess.build_kernel()(key, jtess.init(jnp.asarray(u0)), jtarget.log_prob, jflow)
    with torch.no_grad():
        ps, pi = tess.build_kernel()(tess.init(tt(u0)), ptarget.log_prob, pflow,
                                     tess_noise(key, B, d))
    np.testing.assert_array_equal(npy(pi.subiter), np.asarray(ji.subiter))
    assert int(np.max(np.asarray(ji.subiter))) >= 2  # the shrink loop ran
    for got, ref in ((ps.position, js.position), (ps.pullback_position, js.pullback_position),
                     (pi.theta, ji.theta), (pi.slice_value, ji.slice_value),
                     (pi.momentum, ji.momentum)):
        np.testing.assert_allclose(npy(got), np.asarray(ref), atol=tol, rtol=tol)


def test_tess_stops_at_max_subiter():
    """A slice no proposal reaches (a NaN density) shrinks for exactly
    max_subiter trips, as the reference's loop bound does."""
    B, d, n = 8, 2, 5
    nan_target = lambda x: torch.full(x.shape[:1], torch.nan)
    gen = torch.Generator().manual_seed(0)
    _, info = tess.build_kernel(max_subiter=n)(
        tess.init(torch.randn(B, d, generator=gen)), nan_target, identity_pair()[1], gen)
    assert torch.equal(info.subiter, torch.full((B,), n + 1, dtype=torch.int32))


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cis_step_matches(flow):
    make, tol = FLOWS[flow]
    jflow, pflow = make()
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    B, N, d = 16, 4, 2
    u0 = np.random.default_rng(1).standard_normal((B, d)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    js, ji = jcis.build_kernel(N)(key, jcis.init(jnp.asarray(u0)), jtarget.log_prob, jflow)
    with torch.no_grad():
        ps, pi = cis.build_kernel(N)(cis.init(tt(u0)), ptarget.log_prob, pflow,
                                     cis_noise(key, B, N, d))
    pick = lambda pos, cand: np.argmin(np.abs(np.asarray(cand) - np.asarray(pos)[:, None]).sum(-1),
                                       axis=1)
    jchoice, pchoice = pick(js.pullback_position, ji.pullback_positions), pick(
        npy(ps.pullback_position), npy(pi.pullback_positions))
    np.testing.assert_array_equal(pchoice, jchoice)
    assert len(set(jchoice.tolist())) > 1  # the pick is not the same slot everywhere
    np.testing.assert_allclose(npy(pi.log_weights), np.asarray(ji.log_weights), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(npy(ps.position), np.asarray(js.position), atol=tol, rtol=tol)
    np.testing.assert_allclose(npy(pi.positions), np.asarray(ji.positions), atol=tol, rtol=tol)


def test_cis_nan_weight_is_never_picked():
    """A NaN log-weight counts as -inf: a candidate the target scores NaN
    is never chosen."""
    B, N, d = 64, 3, 2
    gen = torch.Generator().manual_seed(2)
    logp = lambda x: torch.where(x[:, 0] > 0, torch.nan, -0.5 * torch.sum(x * x, -1))
    new, info = cis.build_kernel(N)(cis.init(-torch.rand(B, d, generator=gen) - 0.1), logp,
                                    identity_pair()[1], gen)
    assert bool((new.position[:, 0] <= 0).all())
    assert bool(torch.isneginf(info.log_weights).any())


def test_inference_loop_stacks_states_and_infos():
    B, d, n = 8, 2, 3
    algo = tess.tess(pt.IndepGaussian(d).log_prob, identity_pair()[1])
    assert isinstance(algo, SamplingAlgorithm)
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(B, d, generator=gen)
    states, infos = inference_loop(gen, algo.step, algo.init(x0), n)
    assert states.position.shape == (n, B, d) and infos.subiter.shape == (n, B)
    # the same loop on injected noise, step by step
    noises = [tess.draw_noise(torch.Generator().manual_seed(k), B, d) for k in range(n)]
    states2, _ = inference_loop(noises, algo.step, algo.init(x0), n)
    s = algo.init(x0)
    for k in range(n):
        s, _ = algo.step(noises[k], s)
    assert torch.equal(states2.position[-1], s.position)


# The reference's statistical tests (tests/test_kernels_extra.py), on torch.

def _run(kernel, target, flow, state, gen, n_steps):
    positions = []
    for _ in range(n_steps):
        state, _ = kernel(state, target.log_prob, flow, gen)
        positions.append(state.position)
    return torch.stack(positions)


def test_tess_identity_flow_gaussian_invariance():
    gen = torch.Generator().manual_seed(0)
    n_chain, n_steps = 256, 400
    positions = _run(tess.build_kernel(), pt.IndepGaussian(2), identity_pair()[1],
                     tess.init(torch.randn(n_chain, 2, generator=gen)), gen, n_steps)
    pool = npy(positions[n_steps // 2:].reshape(-1, 2))
    np.testing.assert_allclose(pool.mean(axis=0), 0.0, atol=0.06)
    np.testing.assert_allclose(pool.var(axis=0), 1.0, atol=0.12)


def test_tess_always_accepts_eventually():
    gen = torch.Generator().manual_seed(0)
    new, info = tess.build_kernel()(tess.init(torch.randn(64, 2, generator=gen)),
                                    pt.four_mode_mixture().log_prob, identity_pair()[1], gen)
    assert bool(torch.isfinite(new.position).all()) and bool((info.subiter >= 1).all())


def test_tess_affine_flow_targets_pushforward():
    """With x = 2u (logdet = d log 2), x follows the target."""
    gen = torch.Generator().manual_seed(0)
    ld = 2.0 * float(np.log(2.0))
    flow = lambda u: (2.0 * u, torch.full(u.shape[:1], ld))
    positions = _run(tess.build_kernel(), pt.IndepGaussian(2, mean=1.0, var=4.0), flow,
                     tess.init(torch.randn(256, 2, generator=gen)), gen, 400)
    pool = npy(positions[200:].reshape(-1, 2))
    np.testing.assert_allclose(pool.mean(axis=0), 1.0, atol=0.1)
    np.testing.assert_allclose(pool.var(axis=0), 4.0, rtol=0.15)


def test_cis_identity_flow_gaussian():
    gen = torch.Generator().manual_seed(0)
    positions = _run(cis.build_kernel(32), pt.IndepGaussian(1, mean=0.5, var=0.25),
                     identity_pair()[1], cis.init(torch.randn(512, 1, generator=gen)), gen, 50)
    pool = npy(positions[25:].reshape(-1))
    np.testing.assert_allclose(pool.mean(), 0.5, atol=0.03)
    np.testing.assert_allclose(pool.var(), 0.25, rtol=0.1)


def test_cis_weights_and_selection_shapes():
    gen = torch.Generator().manual_seed(0)
    algo = cis.cis(pt.four_mode_mixture().log_prob, identity_pair()[1], 4)
    new, info = algo.step(gen, algo.init(torch.randn(8, 2, generator=gen)))
    assert info.positions.shape == (8, 5, 2) and info.log_weights.shape == (8, 5)
    assert new.position.shape == (8, 2)
    diffs = torch.abs(info.positions - new.position[:, None]).sum(-1)
    assert bool((diffs.min(dim=1).values < 1e-6).all())
