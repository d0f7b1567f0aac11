"""Port parity for the trajectory kernels and the adaptation:
``mfm_tpu_torch.kernels.{hmc,nuts}`` and ``mfm_tpu_torch.adaptation.window``
against ``mfm_tpu``'s, on 4-mode (d=2) and ``PhiFour(8)``, 16 chains.

The port's kernels take their noise as tensors; here it is the reference's
own draws, replayed by walking its key splits (hmc.py:60,63; nuts.py:177,
195-209 and the merge keys of :129 in pre-order for the static variant;
:303,432,340 for the iterative one). Three chained steps each, with a
diagonal inverse mass. Tolerances: positions, log densities and
acceptance to 1e-4 (fp32 through a few leapfrogs); accept masks, divergence
and u-turn flags and tree depths identical. Dual averaging, Welford and the
window schedule to 1e-6 (float32 arithmetic in the same order), and the
window adaptation's state over 150 steps to 1e-4.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.adaptation import window as jw
from mfm_tpu.kernels import ChainState as JChainState
from mfm_tpu.kernels import hmc as jhmc
from mfm_tpu.kernels import nuts as jnuts
from mfm_tpu_torch.adaptation import window as pw
from mfm_tpu_torch.kernels import ChainState, hmc, nuts
from torch_parity import npy, nuts_noise, tt

torch.set_num_threads(1)
B = 16

# (reference target, port target, (HMC step, NUTS step)): steps at which
# HMC rejects some proposals and NUTS trees end at several depths
TARGETS = {
    "4-mode": (jt.four_mode_mixture, pt.four_mode_mixture, (0.8, 0.4)),
    "phi-four": (lambda: jt.PhiFour(8), lambda: pt.PhiFour(8), (0.08, 0.05)),
}


def _setup(name, seed=0):
    jfac, pfac, step = TARGETS[name]
    jtarget, ptarget = jfac(), pfac()
    d = ptarget.dim
    key = jax.random.PRNGKey(seed)
    k0, k1 = jax.random.split(key)
    x0 = (2.0 if name == "4-mode" else 0.6) * jax.random.normal(k0, (B, d))
    if name == "4-mode":
        x0 = x0 + 8.0 * jnp.sign(jax.random.normal(k1, (B, d)))
    inv_mass = 0.5 + jax.random.uniform(jax.random.fold_in(key, 3), (d,))
    jstate = JChainState(x0, *jtarget.value_and_score(x0))
    pstate = ChainState(tt(x0), *ptarget.value_and_score(tt(x0)))
    return jtarget, ptarget, jstate, pstate, inv_mass, step


def _close(pstate, jstate, atol=1e-4):
    np.testing.assert_allclose(npy(pstate.position), np.asarray(jstate.position), atol=atol)
    np.testing.assert_allclose(npy(pstate.logdensity), np.asarray(jstate.logdensity),
                               rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", list(TARGETS))
def test_hmc_matches_reference(name):
    jtarget, ptarget, jstate, pstate, inv_mass, (step, _) = _setup(name)
    jk = jax.jit(jhmc.build_kernel(jtarget.value_and_score), static_argnums=3)
    pk = hmc.build_kernel(ptarget.value_and_score)
    seen = set()
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jstate, jinfo = jk(key, jstate, step, 5, inv_mass)
        key_mom, key_acc = jax.random.split(key)
        noise = hmc.HMCNoise(tt(jax.random.normal(key_mom, (B, ptarget.dim))),
                             tt(jax.random.uniform(key_acc, (B,))))
        pstate, pinfo = pk(pstate, step, 5, tt(inv_mass), *noise)
        _close(pstate, jstate)
        np.testing.assert_allclose(npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
        np.testing.assert_array_equal(npy(pinfo.is_divergent), np.asarray(jinfo.is_divergent))
        seen.update(np.asarray(jinfo.is_accepted).tolist())
    assert seen == {True, False}, "the steps accept some chains and reject others"


def _nuts_noise(key, d, depth, variant):
    return nuts_noise(key, B, d, depth, variant)


@pytest.mark.parametrize("variant", ["static", "iterative"])
@pytest.mark.parametrize("name", list(TARGETS))
def test_nuts_matches_reference(name, variant):
    depth = 3
    jtarget, ptarget, jstate, pstate, inv_mass, (_, step) = _setup(name, seed=1)
    jk = jax.jit(jnuts.build_kernel(jtarget.value_and_score, depth, variant=variant))
    pk = nuts.build_kernel(ptarget.value_and_score, depth, variant=variant)
    depths, turned = set(), set()
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        jstate, jinfo = jk(key, jstate, step, inv_mass)
        noise = _nuts_noise(key, ptarget.dim, depth, variant)
        assert noise.tree_u.shape[0] == nuts.tree_offset(depth, variant)
        pstate, pinfo = pk(pstate, step, tt(inv_mass), noise)
        _close(pstate, jstate)
        np.testing.assert_allclose(npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(npy(pinfo.energy), np.asarray(jinfo.energy), rtol=1e-4,
                                   atol=1e-3)
        for f in ("is_divergent", "is_turning", "num_doublings"):
            np.testing.assert_array_equal(npy(getattr(pinfo, f)), np.asarray(getattr(jinfo, f)),
                                          err_msg=f)
        depths.update(np.asarray(jinfo.num_doublings).tolist())
        turned.update(np.asarray(jinfo.is_turning).tolist())
    assert len(depths) > 1 and True in turned, "trees of several depths, some ending in a u-turn"


def test_nuts_marks_divergence_like_the_reference():
    """A step far too large for phi-four: every trajectory diverges at once."""
    jtarget, ptarget, jstate, pstate, inv_mass, _ = _setup("phi-four", seed=2)
    key = jax.random.PRNGKey(7)
    for variant in ("static", "iterative"):
        jstate2, jinfo = jnuts.build_kernel(jtarget.value_and_score, 3, variant=variant)(
            key, jstate, 1.0, inv_mass)
        pstate2, pinfo = nuts.build_kernel(ptarget.value_and_score, 3, variant=variant)(
            pstate, 1.0, tt(inv_mass), _nuts_noise(key, 8, 3, variant))
        assert bool(np.asarray(jinfo.is_divergent).all())
        np.testing.assert_array_equal(npy(pinfo.is_divergent), np.asarray(jinfo.is_divergent))
        np.testing.assert_array_equal(npy(pinfo.num_doublings), np.asarray(jinfo.num_doublings))
        _close(pstate2, jstate2)


def test_nuts_variant_resolution():
    assert nuts.resolve_variant(6) == "static" and nuts.resolve_variant(7) == "iterative"
    assert nuts.resolve_variant(3, "iterative") == "iterative"
    with pytest.raises(ValueError, match="variant"):
        nuts.resolve_variant(3, "recursive")
    gen = torch.Generator().manual_seed(0)
    for variant, rows in (("static", 2**6 - 1 - 6), ("iterative", 2**6 - 1)):
        noise = nuts.draw_noise(gen, 4, 3, 6, variant)
        assert noise.tree_u.shape == (rows, 4) and noise.direction_u.shape == (6, 4)


def test_dual_averaging_matches_reference():
    jda, pda = jw.da_init(0.3), pw.da_init(0.3)
    rng = np.random.default_rng(0)
    for _ in range(40):
        acc = float(rng.uniform())
        jda, pda = jw.da_update(jda, acc, 0.8), pw.da_update(pda, torch.tensor(acc), 0.8)
    for a, b in zip(pda, jda):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-6)


def test_welford_matches_reference():
    rng = np.random.default_rng(1)
    jwf, pwf = jw.welford_init(5), pw.welford_init(5)
    for n in (7, 16, 16, 3):
        batch = (rng.normal(size=(n, 5)) * [1, 2, 3, 0.5, 10] + 4).astype(np.float32)
        jwf, pwf = jw.welford_update_batch(jwf, jnp.asarray(batch)), pw.welford_update_batch(
            pwf, torch.from_numpy(batch))
    assert pwf.count == int(jwf.count) == 42
    np.testing.assert_allclose(npy(pwf.mean), np.asarray(jwf.mean), rtol=1e-6)
    np.testing.assert_allclose(npy(pwf.m2), np.asarray(jwf.m2), rtol=1e-6)
    for reg in (True, False):
        np.testing.assert_allclose(npy(pw.welford_variance(pwf, reg)),
                                   np.asarray(jw.welford_variance(jwf, reg)), rtol=1e-6)


@pytest.mark.parametrize("n", [10, 24, 150, 400, 1000])
def test_build_schedule_matches_reference(n):
    ps, pe = pw.build_schedule(n)
    js, je = jw.build_schedule(n)
    np.testing.assert_array_equal(ps, np.asarray(js))
    np.testing.assert_array_equal(pe, np.asarray(je))


class _Info(NamedTuple):
    acceptance_rate: object


def test_window_adaptation_matches_reference():
    """The window machinery over 150 steps (two slow windows, re-anchoring,
    mass refreshes) with a stand-in kernel whose acceptance is its uniform
    draw and whose move is ``step * sqrt(inv_mass) * eps``: dual averaging
    gets the same acceptances on both sides, and the mass feeds the moves.
    (With a real kernel, dual averaging's feedback at early counts doubles
    any fp32 difference every step; the kernels are held above.) The step
    size, the inverse mass, the positions and the acceptances to 1e-4."""
    n_steps, d = 150, 3
    x0 = jax.random.normal(jax.random.PRNGKey(3), (B, d))
    scale = jnp.asarray([0.5, 1.0, 3.0])

    def jkern(key, state, h, m):
        ke, ku = jax.random.split(key)
        pos = state.position + h * jnp.sqrt(m) * scale * jax.random.normal(ke, (B, d))
        return JChainState(pos, state.logdensity, state.logdensity_grad), _Info(
            jax.random.uniform(ku, (B,)))

    def pkern(state, h, m, eps, u):
        pos = state.position + h * torch.sqrt(m) * tt(scale) * eps
        return ChainState(pos, state.logdensity, state.logdensity_grad), _Info(u)

    zeros = lambda x: (x[:, 0] * 0, x * 0)
    run = jw.window_adaptation(jkern, lambda x: JChainState(x, *zeros(x)), n_steps, 0.3).run
    key = jax.random.PRNGKey(4)
    jstate, (jstep, jmass), jacc = jax.jit(run)(key, x0)
    noises = []
    for k in jax.random.split(key, n_steps):
        ke, ku = jax.random.split(k)
        noises.append((tt(jax.random.normal(ke, (B, d))), tt(jax.random.uniform(ku, (B,)))))
    prun = pw.window_adaptation(pkern, lambda x: ChainState(x, *zeros(x)), n_steps, 0.3)
    pstate, (pstep, pmass), pacc = prun(tt(x0), noises)
    np.testing.assert_allclose(npy(pacc), np.asarray(jacc), rtol=1e-6)
    np.testing.assert_allclose(float(pstep), float(jstep), rtol=1e-4)
    np.testing.assert_allclose(npy(pmass), np.asarray(jmass), rtol=1e-4)
    np.testing.assert_allclose(npy(pstate.position), np.asarray(jstate.position), rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(np.asarray(jmass), 1.0), "the mass was adapted"
