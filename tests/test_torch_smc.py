"""Port parity for the SMC stack: ``mfm_tpu_torch.smc`` and
``drivers/smc_run.py`` against ``mfm_tpu``'s, with the reference's draws
replayed by walking its key splits (resampling.py:20-95, base.py:43,
tempered.py:125,141, smc_run.py:89,216,224).

Tolerances: resampled indices identical; the ESS solve and the bisections
to 1e-6 (the same float32 arithmetic); one SMC step, tempered and
waste-free steps to 1e-5 on particles and weights; ``run_smc`` on 4-mode
(64 particles, 5 tempering steps, 2 harvest steps) to 1e-4 on particles,
lambda and log Z.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.config import MFMConfig as JConfig
from mfm_tpu.drivers.smc_run import run_smc as j_run_smc
from mfm_tpu.kernels import mala as jmala
from mfm_tpu.smc import base as jbase
from mfm_tpu.smc import ess as jess
from mfm_tpu.smc import resampling as jres
from mfm_tpu.smc import solvers as jsolvers
from mfm_tpu.smc import tempered as jtempered
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers.smc_run import build_smc
from mfm_tpu_torch.kernels import hmc, mala
from mfm_tpu_torch.smc import base, ess, resampling, solvers, tempered
from mfm_tpu_torch.smc.tempered import SMCStepNoise
from torch_parity import npy, tt

torch.set_num_threads(1)


def _resample_noise(name, key, num):
    """The draws the reference's resampler ``name`` takes from ``key``."""
    if name == "systematic":
        return tt(jax.random.uniform(key, ()))
    if name == "stratified":
        return tt(jax.random.uniform(key, (num,)))
    if name == "multinomial":
        return tt(jax.random.uniform(key, (num + 1,)))
    key_res, key_perm = jax.random.split(key)
    return (tt(jax.random.uniform(key_res, (num + 1,))),
            torch.from_numpy(np.array(jax.random.permutation(key_perm, num))).long())


@pytest.mark.parametrize("num", [64, 16])
@pytest.mark.parametrize("name", ["systematic", "stratified", "multinomial", "residual"])
def test_resamplers_match_reference(name, num):
    rng = np.random.default_rng(num)
    w = rng.exponential(size=64) ** 3  # uneven: some particles carry most weight
    w = (w / w.sum()).astype(np.float32)
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jres.get_resampler(name)(key, jnp.asarray(w), num))
        got = resampling.get_resampler(name)(_resample_noise(name, key, num),
                                              torch.from_numpy(w), num)
        np.testing.assert_array_equal(npy(got), want)
        assert got.dtype == torch.int64 and got.min() >= 0 and got.max() < 64


def test_resample_noise_shapes_and_unknown_name():
    gen = torch.Generator().manual_seed(0)
    assert resampling.draw_noise("systematic", gen, 8).shape == ()
    assert resampling.draw_noise("multinomial", gen, 8).shape == (9,)
    u, perm = resampling.draw_noise("residual", gen, 8)
    assert sorted(perm.tolist()) == list(range(8))
    with pytest.raises(ValueError, match="resampler"):
        resampling.get_resampler("optimal")


def test_ess_matches_reference():
    lw = np.random.default_rng(2).normal(size=100).astype(np.float32) * 3
    np.testing.assert_allclose(float(ess.log_ess(torch.from_numpy(lw))),
                               float(jess.log_ess(jnp.asarray(lw))), rtol=1e-6)
    np.testing.assert_allclose(float(ess.ess(torch.from_numpy(lw))),
                               float(jess.ess(jnp.asarray(lw))), rtol=1e-5)


@pytest.mark.parametrize("case", ["root", "saturated", "nan"])
def test_ess_solver_matches_reference(case):
    """A root inside the bracket; the whole remaining increment admissible
    (the solver returns max_delta); and an ESS target above N (f(0) < 0:
    NaN, which the adaptive kernel turns into 0)."""
    loglik = np.random.default_rng(3).normal(size=64).astype(np.float32) * 20
    max_delta, target = {"root": (0.7, 0.5), "saturated": (1e-5, 0.5), "nan": (0.7, 1.5)}[case]
    want = float(jess.ess_solver(jnp.asarray(loglik), target, max_delta, jsolvers.dichotomy))
    got = float(ess.ess_solver(torch.from_numpy(loglik), target, torch.tensor(max_delta),
                               solvers.dichotomy))
    if case == "nan":
        assert np.isnan(want) and np.isnan(got)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got == np.float32(max_delta)) == (case == "saturated")


@pytest.mark.parametrize("fn", ["linear", "steep", "nan_at_max"])
def test_dichotomy_matches_reference(fn):
    fns = {
        "linear": (lambda x: 0.3 - x, lambda x: 0.3 - x),
        "steep": (lambda x: jnp.exp(-20 * x) - 0.5, lambda x: torch.exp(-20 * x) - 0.5),
        # f(max) is NaN: the loop's condition is false at once and a = min
        "nan_at_max": (lambda x: jnp.where(x > 0.9, jnp.nan, 0.5 - x),
                       lambda x: torch.where(x > 0.9, torch.nan, 0.5 - x)),
    }
    jf, pf = fns[fn]
    want = float(jsolvers.dichotomy(jf, 0.0, 0.0, 1.0))
    got = float(solvers.dichotomy(pf, 0.0, 0.0, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_bisection_matches_reference():
    want = float(jsolvers.bisection(lambda b: jnp.exp(-5 * b) - 0.2, 0.0, 1.0))
    got = float(solvers.bisection(lambda b: torch.exp(-5 * b) - 0.2, 0.0, 1.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_smc_base_step_matches_reference():
    """resample -> move -> reweigh with a move made of the update key's
    normal draws, and the log normaliser's increment."""
    n, d = 32, 3
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.exponential(size=n).astype(np.float32)
    w /= w.sum()
    weigh_j = lambda p: -0.5 * jnp.sum((p - 1.0) ** 2, -1)
    weigh_p = lambda p: -0.5 * torch.sum((p - 1.0) ** 2, -1)
    key = jax.random.PRNGKey(5)
    jstate, jinfo = jbase.step(
        key, jbase.SMCState(jnp.asarray(x), jnp.asarray(w)),
        lambda k, p: (p + 0.1 * jax.random.normal(k, p.shape), None), weigh_j,
        jres.systematic,
    )
    key_update, key_resample = jax.random.split(key)
    pstate, pinfo = base.step(
        base.SMCState(torch.from_numpy(x), torch.from_numpy(w)),
        lambda p, eps: (p + 0.1 * eps, None), weigh_p, resampling.systematic,
        tt(jax.random.uniform(key_resample, ())), tt(jax.random.normal(key_update, (n, d))),
    )
    np.testing.assert_array_equal(npy(pinfo.ancestors), np.asarray(jinfo.ancestors))
    np.testing.assert_allclose(npy(pstate.particles), np.asarray(jstate.particles), atol=1e-5)
    np.testing.assert_allclose(npy(pstate.weights), np.asarray(jstate.weights), rtol=1e-5)
    np.testing.assert_allclose(float(pinfo.log_likelihood_increment),
                               float(jinfo.log_likelihood_increment), rtol=1e-5)


def _mala_moves(key, n_moves, m, d):
    """The reference's inner MALA draws for one SMC step's update key."""
    out = []
    for k in jax.random.split(key, n_moves):
        kn, ka = jax.random.split(k)
        out.append(mala.MalaNoise(tt(jax.random.normal(kn, (m, d))),
                                  tt(jax.random.uniform(ka, (m,)))))
    return out


@pytest.mark.parametrize("waste_free_p", [0, 4])
def test_tempered_step_matches_reference(waste_free_p):
    """One tempered step from lambda 0.2 to 0.5 on 4-mode with MALA (3
    moves, or waste-free with P = 4: 16 ancestors, 3 moves each, every
    state kept in chain-major order)."""
    n, d, step = 64, 2, 0.2
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    x = np.array(4.0 * jax.random.normal(jax.random.PRNGKey(6), (n, d)))
    w = np.full(n, 1.0 / n, np.float32)
    jk = jtempered.build_kernel(
        jtarget, lambda vs: (lambda k, s: jmala.build_kernel(vs)(k, s, step)), jmala.init,
        jres.systematic, num_mcmc_steps=3, waste_free_p=waste_free_p)
    key = jax.random.PRNGKey(7)
    jstate, jinfo = jk(key, jtempered.TemperedSMCState(jnp.asarray(x), jnp.asarray(w),
                                                       jnp.asarray(0.2)), 0.5)
    pk = tempered.build_kernel(
        ptarget, lambda vs: (lambda s, noise: mala.build_kernel(vs)(s, step, *noise)),
        mala.init, resampling.systematic, num_mcmc_steps=3, waste_free_p=waste_free_p)
    m = n // waste_free_p if waste_free_p else n
    key_update, key_resample = jax.random.split(key)
    noise = SMCStepNoise(tt(jax.random.uniform(key_resample, ())),
                         _mala_moves(key_update, 3, m, d))
    pstate, pinfo = pk(tempered.TemperedSMCState(torch.from_numpy(x), torch.from_numpy(w),
                                                 torch.tensor(0.2)), torch.tensor(0.5), noise)
    assert pstate.particles.shape == (n, d) and pinfo.update_info.shape == (3, m)
    np.testing.assert_array_equal(npy(pinfo.ancestors), np.asarray(jinfo.ancestors))
    np.testing.assert_allclose(npy(pstate.particles), np.asarray(jstate.particles), atol=1e-5)
    np.testing.assert_allclose(npy(pstate.weights), np.asarray(jstate.weights), rtol=1e-5)
    np.testing.assert_allclose(npy(pinfo.update_info), np.asarray(jinfo.update_info), atol=1e-5)
    np.testing.assert_allclose(float(pstate.lmbda), float(jstate.lmbda), rtol=1e-6)
    np.testing.assert_allclose(float(pinfo.log_likelihood_increment),
                               float(jinfo.log_likelihood_increment), rtol=1e-5)


def test_waste_free_p_one_is_refused():
    with pytest.raises(ValueError, match="waste_free_p=1"):
        tempered.build_kernel(pt.four_mode_mixture(), None, None, None, waste_free_p=1)


SMC_CFG = dict(example="4-mode", dim=2, num_chain=64, learning_iter=5, eval_iter=2, seed=0,
               step_size=0.2)


def _replayed_step_noise(key, cfg, d):
    key_update, key_resample = jax.random.split(key)
    m = cfg.num_chain // cfg.waste_free_p if cfg.waste_free_p else cfg.num_chain
    n_moves = cfg.waste_free_p - 1 if cfg.waste_free_p else cfg.iter_per_temp
    if cfg.mcmc_kernel == "mala":
        moves = _mala_moves(key_update, n_moves, m, d)
    else:
        moves = []
        for k in jax.random.split(key_update, n_moves):
            km, ka = jax.random.split(k)
            moves.append(hmc.HMCNoise(tt(jax.random.normal(km, (m, d))),
                                      tt(jax.random.uniform(ka, (m,)))))
    return SMCStepNoise(tt(jax.random.uniform(key_resample, ())), moves)


@pytest.mark.parametrize("extra", [
    {},
    # dual averaging feeds each step's acceptance back into the next step
    # size, which doubles an fp32 difference a step at early counts: fewer
    # steps, from a step size whose first updates stay tame
    {"mcmc_kernel": "hmc", "smc_path": "geometric", "waste_free_p": 4, "step_size": 1.2,
     "learning_iter": 4, "eval_iter": 1},
], ids=["mala", "hmc-geometric-waste-free"])
def test_run_smc_matches_reference(extra):
    """The whole driver under replayed keys: 5 adaptive tempering steps
    and the harvest of 2 (MALA at the preset step); 4 and 1 with HMC, its
    dual-averaged step and the particle-variance mass, on the geometric
    path, waste-free."""
    jcfg, pcfg = JConfig(**{**SMC_CFG, **extra}), MFMConfig(**{**SMC_CFG, **extra})
    jtarget = jt.four_mode_mixture()
    res = j_run_smc(jtarget, jcfg)
    key_init, key_run, key_harvest = jax.random.split(jax.random.PRNGKey(0), 3)
    pieces = build_smc(pt.four_mode_mixture(), pcfg)
    jpath = jt.GeometricPath(jtarget) if extra else jtarget
    carry = pieces.init_fn(tt(jpath.init_positions(key_init, pcfg.num_chain)))
    log_z, lmbdas = torch.zeros(()), []
    for k in jax.random.split(key_run, pcfg.learning_iter):
        carry, info = pieces.step_fn(carry, _replayed_step_noise(k, pcfg, 2))
        log_z = log_z + info.log_likelihood_increment
        lmbdas.append(float(carry.state.lmbda))
    lmbda = float(carry.state.lmbda)  # the anneal's, before the harvest
    harvest = []
    for k in jax.random.split(key_harvest, pcfg.eval_iter):
        carry, _ = pieces.step_fn(carry, _replayed_step_noise(k, pcfg, 2))
        harvest.append(carry.state.particles)
    assert 0 < lmbdas[0] < lmbdas[-1], "the anneal moves"
    np.testing.assert_allclose(lmbda, float(res.lmbda), atol=1e-4)
    np.testing.assert_allclose(float(log_z), float(res.log_z), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(npy(torch.cat(harvest)), np.asarray(res.particles), atol=1e-4)
