"""Port parity: SVGD and coin-SVGD (vi/svgd.py), COCOB
(optimizers/cocob.py), optax's sgd (flows/train.py), the optimizer loop,
cross-chain and parallel-ECA adaptation, ATESS, MSC and MSC-MALA
(adaptation/), SNPE-A (sbi/snpe.py) and the profiling helpers
(utils/profiling.py) against mfm_tpu's.

JAX's draws are replayed: each test splits the keys as the reference
function does and hands the port the draws as its noise (one entry a
step, a batch or a simulation). The flows are a tiny CNF (widths 8, F = 4,
4 RK4 steps, exact divergence) in both packages on the same parameters.

Tolerances: 1e-6 for COCOB over 50 steps, the median heuristic and the
optimizer loop (the same fp32 elementwise arithmetic); 1e-5 for one SVGD
step (three (N, N) x (N, d) products in another summation order) and
SNPE-A (a sum of 64 terms); 1e-4 for the warmups through a transport over
2-3 steps (the transport's fp32 sums in another order, carried through a
gradient step and the next move). The statistical tests are the
reference's (tests/test_vi_adaptation.py) on torch alone, at its
tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.adaptation import atess as j_atess, cross_chain as j_cross_chain
from mfm_tpu.adaptation import msc as j_msc, msc_mala as j_msc_mala
from mfm_tpu.adaptation import optimize as j_optimize, parallel_eca as j_parallel_eca
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.kernels import mala as jmala
from mfm_tpu.optimizers import cocob as j_cocob
from mfm_tpu.sbi import SNPE_A as J_SNPE_A
from mfm_tpu.vi import coin_svgd as j_coin_svgd, median_heuristic as j_median
from mfm_tpu.vi import svgd as j_svgd
from mfm_tpu_torch.adaptation import (
    atess,
    cross_chain,
    msc,
    msc_mala,
    optimize,
    parallel_eca,
)
from mfm_tpu_torch.adaptation.chain_adaptation import _rotate
from mfm_tpu_torch.adaptation.msc import step_generator
from mfm_tpu_torch.adaptation.msc_mala import MSCMalaNoise
from mfm_tpu_torch.flows import adam, make_transport, module_tangent_field, sgd
from mfm_tpu_torch.kernels import mala
from mfm_tpu_torch.optimizers import cocob
from mfm_tpu_torch.sbi import SNPE_A
from mfm_tpu_torch.utils import profiling
from mfm_tpu_torch.utils.convert import params_from_flax
from mfm_tpu_torch.vi import coin_svgd, median_heuristic, svgd
from test_torch_tess_cis import cis_noise, tess_noise
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)


def mala_noise(key, B, d) -> mala.MalaNoise:
    """The reference MALA kernel's draws (mfm_tpu/kernels/mala.py:61-64)."""
    key_noise, key_accept = jax.random.split(key)
    return mala.MalaNoise(tt(jax.random.normal(key_noise, (B, d))),
                          tt(jax.random.uniform(key_accept, (B,))))


def assert_tree_close(got: dict, ref, tol):
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, ref))
    for k, v in ref.items():
        np.testing.assert_allclose(npy(got[k]), npy(v), atol=tol, rtol=tol, err_msg=k)


# ---------------------------------------------------------------- optimizers

def test_sgd_matches_optax():
    g = {"a": torch.tensor([1.0, -2.0]), "b": torch.tensor(3.0)}
    updates, _ = sgd(0.3).update(g, sgd(0.3).init(g))
    jg = {"a": jnp.array([1.0, -2.0]), "b": jnp.array(3.0)}
    ref, _ = optax.sgd(0.3).update(jg, optax.sgd(0.3).init(jg))
    for k in g:
        np.testing.assert_array_equal(npy(updates[k]), np.asarray(ref[k]))


def test_cocob_matches_over_50_steps():
    target = np.array([1.0, -0.5, 2.0], np.float32)
    w0 = np.array([5.0, -3.0, 0.0], np.float32)
    jopt, popt = j_cocob(), cocob()
    jw, pw = jnp.asarray(w0), {"w": tt(w0)}
    js, ps = jopt.init(jw), popt.init(pw)
    for _ in range(50):
        ju, js = jopt.update(2.0 * (jw - target), js, jw)
        jw = optax.apply_updates(jw, ju)
        pu, ps = popt.update({"w": 2.0 * (pw["w"] - tt(target))}, ps, pw)
        pw = {"w": pw["w"] + pu["w"]}
    np.testing.assert_allclose(npy(pw["w"]), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(npy(ps.reward["w"]), np.asarray(js.reward), rtol=1e-6,
                               atol=1e-6)


def test_cocob_requires_params():
    opt = cocob()
    with pytest.raises(ValueError, match="requires params"):
        opt.update(torch.ones(2), opt.init(torch.zeros(2)))


def test_cocob_minimizes_quadratic():
    opt = cocob()
    w = torch.tensor([5.0, -3.0])
    state = opt.init(w)
    for _ in range(200):
        updates, state = opt.update(2.0 * (w - 1.0), state, w)
        w = w + updates
    np.testing.assert_allclose(npy(w), 1.0, atol=0.05)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_optimize_holds_a_nonfinite_step(opt):
    """The loss turns NaN once p[0] passes 1 (log of a negative): that step
    and every later one keep params and optimizer state, and report NaN."""
    jopt, popt = (optax.sgd(0.3), sgd(0.3)) if opt == "sgd" else (optax.adam(0.6), adam(0.6))
    x = np.array([2.0, -1.0], np.float32)
    jloss = lambda p, x: jnp.sum((p["w"] - x) ** 2) + jnp.log(1.0 - p["w"][0])
    ploss = lambda p, x: torch.sum((p["w"] - x) ** 2) + torch.log(1.0 - p["w"][0])
    jp = {"w": jnp.zeros(2)}
    (jp, js), jl = j_optimize(jp, jopt.init(jp), jloss, jopt, 6, positions=jnp.asarray(x))
    pp = {"w": torch.zeros(2)}
    (pp, ps), pl = optimize(pp, popt.init(pp), ploss, popt, 6, positions=tt(x))
    jl, pl = np.asarray(jl), npy(pl)
    np.testing.assert_array_equal(np.isnan(pl), np.isnan(jl))
    assert np.isnan(pl[-1]) and not np.isnan(pl[0])
    np.testing.assert_allclose(pl[~np.isnan(pl)], jl[~np.isnan(jl)], rtol=1e-6)
    np.testing.assert_allclose(npy(pp["w"]), np.asarray(jp["w"]), rtol=1e-6)
    n_ok = int(np.argmax(np.isnan(pl)))  # the first step whose loss is NaN
    (held, _), _ = optimize({"w": torch.zeros(2)}, popt.init({"w": torch.zeros(2)}), ploss, popt,
                            n_ok, positions=tt(x))
    assert torch.equal(pp["w"], held["w"])  # every later step kept the params
    if opt == "adam":
        adam_state = js[0]  # optax.adam: (ScaleByAdamState, EmptyState)
        assert int(ps.count) == int(adam_state.count) == n_ok
        np.testing.assert_allclose(npy(ps.mu["w"]), np.asarray(adam_state.mu["w"]), rtol=1e-6)


def test_optimize_key_mode_takes_one_noise_a_step():
    """key= mode: loss(params, key_k) for the k-th split key; the port
    takes the k-th entry of the injected noise, or the generator."""
    key = jax.random.PRNGKey(4)
    jloss = lambda p, k: jnp.sum((p["w"] - jax.random.normal(k, (3,))) ** 2)
    jp = {"w": jnp.zeros(3)}
    (jp, _), jl = j_optimize(jp, optax.adam(0.1).init(jp), jloss, optax.adam(0.1), 4, key=key)
    noise = [tt(jax.random.normal(k, (3,))) for k in jax.random.split(key, 4)]
    ploss = lambda p, e: torch.sum((p["w"] - e) ** 2)
    pp = {"w": torch.zeros(3)}
    (pp, _), pl = optimize(pp, adam(0.1).init(pp), ploss, adam(0.1), 4, noise=noise)
    np.testing.assert_allclose(npy(pl), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(npy(pp["w"]), np.asarray(jp["w"]), rtol=1e-6, atol=1e-7)
    drawn = lambda p, g: torch.sum((p["w"] - torch.randn(3, generator=g)) ** 2)
    (_, _), gl = optimize(pp, adam(0.1).init(pp), drawn, adam(0.1), 4,
                          noise=torch.Generator().manual_seed(0))
    assert gl.shape == (4,) and bool(torch.isfinite(gl).all())


# ---------------------------------------------------------------------- SVGD

@pytest.mark.parametrize("N", [8, 7, 9])  # 28 and 36 pairs (even), 21 (odd)
def test_median_heuristic_matches(N):
    p = np.random.default_rng(N).standard_normal((N, 3)).astype(np.float32)
    np.testing.assert_allclose(float(median_heuristic(tt(p))), float(j_median(jnp.asarray(p))),
                               rtol=1e-6)


def test_median_heuristic_takes_the_mean_of_the_middle_pair():
    p = torch.tensor([[0.0], [1.0], [3.0], [7.0]])  # distances 1 2 3 4 6 7
    assert float(median_heuristic(p)) == pytest.approx(3.5**2 / np.log(4.0), rel=1e-6)


@pytest.mark.parametrize("algo", ["svgd", "coin_svgd"])
def test_svgd_step_matches(algo):
    jtarget, ptarget = jt.IndepGaussian(2, mean=2.0), pt.IndepGaussian(2, mean=2.0)
    x = np.random.default_rng(3).standard_normal((16, 2)).astype(np.float32)
    if algo == "svgd":
        ja, pa = j_svgd(jtarget.score, optax.sgd(0.3)), svgd(ptarget.score, sgd(0.3))
    else:
        ja, pa = j_coin_svgd(jtarget.score), coin_svgd(ptarget.score)
    js, ps = ja.init(jnp.asarray(x)), pa.init(tt(x))
    for _ in range(2):
        js, ps = ja.step(js), pa.step(ps)
    np.testing.assert_allclose(npy(ps.particles), np.asarray(js.particles), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(ps.kernel_parameters["length_scale"]),
                               float(js.kernel_parameters["length_scale"]), rtol=1e-5)


def test_svgd_converges_to_gaussian():
    target = pt.IndepGaussian(2, mean=2.0, var=1.0)
    algo = svgd(target.score, sgd(0.3))
    state = algo.init(torch.randn(128, 2, generator=torch.Generator().manual_seed(0)) - 2.0)
    for _ in range(300):
        state = algo.step(state)
    particles = npy(state.particles)
    np.testing.assert_allclose(particles.mean(axis=0), 2.0, atol=0.1)
    assert 0.5 < particles.var(axis=0).mean() < 1.5


def test_coin_svgd_converges():
    target = pt.IndepGaussian(2, mean=-1.0, var=0.5)
    algo = coin_svgd(target.score)
    state = algo.init(torch.randn(64, 2, generator=torch.Generator().manual_seed(0)) + 1.0)
    for _ in range(200):
        state = algo.step(state)
    np.testing.assert_allclose(npy(state.particles).mean(axis=0), -1.0, atol=0.2)


def test_median_heuristic_positive():
    assert float(median_heuristic(torch.randn(32, 3))) > 0


# -------------------------------------------------------------------- SNPE-A

def test_snpe_a_loss_and_gradient_match():
    key, n = jax.random.PRNGKey(6), 64
    j_prior = lambda k: jax.random.normal(k, (2,))
    j_lik = lambda k, theta: theta + 0.1 * jax.random.normal(k, (2,))
    j_logprob = lambda params, theta, data: -0.5 * jnp.sum((data - theta - params) ** 2)
    jloss = J_SNPE_A(j_logprob, 1, j_lik, j_prior).get_loss_function(key, n)
    params = np.array([0.3, -0.2], np.float32)
    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(params))
    # the simulations' draws (mfm_tpu/sbi/snpe.py: split(key, n), then each
    # key into its prior and likelihood keys), handed to the batched port
    pairs = jax.vmap(jax.random.split)(jax.random.split(key, n))
    thetas = tt(jax.vmap(j_prior)(pairs[:, 0]))
    eps = tt(jax.vmap(lambda k: jax.random.normal(k, (2,)))(pairs[:, 1]))
    p_prior = lambda gen, m: thetas[:m]
    p_lik = lambda gen, theta: theta + 0.1 * eps
    p_logprob = lambda params, theta, data: -0.5 * torch.sum((data - theta - params) ** 2, -1)
    ploss = SNPE_A(p_logprob, 1, p_lik, p_prior).get_loss_function(torch.Generator(), n)
    pparams = tt(params).requires_grad_(True)
    pval = ploss(pparams)
    (pgrad,) = torch.autograd.grad(pval, pparams)
    np.testing.assert_allclose(float(pval.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(npy(pgrad), np.asarray(jgrad), rtol=1e-5, atol=1e-5)


def test_snpe_a_loss_from_a_generator_is_finite():
    prior = lambda gen, n: torch.randn((n, 2), generator=gen)
    lik = lambda gen, theta: theta + 0.1 * torch.randn(theta.shape, generator=gen)
    logprob = lambda params, theta, data: -0.5 * torch.sum((data - theta - params) ** 2, -1)
    loss = SNPE_A(logprob, 1, lik, prior).get_loss_function(
        torch.Generator().manual_seed(0), 64)
    params = torch.zeros(2, requires_grad=True)
    val = loss(params)
    (grad,) = torch.autograd.grad(val, params)
    assert bool(torch.isfinite(val)) and bool(torch.isfinite(grad).all())


# ---------------------------------------------------- chain adaptation (MALA)

def _mala_pair(parameter_gn_j, parameter_gn_p):
    """A MALA kernel whose step is the adapted parameter, in both packages;
    a large step moves the chains visibly."""
    jtarget, ptarget = jt.IndepGaussian(2), pt.IndepGaussian(2)
    jk, pk = jmala.build_kernel(jtarget.value_and_score), mala.build_kernel(
        ptarget.value_and_score)
    jfactory = lambda step_size: (lambda key, s: jk(key, s, step_size))
    pfactory = lambda step_size: (lambda n, s: pk(s, step_size, n.noise, n.u_accept))
    return (jtarget, jfactory, parameter_gn_j), (ptarget, pfactory, parameter_gn_p)


def test_cross_chain_matches():
    (jtarget, jfac, jgn), (ptarget, pfac, pgn) = _mala_pair(
        lambda s, step, h: (0.3 + 0.05 * jnp.mean(s.position**2),),
        lambda s, step, h: (0.3 + 0.05 * torch.mean(s.position**2),))
    x = np.random.default_rng(0).standard_normal((32, 2)).astype(np.float32)
    jinit, jup = j_cross_chain(jfac, jgn, 32)
    pinit, pup = cross_chain(pfac, pgn, 32)
    js = jinit(jmala.init(jnp.asarray(x), jtarget.value_and_score))
    ps = pinit(mala.init(tt(x), ptarget.value_and_score))
    key = jax.random.PRNGKey(2)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        js, jp, _ = jup(k, js, 0.5)
        ps, pp, _ = pup(mala_noise(k, 32, 2), ps, 0.5)
    assert ps.step == 3
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(pp[0]), float(jp[0]), rtol=1e-6)


def test_cross_chain_shape_check():
    init, _ = cross_chain(lambda *a: None, lambda *a: a, 16)
    with pytest.raises(ValueError):
        init(mala.ChainState(torch.zeros(8, 2), torch.zeros(8), torch.zeros(8, 2)))


def test_parallel_eca_matches_and_the_holding_batch_keeps_its_state():
    """Batch b moves with batch b+1's refit step size; batch step % 4 keeps
    its chains bit for bit (the reference's inverted ``skip``)."""
    nb, bs = 4, 8
    (jtarget, jfac, jgn), (ptarget, pfac, pgn) = _mala_pair(
        lambda s, step, h: (0.2 + 0.2 * jnp.mean(s.position**2),),
        lambda s, step, h: (0.2 + 0.2 * torch.mean(s.position**2),))
    # batches at very different scales, so their step sizes differ
    x = (np.random.default_rng(1).standard_normal((nb, bs, 2))
         * np.array([0.5, 1.0, 2.0, 3.0])[:, None, None]).astype(np.float32)
    jinit, jup = j_parallel_eca(jfac, jgn, nb, bs)
    pinit, pup = parallel_eca(pfac, pgn, nb, bs)
    js = jinit(jax.vmap(lambda p: jmala.init(p, jtarget.value_and_score))(jnp.asarray(x)))
    ps = pinit(mala.ChainState(*(torch.stack(v) for v in zip(
        *[mala.init(tt(x[b]), ptarget.value_and_score) for b in range(nb)]))))
    jparams = (0.5 * jnp.ones(nb),)
    pparams = (0.5 * torch.ones(nb),)
    key = jax.random.PRNGKey(8)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        before = ps.states.position.clone()
        js, jparams, _ = jup(k, js, *jparams)
        ps, pparams, _ = pup([mala_noise(kb, bs, 2) for kb in jax.random.split(k, nb)], ps,
                             *pparams)
        hold = i % nb
        assert torch.equal(ps.states.position[hold], before[hold])
        moved = [b for b in range(nb) if b != hold]
        assert all(not torch.equal(ps.states.position[b], before[b]) for b in moved)
        np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(npy(pparams[0]), np.asarray(jparams[0]), rtol=1e-6)


def test_rotation_hands_batch_b_the_params_of_b_plus_1():
    p = (torch.arange(4.0), {"w": torch.arange(8.0).reshape(4, 2)})
    r = _rotate(p)
    assert r[0].tolist() == [1.0, 2.0, 3.0, 0.0]
    assert r[1]["w"][0].tolist() == [2.0, 3.0] and r[1]["w"][3].tolist() == [0.0, 1.0]


def test_mesh_is_refused_by_name():
    """A mesh whose ``ensemble`` axis does not split the batches, one with no
    such axis, and a mesh for cross-chain adaptation are refused by name
    (the sharded runs themselves: ``tests/test_torch_mesh.py``)."""
    from mfm_tpu_torch.parallel.mesh import ChainMesh

    two = ChainMesh((2,), ("ensemble",), None, 0, 2, "gloo", "cpu")
    with pytest.raises(ValueError, match="num_batch=3 does not split over the 2 shards"):
        parallel_eca(lambda *a: None, lambda *a: a, 3, 2, mesh=two)
    with pytest.raises(ValueError, match="num_batch=3 does not split over the 2 shards"):
        atess(lambda x: x, adam(1e-3), {"w": torch.zeros(1)}, None, None, 3, 2, eca=True,
              mesh=two)
    chains = ChainMesh((2,), ("chains",), None, 0, 2, "gloo", "cpu")
    with pytest.raises(ValueError, match="has no axis 'ensemble'"):
        parallel_eca(lambda *a: None, lambda *a: a, 2, 2, mesh=chains)
    with pytest.raises(ValueError, match="cross-chain adaptation"):
        atess(lambda x: x, adam(1e-3), {"w": torch.zeros(1)}, None, None, 2, 2, eca=False,
              mesh=two)


# ------------------------------------------------------------ warmups (CNF)

D = 2


def _flows():
    """The reference's test flow and loss (tests/test_vi_adaptation.py:69-85:
    the transport, and -log q_flow(positions) through the inverse) in both
    packages on one set of parameters."""
    net_j, jparams, freqs = flax_field(jax.random.PRNGKey(9), D, 8, 4, "tanh")
    net_p, pparams = torch_field(jparams, freqs, D, 8, "tanh")
    jtr = j_transport(net_j.apply, divergence="exact", n_steps=4)
    ptr = make_transport(module_tangent_field(net_p), divergence="exact", n_steps=4)

    def jloss(p, positions):
        u, logdet = jtr.inverse(p, positions)
        return jnp.mean(0.5 * jnp.sum(u * u, axis=-1) + logdet)

    def ploss(p, positions):
        u, logdet = ptr.inverse(p, positions)
        return torch.mean(0.5 * torch.sum(u * u, dim=-1) + logdet)

    return ((lambda u, p: jtr.forward(p, u)), jloss, jparams), (
        (lambda u, p: ptr.forward(p, u)), ploss, pparams)


def test_atess_cross_chain_matches():
    (jflow, jloss, jparams), (pflow, ploss, pparams) = _flows()
    jtarget, ptarget = jt.IndepGaussian(D, mean=0.5), pt.IndepGaussian(D, mean=0.5)
    B, steps, key = 12, 2, jax.random.PRNGKey(1)
    x = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    js, _, jfit = j_atess(jtarget.log_prob, optax.adam(1e-2), jparams, jflow, jloss, 1, B,
                          num_steps=steps).run(key, jnp.asarray(x))
    noise = [tess_noise(k, B, D) for k in jax.random.split(key, steps)]
    ps, pkernel, pfit = atess(ptarget.log_prob, adam(1e-2), pparams, pflow, ploss, 1, B,
                              num_steps=steps).run(noise, tt(x))
    assert ps.step == steps and callable(pkernel)
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-4, atol=1e-4)
    assert_tree_close(pfit, jfit, 1e-4)


def test_atess_eca_matches():
    (jflow, jloss, jparams), (pflow, ploss, pparams) = _flows()
    jtarget, ptarget = jt.IndepGaussian(D, mean=0.5), pt.IndepGaussian(D, mean=0.5)
    nb, bs, steps, key = 2, 6, 2, jax.random.PRNGKey(3)
    x = np.random.default_rng(4).standard_normal((nb, bs, D)).astype(np.float32)
    js, jk, (jfit, _) = j_atess(jtarget.log_prob, optax.adam(1e-2), jparams, jflow, jloss, nb,
                                bs, num_steps=steps, eca=True).run(key, jnp.asarray(x))
    noise = [[tess_noise(kb, bs, D) for kb in jax.random.split(k, nb)]
             for k in jax.random.split(key, steps)]
    ps, pk, (pfit, _) = atess(ptarget.log_prob, adam(1e-2), pparams, pflow, ploss, nb, bs,
                              num_steps=steps, eca=True).run(noise, tt(x))
    assert jk is None and pk is None
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-4, atol=1e-4)
    for b in range(nb):
        assert_tree_close({k: v[b] for k, v in pfit.items()},
                          jax.tree_util.tree_map(lambda v: v[b], jfit), 1e-4)


def test_msc_matches():
    (jflow, jloss, jparams), (pflow, ploss, pparams) = _flows()
    jtarget, ptarget = jt.IndepGaussian(D, mean=0.5), pt.IndepGaussian(D, mean=0.5)
    B, N, steps, key = 12, 3, 2, jax.random.PRNGKey(5)
    x = np.random.default_rng(6).standard_normal((B, D)).astype(np.float32)
    js, _, jfit, jinfo = j_msc(jtarget.log_prob, optax.adam(1e-2), jparams, jflow, jloss, B,
                               num_steps=steps, num_importance_samples=N).run(key,
                                                                              jnp.asarray(x))
    noise = [cis_noise(k, B, N, D) for k in jax.random.split(key, steps)]
    ps, _, pfit, pinfo = msc(ptarget.log_prob, adam(1e-2), pparams, pflow, ploss, B,
                             num_steps=steps, num_importance_samples=N).run(noise, tt(x))
    np.testing.assert_allclose(npy(pinfo.log_weights), np.asarray(jinfo.log_weights),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-4, atol=1e-4)
    assert_tree_close(pfit, jfit, 1e-4)


def test_msc_stochastic_loss_matches_under_injected_noise():
    """The reference's stochastic loss draws from fold_in(PRNGKey(0), step);
    the port's from step_generator(step, device). The streams differ, so the
    test hands the port's loss the reference's draws, in call order."""
    (jflow, jloss, jparams), (pflow, ploss, pparams) = _flows()
    jtarget, ptarget = jt.IndepGaussian(D, mean=0.5), pt.IndepGaussian(D, mean=0.5)
    B, N, steps, n_opt, key = 12, 2, 2, 2, jax.random.PRNGKey(7)
    x = np.random.default_rng(8).standard_normal((B, D)).astype(np.float32)

    def j_stochastic(positions):
        return lambda p, k: jloss(p, positions + 0.1 * jax.random.normal(k, positions.shape))

    js, _, jfit, _ = j_msc(jtarget.log_prob, optax.adam(1e-2), jparams, jflow, None, B,
                           num_steps=steps, n_opt_iter=n_opt, num_importance_samples=N,
                           stochastic_loss=j_stochastic).run(key, jnp.asarray(x))
    draws = [tt(jax.random.normal(k, (B, D))) for s in range(steps + 1)
             for k in jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), s), n_opt)]
    seeds = []

    def p_stochastic(positions):
        def loss(p, gen):
            seeds.append(gen.initial_seed())
            return ploss(p, positions + 0.1 * draws[len(seeds) - 1])
        return loss

    noise = [cis_noise(k, B, N, D) for k in jax.random.split(key, steps)]
    ps, _, pfit, _ = msc(ptarget.log_prob, adam(1e-2), pparams, pflow, None, B,
                         num_steps=steps, n_opt_iter=n_opt, num_importance_samples=N,
                         stochastic_loss=p_stochastic).run(noise, tt(x))
    # one generator a step, seeded with the step alone (the final refit at step 2)
    assert seeds == [s for s in range(steps + 1) for _ in range(n_opt)]
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-4, atol=1e-4)
    assert_tree_close(pfit, jfit, 1e-4)


def test_step_generator_depends_on_the_step_alone():
    a = torch.randn(3, generator=step_generator(4, "cpu"))
    assert torch.equal(a, torch.randn(3, generator=step_generator(4, "cpu")))
    assert not torch.equal(a, torch.randn(3, generator=step_generator(5, "cpu")))


def test_msc_mala_matches():
    (jflow, jloss, jparams), (pflow, ploss, pparams) = _flows()
    jtarget, ptarget = jt.IndepGaussian(D, mean=0.5), pt.IndepGaussian(D, mean=0.5)
    B, n_mala, steps, key = 12, 2, 2, jax.random.PRNGKey(9)
    x = np.random.default_rng(10).standard_normal((B, D)).astype(np.float32)
    js, _, jfit, jinfo = j_msc_mala(jtarget.value_and_score, optax.adam(1e-2), jparams, jflow,
                                    jloss, B, 0.3, num_steps=steps,
                                    num_mala_samples=n_mala).run(key, jnp.asarray(x))

    def step_noise(k):
        key_init, key_sample = jax.random.split(k)
        return MSCMalaNoise(tt(jax.random.normal(key_init, (B, D))),
                            [mala_noise(km, B, D) for km in jax.random.split(key_sample,
                                                                              n_mala)])

    noise = [step_noise(k) for k in jax.random.split(key, steps)]
    ps, _, pfit, pinfo = msc_mala(ptarget.value_and_score, adam(1e-2), pparams, pflow, ploss, B,
                                  0.3, num_steps=steps, num_mala_samples=n_mala).run(noise,
                                                                                     tt(x))
    assert pinfo.acceptance_rate.shape == (steps, n_mala, B)
    np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
    np.testing.assert_allclose(npy(ps.states.position), np.asarray(js.states.position),
                               rtol=1e-4, atol=1e-4)
    assert_tree_close(pfit, jfit, 1e-4)


def test_warmups_run_from_a_generator():
    """The three warmups on generator noise: finite chains, and the
    refitted kernel moves them once more."""
    (_, _, _), (pflow, ploss, pparams) = _flows()
    target = pt.IndepGaussian(D)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(16, D, generator=gen)
    state, kernel, _ = atess(target.log_prob, adam(1e-3), pparams, pflow, ploss, 1, 16,
                             num_steps=2).run(gen, x)
    assert bool(torch.isfinite(kernel(gen, state.states)[0].position).all())
    state, _, _, _ = msc(target.log_prob, adam(1e-3), pparams, pflow, ploss, 16, num_steps=2,
                         num_importance_samples=3).run(gen, x)
    assert bool(torch.isfinite(state.states.position).all())
    state, _, _, _ = msc_mala(target.value_and_score, adam(1e-3), pparams, pflow, ploss, 16,
                              0.3, num_steps=2, num_mala_samples=2).run(gen, x)
    assert bool(torch.isfinite(state.states.position).all())


# ----------------------------------------------------------------- profiling

def test_timed_reports_mean_seconds_and_the_output():
    calls = []
    secs, out = profiling.timed(lambda a: calls.append(a) or a + 1, torch.ones(2), repeats=3,
                                warmup=2)
    assert len(calls) == 5 and secs >= 0.0 and torch.equal(out, torch.full((2,), 2.0))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
