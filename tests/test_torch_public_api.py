"""Port parity for the public remainder: the chain diagnostics, the proposal
combinators, the ``SamplingAlgorithm`` constructors (MALA, ``run_chain``,
HMC, NUTS, the two tempered SMCs), the small helpers (``as_logprob_fn``,
``make_optimizer``, ``make_vector_field`` and ``MLP``,
``discrete_map_logdet``, ``tempered_value_and_score``, ``make_target``) and
the CLI's ``--pallas-metrics`` / ``--no-pallas-metrics``.

The same numpy inputs go through both packages, and the reference's draws
are replayed into the port by walking its key splits (a Bernoulli draw is
``uniform(key) < p``). Tolerances: the chain diagnostics are float64 numpy
on both sides, 1e-10; everything else fp32 through a few steps, 1e-5
(1e-4 relative where a mixture score's cancellation shows, as in
``test_torch_mcmc.py``); accept masks identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.diagnostics import metrics as jmetrics
from mfm_tpu.kernels import ChainState as JChainState
from mfm_tpu.kernels import hmc as jhmc
from mfm_tpu.kernels import mala as jmala
from mfm_tpu.kernels import nuts as jnuts
from mfm_tpu.kernels import proposal as jprop
from mfm_tpu.smc import adaptive_tempered_smc as j_adaptive_smc
from mfm_tpu.smc import resampling as jres
from mfm_tpu.smc import tempered_smc as j_tempered_smc
from mfm_tpu_torch import diagnostics as pdiag
from mfm_tpu_torch.kernels import ChainState, hmc, mala, nuts
from mfm_tpu_torch.kernels import proposal as pprop
from mfm_tpu_torch.smc import SMCStepNoise, adaptive_tempered_smc, resampling, tempered_smc
from torch_parity import npy, nuts_noise, tt

torch.set_num_threads(1)
B = 16


def _close(a, b, tol=1e-5):
    np.testing.assert_allclose(npy(a), np.asarray(b), rtol=tol, atol=tol)


# --- chain diagnostics -------------------------------------------------------

def _chains(seed=0, T=301, m=4, d=3):
    """AR(1) chains with a per-chain offset, float64: autocorrelated, and
    the chains disagree a little (R-hat above 1)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((T, m, d))
    for t in range(1, T):
        x[t] = 0.8 * x[t - 1] + rng.standard_normal((m, d))
    return x + 0.3 * rng.standard_normal((1, m, d))


@pytest.mark.parametrize("name", ["autocorrelation", "effective_sample_size",
                                  "potential_scale_reduction"])
def test_chain_diagnostics_match_reference(name):
    x = _chains()
    arg = {"autocorrelation": x, "effective_sample_size": x[:, 0],
           "potential_scale_reduction": x}[name]
    ref = getattr(jmetrics, name)(arg)
    for given in (arg, torch.from_numpy(arg)):  # an array, and a tensor for the host
        np.testing.assert_allclose(getattr(pdiag, name)(given), ref, rtol=1e-10, atol=1e-10)
    if name == "autocorrelation":  # another axis, odd length
        np.testing.assert_allclose(pdiag.autocorrelation(x[:77], axis=1),
                                   jmetrics.autocorrelation(x[:77], axis=1), rtol=1e-10)


# --- proposals ---------------------------------------------------------------

def _proposals(rng, n=8):
    """Two proposal ensembles with dict states and weights of both signs."""
    mk = lambda: [rng.standard_normal(n).astype(np.float32) for _ in range(4)]
    old, new = mk(), mk()
    old[2] *= 2.0
    new[2] *= 2.0
    build = lambda mod, conv, a: mod.Proposal({"x": conv(a[0])}, conv(a[1]), conv(a[2]),
                                              conv(a[3]))
    return (build(jprop, jnp.asarray, old), build(jprop, jnp.asarray, new),
            build(pprop, tt, old), build(pprop, tt, new))


def _same_proposal(p, j):
    _close(p.state["x"], j.state["x"])
    for f in ("energy", "weight", "sum_log_p_accept"):
        _close(getattr(p, f), getattr(j, f))


@pytest.mark.parametrize("name", ["progressive_uniform_sampling",
                                  "progressive_biased_sampling"])
def test_progressive_sampling_matches(name):
    jold, jnew, pold, pnew = _proposals(np.random.default_rng(1))
    key = jax.random.PRNGKey(3)
    jout = getattr(jprop, name)(key, jold, jnew)
    u = jax.random.uniform(key, (8,))  # bernoulli(key, p) = uniform(key) < p
    pout = getattr(pprop, name)(tt(u), pold, pnew)
    _same_proposal(pout, jout)
    picked = npy(pout.energy) == npy(pnew.energy)
    assert picked.any() and not picked.all()


def test_nonreversible_slice_matches():
    jold, jnew, pold, pnew = _proposals(np.random.default_rng(2))
    s = np.random.default_rng(3).uniform(-1.0, 1.0, 8).astype(np.float32)
    jout, jacc, jslice = jprop.nonreversible_slice_sampling(jnp.asarray(s), jold, jnew)
    pout, pacc, pslice = pprop.nonreversible_slice_sampling(tt(s), pold, pnew)
    np.testing.assert_array_equal(npy(pacc), np.asarray(jacc))
    assert npy(pacc).any() and not npy(pacc).all()
    _same_proposal(pout, jout)
    _close(pslice, jslice)


def test_proposal_generator_matches():
    x = np.random.default_rng(4).standard_normal((8, 2)).astype(np.float32)
    jnew, jupd = jprop.proposal_generator(lambda s: jnp.sum(s["x"] ** 2, -1), 3.0)
    pnew, pupd = pprop.proposal_generator(lambda s: torch.sum(s["x"] ** 2, -1), 3.0)
    _same_proposal(pnew({"x": tt(x)}), jnew({"x": jnp.asarray(x)}))
    e0 = np.linspace(0.0, 4.0, 8).astype(np.float32)
    (jp, jdiv), (pp, pdiv) = jupd(jnp.asarray(e0), {"x": jnp.asarray(x)}), pupd(
        tt(e0), {"x": tt(x)})
    _same_proposal(pp, jp)
    np.testing.assert_array_equal(npy(pdiv), np.asarray(jdiv))


def test_asymmetric_generator_matches_mala():
    """The asymmetric generator with MALA's transition energy, in both
    packages, and against the port's own MALA kernel."""
    jtarget, ptarget = jt.IndepGaussian(2), pt.IndepGaussian(2)
    x = np.random.default_rng(5).standard_normal((B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    jstate = jmala.init(jnp.asarray(x), jtarget.value_and_score)
    _, jinfo = jmala.build_kernel(jtarget.value_and_score)(key, jstate, 0.5)
    prop_x = np.asarray(jinfo.proposed_position)

    def energy(theta_sum, logdens, step):
        return -logdens + 0.25 / step * theta_sum

    def j_trans(a, b, step_size):
        th = b.position - a.position - step_size * a.logdensity_grad
        return energy(jnp.sum(th * th, -1), a.logdensity, step_size)

    def p_trans(a, b, step_size):
        th = b.position - a.position - step_size * a.logdensity_grad
        return energy(torch.sum(th * th, -1), a.logdensity, step_size)

    _, jupd = jprop.asymmetric_proposal_generator(j_trans, jnp.inf)
    pnew, pupd = pprop.asymmetric_proposal_generator(p_trans, torch.inf)
    jp, _ = jupd(jstate, jmala.init(jnp.asarray(prop_x), jtarget.value_and_score), step_size=0.5)
    pstate = mala.init(tt(x), ptarget.value_and_score)
    pp, _ = pupd(pstate, mala.init(tt(prop_x), ptarget.value_and_score), step_size=0.5)
    _close(pp.weight, jp.weight)
    assert npy(pnew(pstate).energy).shape == (B,)
    np.testing.assert_allclose(
        npy(torch.clamp(torch.exp(pp.weight), max=1.0)), np.asarray(jinfo.acceptance_rate),
        rtol=1e-5, atol=1e-6)


# --- SamplingAlgorithm constructors -----------------------------------------

def _four_mode_start(seed=0):
    rng = np.random.default_rng(seed)
    x = 2.0 * rng.standard_normal((B, 2)) + 8.0 * np.sign(rng.standard_normal((B, 2)))
    return x.astype(np.float32)


def _mala_noise(key, shape):
    key_noise, key_accept = jax.random.split(key)
    return mala.MalaNoise(tt(jax.random.normal(key_noise, shape)),
                          tt(jax.random.uniform(key_accept, shape[:1])))


def test_mala_constructor_and_run_chain_match():
    """``mala(vs, step)`` over 3 steps and ``run_chain`` over 5, on the
    reference's draws; both accept and reject are seen."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    x = _four_mode_start()
    jalg = jmala.mala(jtarget.value_and_score, 0.8)
    palg = mala.mala(ptarget.value_and_score, 0.8)
    js, ps = jalg.init(jnp.asarray(x)), palg.init(tt(x))
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        js, jinfo = jalg.step(key, js)
        ps, pinfo = palg.step(_mala_noise(key, x.shape), ps)
        np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
        for a, b in zip(ps, js):
            _close(a, b, 1e-4)
    # run_chain: the reference's split keys, one MalaNoise a step
    key = jax.random.PRNGKey(30)
    jk = jmala.build_kernel(jtarget.value_and_score)
    jfinal, jpos, jacc = jmala.run_chain(key, jk, js, 0.8, 5)
    noises = [_mala_noise(k, x.shape) for k in jax.random.split(key, 5)]
    pfinal, ppos, pacc = mala.run_chain(noises, mala.build_kernel(ptarget.value_and_score), ps,
                                        0.8, 5)
    assert ppos.shape == (5, B, 2) and pacc.shape == (5, B)
    _close(ppos, jpos, 1e-4)
    _close(pacc, jacc, 1e-4)
    _close(pfinal.position, jfinal.position, 1e-4)
    assert 0.0 < float(pacc.mean()) < 1.0
    # a generator draws the same shapes
    out = mala.run_chain(torch.Generator().manual_seed(0), mala.build_kernel(
        ptarget.value_and_score), ps, 0.8, 2)
    assert out[1].shape == (2, B, 2)


def test_hmc_constructor_matches():
    jtarget, ptarget = jt.PhiFour(8), pt.PhiFour(8)
    x = (0.6 * np.random.default_rng(1).standard_normal((B, 8))).astype(np.float32)
    inv_mass = np.linspace(0.5, 1.5, 8).astype(np.float32)
    jalg = jhmc.hmc(jtarget.value_and_score, 0.08, 5, jnp.asarray(inv_mass))
    palg = hmc.hmc(ptarget.value_and_score, 0.08, 5, tt(inv_mass))
    js, ps = jalg.init(jnp.asarray(x)), palg.init(tt(x))
    for i in range(3):
        key = jax.random.PRNGKey(40 + i)
        js, jinfo = jalg.step(key, js)
        key_mom, key_acc = jax.random.split(key)
        ps, pinfo = palg.step(hmc.HMCNoise(tt(jax.random.normal(key_mom, (B, 8))),
                                           tt(jax.random.uniform(key_acc, (B,)))), ps)
        np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
        for a, b in zip(ps, js):
            _close(a, b, 1e-4)
    assert isinstance(palg.step(torch.Generator().manual_seed(0), ps)[0], ChainState)


@pytest.mark.parametrize("variant", ["static", "iterative"])
def test_nuts_constructors_match(variant):
    """``nuts(vs, step)`` (static at depth 6) and ``build_kernel_iterative``
    (depth 7) over 3 steps on 4-mode."""
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    x = _four_mode_start(2)
    js = JChainState(jnp.asarray(x), *jtarget.value_and_score(jnp.asarray(x)))
    ps = ChainState(tt(x), *ptarget.value_and_score(tt(x)))
    depth = 6 if variant == "static" else 7
    if variant == "static":
        jstep = jnuts.nuts(jtarget.value_and_score, 0.4).step
        palg = nuts.nuts(ptarget.value_and_score, 0.4)
        pstep = palg.step
        assert palg.init(tt(x)).position.shape == (B, 2)
    else:
        jk = jnuts.build_kernel_iterative(jtarget.value_and_score, depth)
        pk = nuts.build_kernel_iterative(ptarget.value_and_score, depth)
        jstep = lambda key, s: jk(key, s, 0.4)
        pstep = lambda noise, s: pk(s, 0.4, None, noise)
    for i in range(3):
        key = jax.random.PRNGKey(50 + i)
        js, jinfo = jstep(key, js)
        ps, pinfo = pstep(nuts_noise(key, B, 2, depth, variant), ps)
        np.testing.assert_array_equal(npy(pinfo.num_doublings), np.asarray(jinfo.num_doublings))
        for a, b in zip(ps, js):
            _close(a, b, 1e-4)


def _mala_moves(key, n_moves, m, d):
    out = []
    for k in jax.random.split(key, n_moves):
        kn, ka = jax.random.split(k)
        out.append(mala.MalaNoise(tt(jax.random.normal(kn, (m, d))),
                                  tt(jax.random.uniform(ka, (m,)))))
    return out


@pytest.mark.parametrize("adaptive", [False, True])
def test_smc_constructors_match(adaptive):
    """Two steps of ``tempered_smc`` (lambda 0 -> 0.3 -> 0.6) and of
    ``adaptive_tempered_smc`` (target ESS 0.5) on 4-mode, 64 particles, 3
    MALA moves a step."""
    n, d, step = 64, 2, 0.2
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    x = np.array(4.0 * jax.random.normal(jax.random.PRNGKey(6), (n, d)))
    jbuild = lambda vs: (lambda k, s: jmala.build_kernel(vs)(k, s, step))
    pbuild = lambda vs: (lambda s, noise: mala.build_kernel(vs)(s, step, *noise))
    if adaptive:
        jalg = j_adaptive_smc(jtarget, jbuild, jmala.init, jres.systematic, 0.5, 3)
        palg = adaptive_tempered_smc(ptarget, pbuild, mala.init, resampling.systematic, 0.5, 3)
    else:
        jalg = j_tempered_smc(jtarget, jbuild, jmala.init, jres.systematic, 3)
        palg = tempered_smc(ptarget, pbuild, mala.init, resampling.systematic, 3)
    js, ps = jalg.init(jnp.asarray(x)), palg.init(torch.from_numpy(x))
    for i, lmbda in enumerate((0.3, 0.6)):
        key = jax.random.PRNGKey(70 + i)
        key_update, key_resample = jax.random.split(key)
        noise = SMCStepNoise(tt(jax.random.uniform(key_resample, ())),
                             _mala_moves(key_update, 3, n, d))
        if adaptive:
            js, jinfo = jalg.step(key, js)
            ps, pinfo = palg.step(noise, ps)
        else:
            js, jinfo = jalg.step(key, js, lmbda)
            ps, pinfo = palg.step(noise, ps, torch.tensor(lmbda))
        np.testing.assert_array_equal(npy(pinfo.ancestors), np.asarray(jinfo.ancestors))
        _close(ps.particles, js.particles)
        _close(ps.weights, js.weights)
        _close(ps.lmbda, js.lmbda)
    assert 0.0 < float(ps.lmbda) < 1.0


# --- small helpers -----------------------------------------------------------

@pytest.mark.parametrize("beta", [None, 0.3])
def test_as_logprob_fn_matches(beta):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    jf = jt.as_logprob_fn(jtarget, None if beta is None else jnp.asarray(beta))
    pf = pt.as_logprob_fn(ptarget, None if beta is None else torch.tensor(beta))
    for x in (np.array([1.5, -7.0], np.float32), np.array([0.25], np.float32)[:1].repeat(2)):
        _close(pf(tt(x)), jf(jnp.asarray(x)))


def test_make_optimizer_matches_reference():
    """The reference's argument order (weight decay second), four steps."""
    from mfm_tpu.flows.train import make_lr_schedule as j_schedule
    from mfm_tpu.flows.train import make_optimizer as j_optimizer
    from mfm_tpu_torch.flows import make_lr_schedule, make_optimizer

    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    tx_j = j_optimizer(j_schedule(10, 2, 1e-2), 1e-2, gradient_clip=0.5)
    tx_p = make_optimizer(make_lr_schedule(10, 2, 1e-2), 1e-2, gradient_clip=0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: tt(v) for k, v in params.items()}
    sj, sp = tx_j.init(jp), tx_p.init(pp)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        uj, sj = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, jp)
        up, sp = tx_p.update({k: tt(v) for k, v in g.items()}, sp, pp)
        jp = {k: jp[k] + uj[k] for k in jp}
        pp = {k: pp[k] + up[k] for k in pp}
        for k in params:
            np.testing.assert_allclose(npy(pp[k]), np.asarray(jp[k]), atol=1e-6)


def test_make_vector_field_and_mlp_match():
    """The port's net takes the reference's initial tree as is (the same
    parameter names and shapes), and with it gives the reference's field;
    the reference's ``MLP`` and the port's on the same weights agree."""
    from mfm_tpu.flows.vector_field import MLP as JMLP
    from mfm_tpu.flows.vector_field import make_vector_field as j_make
    from mfm_tpu_torch.flows import MLP, make_vector_field
    from mfm_tpu_torch.utils.convert import params_from_flax

    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    kw = dict(hidden_x=(16, 8), hidden_t=(12,), hidden_xt=(16,), fourier_dim=6,
              non_linearity="tanh", score_clip=5.0)
    apply_fn, jparams = j_make(jax.random.PRNGKey(0), 2, jtarget.score, **kw)
    net, params = make_vector_field(torch.Generator().manual_seed(0), 2, ptarget.score,
                                    device="cpu", **kw)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    assert {k: tuple(v.shape) for k, v in ref.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert net.fourier_freqs.shape == (6,)
    # the reference's frequencies live in its module; perturb the zero heads
    freqs = apply_fn.__self__.fourier_freqs
    net.fourier_freqs.copy_(tt(freqs))
    rng = np.random.default_rng(8)
    jparams = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32), jparams)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    x = 3.0 * rng.standard_normal((B, 2)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    with torch.no_grad():
        got = functional_call(net, ref, (tt(x), tt(t)))
    _close(got, apply_fn(jparams, jnp.asarray(x), jnp.asarray(t)), 1e-5)

    jmlp = JMLP((8, 5), jax.nn.tanh, jax.lax.Precision.HIGHEST)
    mp = jmlp.init(jax.random.PRNGKey(1), jnp.zeros((1, 3)))
    pmlp = MLP(3, (8, 5), "tanh")
    mp = jax.tree_util.tree_map(lambda v: v + 0.1, mp)  # non-zero biases
    with torch.no_grad():
        for i, layer in enumerate(pmlp):
            dense = mp["params"][f"Dense_{i}"]
            layer.weight.copy_(tt(np.asarray(dense["kernel"]).T))
            layer.bias.copy_(tt(dense["bias"]))
        h = rng.standard_normal((B, 3)).astype(np.float32)
        _close(pmlp(tt(h)), jmlp.apply(mp, jnp.asarray(h)), 1e-5)


def test_discrete_map_logdet_matches():
    """A batch-decoupled map with a dense Jacobian, through ``torch.func.jvp``
    in the port and ``jax.linearize`` in the reference."""
    from mfm_tpu.flows.cnf import discrete_map_logdet as j_logdet
    from mfm_tpu_torch.flows import discrete_map_logdet

    rng = np.random.default_rng(9)
    W = (0.4 * rng.standard_normal((5, 5))).astype(np.float32)
    u = rng.standard_normal((B, 5)).astype(np.float32)
    jx, jld = j_logdet(lambda v: v + jnp.tanh(v @ W) + 0.1 * v**3, jnp.asarray(u))
    px, pld = discrete_map_logdet(lambda v: v + torch.tanh(v @ tt(W)) + 0.1 * v**3, tt(u))
    _close(px, jx)
    _close(pld, jld)


def test_tempered_value_and_score_matches():
    from mfm_tpu.drivers.mfm import tempered_value_and_score as j_tvs
    from mfm_tpu_torch.drivers.mfm import tempered_value_and_score

    x = _four_mode_start(3)
    jv, jg = j_tvs(jt.four_mode_mixture())(jnp.asarray(x), 0.4)
    pv, pg = tempered_value_and_score(pt.four_mode_mixture())(tt(x), torch.tensor(0.4))
    _close(pv, jv, 1e-4)
    _close(pg, jg, 1e-4)


@pytest.mark.parametrize("example", ["4-mode", "gaussian-mixture", "phi-four", "pines",
                                     "funnel", "many-well"])
def test_make_target_matches(example):
    from mfm_tpu.cli import make_target as j_make_target
    from mfm_tpu_torch.cli import make_target

    jtarget, ptarget = j_make_target(example), make_target(example, "cpu")
    assert ptarget.dim == jtarget.dim
    x = (0.5 * np.random.default_rng(10).standard_normal((4, jtarget.dim))).astype(np.float32)
    np.testing.assert_allclose(npy(ptarget.log_prob(tt(x))),
                               np.asarray(jtarget.log_prob(jnp.asarray(x))), rtol=1e-4)
    with pytest.raises(ValueError, match="unknown example"):
        make_target("no-such-example", "cpu")


# --- the CLI flag ------------------------------------------------------------

_TINY = [
    "--example", "4-mode", "--seed", "0", "--learning-iter", "8", "--num-chain", "8",
    "--ode-steps", "2", "--chunk-size", "4", "--mcmc-per-flow-steps", "3",
    "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)",
    "--set", "fourier_dim=4", "--set", "eval_iter=4",
]


def test_no_pallas_metrics_parses_in_both_and_runs_plain(monkeypatch, tmp_path):
    """A reference command line with --no-pallas-metrics: the reference's
    parser takes it (its run is stubbed: the point is the parse), and the
    port runs it with the plain statistics."""
    import mfm_tpu.cli as jcli
    from mfm_tpu_torch import cli

    seen = {}

    def fake_run_one(target, cfg, args):
        seen["pallas_metrics"] = args.pallas_metrics
        return [0.0] * 5, [0.0] * 5

    monkeypatch.setattr(jcli, "run_one", fake_run_one)
    argv = _TINY + ["--no-pallas-metrics", "--run-dir", str(tmp_path)]
    jcli.main(argv)
    assert seen == {"pallas_metrics": False}
    (row,) = cli.main(argv + ["--device", "cpu"])
    assert row["metrics_kernel"] == "torch" and np.isfinite(row["stein_u"])


def test_pallas_metrics_on_cpu_is_refused():
    from mfm_tpu_torch import cli

    with pytest.raises(SystemExit, match="--pallas-metrics"):
        cli.main(_TINY + ["--pallas-metrics", "--device", "cpu"])


def test_run_one_passes_fused_metrics(monkeypatch):
    """``--pallas-metrics`` reaches ``evaluate_samples`` (and the floor's
    statistics under --check) as its ``fused_metrics``."""
    from mfm_tpu_torch import cli

    seen = []
    real = cli.evaluate_samples

    def spy(*a, **kw):
        seen.append(kw.get("fused_metrics"))
        return real(*a, **kw)

    monkeypatch.setattr(cli, "evaluate_samples", spy)
    cli.main(_TINY + ["--no-pallas-metrics", "--device", "cpu"])
    cli.main(_TINY + ["--device", "cpu"])
    assert seen == [False, None]
