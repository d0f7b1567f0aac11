"""Port parity: the flow kernels (flows.flow_mh: pullback random-walk MH,
independence MH, CIS) and the IS resampling
(drivers.baselines.is_resample) against mfm_tpu's.

Noise replayed from JAX's keys: every kernel splits its key in four
(flow_mh.py:58,93,128) into (draws, accept or choice, forward probe,
inverse probe). eps = normal(key_gen) or the reference draws
ref.sample(key_gen), u = uniform(key_acc); a categorical choice is
``argmax(gumbel(key, logits.shape) + logits)``, so the port takes the same
Gumbel draw. Accept masks and choices must be identical; states agree to
the transport tolerance (atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.drivers.baselines import is_resample as j_is_resample
from mfm_tpu.flows.cnf import make_transport as j_transport
from mfm_tpu.flows.flow_mh import FlowTarget as JFlowTarget
from mfm_tpu.flows.flow_mh import cis_refresh as j_cis
from mfm_tpu.flows.flow_mh import independence_mh as j_indep
from mfm_tpu.flows.flow_mh import pullback_rwm as j_rwm
from mfm_tpu.kernels import mala as jmala
from mfm_tpu_torch.drivers.baselines import is_resample
from mfm_tpu_torch.flows import (
    FlowTarget,
    cis_refresh,
    flow_noise_sampler,
    independence_mh,
    kernel_tangent_field,
    make_transport,
    pullback_rwm,
    select_flow_kernel,
)
from mfm_tpu_torch.flows.flow_mh import CisNoise, IndepNoise, RwmNoise
from mfm_tpu_torch.kernels import mala as pmala
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

D, W, F, B = 4, 16, 8, 32


def test_pullback_rwm_matches():
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(0), D, W, F, "relu", jtarget.score, gate_perturb=0.01
    )
    net_p, pparams = torch_field(params, freqs, D, W, "relu", ptarget.score)
    jtr = j_transport(net_j.apply, divergence="exact", n_steps=3)
    ptr = make_transport(kernel_tangent_field(net_p), divergence="exact", n_steps=3)
    beta = 0.3
    jvs = lambda x: jtarget.tempered_value_and_score(x, beta)
    pvs = lambda x: ptarget.tempered_value_and_score(x, torch.tensor(beta))
    ref_j, ref_p = jt.IndepGaussian(D), pt.IndepGaussian(D)
    x0 = np.random.default_rng(0).uniform(-1, 1, (B, D)).astype(np.float32)
    jstate, pstate = jmala.init(jnp.asarray(x0), jvs), pmala.init(tt(x0), pvs)
    key = jax.random.PRNGKey(4)
    key_gen, key_acc, _, _ = jax.random.split(key, 4)
    eps = jax.random.normal(key_gen, (B, D))
    u = jax.random.uniform(key_acc, (B,))
    jnew, jinfo = j_rwm(key, jstate, params, jtr, JFlowTarget(jvs, ref_j.log_prob, ref_j.sample))
    pnew, pinfo = pullback_rwm(
        pstate, pparams, ptr, FlowTarget(pvs, ref_p.log_prob, ref_p.sample), tt(eps), tt(u)
    )
    np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
    assert 0 < int(npy(pinfo.is_accepted).sum()) < B, "both outcomes must occur"
    np.testing.assert_allclose(
        npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate), atol=1e-4
    )
    for a, b in zip(pnew, jnew):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-4, atol=1e-4)


def _setting(divergence="exact", seed=0, beta=0.3):
    """Both packages' transport, tempered target, reference and one chain
    state, on the same parameters."""
    jtarget, ptarget = jt.PhiFour(D), pt.PhiFour(D)
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(seed), D, W, F, "relu", jtarget.score, gate_perturb=0.01
    )
    net_p, pparams = torch_field(params, freqs, D, W, "relu", ptarget.score)
    jtr = j_transport(net_j.apply, divergence=divergence, n_steps=3)
    ptr = make_transport(kernel_tangent_field(net_p), divergence=divergence, n_steps=3)
    jvs = lambda x: jtarget.tempered_value_and_score(x, beta)
    pvs = lambda x: ptarget.tempered_value_and_score(x, torch.tensor(beta))
    ref_j, ref_p = jt.IndepGaussian(D), pt.IndepGaussian(D)
    x0 = np.random.default_rng(seed).uniform(-1, 1, (B, D)).astype(np.float32)
    return dict(
        params=params, pparams=pparams, jtr=jtr, ptr=ptr, ref_j=ref_j,
        jtgt=JFlowTarget(jvs, ref_j.log_prob, ref_j.sample),
        ptgt=FlowTarget(pvs, ref_p.log_prob, ref_p.sample),
        jstate=jmala.init(jnp.asarray(x0), jvs), pstate=pmala.init(tt(x0), pvs),
    )


def _assert_states_match(pnew, jnew):
    for a, b in zip(pnew, jnew):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("divergence", ["exact", "hutchinson"])
def test_independence_mh_matches(divergence):
    s = _setting(divergence, seed=1)
    key = jax.random.PRNGKey(5)
    key_gen, key_acc, key_h1, key_h2 = jax.random.split(key, 4)
    probes = (None, None)
    if divergence == "hutchinson":  # h2 the inverse's, h1 the forward's
        probes = tuple(tt(jax.random.normal(k, (B, D))) for k in (key_h2, key_h1))
    jnew, jinfo = j_indep(key, s["jstate"], s["params"], s["jtr"], s["jtgt"])
    pnew, pinfo = independence_mh(
        s["pstate"], s["pparams"], s["ptr"], s["ptgt"],
        tt(s["ref_j"].sample(key_gen, (B,))), tt(jax.random.uniform(key_acc, (B,))), *probes,
    )
    np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
    assert 0 < int(npy(pinfo.is_accepted).sum()) < B, "both outcomes must occur"
    np.testing.assert_allclose(
        npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate), atol=1e-4
    )
    _assert_states_match(pnew, jnew)


@pytest.mark.parametrize("num_samples", [1, 4])
@pytest.mark.parametrize("divergence", ["exact", "hutchinson"])
def test_cis_refresh_matches(divergence, num_samples):
    N = num_samples
    s = _setting(divergence, seed=2)
    key = jax.random.PRNGKey(6)
    key_gen, key_choice, key_h1, key_h2 = jax.random.split(key, 4)
    probes = (None, None)
    if divergence == "hutchinson":
        probes = (tt(jax.random.normal(key_h2, (B, D))), tt(jax.random.normal(key_h1, (B * N, D))))
    jnew, jinfo = j_cis(key, s["jstate"], s["params"], s["jtr"], s["jtgt"], N)
    pnew, pinfo = cis_refresh(
        s["pstate"], s["pparams"], s["ptr"], s["ptgt"], N,
        tt(s["ref_j"].sample(key_gen, (B * N,))), tt(jax.random.gumbel(key_choice, (B, N + 1))),
        *probes,
    )
    # is_accepted is "a fresh candidate was chosen"; proposal the selected point
    np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
    assert 0 < int(npy(pinfo.is_accepted).sum()) < B, "kept and refreshed chains must occur"
    np.testing.assert_allclose(
        npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate), atol=1e-4
    )
    _assert_states_match(pnew, jnew)
    # the same kernel through the dispatch
    dnew, _ = select_flow_kernel(N)(
        s["pstate"], s["pparams"], s["ptr"], s["ptgt"],
        tt(s["ref_j"].sample(key_gen, (B * N,))), tt(jax.random.gumbel(key_choice, (B, N + 1))),
        *probes,
    )
    np.testing.assert_array_equal(npy(dnew.position), npy(pnew.position))


def test_flow_kernels_count_nan_weights_as_never():
    """A chain whose candidate has a nan log-density: independence MH
    rejects it, CIS never picks it (both as the reference: nan -> -inf)."""
    s = _setting(seed=3)
    vs = s["ptgt"].value_and_score

    def poisoned(x):  # nan for every candidate of chain 0 (first row of a batch)
        v, g = vs(x)
        rows = x.shape[0] // B
        return torch.cat([torch.full((rows,), torch.nan), v[rows:]]), g

    tgt = s["ptgt"]._replace(value_and_score=poisoned)
    gen = torch.Generator().manual_seed(0)
    new, info = independence_mh(
        s["pstate"], s["pparams"], s["ptr"], tgt, torch.randn(B, D, generator=gen),
        torch.zeros(B),  # u = 0 accepts anything with p > 0
    )
    assert not bool(info.is_accepted[0]) and bool(info.is_accepted[1:].any())
    np.testing.assert_array_equal(npy(new.position[0]), npy(s["pstate"].position[0]))
    new, info = cis_refresh(
        s["pstate"], s["pparams"], s["ptr"], tgt, 4, torch.randn(B * 4, D, generator=gen),
        torch.zeros(B, 5),
    )
    assert not bool(info.is_accepted[0])
    assert bool(torch.isfinite(new.logdensity[1:]).all())


def test_select_flow_kernel():
    """Dispatch by sign, and the noise each kernel's sampler draws."""
    assert select_flow_kernel(0) is pullback_rwm
    assert select_flow_kernel(-1) is independence_mh
    assert select_flow_kernel(-7) is independence_mh
    assert select_flow_kernel(4).__closure__[0].cell_contents == 4
    ref = pt.IndepGaussian(D, var=5.0)
    hutch = make_transport(lambda params: None, divergence="hutchinson", num_probes=2)
    exact = make_transport(lambda params: None, divergence="exact")
    gen = torch.Generator().manual_seed(0)
    rwm = flow_noise_sampler(0)(gen, hutch, ref.sample, B, D)
    assert isinstance(rwm, RwmNoise) and rwm.eps.shape == (B, D) and rwm.u_accept.shape == (B,)
    assert rwm.probe_inv.shape == rwm.probe_fwd.shape == (2, B, D)
    ind = flow_noise_sampler(-1)(gen, exact, ref.sample, B, D)
    assert isinstance(ind, IndepNoise) and ind.u_prop.shape == (B, D) and ind.probe_inv is None
    big = flow_noise_sampler(-1)(gen, exact, ref.sample, 4000, D)
    np.testing.assert_allclose(float(big.u_prop.var()), 5.0, rtol=0.05)  # reference draws
    cis = flow_noise_sampler(3)(gen, hutch, ref.sample, B, D)
    assert isinstance(cis, CisNoise) and cis.u_new.shape == (3 * B, D)
    assert cis.gumbel.shape == (B, 4)
    assert cis.probe_inv.shape == (2, B, D) and cis.probe_fwd.shape == (2, 3 * B, D)
    g = flow_noise_sampler(1)(gen, exact, ref.sample, 20000, D).gumbel  # standard Gumbel
    np.testing.assert_allclose(float(g.mean()), 0.5772, atol=0.02)
    np.testing.assert_allclose(float(g.var()), np.pi**2 / 6, rtol=0.05)


def test_is_resample_matches_with_the_same_gumbel_draw():
    n = 48
    rng = np.random.default_rng(5)
    samples = rng.standard_normal((n, 3)).astype(np.float32)
    log_t = rng.standard_normal(n).astype(np.float32) * 3.0
    log_f = rng.standard_normal(n).astype(np.float32)
    log_t[[3, 7]] = np.nan  # NaN weights are -inf on both sides
    key = jax.random.PRNGKey(6)
    jres, jlw = j_is_resample(key, jnp.asarray(samples), jnp.asarray(log_t), jnp.asarray(log_f))
    gumbel = jax.random.gumbel(key, (n, n))
    pres, plw = is_resample(tt(samples), tt(log_t), tt(log_f), gumbel=tt(gumbel))
    np.testing.assert_array_equal(npy(pres), np.asarray(jres))
    np.testing.assert_array_equal(npy(plw), np.asarray(jlw))


def test_is_resample_generator_path_samples_the_weights():
    """Without a Gumbel draw: inverse-CDF sampling of the same law."""
    n = 20000
    log_w = torch.log(torch.tensor([0.1, 0.6, 0.0, 0.3]))
    samples = torch.arange(4.0)[:, None]
    picks = torch.cat([
        is_resample(samples, log_w, generator=torch.Generator().manual_seed(s))[0]
        for s in range(n // 4)
    ])
    freq = np.bincount(npy(picks)[:, 0].astype(int), minlength=4) / picks.shape[0]
    np.testing.assert_allclose(freq, [0.1, 0.6, 0.0, 0.3], atol=0.015)
