"""Port parity: pullback random-walk MH (flows.flow_mh) and the IS
resampling (drivers.baselines.is_resample) against mfm_tpu's.

Noise replayed from JAX's keys (flow_mh.py:93-97): eps = normal(key_gen),
u = uniform(key_acc); the resampling indices come from the same (n, n)
Gumbel draw ``jax.random.categorical`` takes. Accept masks and indices must
be identical; states agree to the transport tolerance (atol 1e-4).
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
from mfm_tpu.flows.flow_mh import pullback_rwm as j_rwm
from mfm_tpu.kernels import mala as jmala
from mfm_tpu_torch.drivers.baselines import is_resample
from mfm_tpu_torch.flows import (
    FlowTarget,
    kernel_tangent_field,
    make_transport,
    pullback_rwm,
    select_flow_kernel,
)
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


def test_select_flow_kernel():
    assert select_flow_kernel(0) is pullback_rwm
    for n in (4, -1):
        with pytest.raises(NotImplementedError, match="not ported"):
            select_flow_kernel(n)


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
