"""Port parity: the MCMC core (kernels.proposal, kernels.mala,
smc.solvers.bisection, drivers.mfm.next_beta).

The noise JAX draws from its keys (mala.py:61-64) is replayed into the
port: normal(key_noise) as ``noise``, uniform(key_accept) as ``u_accept``
(jax.random.bernoulli is uniform < p). Accept masks must be identical.
States and acceptance probabilities: 1e-4 relative/absolute -- the
mixture score is a softmax-weighted sum of component scores of size
|x - mode| ~ 10 that cancel, and the MH log-ratio is a difference of
energies of size ~30, so fp32 rounding shows at ~2e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.drivers.mfm import next_beta as j_next_beta
from mfm_tpu.kernels import mala as jmala
from mfm_tpu.kernels.proposal import proposal_from_energy_diff as j_pfed
from mfm_tpu.smc.solvers import bisection as j_bisection
from mfm_tpu_torch.drivers.mfm import next_beta as p_next_beta
from mfm_tpu_torch.kernels import mala as pmala
from mfm_tpu_torch.kernels.proposal import proposal_from_energy_diff as p_pfed
from mfm_tpu_torch.smc.solvers import bisection as p_bisection
from torch_parity import npy, tt

torch.set_num_threads(1)


@pytest.mark.parametrize("step_size", [0.5, 2.0])
def test_mala_step_matches(step_size):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    beta = 0.6
    jvs = lambda x: jtarget.tempered_value_and_score(x, beta)
    pvs = lambda x: ptarget.tempered_value_and_score(x, torch.tensor(beta))
    x0 = 6.0 * np.random.default_rng(1).standard_normal((64, 2)).astype(np.float32)
    jstate, pstate = jmala.init(jnp.asarray(x0), jvs), pmala.init(tt(x0), pvs)
    jkernel, pkernel = jmala.build_kernel(jvs), pmala.build_kernel(pvs)
    seen = set()
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        key_noise, key_accept = jax.random.split(key)
        noise = jax.random.normal(key_noise, x0.shape, jnp.float32)
        u = jax.random.uniform(key_accept, (64,))
        jstate, jinfo = jkernel(key, jstate, step_size)
        pstate, pinfo = pkernel(pstate, step_size, tt(noise), tt(u))
        np.testing.assert_array_equal(npy(pinfo.is_accepted), np.asarray(jinfo.is_accepted))
        seen.update(np.asarray(jinfo.is_accepted).tolist())
        np.testing.assert_allclose(
            npy(pinfo.acceptance_rate), np.asarray(jinfo.acceptance_rate), rtol=1e-4, atol=1e-4
        )
        for a, b in zip(pstate, jstate):
            np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-4, atol=1e-4)
    assert seen == {True, False}, "the test must see both accepts and rejects"


def test_energy_diff_nan_becomes_minus_inf():
    prev = np.array([1.0, np.nan, 2.0], np.float32)
    new = np.array([0.5, 1.0, np.inf], np.float32)
    jp, jdiv = j_pfed(jnp.asarray(prev), jnp.asarray(new), jnp.inf, None)
    pp, pdiv = p_pfed(tt(prev), tt(new), torch.inf, None)
    np.testing.assert_array_equal(npy(pp.weight), np.asarray(jp.weight))
    np.testing.assert_array_equal(npy(pp.sum_log_p_accept), np.asarray(jp.sum_log_p_accept))
    np.testing.assert_array_equal(npy(pdiv), np.asarray(jdiv))


@pytest.mark.parametrize("root", [0.3, 0.8123, 2.0])
def test_bisection_matches(root):
    """30 fixed fp32 halvings; saturates at the upper bound."""
    j = j_bisection(lambda b: root - b, 0.0, 1.0)
    p = p_bisection(lambda b: root - b, 0.0, 1.0)
    assert p.dtype == torch.float32
    assert float(p) == float(j)


def test_next_beta_matches():
    """ESS-bisection tempering on phi-four log-likelihoods: same fp32
    bisection, ESS to fp32 rounding -> beta to 1e-6."""
    x = np.random.default_rng(2).uniform(-1, 1, (64, 8)).astype(np.float32)
    jl = jt.PhiFour(8).log_lik(jnp.asarray(x))
    pl = pt.PhiFour(8).log_lik(tt(x))
    for prev in (0.0, 0.05):
        jb = j_next_beta(prev, jl, 0.95, 64)
        pb = p_next_beta(torch.tensor(prev), pl, 0.95, 64)
        np.testing.assert_allclose(float(pb), float(jb), atol=1e-6)
        assert prev < float(pb) < 1.0
