"""Port parity: Stein discrepancy and MMD (diagnostics.metrics), the plain
versions of kernels K2a/K2b (ops.pairwise) against the Pallas kernels in
interpret mode, and evaluate_samples (drivers.eval).

Tolerance: rtol 1e-4 -- fp32 Gram products, ~T^2 terms summed in another
order (the port sums tiles in fp64, the reference in fp32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.diagnostics import max_mean_disc as j_mmd
from mfm_tpu.diagnostics import stein_disc as j_stein
from mfm_tpu.drivers.eval import evaluate_samples as j_eval
from mfm_tpu.ops.pairwise_pallas import rbf_kernel_sum as j_rbf_sum
from mfm_tpu.ops.pairwise_pallas import stein_pairwise_sum as j_stein_sum
from mfm_tpu_torch.diagnostics import max_mean_disc, stein_disc
from mfm_tpu_torch.drivers import evaluate_samples
from mfm_tpu_torch.ops import pairwise as K2
from torch_parity import npy, tt

torch.set_num_threads(1)

RTOL = 1e-4


def _draw(T, d, seed, scale=2.0):
    return scale * np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_stein_disc_matches(weighted):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    X = _draw(150, 2, 0, 6.0)  # 150: not a multiple of the 128-row tile
    w = np.random.default_rng(1).uniform(0.1, 1.0, 150).astype(np.float32) if weighted else None
    ju, jv = j_stein(jnp.asarray(X), jtarget.score, weights=None if w is None else jnp.asarray(w))
    pu, pv = stein_disc(tt(X), ptarget.score, weights=None if w is None else tt(w))
    np.testing.assert_allclose(float(pu), float(ju), rtol=RTOL)
    np.testing.assert_allclose(float(pv), float(jv), rtol=RTOL)


def test_max_mean_disc_matches():
    X, Y = _draw(300, 3, 2), _draw(300, 3, 3, 2.5)
    np.testing.assert_allclose(
        float(max_mean_disc(tt(X), tt(Y))), float(j_mmd(jnp.asarray(X), jnp.asarray(Y))),
        rtol=RTOL,
    )


def test_stein_pairwise_plain_matches_pallas_interpret():
    """K2a's plain version against the Pallas kernel, T=300 over 256-row
    tiles (the padded rows must be masked)."""
    X = _draw(300, 3, 4)
    S = -X / 4.0 + 0.1 * _draw(300, 3, 5)
    ref = j_stein_sum(jnp.asarray(X), jnp.asarray(S), interpret=True)
    got = K2.stein_pairwise_sum(tt(X), tt(S))  # CPU tensors: the plain version
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_rbf_plain_matches_pallas_interpret():
    A, B = _draw(300, 3, 6), _draw(200, 3, 7, 1.5)
    ref = j_rbf_sum(jnp.asarray(A), jnp.asarray(B), interpret=True)
    np.testing.assert_allclose(float(K2.rbf_kernel_sum(tt(A), tt(B))), float(ref), rtol=RTOL)


def test_fused_assembly_matches_reference_statistics():
    """U/V and MMD^2 assembled from the pairwise sums (the fused path's
    wrapper algebra) equal the tiled statistics."""
    ptarget = pt.four_mode_mixture()
    X, Y = tt(_draw(200, 2, 8, 6.0)), tt(_draw(200, 2, 9, 6.0))
    fu, fv = K2.stein_disc_fused(X, ptarget.score)
    u, v = stein_disc(X, ptarget.score)
    np.testing.assert_allclose(float(fu), float(u), rtol=RTOL)
    np.testing.assert_allclose(float(fv), float(v), rtol=RTOL)
    np.testing.assert_allclose(
        float(K2.max_mean_disc_fused(X, Y)), float(max_mean_disc(X, Y)), rtol=RTOL, atol=1e-7
    )


@pytest.mark.parametrize("fused", [False, True])
def test_evaluate_samples_matches(fused):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    flow, exact, real = _draw(256, 2, 10, 7.0), _draw(256, 2, 11, 7.0), _draw(256, 2, 12, 7.0)
    logw = np.random.default_rng(13).standard_normal(256).astype(np.float32)
    ref = j_eval(jtarget, *map(jnp.asarray, (flow, exact, real)),
                 log_weights=jnp.asarray(logw), pallas_metrics=False)
    got = evaluate_samples(ptarget, *map(tt, (flow, exact, real)),
                           log_weights=tt(logw), fused_metrics=fused)
    assert got["metrics_kernel"] == "torch"  # CPU tensors: the plain versions ran
    for k, v in ref.items():
        if k != "metrics_kernel":
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=1e-7, err_msg=k)
    # CPU samples resolve to the plain path
    assert evaluate_samples(ptarget, tt(flow), tt(exact))["metrics_kernel"] == "torch"
