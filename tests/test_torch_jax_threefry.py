"""``tools/jax_threefry.py`` is ``jax.random``'s threefry without JAX: equal
bits for ``PRNGKey``, ``split``, ``fold_in`` and ``uniform``; ``normal``
within 3 ulp (its erfinv is XLA's polynomial, but XLA's log1p on the CPU is
not correctly rounded: about 1 % of draws differ by 1-3 ulp). And
``tools/many_well_nonfinite.py --noise reference`` replays, iteration by
iteration, the draws ``tests/test_torch_many_well_nan.py`` takes from JAX.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import jax_threefry as tf  # noqa: E402
import many_well_nonfinite as mw  # noqa: E402
from mfm_tpu_torch import config as pcfg  # noqa: E402
from test_torch_many_well_nan import _replayed_noise  # noqa: E402
from torch_parity import npy  # noqa: E402

SEEDS = [0, 1, 7, 1000, 1099, 2**31 + 11, 3486784401]


def ulps(a, b):
    return np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                  - np.asarray(b).view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_jax_keys(seed):
    key = jax.random.PRNGKey(seed)
    k = tf.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key), k)
    for n in (2, 3, 4, 100):
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, n)), tf.split(k, n))
    for data in (0, 7, 999, 1000, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, data)),
                                      tf.fold_in(k, data))


@pytest.mark.parametrize("shape", [(1,), (128,), (128, 32), (3, 5, 7)])
@pytest.mark.parametrize("seed", [0, 1000])
def test_uniform_and_normal_are_jax_draws(seed, shape):
    key, k = jax.random.PRNGKey(seed), tf.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, shape)).view(np.uint32),
                                  tf.uniform(k, shape).view(np.uint32))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0)).view(np.uint32),
        tf.uniform(k, shape, lo, 1.0).view(np.uint32))
    assert ulps(jax.random.normal(key, shape), tf.normal(k, shape)).max() <= 3


def test_normal_over_many_draws():
    """200,000 draws: within 3 ulp, at most 2 % not equal, and the tails
    (|z| beyond 4) as JAX's."""
    key, k = jax.random.PRNGKey(3), tf.prng_key(3)
    want, got = np.asarray(jax.random.normal(key, (200_000,))), tf.normal(k, (200_000,))
    d = ulps(want, got)
    assert d.max() <= 3 and np.mean(d > 0) < 0.02
    np.testing.assert_array_equal(np.abs(want) > 4, np.abs(got) > 4)


@pytest.mark.parametrize("seed", [1, 1000])
def test_replayed_reference_noise_is_the_test_harness_noise(seed):
    """The tool's replay of many-well's step noise at iterations 1-12 (MALA
    and the flow step at 11) against the JAX draws of the replay test."""
    cfg = pcfg.preset("many-well", seed=seed, learning_iter=12)
    draw = mw.reference_noise(seed, cfg, "cpu")
    _, _, key_loop = jax.random.split(jax.random.PRNGKey(seed), 3)
    keys = jax.random.split(key_loop, cfg.learning_iter)
    for count in range(1, cfg.learning_iter + 1):
        move, fm = draw(count)
        want_move, want_fm = _replayed_noise(keys[count - 1], count, cfg.num_chain, cfg.dim,
                                             cfg.mcmc_per_flow_steps)
        assert type(move) is type(want_move)
        for got, want in ((move.u_accept, want_move.u_accept), (fm.t, want_fm.t)):
            np.testing.assert_array_equal(npy(got), npy(want))
        for got, want in ((move[0], want_move[0]), (fm.x0, want_fm.x0), (fm.eps, want_fm.eps)):
            assert ulps(npy(got), npy(want)).max() <= 3, count
