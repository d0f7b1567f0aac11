#!/usr/bin/env python3
"""``jax.random``'s threefry draws in numpy, without JAX: ``PRNGKey``,
``split``, ``fold_in``, ``uniform`` and ``normal`` as JAX computes them
with ``jax_threefry_partitionable`` on (the default since jax 0.5), so that
a machine with no JAX can replay the reference's noise.

- the Threefry-2x32 hash, 20 rounds, on uint32 words;
- ``split(key, n)``: the hash of the counters (0, i), i < n;
- ``fold_in(key, data)``: the hash of the pair (0, data);
- 32 random bits at flat index i: the two words of the hash of (hi(i),
  lo(i)) xor-ed;
- ``uniform``: the top 23 bits as a mantissa in [1, 2), minus 1, scaled to
  [minval, maxval) and clamped below at minval;
- ``normal``: sqrt(2) erfinv(u) for u uniform in (-1, 1), erfinv in
  float32 by Giles' single-precision polynomial, as XLA lowers
  ``chlo.erf_inv``.

``split``, ``fold_in`` and ``uniform`` give JAX's bits exactly; ``normal``
is within 3 ulp of it: the polynomial's steps are fused multiply-adds as
XLA's, but XLA's log1p on the CPU is not correctly rounded, so about 1 % of
draws differ by 1-3 ulp; ``tests/test_torch_jax_threefry.py`` holds both.
A key is a (2,) uint32 array."""

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1):
    """The hash of the words (x0, x1) (uint32 arrays of one shape) under
    ``key`` (2,): the pair of uint32 arrays JAX's ``threefry2x32_p`` gives."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**32 (JAX's seeds
    without x64): the words (0, seed)."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2)."""
    hi, lo = threefry2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=-1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    hi, lo = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.array([hi[0], lo[0]], np.uint32)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits of each element of ``shape``, row-major."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


# Giles, "Approximating the erfinv function" (GPU Gems 4), single precision
_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                   0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                   1.50140941], np.float32)
_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                   0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                   2.83297682], np.float32)


def erfinv(x) -> np.ndarray:
    """erfinv in float32 by Giles' polynomial (XLA's ``chlo.erf_inv``)."""
    x = np.asarray(x, np.float32)
    f64 = lambda v: np.asarray(v, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (-np.log1p(f64(x * -x))).astype(np.float32)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(small, _SMALL[0], _LARGE[0])
        for a, b in zip(_SMALL[1:], _LARGE[1:]):  # each step one fused multiply-add
            p = (f64(np.where(small, a, b)) + f64(p) * f64(w)).astype(np.float32)
        out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * erfinv(uniform(key, shape, lo, 1.0))
