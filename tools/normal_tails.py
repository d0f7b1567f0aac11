#!/usr/bin/env python3
"""How often a generator's standard normals pass |z| > t, against the
Gaussian's 2 Q(t): ``torch.randn`` on a device (CUDA's Philox Box-Muller,
or the CPU's mt19937 Box-Muller), or ``jax.random.normal``'s float32 draws
(``--jax``, made by ``tools/jax_threefry.py``; JAX itself is not needed).

many-well's eval latents that the flow sends to a non-finite point have
their largest coordinate between 3 and 5 (``tools/many_well_nonfinite.py``
records it), so a difference between two generators' laws there would
change how often a flow row is NaN.

    python3 tools/normal_tails.py --device cuda --draws 1e9
    python3 tools/normal_tails.py --device cpu --draws 1e8
    python3 tools/normal_tails.py --jax --draws 1e7

Prints one JSON object: for each threshold the count, the Gaussian's
expectation and the ratio with its binomial standard error."""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax_threefry as tf  # noqa: E402

THRESHOLDS = (3.0, 3.5, 4.0, 4.5, 5.0)
CHUNK = 10_000_000


def counts(draw, n):
    """Exceedances of every threshold over ``n`` draws of ``draw(k)``."""
    out = np.zeros(len(THRESHOLDS), np.int64)
    done = 0
    while done < n:
        k = min(CHUNK, n - done)
        z = draw(k, done // CHUNK).abs()
        out += np.array([int((z > t).sum()) for t in THRESHOLDS])
        done += k
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--jax", action="store_true", help="jax.random.normal's draws instead")
    p.add_argument("--draws", type=float, default=1e8)
    args = p.parse_args(argv)
    n = int(args.draws)
    t0 = time.perf_counter()
    if args.jax:
        key = tf.prng_key(0)
        got = counts(lambda k, i: torch.from_numpy(tf.normal(tf.fold_in(key, i), (k,))), n)
        source = "jax.random.normal (float32, threefry)"
    else:
        gen = torch.Generator(device=args.device).manual_seed(0)
        got = counts(lambda k, i: torch.randn(k, generator=gen, device=args.device), n)
        source = f"torch.randn on {args.device}"
    rows = []
    for t, c in zip(THRESHOLDS, got):
        q = math.erfc(t / math.sqrt(2))  # P(|Z| > t)
        want = q * n
        rows.append(dict(t=t, count=int(c), expected=want, ratio=c / want,
                         ratio_se=math.sqrt(want * (1 - q)) / want))
    print(json.dumps(dict(source=source, draws=n, seconds=time.perf_counter() - t0,
                          tails=rows)))


if __name__ == "__main__":
    main()
