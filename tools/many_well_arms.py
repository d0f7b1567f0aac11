#!/usr/bin/env python3
"""many-well's non-finite flow rows with one group of draws swapped between
the packages: the reference (``mfm_tpu``, JAX on the CPU) trained and
sampled as ``run_mfm`` and ``sample_flow`` do, over seeds, in four arms.

- ``R0``: the reference's own draws throughout;
- ``R-eval``: the same trained flow, but the port's eval latents (the
  draws ``ref_dist.sample`` takes first from the port's eval stream on the
  CPU, ``make_generator("cpu", seed, EVAL_STREAM)``);
- ``R-init``: the reference trained from the port's initial draws (the
  positions of ``make_generator("cpu", seed)``, and the Fourier frequencies
  and weights of ``init_generator(seed)``), with its own step noise and
  eval latents;
- ``R-both``: that flow on the port's eval latents.

The reference's loop is ``run_mfm``'s: ``PRNGKey(seed)`` split into the
build, position and loop keys, ``lax.scan`` of ``step_fn`` over the loop's
keys (``mfm_tpu/drivers/mfm.py:408-448``); its eval latents those of
``sample_flow_parts`` on ``fold_in(key, 999)``. The port's flows under the
reference's step noise are ``tools/many_well_nonfinite.py --noise
reference``.

    JAX_PLATFORMS=cpu python3 tools/many_well_arms.py --seeds 1000-1029 \\
        --out /tmp/arms_1000.jsonl

``--save-init PATH`` instead saves the reference's initial draws at
``--seeds`` (positions, Fourier frequencies and the initial weights as the
port's parameters) for ``tools/many_well_nonfinite.py --reference-init``.

Appends one JSON line a seed (each arm's non-finite samples, as the largest
|latent coordinate| of each); ``--summary
PATH ...`` prints each arm's count of seeds with a non-finite row over the
lines of those files."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax import lax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from mfm_tpu import config as jcfg  # noqa: E402
from mfm_tpu.cli import make_target as j_make_target  # noqa: E402
from mfm_tpu.drivers.mfm import build_mfm as j_build  # noqa: E402
from mfm_tpu_torch import cli as pcli  # noqa: E402
from mfm_tpu_torch import config as pcfg  # noqa: E402
from mfm_tpu_torch.drivers.mfm import (  # noqa: E402
    EVAL_STREAM, build_mfm, init_generator, make_generator,
)
from mfm_tpu_torch.flows import field_params  # noqa: E402
from mfm_tpu_torch.targets import make_ref_dist  # noqa: E402
from mfm_tpu_torch.utils.convert import params_from_flax  # noqa: E402
from torch_parity import flax_from_params, npy  # noqa: E402

ARMS = ("R0", "R-eval", "R-init", "R-both")
ITERS = 100


def port_init(seed, cfg):
    """The port's initial draws at ``seed`` on the CPU: (positions,
    Fourier frequencies, parameters), as ``run_mfm`` draws them."""
    target = pcli.make_target("many-well", "cpu")
    pieces = build_mfm(target, pcfg.preset("many-well", seed=seed, learning_iter=ITERS), "cpu",
                       init_generator(seed))
    positions = target.init_positions(make_generator("cpu", seed), cfg.num_chain)
    return npy(positions), npy(pieces.fourier), field_params(pieces.net)


def port_latents(seed, n, d):
    """The port's eval latents on the CPU: ``sample_flow``'s first draw."""
    return npy(make_ref_dist("stdgauss", d, "cpu").sample(make_generator("cpu", seed, EVAL_STREAM),
                                                          (n,)))


def reference_flow(seed, cfg, init=None):
    """The reference's trained run at ``seed``: (pieces, final carry); with
    ``init`` (positions, frequencies, port parameters) in place of its own
    initial draws."""
    target = j_make_target("many-well")
    key = jax.random.PRNGKey(seed)
    key_build, key_pos, key_loop = jax.random.split(key, 3)
    if init is None:
        pieces = j_build(target, cfg, key_build)
        positions = target.init_positions(key_pos, cfg.num_chain)
    else:
        positions, freqs, params = init
        normal = jax.random.normal
        # build_mfm's one jax.random.normal is the Fourier draw (the weights
        # are truncated normals): hand it the port's frequencies
        jax.random.normal = lambda k, shape, *a, **kw: jnp.asarray(freqs).reshape(shape)
        try:
            pieces = j_build(target, cfg, key_build)
        finally:
            jax.random.normal = normal
        positions = jnp.asarray(positions)
    carry = jax.jit(pieces.init_fn)(positions)
    if init is not None:
        carry = carry._replace(train=carry.train._replace(params=flax_from_params(init[2])))
    run = jax.jit(lambda c, ks, cs: lax.scan(pieces.step_fn, c, (ks, cs)))
    carry, _ = run(carry, jax.random.split(key_loop, ITERS), jnp.arange(1, ITERS + 1))
    return pieces, carry


def nonfinite(pieces, carry, u):
    """The largest |latent coordinate| of each sample that the flow sends
    to a non-finite point."""
    x, _ = pieces.transport.forward(carry.train.params, jnp.asarray(u), None)
    bad = ~np.all(np.isfinite(np.asarray(x)), axis=-1)
    return sorted(np.abs(u[bad]).max(-1).tolist())


def seed_arms(seed):
    """One seed's arms: each the largest |latent coordinate| of every
    sample its flow sends to a non-finite point."""
    cfg = jcfg.preset("many-well", seed=seed, learning_iter=ITERS)
    n, d = cfg.eval_iter * cfg.num_chain, cfg.dim
    key = jax.random.PRNGKey(seed)
    key_ref, _, _ = jax.random.split(jax.random.fold_in(key, 999), 3)
    u_port = port_latents(seed, n, d)
    out = {"max_abs_u_port": float(np.abs(u_port).max())}
    for init, own, other in ((None, "R0", "R-eval"), ("port", "R-init", "R-both")):
        pieces, carry = reference_flow(seed, cfg, None if init is None else port_init(seed, cfg))
        u_ref = np.asarray(pieces.ref_dist.sample(key_ref, (n,)))
        out["max_abs_u_ref"] = float(np.abs(u_ref).max())
        out[own], out[other] = nonfinite(pieces, carry, u_ref), nonfinite(pieces, carry, u_port)
    return out


def save_reference_init(seeds, path):
    """The reference's initial draws at each seed, as the port takes them:
    {seed: (positions, Fourier frequencies, the port's parameter dict)},
    for ``tools/many_well_nonfinite.py --reference-init`` on a machine with
    no JAX."""
    out = {}
    for seed in seeds:
        cfg = jcfg.preset("many-well", seed=seed, learning_iter=ITERS)
        key_build, key_pos, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
        target = j_make_target("many-well")
        pieces = j_build(target, cfg, key_build)
        positions = target.init_positions(key_pos, cfg.num_chain)
        params = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                          pieces.init_fn(positions).train.params))
        out[seed] = (torch.tensor(np.asarray(positions)),
                     torch.tensor(np.asarray(pieces.fourier)), params)
    torch.save(out, path)


def summary(paths):
    rows = {}
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if line.strip():
                rec = json.loads(line)
                rows[rec["seed"]] = rec
    return dict(seeds=len(rows), **{
        arm: dict(nan_rows=sum(len(r[arm]) > 0 for r in rows.values()),
                  nonfinite_samples=sum(len(r[arm]) for r in rows.values())) for arm in ARMS})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default=None, metavar="FIRST-LAST")
    p.add_argument("--out", default=None, metavar="PATH", help="append a JSON line a seed")
    p.add_argument("--summary", nargs="+", default=None, metavar="PATH")
    p.add_argument("--save-init", default=None, metavar="PATH",
                   help="save the reference's initial draws at --seeds for the port, and stop")
    args = p.parse_args(argv)
    if args.summary:
        print(json.dumps(summary(args.summary)))
        return
    first, _, last = args.seeds.partition("-")
    if args.save_init:
        return save_reference_init(range(int(first), int(last or first) + 1), args.save_init)
    for seed in range(int(first), int(last or first) + 1):
        t0 = time.perf_counter()
        rec = dict(seed=seed, **seed_arms(seed), seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
