"""many-well's NaN flow rows are the reference's: the preset at 100
iterations (d=32, 128 chains, trunks 128, 24 RK4 steps, exact divergence),
the port's ``step_fn`` driven from the reference's initial carry with the
reference's noise replayed for all 100 iterations (the draws of
``mfm_tpu.drivers.run_mfm``'s loop keys), then the reference's own eval
draws (``sample_flow`` on ``fold_in(PRNGKey(seed), 999)``) through both
packages' transports.

Seed 1 is one of the CLI's replication seeds whose flow row the reference
leaves NaN (one of its 12,800 samples diverges; ``many_well`` in
``tools/seed_band_reference.json``): the port, given the same noise, trains
the same flow and loses the same sample. Over seeds the two packages draw
from different streams (threefry against torch.Generator), so their NaN
rows fall on different seeds; ``tools/many_well_nonfinite.py`` counts the
port's, ``tools/seed_band_reference.py --many-well`` the reference's.

Tolerances, for 100 fp32 iterations of a chaotic sampler: every
iteration's metrics 1e-3 relative, positions 1e-3, the flow's parameters
1e-2 absolute, and the finite flow samples 1e-2 absolute; the port's own
initial carry on the same points 1e-5.

Also (slow) the port's single-seed path over ten committed seeds, its share
of non-finite flow rows held to the reference's (two-sided Fisher p at
least 0.01); and (fast) ``run_mfm``'s warm-up leaves the run it precedes
as it was.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu import config as jcfg
from mfm_tpu.cli import make_target as j_make_target
from mfm_tpu.drivers.mfm import build_mfm as j_build
from mfm_tpu_torch import cli as pcli
from mfm_tpu_torch import config as pcfg
from mfm_tpu_torch.drivers.mfm import (
    EVAL_STREAM, FMNoise, MalaNoise, RwmNoise, _interleave_is_flow, build_mfm, init_generator,
    make_generator, run_mfm,
)
from mfm_tpu_torch.drivers.eval import fisher_exact
from torch_parity import npy, port_mfm_carry, tt

SEED, ITERS = 1, 100


def _replayed_noise(key, count, B, d, every):
    """The draws the reference's step takes from ``key`` (its ``stdgauss``
    reference, as ``tests/test_torch_slice.py`` replays phi-four's)."""
    k_gen, k_loss = jax.random.split(key)
    if _interleave_is_flow(count, every):
        kg, ka, _, _ = jax.random.split(k_gen, 4)
        move = RwmNoise(tt(jax.random.normal(kg, (B, d))), tt(jax.random.uniform(ka, (B,))))
    else:
        kn, ka = jax.random.split(k_gen)
        move = MalaNoise(tt(jax.random.normal(kn, (B, d))), tt(jax.random.uniform(ka, (B,))))
    kt, kr, ke, _ = jax.random.split(k_loss, 4)
    return move, FMNoise(tt(jax.random.uniform(kt, (B,))), tt(jax.random.normal(kr, (B, d))),
                         tt(jax.random.normal(ke, (B, d))))


@pytest.mark.slow
def test_many_well_nan_row_matches_the_reference_under_replayed_noise():
    torch.set_num_threads(2)
    cfg = jcfg.preset("many-well", seed=SEED, learning_iter=ITERS)
    B, d = cfg.num_chain, cfg.dim
    target = j_make_target("many-well")
    # run_mfm's keys (mfm_tpu/drivers/mfm.py:408-448), its loop unrolled
    key = jax.random.PRNGKey(SEED)
    key_build, key_pos, key_loop = jax.random.split(key, 3)
    pieces = j_build(target, cfg, key_build)
    carry = jax.jit(pieces.init_fn)(target.init_positions(key_pos, B))
    step = jax.jit(pieces.step_fn)
    keys = jax.random.split(key_loop, ITERS)

    p_cfg = pcfg.preset("many-well", seed=SEED, learning_iter=ITERS)
    p_pieces = build_mfm(pcli.make_target("many-well", "cpu"), p_cfg, "cpu",
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        p_pieces.net.fourier_freqs.copy_(tt(pieces.fourier))
    p_carry = port_mfm_carry(carry)
    own = p_pieces.init_fn(p_carry.chain.position)  # the port's own initial carry
    np.testing.assert_allclose(float(own.beta), float(carry.beta), rtol=1e-5)
    np.testing.assert_allclose(npy(own.chain.logdensity), np.asarray(carry.chain.logdensity),
                               rtol=1e-5, atol=1e-4)
    for i in range(ITERS):
        carry, m = step(carry, (keys[i], jnp.asarray(i + 1)))
        p_carry, pm = p_pieces.step_fn(
            p_carry, i + 1, *_replayed_noise(keys[i], i + 1, B, d, cfg.mcmc_per_flow_steps))
        for k, v in m.items():
            np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-3, atol=1e-6,
                                       err_msg=f"iteration {i + 1} {k}")
    np.testing.assert_allclose(npy(p_carry.chain.position), np.asarray(carry.chain.position),
                               atol=1e-3)
    for k, v in port_mfm_carry(carry).train.params.items():
        np.testing.assert_allclose(npy(p_carry.train.params[k]), npy(v), atol=1e-2, err_msg=k)

    # the reference's eval draws (sample_flow_parts: mfm_tpu/drivers/mfm.py:572-574)
    key_ref, _, _ = jax.random.split(jax.random.fold_in(key, 999), 3)
    n = cfg.eval_iter * B
    u = pieces.ref_dist.sample(key_ref, (n,))
    x_ref, _ = pieces.transport.forward(carry.train.params, u, None)
    with torch.no_grad():
        x_port, _ = p_pieces.transport.forward(p_carry.train.params, tt(u), None)
    x_ref, x_port = np.asarray(x_ref), npy(x_port)
    bad_ref = ~np.isfinite(x_ref).all(-1)
    bad_port = ~np.isfinite(x_port).all(-1)
    assert bad_ref.sum() >= 1, "the reference's row at this seed is NaN"
    np.testing.assert_array_equal(bad_port, bad_ref)
    ok = ~bad_ref
    np.testing.assert_allclose(x_port[ok], x_ref[ok], atol=1e-2)


COMMITTED = Path(__file__).resolve().parents[1] / "tools" / "seed_band_reference.json"
HELD_SEEDS = range(1000, 1010)


@pytest.mark.slow
def test_many_well_nan_share_is_the_references_on_the_single_seed_path():
    """The CLI's ``--seed s`` path (``run_mfm``, then ``sample_flow`` on the
    seed's eval stream) on the CPU over seeds 1000-1009: the share of seeds
    whose flow row is not finite against the reference's over every seed in
    ``tools/seed_band_reference.json``, two-sided Fisher p at least 0.01.
    ~1 h at two threads."""
    torch.set_num_threads(2)
    data = json.loads(COMMITTED.read_text())
    ref = list({r["seed"]: r for k in ("many_well", "many_well_more")
                for r in data[k]["rows"]}.values())
    ref_bad = sum(not r["flow_row_finite"] for r in ref)
    target = pcli.make_target("many-well", "cpu")
    bad = 0
    for seed in HELD_SEEDS:
        cfg = pcfg.preset("many-well", seed=seed, learning_iter=ITERS)
        run = run_mfm(target, cfg, "cpu")
        flow, _, _ = pcli.sample_flow(run, cfg.eval_iter * cfg.num_chain, target,
                                      make_generator("cpu", seed, EVAL_STREAM))
        bad += not bool(torch.isfinite(flow).all())
    p = fisher_exact(bad, len(HELD_SEEDS), ref_bad, len(ref))
    assert p >= 0.01, (bad, len(HELD_SEEDS), ref_bad, len(ref), p)


def test_run_mfm_is_its_step_loop_after_the_warm_up():
    """``run_mfm``'s warm-up (one MCMC and one flow iteration on the
    initial carry, from a generator of its own) leaves the run as it was:
    the run equals ``step_fn`` over the same generator's draws, bit for
    bit, on many-well at a small size."""
    torch.set_num_threads(2)
    cfg = pcfg.preset("many-well", seed=3, learning_iter=25, num_chain=16, hidden_x=(16, 16),
                      hidden_t=(16, 16), hidden_xt=(16, 16), fourier_dim=8, ode_steps=4)
    target = pcli.make_target("many-well", "cpu")
    run = run_mfm(target, cfg, "cpu")
    pieces = build_mfm(target, cfg, "cpu", init_generator(cfg.seed))
    gen = make_generator("cpu", cfg.seed)
    carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
    for count in range(1, cfg.learning_iter + 1):
        carry, _ = pieces.step_fn(carry, count, *pieces.draw_step_noise(gen, count))
    assert torch.equal(carry.chain.position, run.chain.position)
    assert all(torch.equal(v, run.train.params[k]) for k, v in carry.train.params.items())
