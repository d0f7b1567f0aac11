"""Port parity for the slice as a whole: twelve ``step_fn`` iterations of
the MFM driver from one carry converted from JAX (MALA, pullback-RWM flow
steps and tempering all occur), then final sampling with the IS
correction and the metric row -- mfm_tpu_torch.drivers against
mfm_tpu.drivers on phi-four at a small size.

The port runs both of its transport paths: the fused-field path (K1's
plain version on the CPU) and the nn.Module path; the reference runs its
flax path (the same function). Noise is replayed from the reference's
key tree (mfm.py:347, mala.py:61-64, flow_mh.py:93-97, losses.py:97-102,
mfm.py:572). Tolerances: positions, parameters and beta to 1e-4 after
twelve fp32 steps; the metric row to 1e-3 relative.

Also: the port's packages import no JAX, and the CLI refuses what is not
ported yet.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.config import MFMConfig as JConfig
from mfm_tpu.drivers.eval import evaluate_samples as j_eval
from mfm_tpu.drivers.mfm import build_mfm as j_build
from mfm_tpu.drivers.mfm import sample_flow_parts as j_sample_flow_parts
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers import evaluate_samples, sample_flow_parts
from mfm_tpu_torch.drivers.mfm import (
    FMNoise,
    MalaNoise,
    MFMCarry,
    RwmNoise,
    _interleave_is_flow,
    build_mfm,
)
from mfm_tpu_torch.flows.train import AdamWFiniteState, TrainState
from mfm_tpu_torch.kernels import ChainState
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import npy, tt

torch.set_num_threads(1)

D, B, N_STEPS, N_SAMPLES = 4, 16, 12, 32
CFG = dict(
    example="phi-four", dim=D, num_chain=B, hidden_x=(16, 16), hidden_t=(16, 16),
    hidden_xt=(16, 16), fourier_dim=8, ode_steps=3, mcmc_per_flow_steps=3.0,
    learning_iter=N_STEPS, chunk_size=N_STEPS, step_size=1e-3, field_precision="highest",
)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """The reference run: the initial carry, the carry after each step,
    the per-step metrics, and the final sampling + metric row."""
    target = jt.PhiFour(D)
    cfg = JConfig(**CFG)
    pieces = j_build(target, cfg, jax.random.PRNGKey(0))
    carry0 = jax.jit(pieces.init_fn)(target.init_positions(jax.random.PRNGKey(1), B))
    step = jax.jit(pieces.step_fn)
    keys = jax.random.split(jax.random.PRNGKey(2), N_STEPS)
    carry, metrics = carry0, []
    for i in range(N_STEPS):
        carry, m = step(carry, (keys[i], jnp.asarray(i + 1)))
        metrics.append({k: float(v) for k, v in m.items()})
    skey = jax.random.PRNGKey(3)
    flow, exact, logw = j_sample_flow_parts(
        pieces.transport, carry.train.params, pieces.ref_dist, skey, N_SAMPLES, target
    )
    row = j_eval(target, flow, exact)
    return dict(pieces=pieces, carry0=carry0, carry=carry, keys=keys, metrics=metrics,
                skey=skey, flow=flow, exact=exact, logw=logw, row=row)


def _port_carry(jcarry) -> MFMCarry:
    c, tr = jcarry.chain, jcarry.train
    opt = tr.opt_state
    return MFMCarry(
        ChainState(tt(c.position), tt(c.logdensity), tt(c.logdensity_grad)),
        TrainState(
            torch.tensor(int(tr.step), dtype=torch.int32),
            params_from_flax(_tree_np(tr.params)),
            AdamWFiniteState(
                torch.tensor(int(opt.count), dtype=torch.int32),
                torch.tensor(int(opt.notfinite_count), dtype=torch.int32),
                params_from_flax(_tree_np(opt.mu)),
                params_from_flax(_tree_np(opt.nu)),
            ),
        ),
        tt(jcarry.beta),
    )


def _replayed_noise(key, count):
    """The draws the reference's step takes from ``key``."""
    k_gen, k_loss = jax.random.split(key)
    if _interleave_is_flow(count, CFG["mcmc_per_flow_steps"]):
        kg, ka, _, _ = jax.random.split(k_gen, 4)
        move = RwmNoise(tt(jax.random.normal(kg, (B, D))), tt(jax.random.uniform(ka, (B,))))
    else:
        kn, ka = jax.random.split(k_gen)
        move = MalaNoise(tt(jax.random.normal(kn, (B, D))), tt(jax.random.uniform(ka, (B,))))
    kt, kr, ke, _ = jax.random.split(k_loss, 4)
    fm = FMNoise(
        tt(jax.random.uniform(kt, (B,))), tt(jax.random.normal(kr, (B, D))),
        tt(jax.random.normal(ke, (B, D))),
    )
    return move, fm


@pytest.mark.parametrize("path", ["kernel", "module"])
def test_slice_matches_reference(reference, path):
    ref = reference
    cfg = MFMConfig(**CFG, pallas_field=(path == "kernel"))
    pieces = build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator().manual_seed(0))
    assert pieces.field_bind.__qualname__.startswith(f"{path}_tangent_field.")
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(tt(ref["pieces"].fourier))
    carry = _port_carry(ref["carry0"])
    kinds, betas = set(), []
    for i in range(N_STEPS):
        count = i + 1
        kinds.add(_interleave_is_flow(count, CFG["mcmc_per_flow_steps"]))
        carry, m = pieces.step_fn(carry, count, *_replayed_noise(ref["keys"][i], count))
        for k, v in ref["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-4, atol=1e-5, err_msg=f"{count} {k}")
        betas.append(float(carry.beta))
    assert kinds == {True, False} and 0 < betas[0] < betas[-1] < 1, "MALA, flow, tempering"

    jc = ref["carry"]
    np.testing.assert_allclose(npy(carry.chain.position), np.asarray(jc.chain.position), atol=1e-4)
    np.testing.assert_allclose(
        npy(carry.chain.logdensity), np.asarray(jc.chain.logdensity), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(float(carry.beta), float(jc.beta), atol=1e-4)
    for k, v in params_from_flax(_tree_np(jc.train.params)).items():
        np.testing.assert_allclose(npy(carry.train.params[k]), npy(v), atol=1e-4, err_msg=k)

    k_ref, _, k_choice = jax.random.split(ref["skey"], 3)
    u = tt(jax.random.normal(k_ref, (N_SAMPLES, D)))
    gumbel = tt(jax.random.gumbel(k_choice, (N_SAMPLES, N_SAMPLES)))
    flow, exact, logw = sample_flow_parts(
        pieces.transport, carry.train.params, pieces.ref_dist, pt.PhiFour(D), u, gumbel=gumbel
    )
    np.testing.assert_allclose(npy(flow), np.asarray(ref["flow"]), atol=1e-4)
    np.testing.assert_allclose(npy(exact), np.asarray(ref["exact"]), atol=1e-4)
    np.testing.assert_allclose(npy(logw), np.asarray(ref["logw"]), rtol=1e-3, atol=1e-3)
    row = evaluate_samples(pt.PhiFour(D), flow, exact)
    for k, v in ref["row"].items():
        if k != "metrics_kernel":
            np.testing.assert_allclose(row[k], v, rtol=1e-3, atol=1e-6, err_msg=k)


def test_port_imports_no_jax():
    code = (
        "import sys, mfm_tpu_torch, mfm_tpu_torch.cli, mfm_tpu_torch.drivers; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mfm_tpu.'))"
        " or m == 'mfm_tpu']; assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("argv,match", [
    (["--example", "pines"], "not ported"),
    (["--example", "4-mode", "--do-smc"], "not ported"),
    (["--example", "4-mode", "--move-correct", "10"], "not ported"),
    (["--example", "4-mode", "--vmap-seeds"], "not ported"),
])
def test_cli_refuses_unported_paths(argv, match):
    from mfm_tpu_torch import cli

    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--device", "cpu"])


def test_unported_config_raises():
    cfg = MFMConfig(**{**CFG, "ref_dist": "prior"})
    with pytest.raises(NotImplementedError, match="prior"):
        build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator())
    cfg = MFMConfig(**{**CFG, "mcmc_kernel": "nuts"})
    with pytest.raises(NotImplementedError, match="mcmc_kernel"):
        build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator())


@pytest.mark.parametrize("override,match", [
    ({"hidden_x": (256, 256), "hidden_xt": (256, 256)}, "widths"),
    ({"non_linearity": "gelu"}, "activations"),
])
def test_fused_field_refuses_what_the_kernel_cannot_take(override, match):
    """pallas_field=true with a net the kernel cannot take raises; the
    module path takes the same net."""
    cfg = MFMConfig(**{**CFG, **override, "pallas_field": True})
    with pytest.raises(ValueError, match=match):
        build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator().manual_seed(0))
    cfg.pallas_field = False
    pieces = build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator())
    assert pieces.field_bind.__qualname__.startswith("module_tangent_field.")


def test_cli_runs_on_cpu(capsys):
    """The entry point end to end at a tiny size (the chip smoke test runs
    it at full size on the GPU)."""
    from mfm_tpu_torch import cli

    (m,) = cli.main([
        "--example", "4-mode", "--device", "cpu", "--seed", "0", "--learning-iter", "8",
        "--num-chain", "8", "--ode-steps", "2", "--chunk-size", "4",
        "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)",
        "--set", "fourier_dim=4", "--set", "eval_iter=4",
    ])
    assert all(np.isfinite(m[k]) for k in ("logpdf", "stein_u", "mmd", "train_time"))
    n_eval = 4 * 8  # eval_iter x num_chain
    assert 1.0 <= m["is_ess"] <= n_eval + 1e-3 and 1 <= m["is_unique"] <= n_eval
    assert "logprob" in capsys.readouterr().out
