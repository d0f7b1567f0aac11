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

The same for pines at a small size (d=16, 8 chains, Hutchinson, the
'prior' reference, the eval transport with two Rademacher probes), metric
row to 1e-3 relative. The pines preset's ``field_precision='default'`` is
fp32 on XLA:CPU (bf16 only on a TPU), so the port runs 'highest' against
it; a second run of the port with its bf16 field checks that path end to
end (tests/test_torch_precision.py holds the bf16 arithmetic itself).

The same slice with HMC and NUTS as the MCMC move, with in-loop
adaptation over eight replayed steps (a mass refresh at the third MCMC
step, the freeze after the fourth iteration; hmc.py:60,63, nuts.py), to
1e-4 on positions, the metrics and the step size.

Also: the port's packages import no JAX, the CLI runs every example and
flag that has a path (the SMC baseline, NUTS, flow-SMC among them) and
refuses what is not ported yet.
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
from mfm_tpu.flows import make_transport as j_make_transport
from mfm_tpu.targets.cox import LogGaussianCoxPines as JCox
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers import evaluate_samples, sample_flow_parts
from mfm_tpu_torch.drivers.mfm import (
    FMNoise,
    MalaNoise,
    RwmNoise,
    _interleave_is_flow,
    build_mfm,
)
from mfm_tpu_torch.flows import make_transport
from mfm_tpu_torch.kernels.hmc import HMCNoise
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import cli_run_dir, npy, nuts_noise, port_mfm_carry as _port_carry, tt  # noqa: F401

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


PD, PB = 16, 8
PINES_CFG = dict(
    example="pines", dim=PD, num_chain=PB, hidden_x=(16, 16), hidden_t=(16, 16),
    hidden_xt=(16, 16), fourier_dim=8, ode_steps=3, mcmc_per_flow_steps=3.0,
    learning_iter=N_STEPS, chunk_size=N_STEPS, step_size=0.01, hutchinson=True,
    ref_dist="prior", eval_hutchinson_probes=2, eval_probe_dist="rademacher",
)


@pytest.fixture(scope="module")
def pines_reference():
    target = JCox(PD)
    cfg = JConfig(**PINES_CFG, field_precision="default")  # as shipped; fp32 on XLA:CPU
    pieces = j_build(target, cfg, jax.random.PRNGKey(0))
    carry0 = jax.jit(pieces.init_fn)(target.init_positions(jax.random.PRNGKey(1), PB))
    step = jax.jit(pieces.step_fn)
    keys = jax.random.split(jax.random.PRNGKey(2), N_STEPS)
    carry, metrics = carry0, []
    for i in range(N_STEPS):
        carry, m = step(carry, (keys[i], jnp.asarray(i + 1)))
        metrics.append({k: float(v) for k, v in m.items()})
    eval_transport = j_make_transport(
        pieces.apply_fn, divergence=cfg.divergence, n_steps=cfg.ode_steps,
        num_probes=cfg.eval_hutchinson_probes, probe_dist=cfg.eval_probe_dist,
    )
    skey = jax.random.PRNGKey(3)
    flow, exact, logw = j_sample_flow_parts(
        eval_transport, carry.train.params, pieces.ref_dist, skey, N_SAMPLES, target
    )
    return dict(pieces=pieces, carry0=carry0, carry=carry, keys=keys, metrics=metrics,
                skey=skey, flow=flow, exact=exact, logw=logw, row=j_eval(target, flow, exact))


def _replayed_pines_noise(ref_dist, key, count):
    """The draws the reference's step takes from ``key``: Hutchinson probes
    from key_h1 (forward) and key_h2 (inverse), x0 from the prior."""
    k_gen, k_loss = jax.random.split(key)
    if _interleave_is_flow(count, PINES_CFG["mcmc_per_flow_steps"]):
        kg, ka, kh1, kh2 = jax.random.split(k_gen, 4)
        move = RwmNoise(
            tt(jax.random.normal(kg, (PB, PD))), tt(jax.random.uniform(ka, (PB,))),
            tt(jax.random.normal(kh2, (PB, PD))), tt(jax.random.normal(kh1, (PB, PD))),
        )
    else:
        kn, ka = jax.random.split(k_gen)
        move = MalaNoise(tt(jax.random.normal(kn, (PB, PD))), tt(jax.random.uniform(ka, (PB,))))
    kt, kr, ke, _ = jax.random.split(k_loss, 4)
    fm = FMNoise(
        tt(jax.random.uniform(kt, (PB,))), tt(ref_dist.sample(kr, (PB,))),
        tt(jax.random.normal(ke, (PB, PD))),
    )
    return move, fm


def test_pines_slice_matches_reference(pines_reference):
    ref = pines_reference
    ptarget = pt.LogGaussianCoxPines(PD)
    cfg = MFMConfig(**PINES_CFG, field_precision="highest")
    pieces = build_mfm(ptarget, cfg, "cpu", torch.Generator().manual_seed(0))
    assert isinstance(pieces.ref_dist, pt.PriorReference)
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(tt(ref["pieces"].fourier))
    carry = _port_carry(ref["carry0"])
    kinds = set()
    for i in range(N_STEPS):
        count = i + 1
        kinds.add(_interleave_is_flow(count, PINES_CFG["mcmc_per_flow_steps"]))
        noise = _replayed_pines_noise(ref["pieces"].ref_dist, ref["keys"][i], count)
        carry, m = pieces.step_fn(carry, count, *noise)
        for k, v in ref["metrics"][i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=1e-3, atol=1e-5, err_msg=f"{count} {k}")
    assert kinds == {True, False}

    jc = ref["carry"]
    np.testing.assert_allclose(npy(carry.chain.position), np.asarray(jc.chain.position),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(npy(carry.chain.logdensity), np.asarray(jc.chain.logdensity),
                               rtol=1e-3)
    np.testing.assert_allclose(float(carry.beta), float(jc.beta), rtol=1e-3)
    for k, v in params_from_flax(_tree_np(jc.train.params)).items():
        np.testing.assert_allclose(npy(carry.train.params[k]), npy(v), atol=1e-4, err_msg=k)

    # the eval transport: two Rademacher probes a sample
    transport = make_transport(
        pieces.field_bind, divergence=cfg.divergence, n_steps=cfg.ode_steps,
        num_probes=cfg.eval_hutchinson_probes, probe_dist=cfg.eval_probe_dist,
    )
    k_ref, k_hutch, k_choice = jax.random.split(ref["skey"], 3)
    u = tt(ref["pieces"].ref_dist.sample(k_ref, (N_SAMPLES,)))
    probe = tt(jax.random.rademacher(k_hutch, (2, N_SAMPLES, PD), jnp.int8).astype(jnp.float32))
    gumbel = tt(jax.random.gumbel(k_choice, (N_SAMPLES, N_SAMPLES)))
    flow, exact, logw = sample_flow_parts(
        transport, carry.train.params, pieces.ref_dist, ptarget, u, probe, gumbel=gumbel
    )
    np.testing.assert_allclose(npy(flow), np.asarray(ref["flow"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(npy(exact), np.asarray(ref["exact"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(npy(logw), np.asarray(ref["logw"]), rtol=1e-3, atol=1e-3)
    row = evaluate_samples(ptarget, flow, exact)
    for k, v in ref["row"].items():
        if k != "metrics_kernel":
            np.testing.assert_allclose(row[k], v, rtol=1e-3, atol=1e-6, err_msg=k)


def test_pines_slice_runs_with_the_bf16_field(pines_reference):
    """The preset's own precision in the port: bf16 operands in every Dense.
    The same twelve steps stay finite and close to the fp32 ones (the heads
    start at zero, so the field is small: bf16 moves the loss by < 1 %)."""
    ref = pines_reference
    cfg = MFMConfig(**PINES_CFG, field_precision="default")
    pieces = build_mfm(pt.LogGaussianCoxPines(PD), cfg, "cpu", torch.Generator().manual_seed(0))
    assert pieces.net.field_head.precision == "default"
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(tt(ref["pieces"].fourier))
    carry = _port_carry(ref["carry0"])
    for i in range(N_STEPS):
        noise = _replayed_pines_noise(ref["pieces"].ref_dist, ref["keys"][i], i + 1)
        carry, m = pieces.step_fn(carry, i + 1, *noise)
        np.testing.assert_allclose(float(m["loss"]), ref["metrics"][i]["loss"], rtol=1e-2)
    assert bool(torch.isfinite(carry.chain.position).all())


# 8 iterations: MCMC at 1-3 and 5-7, flow at 4 and 8; a mass refresh at 3
# (3 MCMC steps of 16 chains), frozen after 4. Dual averaging feeds each
# acceptance back into the next step size, which doubles an fp32
# difference a step while the count is small: a short run keeps 1e-4.
N_ADAPT = 8
ADAPT_CFG = dict(CFG, learning_iter=N_ADAPT, chunk_size=N_ADAPT, mass_refresh_every=3,
                 adapt_freeze_fraction=0.5, hmc_num_integration_steps=4, nuts_max_depth=3,
                 step_size=2e-3)


@pytest.mark.parametrize("kernel", ["hmc", "nuts"])
def test_slice_with_trajectory_kernel_and_adaptation(kernel):
    """Eight iterations with HMC or NUTS (static, depth 3) on the MCMC
    steps and in-loop adaptation: dual averaging, the Welford mass
    refreshed once the count reaches 3 MCMC steps (at iteration 3), and
    the freeze after iteration 4, whose steps take the averaged step size."""
    target = jt.PhiFour(D)
    jcfg = JConfig(**ADAPT_CFG, mcmc_kernel=kernel)
    pieces_j = j_build(target, jcfg, jax.random.PRNGKey(0))
    carry_j = jax.jit(pieces_j.init_fn)(target.init_positions(jax.random.PRNGKey(1), B))
    step_j = jax.jit(pieces_j.step_fn)
    cfg = MFMConfig(**ADAPT_CFG, mcmc_kernel=kernel)
    pieces = build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(tt(pieces_j.fourier))
    carry = _port_carry(carry_j)
    masses = []
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(2), N_ADAPT)):
        count = i + 1
        carry_j, m_j = step_j(carry_j, (key, jnp.asarray(count)))
        move, fm = _replayed_noise(key, count)
        if not _interleave_is_flow(count, CFG["mcmc_per_flow_steps"]):
            k_gen = jax.random.split(key)[0]
            if kernel == "hmc":
                km, ka = jax.random.split(k_gen)
                move = HMCNoise(tt(jax.random.normal(km, (B, D))),
                                tt(jax.random.uniform(ka, (B,))))
            else:
                move = nuts_noise(k_gen, B, D, 3, "static")
        carry, m = pieces.step_fn(carry, count, move, fm)
        for k, v in m_j.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{count} {k}")
        assert carry.wf.count == int(carry_j.wf.count), count
        masses.append(npy(carry.inv_mass).copy())
        np.testing.assert_allclose(masses[-1], np.asarray(carry_j.inv_mass), rtol=1e-4)
        np.testing.assert_allclose(npy(carry.chain.position), np.asarray(carry_j.chain.position),
                                   atol=1e-4, err_msg=str(count))
    assert np.all(masses[1] == 1.0) and not np.allclose(masses[2], 1.0), "refreshed at 3"
    assert np.all(masses[-1] == masses[2]), "frozen: no refresh after"
    np.testing.assert_allclose(float(m["step_size"]), float(jnp.exp(carry_j.da.log_step_avg)),
                               rtol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys, mfm_tpu_torch, mfm_tpu_torch.cli, mfm_tpu_torch.drivers, "
        "mfm_tpu_torch.drivers.fab, mfm_tpu_torch.drivers.flowmc, mfm_tpu_torch.drivers.dds, "
        "mfm_tpu_torch.flows.coupling; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mfm_tpu.'))"
        " or m == 'mfm_tpu']; assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("argv,match", [
    (["--example", "pines", "--do-fab", "--move-correct", "10"], "move-correct"),
    (["--example", "4-mode", "--defensive-alpha", "0.5", "--do-dds"], "defensive-alpha"),
    (["--example", "4-mode", "--move-correct", "10", "--do-smc"], "move-correct"),
    # a mesh_shape without a process group of its size is refused by name (the
    # case's id is the one it had when the mesh was not ported yet)
    pytest.param(["--example", "4-mode", "--set", "mesh_shape=(2,)"], "no process group",
                 id="argv3-not ported"),
])
def test_cli_refuses_unported_paths(argv, match):
    from mfm_tpu_torch import cli

    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("flag", ["--vmap-seeds", "--full-metrics", "--run-dir", "--wandb"])
def test_cli_runs_the_logging_and_seed_flags(flag, tmp_path, monkeypatch, caplog):
    """The flags the port once refused run on the CPU: each seed's JSONL
    under --run-dir (chunk means, then the row as a summary), one record an
    iteration more with --full-metrics, a one-seed sweep's row with
    --vmap-seeds (seed 1; its training logs no chunk means), and --wandb without wandb installed warns and
    keeps the JSONL."""
    import json

    from mfm_tpu_torch import cli

    monkeypatch.setitem(sys.modules, "wandb", None)  # importing it fails
    run_dir = tmp_path / "logs"
    argv = {"--vmap-seeds": ["--vmap-seeds", "--seed", "1"], "--run-dir": [],
            "--full-metrics": ["--full-metrics"], "--wandb": ["--wandb"]}[flag]
    tiny = [a for a in _TINY if flag != "--vmap-seeds" or a not in ("--seed", "0")]
    rows = cli.main(["--example", "4-mode", *tiny, "--run-dir", str(run_dir), *argv])
    seed = 1 if flag == "--vmap-seeds" else 0
    assert len(rows) == 1 and np.isfinite(rows[0]["logpdf"])
    records = [json.loads(line) for line in
               (run_dir / f"4-mode-seed{seed}.jsonl").read_text().splitlines()]
    summaries = [r for r in records if r.get("_summary")]
    assert len(summaries) == 1 and summaries[0]["logpdf"] == rows[0]["logpdf"]
    per_iter = [r for r in records if "iter" in r and "_t" not in r]
    chunks = [r for r in records if "_t" in r]
    assert len(per_iter) == (8 if flag == "--full-metrics" else 0)
    assert len(chunks) == (0 if flag == "--vmap-seeds" else 2)  # 8 iterations in chunks of 4
    warned = "wandb requested but not installed" in caplog.text
    assert warned == (flag == "--wandb")


def test_unported_config_raises():
    # 'prior' needs a target with a prior sampler
    cfg = MFMConfig(**{**CFG, "ref_dist": "prior"})
    with pytest.raises(NotImplementedError, match="prior"):
        build_mfm(pt.PhiFour(D), cfg, "cpu", torch.Generator())
    cfg = MFMConfig(**{**CFG, "dim": 200, "divergence_mode": "exact_disc"})
    with pytest.raises(ValueError, match="exact_disc"):
        build_mfm(pt.PhiFour(200), cfg, "cpu", torch.Generator())


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


_TINY = [
    "--device", "cpu", "--seed", "0", "--learning-iter", "8", "--num-chain", "8",
    "--ode-steps", "2", "--chunk-size", "4", "--mcmc-per-flow-steps", "3",
    "--set", "hidden_x=(8,)", "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)",
    "--set", "fourier_dim=4", "--set", "eval_iter=4",
]


@pytest.mark.parametrize("argv", [
    ["--example", "pines"],
    ["--example", "funnel"],
    ["--example", "many-well"],
    ["--example", "4-mode", "--num-importance-samples", "4"],
    ["--example", "4-mode", "--num-importance-samples", "-1"],
    ["--example", "4-mode", "--ot-cond-flow"],
    ["--example", "4-mode", "--no-cond-flow"],
    ["--example", "many-well", "--check"],
    ["--example", "4-mode", "--set", "divergence_mode=exact_disc"],
    ["--example", "funnel", "--set", "divergence_mode=exact_disc", "--hutchs"],
    ["--example", "phi-four", "--mcmc-kernel", "nuts", "--set", "step_size=1e-3"],
    ["--example", "4-mode", "--mcmc-kernel", "hmc"],
    ["--example", "pines", "--flow-smc", "2"],
], ids=lambda a: " ".join(a[1:]))
def test_cli_runs_new_examples_and_flags(argv):
    """Each example and flag end to end at a tiny size: a finite metric row
    (pines and phi-four have no sampler: their MMD is reported as 0)."""
    from mfm_tpu_torch import cli

    (m,) = cli.main(argv + _TINY)
    keys = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star", "mmd_star")
    assert all(np.isfinite(m[k]) for k in keys), m
    assert ("stein_u_real" in m) == ("--check" in argv)
    assert (m["mmd"] == 0.0) == (argv[1] in ("pines", "phi-four"))  # no exact sampler
    assert ("step_size" in m) == ("--mcmc-kernel" in argv)
    if "--flow-smc" in argv:
        assert 0.0 < m["flow_smc_lmbda"] <= 1.0 and 0.0 < m["flow_smc_ess_fraction"] <= 1.0
        assert np.isfinite(m["flow_smc_log_z"]) and 1 <= m["is_unique"] <= 4 * 8


@pytest.mark.parametrize("argv", [
    ["--example", "4-mode"],
    ["--example", "phi-four"],
    ["--example", "4-mode", "--mcmc-kernel", "hmc", "--set", "smc_path=geometric",
     "--set", "waste_free_p=4"],
    ["--example", "4-mode", "--mcmc-kernel", "nuts", "--set", "nuts_max_depth=3"],
], ids=lambda a: " ".join(a[1:]))
def test_cli_runs_the_smc_baseline(argv):
    """--do-smc at a tiny size: a finite row on the harvested particles,
    log Z and the anneal's lambda; no importance weights behind the row."""
    from mfm_tpu_torch import cli

    (m,) = cli.main(argv + ["--do-smc"] + _TINY)
    assert all(np.isfinite(m[k]) for k in ("logpdf", "stein_u", "logpdf_star", "log_z"))
    assert 0.0 < m["lmbda"] <= 1.0 and m["is_ess"] is None and m["is_unique"] is None


def test_cli_refuses_flow_smc_with_gradients_through_a_forward_only_gate():
    """phi-four's fused score gate is forward only: latent MALA is refused
    by name before the anneal's first transport."""
    from mfm_tpu_torch import cli

    with pytest.raises(ValueError, match="forward-only"):
        cli.main(["--example", "phi-four", "--flow-smc", "2"] + _TINY)
    with pytest.raises(SystemExit, match="--do-smc"):
        cli.main(["--example", "4-mode", "--flow-smc", "2", "--do-smc"] + _TINY)


def test_cli_has_no_unported_example():
    from mfm_tpu_torch import cli

    assert sorted(cli.EXAMPLES) == sorted(
        ["4-mode", "gaussian-mixture", "phi-four", "pines", "funnel", "many-well"])
    assert not hasattr(cli, "NOT_PORTED_EXAMPLES")
    for name, factory in cli.EXAMPLES.items():  # one call shape for every entry
        if name != "pines":
            assert factory(device="cpu").dim >= 2


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
