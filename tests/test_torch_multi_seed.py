"""Port parity for the seed sweep (``--vmap-seeds``): the port's
``run_mfm_seeds`` against ``mfm_tpu.drivers.run_mfm_seeds`` (the whole run
under ``jax.vmap``) on phi-four at a small size (d=4, 16 chains, 16-wide
trunks, 3 RK4 steps, 12 iterations, seeds 0, 1, 2), on both transport
paths of the port (the module under a seed vmap, and K1's seed axis, whose
plain version runs here; the reference's K1 runs in interpret mode under
its vmap), and with HMC and in-loop adaptation over 8 iterations (the
slice test's cut for an adapting run).

The port draws its noise from torch generators; here each seed's noise is
replayed from the reference's key tree (``single_seed`` splits
``PRNGKey(seed)`` as ``run_mfm`` does; mfm.py:347, mala.py:61-64,
flow_mh.py:93-97, losses.py:97-102) and the initial carry is the
reference's, stacked. Tolerances are the slice test's: per-seed metrics
rtol 1e-4, atol 1e-5; positions, parameters and beta 1e-4.

Also: seed s of the port's sweep is the port's own ``run_mfm`` at seed s
(to fp32 rounding, 1e-6; on the CPU the bits agree), a non-finite gradient
in one seed skips only that seed's update, the fused score gate refuses a
tensor batched by ``torch.func.vmap`` (the seed binders never hand it one),
and the CLI's ``--vmap-seeds`` end to end.
"""

import jax
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.config import MFMConfig as JConfig
from mfm_tpu.drivers import run_mfm_seeds as j_run_mfm_seeds
from mfm_tpu.drivers.mfm import build_mfm as j_build
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers import multi_seed, run_mfm, run_mfm_seeds, seed_run
from mfm_tpu_torch.drivers.mfm import (
    FMNoise,
    MalaNoise,
    MFMCarry,
    RwmNoise,
    _interleave_is_flow,
    build_mfm,
    cat_rows,
    stack_trees,
)
from mfm_tpu_torch.kernels import ChainState
from mfm_tpu_torch.kernels.hmc import HMCNoise
from mfm_tpu_torch.ops.phi_four import phi_four_score_gate
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import cli_run_dir, npy, port_mfm_carry, tt  # noqa: F401

torch.set_num_threads(1)

D, B, N_STEPS = 4, 16, 12
SEEDS = [0, 1, 2]
CFG = dict(
    example="phi-four", dim=D, num_chain=B, hidden_x=(16, 16), hidden_t=(16, 16),
    hidden_xt=(16, 16), fourier_dim=8, ode_steps=3, mcmc_per_flow_steps=3.0,
    learning_iter=N_STEPS, chunk_size=N_STEPS, step_size=1e-3, field_precision="highest",
)
# HMC with adaptation over 8 iterations, the slice test's cut: a mass
# refresh at the third MCMC step, frozen after iteration 4 (dual averaging
# feeds each acceptance back into the next step, which doubles an fp32
# difference a step while its count is small: 1e-4 holds over a few steps)
HMC_CFG = dict(CFG, mcmc_kernel="hmc", mass_refresh_every=3, adapt_freeze_fraction=0.5,
               hmc_num_integration_steps=4, step_size=2e-3, learning_iter=8, chunk_size=8)
CASES = {
    "module": dict(CFG, pallas_field=False),
    "kernel": dict(CFG, pallas_field=True),
    "hmc-adapt": dict(HMC_CFG, pallas_field=False),
}


def _replayed_noise(key, count, hmc: bool):
    """The draws one seed's reference step takes from ``key``."""
    k_gen, k_loss = jax.random.split(key)
    if _interleave_is_flow(count, CFG["mcmc_per_flow_steps"]):
        kg, ka, _, _ = jax.random.split(k_gen, 4)
        move = RwmNoise(tt(jax.random.normal(kg, (B, D))), tt(jax.random.uniform(ka, (B,))))
    else:
        k1, k2 = jax.random.split(k_gen)
        noise_type = HMCNoise if hmc else MalaNoise
        move = noise_type(tt(jax.random.normal(k1, (B, D))), tt(jax.random.uniform(k2, (B,))))
    kt, kr, ke, _ = jax.random.split(k_loss, 4)
    fm = FMNoise(
        tt(jax.random.uniform(kt, (B,))), tt(jax.random.normal(kr, (B, D))),
        tt(jax.random.normal(ke, (B, D))),
    )
    return move, fm


def _sweep_carry(carries) -> MFMCarry:
    """S single-seed carries as one sweep carry: chains on S B rows, the rest
    stacked on a seed axis."""
    chain = ChainState(*(torch.cat(v) for v in zip(*(c.chain for c in carries))))
    rest = stack_trees([c._replace(chain=None) for c in carries])
    return rest._replace(chain=chain)


@pytest.fixture(scope="module", params=sorted(CASES))
def reference(request):
    """The reference sweep, and per seed its initial carry, fourier and keys
    (``single_seed``'s split)."""
    cfg = CASES[request.param]
    target = jt.PhiFour(D)
    jcfg = JConfig(**cfg)
    sweep = j_run_mfm_seeds(target, jcfg, SEEDS)
    seeds = []
    for seed in SEEDS:
        key_build, key_pos, key_loop = jax.random.split(jax.random.PRNGKey(seed), 3)
        pieces = j_build(target, jcfg, key_build)
        carry = jax.jit(pieces.init_fn)(target.init_positions(key_pos, B))
        seeds.append((port_mfm_carry(carry), pieces.fourier,
                      jax.random.split(key_loop, jcfg.learning_iter)))
    return request.param, cfg, sweep, seeds


def test_sweep_matches_reference_sweep(reference, monkeypatch):
    """``run_mfm_seeds`` with the reference's initial carry and replayed
    noise: every seed's metrics per iteration, final positions, level and
    parameters against the reference's vmapped sweep."""
    name, cfg_dict, jsweep, seeds = reference
    hmc = cfg_dict.get("mcmc_kernel") == "hmc"

    def replay(gens, count):
        moves, fms = zip(*(_replayed_noise(keys[count - 1], count, hmc) for _, _, keys in seeds))
        return cat_rows(moves), stack_trees(fms)

    def build(target, cfg, device, gens):
        pieces = build_mfm(target, cfg, device, gens)
        with torch.no_grad():
            pieces.fourier.copy_(torch.stack([tt(f) for _, f, _ in seeds]))
        carry0 = _sweep_carry([c for c, _, _ in seeds])
        return pieces._replace(init_fn=lambda positions: carry0, draw_step_noise=replay)

    monkeypatch.setattr(multi_seed, "build_mfm", build)
    cfg = MFMConfig(**cfg_dict)
    sweep = run_mfm_seeds(pt.PhiFour(D), cfg, SEEDS, "cpu")

    assert set(sweep.metrics) == set(jsweep.metrics)
    for k, v in jsweep.metrics.items():
        assert sweep.metrics[k].shape == (len(SEEDS), cfg.learning_iter), k
        np.testing.assert_allclose(npy(sweep.metrics[k]), np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} {k}")
    betas = np.asarray(jsweep.beta)
    assert len(set(np.round(betas, 3))) == len(SEEDS), "tempering differs by seed"
    np.testing.assert_allclose(npy(sweep.beta), betas, atol=1e-4)
    np.testing.assert_allclose(npy(sweep.positions), np.asarray(jsweep.positions), atol=1e-4)
    np.testing.assert_allclose(npy(sweep.fourier), np.asarray(jsweep.fourier), atol=0)
    ref_params = params_from_flax(jax.tree_util.tree_map(np.asarray, jsweep.params))
    for k, v in ref_params.items():
        assert sweep.params[k].shape == v.shape, k
        np.testing.assert_allclose(npy(sweep.params[k]), npy(v), atol=1e-4, err_msg=k)
    if hmc:
        assert "step_size" in sweep.metrics


@pytest.mark.parametrize("overrides", [
    dict(pallas_field=False),
    dict(pallas_field=True),
    dict(HMC_CFG),
    dict(num_importance_samples=3),
    dict(num_importance_samples=-1, ot_cond_flow=True, hutchinson=True),
], ids=["module", "kernel", "hmc-adapt", "cis", "indep-ot-hutchinson"])
def test_sweep_seed_is_its_own_run(overrides):
    """Seed s of the port's sweep computes what ``run_mfm`` computes at
    seed s: metrics, positions, level and parameters within 1e-6 (the same
    generators; the seed axis only batches the arithmetic). Also its
    ``seed_run`` transport against the run's."""
    cfg = MFMConfig(**{**CFG, **overrides})
    sweep = run_mfm_seeds(pt.PhiFour(D), cfg, SEEDS, "cpu")
    for i, seed in enumerate(SEEDS):
        cfg.seed = seed
        run = run_mfm(pt.PhiFour(D), cfg, "cpu")
        one = seed_run(sweep, cfg, i)
        for k, v in run.metrics.items():
            np.testing.assert_allclose(npy(one.metrics[k]), npy(v), rtol=0, atol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(npy(one.chain.position), npy(run.chain.position), atol=1e-6)
        np.testing.assert_allclose(float(one.beta), float(run.beta), atol=1e-6)
        for k, v in run.train.params.items():
            np.testing.assert_allclose(npy(one.train.params[k]), npy(v), atol=1e-6, err_msg=k)
        u = torch.rand((8, D), generator=torch.Generator().manual_seed(seed)) * 1.6 - 0.8
        probe = None if not cfg.hutchinson else torch.randn((8, D))
        x1, ld1 = one.transport.forward(one.train.params, u, probe)
        x0, ld0 = run.transport.forward(run.train.params, u, probe)
        np.testing.assert_allclose(npy(x1), npy(x0), atol=1e-6)
        np.testing.assert_allclose(npy(ld1), npy(ld0), atol=1e-5)


def test_nonfinite_gradient_skips_only_its_seed():
    """A NaN in seed 1's flow-matching noise makes only seed 1's gradient
    non-finite: its parameters and moments stay, its notfinite_count
    counts 1, and seeds 0 and 2 take exactly the update they take without
    it."""
    cfg = MFMConfig(**CFG)
    gens = [torch.Generator().manual_seed(s) for s in SEEDS]
    pieces = build_mfm(pt.PhiFour(D), cfg, "cpu", gens)
    noise_gens = [torch.Generator().manual_seed(10 + s) for s in SEEDS]
    carry = pieces.init_fn(torch.cat([pt.PhiFour(D).init_positions(g, B) for g in noise_gens]))
    move, fm = pieces.draw_step_noise(noise_gens, 1)
    bad_eps = fm.eps.clone()
    bad_eps[1, 3, 0] = torch.nan
    good, m_good = pieces.step_fn(carry, 1, move, fm)
    bad, m_bad = pieces.step_fn(carry, 1, move, fm._replace(eps=bad_eps))
    assert npy(bad.train.opt_state.notfinite_count).tolist() == [0, 1, 0]
    assert npy(bad.train.opt_state.count).tolist() == [1, 0, 1]
    assert np.isnan(float(m_bad["loss"][1])) and np.isfinite(npy(m_bad["loss"][[0, 2]])).all()
    for k, p0 in carry.train.params.items():
        assert torch.equal(bad.train.params[k][1], p0[1]), k
        assert torch.equal(bad.train.opt_state.mu[k][1], carry.train.opt_state.mu[k][1]), k
        for s in (0, 2):
            assert torch.equal(bad.train.params[k][s], good.train.params[k][s]), (k, s)
            assert torch.equal(bad.train.opt_state.nu[k][s], good.train.opt_state.nu[k][s])
    assert not all(torch.equal(good.train.params[k][1], p[1])
                   for k, p in carry.train.params.items()), "without the NaN, seed 1 moves"


def test_score_gate_refuses_a_vmapped_tensor():
    """The fused gate writes through its tensors' memory: under
    ``torch.func.vmap`` it raises by name; the seed binders call it once on
    all S B rows (the sweep tests above run through them)."""
    x = torch.rand(3, 5, D)
    with pytest.raises(ValueError, match="vmap"):
        torch.func.vmap(lambda v: phi_four_score_gate(v, v * 0.0, v * 0.0)[0])(x)
    field, dfield = phi_four_score_gate(x[0], x[0] * 0.0, x[0] * 0.0)
    assert dfield is None and field.shape == (5, D)


_TINY = [
    "--device", "cpu", "--learning-iter", "8", "--num-chain", "8", "--ode-steps", "2",
    "--chunk-size", "4", "--mcmc-per-flow-steps", "3", "--set", "hidden_x=(8,)",
    "--set", "hidden_t=(8,)", "--set", "hidden_xt=(8,)", "--set", "fourier_dim=4",
    "--set", "eval_iter=4",
]


def test_cli_vmap_seeds_rows_are_the_single_seed_rows(tmp_path):
    """``--vmap-seeds`` over seeds 0 and 1 gives each seed the metric row its
    ``--seed s`` run gives (the train time aside: the sweep's is shared
    out), and writes each seed's summary under the run dir."""
    from mfm_tpu_torch import cli

    def rows(argv, run_dir):
        return cli.main(["--example", "4-mode", "--run-dir", str(tmp_path / run_dir)]
                        + argv + _TINY)

    (one,) = rows(["--seed", "1", "--vmap-seeds"], "sweep1")
    (alone,) = rows(["--seed", "1"], "alone1")
    keys = ("logpdf", "stein_u", "stein_v", "mmd", "logpdf_star", "stein_u_star", "mmd_star",
            "is_ess", "is_unique")
    for k in keys:
        np.testing.assert_allclose(one[k], alone[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert (tmp_path / "sweep1" / "4-mode-seed1.jsonl").read_text().count('"_summary"') == 1
