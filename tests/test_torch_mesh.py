"""The chain mesh (``mfm_tpu_torch.parallel.mesh``, the sharded
``drivers/mfm.py``, ``parallel_eca``/``atess`` with ``mesh=``, row-sharded
checkpoints, ``python -m mfm_tpu_torch.parallel.run_mfm``) on the CPU,
as 2 and as 4 gloo processes against one process and against the
reference's sharded step on the virtual CPU mesh.

One module-scoped fixture a world size starts the ranks once
(``torch_mesh_worker.start_workers``); every case then compares what they
returned. Tolerances are ``tests/test_sharding.py:46``'s: positions rtol
1e-4, atol 1e-5; the loss rtol 1e-4. Within a sharded run every rank
holds the same replicated state, bit for bit.

- rows: rank r's rows are the reference's shard on virtual device r;
- two MFM steps on 4-mode (a MALA step, then a flow step, with the OT
  coupling) under the reference's replayed noise, against the
  reference's step sharded over mesh (1, 4) and the port's unsharded step;
- six phi-four steps with HMC adapting its step and mass, a flow step
  and tempering, the noise drawn by ``draw_step_noise``, against one
  process;
- two steps of ``parallel_eca`` (MALA) and of ``atess`` with ECA on the
  ``ensemble`` axis against the unsharded calls; ``window_adaptation``
  (HMC, 24 steps) against the unsharded call;
- a checkpoint written by S ranks resumed in one process, and one written
  by one process resumed by S ranks, each against the whole run; the rows
  restored under the mesh equal the saved rows;
- the launcher's two ranks print equal digests, and it exits non-zero
  when its ranks fail.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import torch_mesh_worker as w
from mfm_tpu.config import MFMConfig as JConfig
from mfm_tpu.drivers.mfm import build_mfm as j_build
from mfm_tpu.parallel import make_mesh as j_make_mesh
from mfm_tpu.parallel import replicate as j_replicate
from mfm_tpu.parallel import shard_chains as j_shard
from mfm_tpu_torch import cli
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers import run_mfm
from mfm_tpu_torch.drivers.mfm import FMNoise, MalaNoise, RwmNoise, _interleave_is_flow
from mfm_tpu_torch.kernels import hmc, mala, tess
from mfm_tpu_torch.parallel.mesh import make_mesh, pick_backend
from torch_parity import npy, port_mfm_carry, tt

torch.set_num_threads(1)

B, D = 32, 2
CFG = dict(example="4-mode", dim=D, num_chain=B, learning_iter=2, hidden_x=(16,),
           hidden_t=(16,), hidden_xt=(16,), fourier_dim=8, ode_steps=4, mcmc_per_flow_steps=1.0,
           ot_cond_flow=True, field_precision="highest")
DRAWN = dict(example="phi-four", dim=4, num_chain=16, learning_iter=6, hidden_x=(16,),
             hidden_t=(16,), hidden_xt=(16,), fourier_dim=8, ode_steps=3,
             mcmc_per_flow_steps=3.0, step_size=1e-3, mcmc_kernel="hmc",
             hmc_num_integration_steps=3, mass_refresh_every=2, anneal_iter=2,
             num_anneal_temp=1)
CKPT = dict(example="phi-four", dim=4, num_chain=16, hidden_x=(16, 16), hidden_t=(16, 16),
            hidden_xt=(16, 16), fourier_dim=8, ode_steps=3, mcmc_per_flow_steps=3.0,
            learning_iter=8, chunk_size=4, step_size=1e-3)
RESUME_AT = 4
TOL = dict(rtol=1e-4, atol=1e-5)


def _replayed_noise(jpieces, key, count):
    """The draws the reference's step takes from ``key`` (mala.py:61-64,
    flow_mh.py:93-97, losses.py:97-102 with the OT choice's key)."""
    k_gen, k_loss = jax.random.split(key)
    if _interleave_is_flow(count, CFG["mcmc_per_flow_steps"]):
        kg, ka, _, _ = jax.random.split(k_gen, 4)
        move = RwmNoise(tt(jax.random.normal(kg, (B, D))), tt(jax.random.uniform(ka, (B,))))
    else:
        kn, ka = jax.random.split(k_gen)
        move = MalaNoise(tt(jax.random.normal(kn, (B, D))), tt(jax.random.uniform(ka, (B,))))
    kt, kr, ke, ko = jax.random.split(k_loss, 4)
    fm = FMNoise(tt(jax.random.uniform(kt, (B,))), tt(jpieces.ref_dist.sample(kr, (B,))),
                 tt(jax.random.normal(ke, (B, D))), tt(jax.random.uniform(ko, (B,))))
    return move, fm


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The inputs every rank gets, the reference's sharded steps, and the
    one-process checkpoint the ranks resume."""
    jpieces = j_build(jt.four_mode_mixture(), JConfig(**CFG), jax.random.PRNGKey(0))
    jcarry0 = jax.jit(jpieces.init_fn)(jt.four_mode_mixture().init_positions(
        jax.random.PRNGKey(1), B))
    keys = [jax.random.PRNGKey(2), jax.random.PRNGKey(3)]
    mesh = j_make_mesh((1, 4), ("ensemble", "chains"), jax.devices()[:4])
    carry = jcarry0._replace(chain=j_shard(jcarry0.chain, mesh),
                             train=j_replicate(jcarry0.train, mesh),
                             beta=j_replicate(jcarry0.beta, mesh))
    step = jax.jit(jpieces.step_fn)
    jsteps = []
    with mesh:
        for i, k in enumerate(keys):
            carry, m = step(carry, (k, jnp.asarray(i + 1)))
            jsteps.append((np.asarray(carry.chain.position), float(m["loss"])))

    gen = torch.Generator().manual_seed(5)
    eca_noise = [[mala.draw_noise(gen, 4, 2) for _ in range(8)] for _ in range(2)]
    atess_noise = [[tess.draw_noise(gen, 6, 2) for _ in range(4)] for _ in range(2)]
    window_noise = [hmc.draw_noise(gen, 16, 2) for _ in range(24)]
    work = tmp_path_factory.mktemp("mesh")
    one = run_mfm(w.mfm_target(CKPT), w._ckpt_cfg(CKPT, str(work / "one"), None), "cpu")
    return {
        "rows": torch.arange(48.0).reshape(16, 3),
        "cfg": CFG, "carry0": port_mfm_carry(jcarry0), "freqs": tt(jpieces.fourier),
        "noises": [_replayed_noise(jpieces, k, i + 1) for i, k in enumerate(keys)],
        "cfg_drawn": DRAWN,
        "eca_pos": torch.randn((8, 4, 2), generator=gen), "eca_noise": eca_noise,
        "atess_pos": torch.randn((4, 6, 2), generator=gen), "atess_noise": atess_noise,
        "window_pos": torch.randn((16, 2), generator=gen), "window_noise": window_noise,
        "ckpt_cfg": CKPT, "ckpt_dir": str(work), "resume_at": RESUME_AT,
        "jsteps": jsteps, "one": w.run_state(one),
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every rank's results at world sizes 2 and 4."""
    sent = {k: v for k, v in inputs.items() if k not in ("jsteps", "one")}
    return w.start_workers("mesh", sent, (2, 4), str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def one_process(inputs):
    """The cases in this process, without a mesh."""
    return {fn.__name__: fn(inputs, None) for fn in (w.case_mfm_steps, w.case_mfm_drawn,
                                                      w.case_eca, w.case_window)}


def _close(a, b, **tol):
    np.testing.assert_allclose(npy(a), npy(b), **(tol or TOL))


def _same_on_every_rank(results, key, fields):
    for r in results[1:]:
        for f in fields:
            a, b = results[0][key][f], r[key][f]
            if isinstance(a, dict):
                assert all(torch.equal(a[k], b[k]) for k in a), f
            elif isinstance(a, list):
                assert all(torch.equal(x, y) for x, y in zip(a, b)), f
            else:
                assert torch.equal(a, b), f


@pytest.mark.parametrize("world", [2, 4])
def test_rows_and_collectives(ranks, inputs, world):
    mesh = j_make_mesh((world,), ("chains",), jax.devices()[:world])
    shards = sorted(j_shard(jnp.asarray(npy(inputs["rows"])), mesh).addressable_shards,
                    key=lambda s: s.index[0].start)
    for r, out in enumerate(ranks[world]):
        got = out["case_mesh"]
        np.testing.assert_array_equal(npy(got["rows"]), np.asarray(shards[r].data))
        assert got["shapes"] == [(world,), (1, world), ("ensemble", "chains")]
        assert "does not cover" in got["refused"]
        assert torch.equal(got["sum"], torch.full((3,), float(sum(range(world)))))
        assert torch.equal(got["left"], torch.full((3,), float((r - 1) % world)))
        assert torch.equal(got["right"], torch.full((3,), float((r + 1) % world)))
        full = sum(torch.arange(2.0 * world) * (k + 1) for k in range(world))
        assert torch.equal(got["scatter"], full[2 * r:2 * r + 2])
        if world == 4:  # mesh (2, 2): rank = 2 e + c
            e, c = divmod(r, 2)
            assert got["axes"][0].tolist() == [c, 2 + c] and got["axes"][1].tolist() == [2 * e,
                                                                                         2 * e + 1]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_steps_match_reference_and_one_process(ranks, inputs, one_process, world):
    results = [r["case_mfm_steps"] for r in ranks[world]]
    _same_on_every_rank([{"x": r} for r in results], "x", ("pos", "loss", "params", "beta"))
    got, one = results[0], one_process["case_mfm_steps"]
    for i, (jpos, jloss) in enumerate(inputs["jsteps"]):
        _close(got["pos"][i], jpos)
        np.testing.assert_allclose(float(got["loss"][i]), jloss, rtol=1e-4)
        _close(got["pos"][i], one["pos"][i])
        np.testing.assert_allclose(float(got["loss"][i]), float(one["loss"][i]), rtol=1e-4)
        np.testing.assert_allclose(float(got["acc"][i]), float(one["acc"][i]), rtol=1e-6)
    for k, v in got["params"].items():
        _close(v, one["params"][k])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_adapting_run_matches_one_process(ranks, one_process, world):
    results = [r["case_mfm_drawn"] for r in ranks[world]]
    _same_on_every_rank([{"x": r} for r in results], "x", ("pos", "step_size", "beta"))
    got, one = results[0], one_process["case_mfm_drawn"]
    assert 0 < float(one["beta"][0]) < float(one["beta"][-1])  # it tempered
    for i in range(DRAWN["learning_iter"]):
        _close(got["pos"][i], one["pos"][i])
        np.testing.assert_allclose(float(got["loss"][i]), float(one["loss"][i]), rtol=1e-4)
        np.testing.assert_allclose(float(got["step_size"][i]), float(one["step_size"][i]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(got["beta"][i]), float(one["beta"][i]), rtol=1e-4)
    assert not torch.equal(one["inv_mass"], torch.ones(DRAWN["dim"]))  # a mass refresh ran
    _close(got["inv_mass"], one["inv_mass"])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_eca_and_atess_match_unsharded(ranks, one_process, world):
    got, one = ranks[world][0]["case_eca"], one_process["case_eca"]
    for k in ("eca_pos", "eca_params", "atess_pos", "atess_b"):
        _close(got[k], one[k])
        assert all(torch.equal(r["case_eca"][k], got[k]) for r in ranks[world])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_window_adaptation_matches_unsharded(ranks, one_process, world):
    """The mean acceptance an all-reduce of sum and count, Welford over every
    rank's positions: the same step, mass and chains as one process."""
    got, one = ranks[world][0]["case_window"], one_process["case_window"]
    assert not torch.equal(one["inv_mass"], torch.ones(2))  # a window ended
    for k in ("pos", "step", "inv_mass", "acc"):
        _close(got[k], one[k])
        assert all(torch.equal(r["case_window"][k], got[k]) for r in ranks[world])


@pytest.mark.parametrize("world", [2, 4])
def test_checkpoints_resume_across_world_sizes(ranks, inputs, world, tmp_path):
    """One process's checkpoint resumed by S ranks, and S ranks' resumed by
    one process, each against the uninterrupted run; the rows restored
    under the mesh are the saved rows, bit for bit."""
    results = [r["case_checkpoint"] for r in ranks[world]]
    one, got = inputs["one"], results[0]
    for r in results:
        assert torch.equal(r["restored"], results[0]["restored"])
    whole_rows = torch.load(os.path.join(
        inputs["ckpt_dir"], "one", f"step_{RESUME_AT:08d}",
        f"rows_{0:010d}_{CKPT['num_chain']:010d}.pt"), weights_only=True)["leaves"][0]
    assert torch.equal(got["restored"], whole_rows)

    def same(a, b):
        _close(a["pos"], b["pos"])
        _close(a["beta"], b["beta"])
        for k, v in a["params"].items():
            _close(v, b["params"][k])

    same(got["whole"], one)  # S ranks against one process, the whole run
    same(got["resumed"], one)  # one process's checkpoint, resumed by S ranks
    sharded = tmp_path / "sharded"
    shutil.copytree(os.path.join(inputs["ckpt_dir"], f"sharded{world}"), sharded)
    shutil.rmtree(sharded / f"step_{CKPT['learning_iter']:08d}")
    resumed = run_mfm(w.mfm_target(CKPT), w._ckpt_cfg(CKPT, str(sharded), None), "cpu")
    same(w.run_state(resumed), got["whole"])  # S ranks' checkpoint, resumed by one


def test_run_mfm_launcher_ranks_agree(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.parallel.run_mfm", "--device", "cpu",
         "--num-processes", "2", "--learning-iter", "6", "--chunk-size", "2",
         "--coordinator", f"localhost:{w._free_port()}", "--timeout", "200"],
        capture_output=True, text=True, timeout=240, cwd=w.ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["process_id"] for r in lines] == [0, 1]
    assert lines[0]["state_digest"] == lines[1]["state_digest"]
    assert lines[0]["chunks_digest"] == lines[1]["chunks_digest"]
    assert all(r["n_chunks"] == 3 and r["num_chain_global"] == 16 and r["global_devices"] == 2
               for r in lines)
    assert set(lines[0]["launches"]) == {"field_apply", "stein_pairwise_sum", "rbf_kernel_sum",
                                         "phi_four_value_and_score", "phi_four_score_gate"}


def test_run_mfm_launcher_exits_non_zero_when_its_ranks_fail():
    """16 chains do not split over 3 ranks: every rank refuses the mesh by
    name before its first collective, and the launcher exits non-zero."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mfm_tpu_torch.parallel.run_mfm", "--device", "cpu",
         "--num-processes", "3", "--learning-iter", "2",
         "--coordinator", f"localhost:{w._free_port()}", "--timeout", "100"],
        capture_output=True, text=True, timeout=160, cwd=w.ROOT, env=env)
    assert out.returncode != 0
    assert "num_chain=16 does not split over the 3 ranks" in out.stderr


@pytest.mark.parametrize("flag", ["--vmap-seeds", "--do-fab", "--do-flowmc", "--do-dds",
                                  "--flow-smc", "--move-correct"])
def test_cli_refuses_a_mesh_where_there_is_no_sharded_path(flag):
    """A deliberate divergence: the reference runs these unsharded, or drops
    the mesh; the port refuses the pair by name, before any group starts."""
    value = {"--flow-smc": ["2"], "--move-correct": ["10"]}.get(flag, [])
    with pytest.raises(SystemExit, match="has no sharded path"):
        cli.main(["--example", "4-mode", "--device", "cpu", "--set", "mesh_shape=(1,2)", flag,
                  *value])


def test_mesh_without_a_group_and_nccl_on_shared_cards_are_refused():
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        make_mesh((1, 2))
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        run_mfm(w.mfm_target(CKPT), MFMConfig(**{**CKPT, "mesh_shape": (1, 2)}), "cpu")
    assert pick_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL cannot run"):
        pick_backend("cpu", "nccl")
