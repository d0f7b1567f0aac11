"""One rank of the chain-mesh tests (``test_torch_mesh.py``,
``test_torch_dist_smc.py``), and the cases they compare.

    python tests/torch_mesh_worker.py SUITE INPUTS OUT_DIR RANK WORLD PORT

joins a gloo group of WORLD ranks at localhost:PORT, runs every case of
SUITE (``mesh`` or ``smc``) on the inputs the test saved to INPUTS, and
saves its results to OUT_DIR/rank<RANK>.pt. Each case is a function of
(inputs, mesh); the tests call the same function with ``mesh=None`` for
the one-process run it is held to. Only torch is imported here: the JAX
references stay in the test process.

``start_workers`` is the tests' launcher: it starts the ranks of every
world size at once, each in a session of its own, and kills them all on a
failure or a timeout, so that no rank is left waiting in a collective.
"""

import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from mfm_tpu_torch.adaptation import atess, parallel_eca  # noqa: E402
from mfm_tpu_torch.config import MFMConfig  # noqa: E402
from mfm_tpu_torch.drivers import run_mfm  # noqa: E402
from mfm_tpu_torch.drivers.mfm import build_mfm, make_generator, shard_noise  # noqa: E402
from mfm_tpu_torch.drivers.smc_run import run_smc  # noqa: E402
from mfm_tpu_torch.flows import adam  # noqa: E402
from mfm_tpu_torch.kernels import mala  # noqa: E402
from mfm_tpu_torch.kernels.base import stack  # noqa: E402
from mfm_tpu_torch.parallel.mesh import make_mesh, shard_chains  # noqa: E402
from mfm_tpu_torch.smc.distributed import (  # noqa: E402
    distributed_stratified,
    distributed_systematic,
    distributed_take,
)
from mfm_tpu_torch.targets import IndepGaussian, PhiFour, four_mode_mixture  # noqa: E402
from mfm_tpu_torch.targets.base import Target  # noqa: E402

TIMEOUT_S = 240


def _gather(x, mesh):
    return x if mesh is None else mesh.all_gather_rows(x)


# ------------------------------------------------------------------ mesh
def case_mesh(inputs, mesh):
    """The mesh's rows and collectives; a mesh of the wrong size refused."""
    x = inputs["rows"]
    out = {"rows": shard_chains({"x": x, "s": torch.tensor(1.0)}, mesh)["x"]}
    world = mesh.size
    out["shapes"] = [make_mesh((world,)).shape, make_mesh((1, world)).shape,
                     make_mesh().axis_names]
    try:
        make_mesh((world + 1,))
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    r = torch.full((3,), float(mesh.rank))
    out["sum"] = mesh.all_reduce_sum(r)
    out["left"] = mesh.ring_shift(r, 1)
    out["right"] = mesh.ring_shift(r, -1)
    out["scatter"] = mesh.reduce_scatter_sum(torch.arange(2.0 * world) * (mesh.rank + 1))
    if world == 4:  # a 2-D mesh and its axes
        m2 = make_mesh((2, 2))
        out["axes"] = [m2.axis("ensemble").all_gather_rows(torch.tensor([mesh.rank])),
                       m2.axis("chains").all_gather_rows(torch.tensor([mesh.rank]))]
    return out


def mfm_target(cfg_kw):
    if cfg_kw["example"] == "4-mode":
        return four_mode_mixture("cpu")
    return PhiFour(cfg_kw["dim"])


def case_mfm_steps(inputs, mesh):
    """``step_fn`` from the global carry ``carry0`` with the replayed global
    noise: the gathered positions and the loss after each step."""
    kw = inputs["cfg"]
    cfg = MFMConfig(**kw, mesh_shape=None if mesh is None else mesh.shape)
    pieces = build_mfm(mfm_target(kw), cfg, "cpu", torch.Generator().manual_seed(0), mesh)
    with torch.no_grad():
        pieces.net.fourier_freqs.copy_(inputs["freqs"])
    carry = inputs["carry0"]
    if mesh is not None:
        carry = carry._replace(chain=shard_chains(carry.chain, mesh))
    B = cfg.num_chain
    out = {"pos": [], "loss": [], "acc": []}
    for i, (move, fm) in enumerate(inputs["noises"]):
        carry, m = pieces.step_fn(carry, i + 1, shard_noise(move, mesh, B),
                                  shard_noise(fm, mesh, B))
        out["pos"].append(_gather(carry.chain.position, mesh))
        out["loss"].append(m["loss"])
        out["acc"].append(m["acceptance_mean"])
    out["params"] = carry.train.params
    out["beta"] = carry.beta
    return out


def case_mfm_drawn(inputs, mesh):
    """``step_fn`` with ``draw_step_noise`` from one seeded generator (each
    rank draws all chains' noise and keeps its rows): HMC with the step
    and the mass adapting, a flow step and tempering."""
    kw = inputs["cfg_drawn"]
    cfg = MFMConfig(**kw, mesh_shape=None if mesh is None else mesh.shape)
    target = mfm_target(kw)
    pieces = build_mfm(target, cfg, "cpu", torch.Generator().manual_seed(0), mesh)
    gen = make_generator("cpu", 3)
    positions = target.init_positions(gen, cfg.num_chain)
    carry = pieces.init_fn(positions if mesh is None else shard_chains(positions, mesh))
    out = {"pos": [], "loss": [], "step_size": [], "beta": []}
    for count in range(1, cfg.learning_iter + 1):
        carry, m = pieces.step_fn(carry, count, *pieces.draw_step_noise(gen, count))
        out["pos"].append(_gather(carry.chain.position, mesh))
        out["loss"].append(m["loss"])
        out["step_size"].append(m["step_size"])
        out["beta"].append(m["beta"])
    out["inv_mass"] = carry.inv_mass
    return out


def _ckpt_cfg(kw, directory, mesh):
    return MFMConfig(**kw, checkpoint_dir=directory, checkpoint_every_chunks=1,
                     mesh_shape=None if mesh is None else mesh.shape)


def run_state(run):
    return {"pos": run.chain.position, "params": run.train.params, "beta": run.beta}


def case_checkpoint(inputs, mesh):
    """A sharded run that checkpoints every chunk (into its own directory),
    a resume of the one-process checkpoint at ``resume_at``, and that
    checkpoint's rows restored under the mesh."""
    kw, work = inputs["ckpt_cfg"], inputs["ckpt_dir"]
    target = mfm_target(kw)
    mine = os.path.join(work, f"sharded{mesh.size}")
    whole = run_mfm(target, _ckpt_cfg(kw, mine, mesh), "cpu")
    from_one = os.path.join(work, f"from_one{mesh.size}")
    if mesh.is_primary:
        shutil.copytree(os.path.join(work, "one"), from_one)
        shutil.rmtree(os.path.join(from_one, f"step_{kw['learning_iter']:08d}"))
    mesh.barrier()
    resumed = run_mfm(target, _ckpt_cfg(kw, from_one, mesh), "cpu")
    return {"whole": run_state(whole), "resumed": run_state(resumed),
            "restored": restore_rows(os.path.join(work, "one"), inputs["resume_at"], whole, mesh)}


def restore_rows(directory, step, run, mesh):
    """The chain rows of checkpoint ``step`` that fall to this rank, gathered."""
    from mfm_tpu_torch.utils.checkpoint import _path, _restore_rows

    template = run.chain if mesh is None else shard_chains(run.chain, mesh)
    rows = _restore_rows(_path(directory, step), template, mesh)
    return _gather(rows.position, mesh)


def _eca_kernel_factory(step_size):
    vs = IndepGaussian(2).value_and_score
    k = mala.build_kernel(vs)
    return lambda noise, s: k(s, step_size, *noise)


def _eca_parameter_gn(states, step, step_size):
    return (0.1 + 0.01 * torch.mean(states.position ** 2),)


def case_eca(inputs, mesh):
    """Two steps of ``parallel_eca`` (8 batches of 4, MALA, parameters from
    the data) on the ``ensemble`` axis, and two of ATESS with ECA."""
    ens = None if mesh is None else make_mesh((mesh.size,), ("ensemble",))
    nb, bs = 8, 4
    vs = IndepGaussian(2).value_and_score
    pos = inputs["eca_pos"]
    states = stack([mala.init(p, vs) for p in pos])
    params = (torch.full((nb,), 0.2),)
    if ens is not None:
        states, params = shard_chains((states, params), ens)
    init, update = parallel_eca(_eca_kernel_factory, _eca_parameter_gn, nb, bs, mesh=ens)
    state = init(states)
    for noise in inputs["eca_noise"]:
        state, params, _ = update(noise, state, *params)
    out = {"eca_pos": _gather(state.states.position, ens), "eca_params": _gather(params[0], ens)}

    target = IndepGaussian(2, mean=0.5)
    flow = lambda u, p: (u * torch.exp(p["s"]) + p["b"], torch.sum(p["s"]).expand(u.shape[0]))

    def loss(p, positions):
        u = (positions - p["b"]) * torch.exp(-p["s"])
        return -torch.mean(IndepGaussian(2).log_prob(u) - torch.sum(p["s"]))

    p0 = {"s": torch.zeros(2), "b": torch.zeros(2)}
    x = inputs["atess_pos"]
    x = x if ens is None else shard_chains(x, ens)
    last, _, (fit, _) = atess(target.log_prob, adam(1e-2), p0, flow, loss, 4, 6, num_steps=2,
                              eca=True, mesh=ens).run(inputs["atess_noise"], x)
    out["atess_pos"] = _gather(last.states.position, ens)
    out["atess_b"] = _gather(fit["b"], ens)
    return out


def case_window(inputs, mesh):
    """``window_adaptation`` with HMC on 16 chains, 24 steps (a slow window,
    a mass refresh): the adapted step and mass and the last positions."""
    from mfm_tpu_torch.adaptation.window import window_adaptation
    from mfm_tpu_torch.kernels import hmc

    vs = IndepGaussian(2, var=2.0).value_and_score
    k = hmc.build_kernel(vs)
    kernel = lambda s, step, inv_mass, *noise: k(s, step, 3, inv_mass, *noise)
    pos, noises = inputs["window_pos"], inputs["window_noise"]
    if mesh is not None:
        pos, noises = shard_chains(pos, mesh), [shard_chains(n, mesh) for n in noises]
    run = window_adaptation(kernel, lambda x: mala.init(x, vs), len(noises), 0.5, mesh=mesh)
    state, (step, inv_mass), acc = run(pos, noises)
    return {"pos": _gather(state.position, mesh), "step": step, "inv_mass": inv_mass,
            "acc": acc}


# ------------------------------------------------------------------ smc
def case_resample(inputs, mesh):
    """The distributed resamplers' ancestors and the ring gather, gathered."""
    out = {}
    for name, fn in (("systematic", distributed_systematic),
                     ("stratified", distributed_stratified)):
        for dtype in ("f64", "f32"):
            w = shard_chains(inputs[f"w_{dtype}"], mesh)
            out[f"{name}_{dtype}"] = mesh.all_gather_rows(
                fn(inputs[f"u_{name}_{dtype}"], w, inputs["num_samples"], mesh))
    anc = shard_chains(inputs["take_ancestors"], mesh)
    out["take"] = mesh.all_gather_rows(
        distributed_take(shard_chains(inputs["take_particles"], mesh), anc, mesh))
    try:
        distributed_systematic(inputs["u_systematic_f64"], shard_chains(inputs["w_f64"], mesh),
                               mesh.size + 1, mesh)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    return out


class Banana64(Target):
    """A float64 Gaussian likelihood under a N(0, I) prior."""

    def __init__(self, dim=3):
        self.dim = dim

    def log_lik(self, x):
        return -torch.sum((x - 1.0) ** 2 / 0.3, dim=-1)

    def log_prior(self, x):
        return -0.5 * torch.sum(x * x, dim=-1)

    def init_positions(self, generator, n_chain):
        return torch.randn((n_chain, self.dim), generator=generator, dtype=torch.float64)


SMC_CASES = {
    "mala": dict(mcmc_kernel="mala", step_size=0.3),
    "waste_free_hmc": dict(mcmc_kernel="hmc", step_size=0.3, waste_free_p=4,
                           hmc_num_integration_steps=3),
    "multinomial": dict(mcmc_kernel="mala", step_size=0.3),
}


def case_run_smc(inputs, mesh):
    """``run_smc`` on a float64 target: log Z, lambda and the harvest."""
    out = {}
    for name, kw in SMC_CASES.items():
        cfg = MFMConfig(example="4-mode", dim=3, num_chain=32, learning_iter=5, eval_iter=2,
                        anneal_iter=2, num_anneal_temp=1,
                        mesh_shape=None if mesh is None else mesh.shape, **kw)
        r = run_smc(Banana64(), cfg, "cpu",
                    resampler="multinomial" if name == "multinomial" else "systematic")
        out[name] = {"log_z": r.log_z, "lmbda": r.lmbda, "particles": r.particles}
    return out


SUITES = {"mesh": (case_mesh, case_mfm_steps, case_mfm_drawn, case_eca, case_window,
                   case_checkpoint),
          "smc": (case_resample, case_run_smc)}


def worker(suite, inputs_path, out_dir, rank, world, port):
    import torch.distributed as dist

    from mfm_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    initialize_distributed(f"localhost:{port}", world, rank, timeout_s=TIMEOUT_S)
    try:
        mesh = make_mesh((world,))
        out = {fn.__name__: fn(inputs, mesh) for fn in SUITES[suite]}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_workers(suite, inputs, worlds, work_dir, timeout_s=TIMEOUT_S):
    """Run ``suite`` with ``inputs`` on a group of each size in ``worlds``,
    all at once; {world: every rank's results, in rank order}. Raises with
    the first failing rank's error output."""
    os.makedirs(work_dir, exist_ok=True)
    inputs_path = os.path.join(work_dir, "inputs.pt")
    torch.save(inputs, inputs_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in worlds:
        out_dir, port = os.path.join(work_dir, f"world{world}"), str(_free_port())
        os.makedirs(out_dir, exist_ok=True)
        procs += [(world, r, subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), suite, inputs_path,
             out_dir, str(r), str(world), port],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env,
            start_new_session=True)) for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for _, _, p in procs):
            if any(p.returncode for _, _, p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
    for world, r, p in procs:
        err = p.stderr.read()
        if p.returncode:
            raise RuntimeError(f"{suite} rank {r} of {world} exited {p.returncode}:\n{err[-3000:]}")
    return {world: [torch.load(os.path.join(work_dir, f"world{world}", f"rank{r}.pt"),
                               weights_only=False) for r in range(world)] for world in worlds}


if __name__ == "__main__":
    suite, inputs_path, out_dir, rank, world, port = sys.argv[1:]
    worker(suite, inputs_path, out_dir, int(rank), int(world), int(port))
