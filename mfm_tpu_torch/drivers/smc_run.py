"""Adaptive tempered SMC, the reference paper's SMC baseline (counterpart
of ``mfm_tpu/drivers/smc_run.py:41-227``): adaptive tempering with an
ensemble inner kernel and systematic resampling, then a harvest of
``eval_iter`` further steps whose particles are the samples.

The inner kernel is ``cfg.mcmc_kernel`` (mala | hmc | nuts), tuned in the
loop as in the reference: the step size by dual averaging on the mean inner
acceptance, carried across temperatures; for hmc and nuts the inverse mass
is the particle variance at each temperature, floored at 1e-6. Adaptation
resolves through ``cfg.resolved_adaptation()`` (on for hmc and nuts, opt-in
for MALA). ``cfg.smc_path='geometric'`` tempers along
``targets.base.GeometricPath``; ``cfg.waste_free_p`` >= 2 runs waste-free
SMC (``smc/tempered.py``).

The noise is injected: ``step_fn(carry, noise)`` takes one step's draws
(``SMCStepNoise``) and ``draw_step_noise(generator)`` draws them.

Deliberate divergences from the reference: the particle variance is the
population variance (``correction=0``), which is ``jnp.var``'s (torch's
default divides by N - 1); and the reference runs the whole anneal twice
so that its timed run excludes compilation (:216-222), where the port warms
up one step with a separate generator, as ``run_mfm`` does, and times one
run. Only the timing differs.

Under a chain mesh (``cfg.mesh_shape``, ``mfm_tpu/drivers/smc_run.py:104-155``)
each rank holds its rows of the particles: ``systematic`` and
``stratified`` take the distributed resampler and every scheme the ring
gather (``smc.distributed``); the other schemes resample the gathered
weights (N scalars), as XLA gathers them for the reference. The ESS
solve, the log Z increment and the normalised weights are global
(``smc.base``, ``smc.ess``); so are the particle variance (two
all-reduces of d floats) and the dual averaging's mean acceptance
(gathered). Waste-free SMC needs num_chain / P divisible by the shard
count. ``run_smc`` returns the harvest of every rank on every rank.
"""

import time
from typing import Callable, NamedTuple

import torch

from mfm_tpu_torch.adaptation.window import da_init, da_update
from mfm_tpu_torch.kernels import hmc, mala, nuts
from mfm_tpu_torch.parallel.mesh import shard_chains
from mfm_tpu_torch.smc import adaptive_tempered, resampling, tempered
from mfm_tpu_torch.smc.distributed import make_distributed_gather, make_distributed_resampler
from mfm_tpu_torch.smc.tempered import SMCStepNoise
from mfm_tpu_torch.targets.base import GeometricPath, Target

class SMCRunResult(NamedTuple):
    particles: torch.Tensor  # (eval_iter * n_chain, d) harvested samples
    lmbda: torch.Tensor  # at the end of the anneal, before the harvest
    log_z: torch.Tensor  # accumulated over the anneal
    train_time: float


class SMCCarry(NamedTuple):
    state: tempered.TemperedSMCState
    da: object  # DualAveragingState
    inv_mass: torch.Tensor


class SMCPieces(NamedTuple):
    init_fn: Callable  # positions -> SMCCarry
    step_fn: Callable  # (carry, SMCStepNoise) -> (carry, SMCInfo)
    draw_step_noise: Callable  # generator -> SMCStepNoise
    target: Target  # the tempered target (the geometric path where asked)
    mesh: object = None  # the chain mesh (parallel.mesh.ChainMesh), or None


def _make_kernel_builder(cfg):
    """(builder, draw_noise) of ``cfg.mcmc_kernel``: ``builder(vs,
    (step_size, inv_mass))`` gives ``kernel(chain, noise)``, and
    ``draw_noise(generator, B, d)`` that kernel's noise."""
    name = cfg.mcmc_kernel
    if name == "mala":

        def builder(vs, params):
            step_size, _ = params
            k = mala.build_kernel(vs)
            return lambda s, noise: k(s, step_size, *noise)

        return builder, mala.draw_noise
    if name == "hmc":

        def builder(vs, params):
            step_size, inv_mass = params
            k = hmc.build_kernel(vs)
            return lambda s, noise: k(s, step_size, cfg.hmc_num_integration_steps, inv_mass,
                                      *noise)

        return builder, hmc.draw_noise
    if name == "nuts":
        variant = nuts.resolve_variant(cfg.nuts_max_depth, cfg.nuts_variant)

        def builder(vs, params):
            step_size, inv_mass = params
            k = nuts.build_kernel(vs, cfg.nuts_max_depth, variant=variant)
            return lambda s, noise: k(s, step_size, inv_mass, noise)

        return builder, lambda gen, B, d: nuts.draw_noise(gen, B, d, cfg.nuts_max_depth, variant)
    raise ValueError(f"unknown mcmc_kernel {name!r} (known: mala, hmc, nuts)")


def particle_inv_mass(particles: torch.Tensor, mesh=None) -> torch.Tensor:
    """The diagonal inverse mass at a temperature: the particles' population
    variance, floored at 1e-6; over every rank's rows under ``mesh``."""
    if mesh is None:
        var = torch.var(particles, dim=0, correction=0)
    else:
        n = particles.shape[0] * mesh.size
        mean = mesh.all_reduce_sum(torch.sum(particles, dim=0)) / n
        var = mesh.all_reduce_sum(torch.sum((particles - mean) ** 2, dim=0)) / n
    return torch.clamp(var, min=1e-6)


def _gathered_resampler(resample_fn, mesh):
    """A single-device scheme on the gathered weights; this rank's slice of
    the ancestors."""

    def resample(noise, weights, num_samples):
        return resample_fn(noise, mesh.all_gather_rows(weights), num_samples)[
            mesh.rows(num_samples)]

    return resample


def build_smc(target: Target, cfg, resampler: str = "systematic", device=None,
              mesh=None) -> SMCPieces:
    """The pieces of an SMC run; under a chain mesh (``mesh``, or
    ``cfg.mesh_shape`` over the initialised process group) ``init_fn`` and
    ``step_fn`` take this rank's rows and ``draw_step_noise`` returns them."""
    from mfm_tpu_torch.drivers.mfm import mesh_of, shard_noise

    mesh = mesh_of(cfg, device, mesh)
    if cfg.smc_path == "geometric":
        target = GeometricPath(target)
    elif cfg.smc_path != "reference":
        raise ValueError(f"unknown smc_path {cfg.smc_path!r}")
    if cfg.waste_free_p and cfg.num_chain % cfg.waste_free_p:
        raise ValueError(
            f"waste_free_p={cfg.waste_free_p} must divide num_chain={cfg.num_chain}"
        )
    n, d = cfg.num_chain, cfg.dim
    n_moved = n // cfg.waste_free_p if cfg.waste_free_p else n
    resample_fn, gather_fn = resampling.get_resampler(resampler), None
    if mesh is not None:
        if n_moved % mesh.size:
            raise ValueError(
                f"waste-free under a mesh needs num_chain / waste_free_p = {n_moved} "
                f"divisible by the shard count {mesh.size}")
        if resampler in ("systematic", "stratified"):
            resample_fn = make_distributed_resampler(resampler, mesh)
        else:
            resample_fn = _gathered_resampler(resample_fn, mesh)
        gather_fn = make_distributed_gather(mesh)
    adapt_step, adapt_mass, target_acc = cfg.resolved_adaptation()
    builder, draw_move = _make_kernel_builder(cfg)
    kernel = adaptive_tempered.build_kernel(
        target, builder, mala.init, resample_fn, cfg.alpha, cfg.iter_per_temp,
        gather_fn=gather_fn, waste_free_p=cfg.waste_free_p, mesh=mesh,
    )
    n_moves = tempered.num_moves(cfg.iter_per_temp, cfg.waste_free_p)

    def init_fn(positions):
        state = tempered.init(positions)
        if mesh is not None:  # this rank's rows of N uniform weights
            state = state._replace(weights=torch.full_like(state.weights, 1.0 / n))
        return SMCCarry(state, da_init(cfg.step_size, positions.device),
                        torch.ones(d, device=positions.device))

    def step_fn(carry: SMCCarry, noise: SMCStepNoise):
        state, da, inv_mass = carry
        step_size = torch.exp(da.log_step) if adapt_step else cfg.step_size
        if adapt_mass:
            inv_mass = particle_inv_mass(state.particles, mesh)
        state, info = kernel(state, noise, (step_size, inv_mass))
        # the inner acceptance, (moves, N) or (P - 1, M): its mean either way
        acc = info.update_info
        if mesh is not None:
            acc = mesh.all_gather_rows(acc.T.contiguous()).T.contiguous()
        mean_acc = torch.nan_to_num(torch.mean(acc), nan=0.0)
        return SMCCarry(state, da_update(da, mean_acc, target_acc), inv_mass), info

    def draw_step_noise(gen: torch.Generator) -> SMCStepNoise:
        """One step's draws for all particles: this rank's rows of the
        moves' under a mesh (the resampler's uniforms are every rank's)."""
        return SMCStepNoise(
            resampling.draw_noise(resampler, gen, n_moved),
            [shard_noise(draw_move(gen, n_moved, d), mesh, n_moved) for _ in range(n_moves)],
        )

    return SMCPieces(init_fn, step_fn, draw_step_noise, target, mesh)


def run_smc(target: Target, cfg, device="cuda", resampler: str = "systematic") -> SMCRunResult:
    """Anneal over ``cfg.learning_iter`` adaptive tempering steps, then
    harvest ``cfg.eval_iter`` more. A warm-up step on the initial carry with
    a separate generator builds the kernels first; ``train_time`` is the
    tempering phase."""
    from mfm_tpu_torch.drivers.mfm import WARM_STREAM, _synchronize, make_generator

    pieces = build_smc(target, cfg, resampler, device)
    mesh = pieces.mesh
    gen = make_generator(device, cfg.seed)
    positions = pieces.target.init_positions(gen, cfg.num_chain)
    carry = pieces.init_fn(positions if mesh is None else shard_chains(positions, mesh))
    pieces.step_fn(carry, pieces.draw_step_noise(make_generator(device, cfg.seed, WARM_STREAM)))
    _synchronize(device)

    start = time.perf_counter()
    log_z = torch.zeros((), device=carry.inv_mass.device)
    for _ in range(cfg.learning_iter):
        carry, info = pieces.step_fn(carry, pieces.draw_step_noise(gen))
        log_z = log_z + info.log_likelihood_increment
    _synchronize(device)
    train_time = time.perf_counter() - start

    lmbda = carry.state.lmbda  # the anneal's, as the reference reports it
    harvest = []
    for _ in range(cfg.eval_iter):
        carry, _ = pieces.step_fn(carry, pieces.draw_step_noise(gen))
        harvest.append(carry.state.particles)
    if mesh is not None:  # every rank's rows, step by step
        harvest = list(mesh.all_gather_rows(torch.stack(harvest, dim=1)).transpose(0, 1))
    return SMCRunResult(torch.cat(harvest), lmbda, log_z, train_time)
