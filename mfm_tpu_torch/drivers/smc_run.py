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
run. Only the timing differs. Meshes (``cfg.mesh_shape``) are not ported.
"""

import time
from typing import Callable, NamedTuple

import torch

from mfm_tpu_torch.adaptation.window import da_init, da_update
from mfm_tpu_torch.kernels import hmc, mala, nuts
from mfm_tpu_torch.smc import adaptive_tempered, resampling, tempered
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


def particle_inv_mass(particles: torch.Tensor) -> torch.Tensor:
    """The diagonal inverse mass at a temperature: the particles' population
    variance, floored at 1e-6."""
    return torch.clamp(torch.var(particles, dim=0, correction=0), min=1e-6)


def build_smc(target: Target, cfg, resampler: str = "systematic") -> SMCPieces:
    if cfg.mesh_shape is not None:
        raise NotImplementedError("not ported yet: mesh_shape")
    if cfg.smc_path == "geometric":
        target = GeometricPath(target)
    elif cfg.smc_path != "reference":
        raise ValueError(f"unknown smc_path {cfg.smc_path!r}")
    if cfg.waste_free_p and cfg.num_chain % cfg.waste_free_p:
        raise ValueError(
            f"waste_free_p={cfg.waste_free_p} must divide num_chain={cfg.num_chain}"
        )
    adapt_step, adapt_mass, target_acc = cfg.resolved_adaptation()
    builder, draw_move = _make_kernel_builder(cfg)
    kernel = adaptive_tempered.build_kernel(
        target, builder, mala.init, resampling.get_resampler(resampler), cfg.alpha,
        cfg.iter_per_temp, waste_free_p=cfg.waste_free_p,
    )
    n, d = cfg.num_chain, cfg.dim
    n_moved = n // cfg.waste_free_p if cfg.waste_free_p else n
    n_moves = tempered.num_moves(cfg.iter_per_temp, cfg.waste_free_p)

    def init_fn(positions):
        return SMCCarry(tempered.init(positions), da_init(cfg.step_size, positions.device),
                        torch.ones(d, device=positions.device))

    def step_fn(carry: SMCCarry, noise: SMCStepNoise):
        state, da, inv_mass = carry
        step_size = torch.exp(da.log_step) if adapt_step else cfg.step_size
        if adapt_mass:
            inv_mass = particle_inv_mass(state.particles)
        state, info = kernel(state, noise, (step_size, inv_mass))
        # the inner acceptance, (moves, N) or (P - 1, M): its mean either way
        mean_acc = torch.nan_to_num(torch.mean(info.update_info), nan=0.0)
        return SMCCarry(state, da_update(da, mean_acc, target_acc), inv_mass), info

    def draw_step_noise(gen: torch.Generator) -> SMCStepNoise:
        return SMCStepNoise(
            resampling.draw_noise(resampler, gen, n_moved),
            [draw_move(gen, n_moved, d) for _ in range(n_moves)],
        )

    return SMCPieces(init_fn, step_fn, draw_step_noise, target)


def run_smc(target: Target, cfg, device="cuda", resampler: str = "systematic") -> SMCRunResult:
    """Anneal over ``cfg.learning_iter`` adaptive tempering steps, then
    harvest ``cfg.eval_iter`` more. A warm-up step on the initial carry with
    a separate generator builds the kernels first; ``train_time`` is the
    tempering phase."""
    from mfm_tpu_torch.drivers.mfm import _synchronize, make_generator

    pieces = build_smc(target, cfg, resampler)
    gen = make_generator(device, cfg.seed)
    carry = pieces.init_fn(pieces.target.init_positions(gen, cfg.num_chain))
    pieces.step_fn(carry, pieces.draw_step_noise(make_generator(device, cfg.seed, 1)))
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
    return SMCRunResult(torch.cat(harvest), lmbda, log_z, train_time)
