"""Flow-annealed SMC: a trained CNF made a weighted sampler with a log
normalising constant (counterpart of ``mfm_tpu/drivers/flow_smc.py:37-307``).

Adaptive tempered SMC in the flow's latent space (``flows/pullback.py``):
each increment's delta-lambda keeps the ESS of the step's weights at
``cfg.alpha``, resampling re-concentrates the ensemble, and inner moves in
u, through the transport, restore diversity. At lambda = 1 the pushed
forward particles are target samples with their weights.

The inner kernel is mala | hmc | nuts (``drivers/smc_run.py``), whose
adaptation resolves for that kernel with step adaptation on by default
(the latent scale has nothing to do with ``cfg.step_size``), or ``tess``:
elliptical slice moves on the tempered latent target, gradient-free and
tuning-free. A gradient kernel takes its gradient through the transport,
which the fused field kernel and a forward-only score gate refuse: the run
says so before any transport (``pullback.check_differentiable``); ``tess``
runs there.

The noise is injected: each tempering step takes fresh Hutchinson probes
(one a batch size the step evaluates, ``FlowSMCStepNoise.probes``) and the
SMC step's draws. The reference chunks the anneal to bound a TPU call;
here it is one loop.
"""

import dataclasses
import math
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from mfm_tpu_torch.adaptation.window import da_init, da_update
from mfm_tpu_torch.flows.cnf import draw_probe
from mfm_tpu_torch.flows.pullback import FlowPullbackTarget, check_differentiable
from mfm_tpu_torch.kernels import mala
from mfm_tpu_torch.kernels.base import ChainState
from mfm_tpu_torch.smc import adaptive_tempered, ess as smc_ess, resampling, tempered
from mfm_tpu_torch.smc.tempered import SMCStepNoise
from mfm_tpu_torch.targets.base import Target


class FlowSMCResult(NamedTuple):
    samples: torch.Tensor  # (N, d) pushed-forward particles at the final lambda
    latent: torch.Tensor  # (N, d) latent particles
    weights: torch.Tensor  # (N,) normalised importance weights
    log_z: torch.Tensor  # log normalising constant estimate of the target
    lmbda: torch.Tensor  # final inverse temperature (1 = reached the target)
    ess_fraction: torch.Tensor  # ESS of ``weights`` / N
    acceptance: torch.Tensor  # (n_steps,) inner-move mean acceptance
    train_time: float


class FlowSMCStepNoise(NamedTuple):
    probes: Optional[Dict[int, torch.Tensor]]  # batch size -> probe; None if exact
    smc: SMCStepNoise


class TESSNoise(NamedTuple):
    nu: torch.Tensor  # (B, d) draws of the reference: the ellipse
    u_y: torch.Tensor  # (B,) uniform: the slice height
    u_theta: torch.Tensor  # (B,) uniform: the first angle
    u_shrink: torch.Tensor  # (max_subiter, B) uniform: one row a shrink trip


class TESSMoveInfo(NamedTuple):
    acceptance_rate: torch.Tensor  # (B,) 1 / shrink trips (a mixing proxy)
    subiter: torch.Tensor


def ess_fraction_of(weights: torch.Tensor) -> torch.Tensor:
    """ESS(w) / N through the log-weight ESS of ``smc/ess.py``."""
    return smc_ess.ess(torch.log(weights)) / weights.shape[0]


def _make_latent_tess_builder(ref_dist: Target, max_subiter: int = 30):
    """(builder, init, draw_noise) of elliptical slice moves on the tempered
    latent target rho_lambda(u) ∝ q0(u) exp(lambda ell(u)) (reference
    :55-146): the ellipse's prior is q0 (ellipses about its
    ``gaussian_mean`` or ``mean``, else 0), and the slice's log-likelihood
    is ``vs.value(u) - log q0(u)``. One transport of the whole ensemble a
    shrink trip; the loop ends when no chain is left to shrink, read on the
    host each trip (each trip is a whole transport: no masked trips)."""
    mean = getattr(ref_dist, "gaussian_mean", None)
    if mean is None:
        mean = getattr(ref_dist, "mean", 0.0)

    def builder(vs, params):
        del params  # nothing to tune

        def slice_l(u):
            return vs.value(u) - ref_dist.log_prob(u)

        def kernel(chain: ChainState, noise: TESSNoise):
            u0, nu = chain.position, noise.nu
            log_y = slice_l(u0) + torch.log(noise.u_y)

            def ellipse(theta):
                return mean + (u0 - mean) * torch.cos(theta)[:, None] + (nu - mean) * torch.sin(
                    theta)[:, None]

            theta = 2.0 * math.pi * noise.u_theta
            tmin, tmax = theta - 2.0 * math.pi, theta
            u = ellipse(theta)
            s = slice_l(u)
            active = (s <= log_y) | ~torch.isfinite(s)
            subiter = torch.ones(u0.shape[0], dtype=torch.int32, device=u0.device)
            for it in range(max_subiter):
                if not bool(active.any()):  # host read: every chain is on its slice
                    break
                prop = torch.maximum(tmin, noise.u_shrink[it] * (tmax - tmin) + tmin)
                theta = torch.where(active, prop, theta)
                u_new = ellipse(theta)
                s_new = slice_l(u_new)
                u = torch.where(active[:, None], u_new, u)
                s = torch.where(active, s_new, s)
                tmin = torch.where(active & (theta < 0), theta, tmin)
                tmax = torch.where(active & (theta > 0), theta, tmax)
                subiter = subiter + active.to(torch.int32)
                active = active & ((s <= log_y) | ~torch.isfinite(s))
            new_chain = ChainState(u, s + ref_dist.log_prob(u), torch.zeros_like(u))
            return new_chain, TESSMoveInfo(1.0 / subiter.to(u.dtype), subiter)

        return kernel

    def init(positions, vs):
        del vs  # no gradient to cache
        return ChainState(positions, torch.zeros(positions.shape[0], device=positions.device),
                          torch.zeros_like(positions))

    def draw_noise(gen, B, d):
        dev = gen.device
        return TESSNoise(
            ref_dist.sample(gen, (B,)), torch.rand(B, generator=gen, device=dev),
            torch.rand(B, generator=gen, device=dev),
            torch.rand((max_subiter, B), generator=gen, device=dev),
        )

    return builder, init, draw_noise


class FlowSMCPieces(NamedTuple):
    init_fn: Callable  # latent positions (N, d) -> carry
    step_fn: Callable  # (carry, FlowSMCStepNoise) -> (carry, SMCInfo, mean acceptance)
    draw_step_noise: Callable  # generator -> FlowSMCStepNoise


def build_flow_smc(
    target: Target,
    cfg,
    transport,
    params,
    ref_dist: Target,
    n_particles: Optional[int] = None,
    inner_kernel: Optional[str] = None,
) -> FlowSMCPieces:
    """The pieces of a flow-SMC anneal of ``n_particles`` (default
    ``cfg.num_chain``); raises, before any transport, when a gradient
    kernel meets a transport that cannot be differentiated."""
    from mfm_tpu_torch.drivers.smc_run import _make_kernel_builder, particle_inv_mass

    n = n_particles or cfg.num_chain
    d = target.dim
    if cfg.waste_free_p and n % cfg.waste_free_p:
        raise ValueError(
            f"waste_free_p={cfg.waste_free_p} must divide the particle count {n}"
        )
    n_mcmc = cfg.iter_per_temp
    kernel_name = inner_kernel or cfg.mcmc_kernel
    if kernel_name == "tess":
        builder, mcmc_init, draw_move = _make_latent_tess_builder(ref_dist)
        adapt_step = adapt_mass = False
        target_acc = 0.0  # unused
    else:
        check_differentiable(target, cfg.pallas_field)
        # adaptation of the kernel that runs (an inner_kernel override brings
        # its own defaults); step adaptation on unless switched off
        inner_cfg = dataclasses.replace(cfg, mcmc_kernel=kernel_name)
        adapt_step, adapt_mass, target_acc = inner_cfg.resolved_adaptation()
        if cfg.adapt_step_size is None:
            adapt_step = True
        builder, draw_move = _make_kernel_builder(inner_cfg)
        mcmc_init = mala.init
    n_moved = n // cfg.waste_free_p if cfg.waste_free_p else n
    n_moves = tempered.num_moves(n_mcmc, cfg.waste_free_p)
    systematic = resampling.get_resampler("systematic")

    def init_fn(u0):
        dev = u0.device
        return tempered.init(u0), da_init(cfg.step_size, dev), torch.ones(d, device=dev)

    def draw_step_noise(gen: torch.Generator) -> FlowSMCStepNoise:
        probes = {B: draw_probe(transport, gen, B, d) for B in sorted({n, n_moved})}
        smc = SMCStepNoise(
            resampling.draw_noise("systematic", gen, n_moved),
            [draw_move(gen, n_moved, d) for _ in range(n_moves)],
        )
        return FlowSMCStepNoise(None if probes[n] is None else probes, smc)

    def step_fn(carry, noise: FlowSMCStepNoise):
        state, da, inv_mass = carry
        latent = FlowPullbackTarget(target, transport, params, ref_dist, noise.probes)
        kernel = adaptive_tempered.build_kernel(
            latent, builder, mcmc_init, systematic, cfg.alpha, n_mcmc,
            waste_free_p=cfg.waste_free_p,
        )
        step_size = torch.exp(da.log_step) if adapt_step else cfg.step_size
        im = particle_inv_mass(state.particles) if adapt_mass else inv_mass
        state, info = kernel(state, noise.smc, (step_size, im))
        mean_acc = torch.nan_to_num(torch.mean(info.update_info), nan=0.0)
        return (state, da_update(da, mean_acc, target_acc), im), info, mean_acc

    return FlowSMCPieces(init_fn, step_fn, draw_step_noise)


def run_flow_smc(
    target: Target,
    cfg,
    transport,
    params,
    ref_dist: Target,
    gen: torch.Generator,
    n_particles: Optional[int] = None,
    n_steps: int = 30,
    inner_kernel: Optional[str] = None,
) -> FlowSMCResult:
    """Anneal q0 --T--> pi in ``n_steps`` adaptive tempering steps (an
    upper bound: steps after lambda reaches 1 are pure moves on the
    pullback). Every draw comes from ``gen``, on the run's device.
    ``train_time`` is the anneal (the training run built the kernels)."""
    from mfm_tpu_torch.drivers.mfm import _synchronize

    pieces = build_flow_smc(target, cfg, transport, params, ref_dist, n_particles,
                            inner_kernel)
    n = n_particles or cfg.num_chain
    carry = pieces.init_fn(ref_dist.sample(gen, (n,)))
    start = time.perf_counter()
    log_z = torch.zeros((), device=gen.device)
    accs = []
    for _ in range(n_steps):
        carry, info, acc = pieces.step_fn(carry, pieces.draw_step_noise(gen))
        log_z = log_z + info.log_likelihood_increment
        accs.append(acc)
    _synchronize(gen.device)
    train_time = time.perf_counter() - start

    state = carry[0]
    probe = draw_probe(transport, gen, n, target.dim)
    samples, _ = transport.forward(params, state.particles, probe)
    return FlowSMCResult(
        samples, state.particles, state.weights, log_z, state.lmbda,
        ess_fraction_of(state.weights), torch.stack(accs), train_time,
    )
