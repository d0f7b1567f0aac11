"""Ensemble Hamiltonian Monte Carlo (counterpart of
``mfm_tpu/kernels/hmc.py:35-104``).

One velocity-Verlet trajectory of ``num_integration_steps`` leapfrogs for
the whole (B, d) ensemble, each a batched score pass, with a diagonal
inverse mass, then the batched MH accept of ``kernels/proposal.py`` with
divergence flagging. The noise is injected: the momentum is
``eps / sqrt(inv_mass)`` for standard normal ``eps`` (B, d), and
``u_accept`` (B,) are the accept's uniforms (the reference's ``key_mom``
and ``key_acc``); ``draw_noise`` draws both from a generator. ``hmc``
wraps the kernel as a ``SamplingAlgorithm``.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from mfm_tpu_torch.kernels.base import ChainState, SamplingAlgorithm, draw
from mfm_tpu_torch.kernels.mala import init
from mfm_tpu_torch.kernels.proposal import (
    Proposal,
    proposal_from_energy_diff,
    static_binomial_sampling,
)


class HMCInfo(NamedTuple):
    acceptance_rate: torch.Tensor  # (B,)
    is_accepted: torch.Tensor  # (B,)
    is_divergent: torch.Tensor  # (B,)
    energy: torch.Tensor  # (B,) proposal Hamiltonian
    proposed_position: torch.Tensor  # (B, d)
    num_integration_steps: int


class HMCNoise(NamedTuple):
    eps: torch.Tensor  # (B, d) standard normal: the momentum before the mass
    u_accept: torch.Tensor  # (B,) uniform


def draw_noise(gen: torch.Generator, B: int, d: int) -> HMCNoise:
    dev = gen.device
    return HMCNoise(
        torch.randn((B, d), generator=gen, device=dev), torch.rand(B, generator=gen, device=dev)
    )


def leapfrog(value_and_score, q, p, g, step_size, inv_mass, n_steps: int):
    """Velocity Verlet for the ensemble; returns the final (q, p, logdens, grad)."""
    logdens = None
    for _ in range(n_steps):
        p = p + 0.5 * step_size * g
        q = q + step_size * (inv_mass * p)
        logdens, g = value_and_score(q)
        p = p + 0.5 * step_size * g
    return q, p, logdens, g


def build_kernel(value_and_score: Callable, divergence_threshold: float = 1000.0) -> Callable:
    """``kernel(state, step_size, num_integration_steps, inverse_mass, eps,
    u_accept) -> (state, HMCInfo)``; ``inverse_mass`` (d,), a scalar, or
    None for the identity. ``step_size`` a number or a 0-d tensor. One step
    and one inverse mass a chain, (B, 1) and (B, d), also work (a seed
    sweep's per-seed values on its rows)."""

    def kernel(
        state: ChainState, step_size, num_integration_steps: int,
        inverse_mass: Optional[torch.Tensor], eps: torch.Tensor, u_accept: torch.Tensor,
    ) -> Tuple[ChainState, HMCInfo]:
        d = state.position.shape[-1]
        inv_mass = (
            torch.ones(d, device=eps.device) if inverse_mass is None else inverse_mass
        )
        momentum = eps / torch.sqrt(torch.as_tensor(inv_mass))
        q, p, prop_logdens, prop_grad = leapfrog(
            value_and_score, state.position, momentum, state.logdensity_grad, step_size,
            inv_mass, num_integration_steps,
        )
        kinetic0 = 0.5 * torch.sum(momentum * momentum * inv_mass, dim=-1)
        kinetic1 = 0.5 * torch.sum(p * p * inv_mass, dim=-1)
        h0 = -state.logdensity + kinetic0
        h1 = -prop_logdens + kinetic1
        new_proposal, divergent = proposal_from_energy_diff(
            h0, h1, divergence_threshold, ChainState(q, prop_logdens, prop_grad)
        )
        zeros = torch.zeros_like(h0)
        sampled, accept, p_accept = static_binomial_sampling(
            u_accept, Proposal(state, h0, zeros, zeros), new_proposal
        )
        info = HMCInfo(p_accept, accept, divergent, h1, q, num_integration_steps)
        return sampled.state, info

    return kernel


def hmc(
    value_and_score: Callable,
    step_size: float,
    num_integration_steps: int = 10,
    inverse_mass: Optional[torch.Tensor] = None,
) -> SamplingAlgorithm:
    """``init(position)``, ``step(noise, state)`` with ``noise`` a generator
    or an ``HMCNoise``."""
    kernel = build_kernel(value_and_score)

    def init_fn(position):
        return init(position, value_and_score)

    def step_fn(noise, state):
        B, d = state.position.shape
        noise = draw(noise, lambda g: draw_noise(g, B, d))
        return kernel(state, step_size, num_integration_steps, inverse_mass, noise.eps,
                      noise.u_accept)

    return SamplingAlgorithm(init_fn, step_fn)
