"""Ensemble MALA (counterpart of ``mfm_tpu.kernels.mala``).

Proposal x' = x + h grad + sqrt(2h) noise, accepted with the asymmetric MH
ratio exp(E(x -> x') - E(x' -> x)), E(a -> b) = -log pi(a) +
||b - a - h grad(a)||^2 / (4h). ``noise`` (B, d) and ``u_accept`` (B,) are
injected: they are the standard normal and uniform draws the reference
takes from ``key_noise`` and ``key_accept`` (``MalaNoise``, drawn by
``draw_noise``).
"""

import math
from typing import Callable, NamedTuple, Tuple

import torch

from mfm_tpu_torch.kernels.base import ChainInfo, ChainState
from mfm_tpu_torch.kernels.proposal import (
    Proposal,
    proposal_from_energy_diff,
    static_binomial_sampling,
)


class MalaNoise(NamedTuple):
    noise: torch.Tensor  # (B, d) standard normal
    u_accept: torch.Tensor  # (B,) uniform


def draw_noise(gen: torch.Generator, B: int, d: int) -> MalaNoise:
    dev = gen.device
    return MalaNoise(
        torch.randn((B, d), generator=gen, device=dev), torch.rand(B, generator=gen, device=dev)
    )


def init(position: torch.Tensor, value_and_score: Callable) -> ChainState:
    logdensity, grad = value_and_score(position)
    return ChainState(position, logdensity, grad)


def _transition_energy(logdensity_a, pos_a, grad_a, pos_b, step_size):
    theta = pos_b - pos_a - step_size * grad_a
    theta_dot = torch.sum(theta * theta, dim=-1)
    return -logdensity_a + 0.25 / step_size * theta_dot


def build_kernel(value_and_score: Callable) -> Callable:
    """``kernel(state, step_size, noise, u_accept) -> (state, info)``;
    ``step_size`` a number or a 0-d tensor."""

    def kernel(
        state: ChainState, step_size: float, noise: torch.Tensor, u_accept: torch.Tensor
    ) -> Tuple[ChainState, ChainInfo]:
        # a step size on the device (dual averaging) stays there
        if isinstance(step_size, torch.Tensor):
            scale = torch.sqrt(2.0 * step_size)
        else:
            scale = math.sqrt(2.0 * step_size)
        proposed = state.position + step_size * state.logdensity_grad + scale * noise
        prop_logdensity, prop_grad = value_and_score(proposed)
        fwd = _transition_energy(
            state.logdensity, state.position, state.logdensity_grad, proposed, step_size
        )
        bwd = _transition_energy(
            prop_logdensity, proposed, prop_grad, state.position, step_size
        )
        proposed_state = ChainState(proposed, prop_logdensity, prop_grad)
        new_proposal, _ = proposal_from_energy_diff(fwd, bwd, torch.inf, proposed_state)
        zeros = torch.zeros_like(fwd)
        prev = Proposal(state, fwd, zeros, zeros)
        sampled, accept, p_accept = static_binomial_sampling(u_accept, prev, new_proposal)
        theta = state.position - proposed - step_size * prop_grad
        proposed_weight = torch.exp(
            prop_logdensity + 0.25 / step_size * torch.sum(theta * theta, dim=-1)
        )
        return sampled.state, ChainInfo(p_accept, accept, proposed, proposed_weight)

    return kernel
