"""Ensemble MALA (counterpart of ``mfm_tpu.kernels.mala``).

Proposal x' = x + h grad + sqrt(2h) noise, accepted with the asymmetric MH
ratio exp(E(x -> x') - E(x' -> x)), E(a -> b) = -log pi(a) +
||b - a - h grad(a)||^2 / (4h). ``noise`` (B, d) and ``u_accept`` (B,) are
injected: they are the standard normal and uniform draws the reference
takes from ``key_noise`` and ``key_accept`` (``MalaNoise``, drawn by
``draw_noise``). ``mala`` wraps the kernel as a ``SamplingAlgorithm``
whose ``step(noise, state)`` takes a generator or a ``MalaNoise``;
``run_chain`` runs a kernel for a number of steps.
"""

import math
from typing import Callable, NamedTuple, Tuple

import torch

from mfm_tpu_torch.kernels.base import (
    ChainInfo,
    ChainState,
    SamplingAlgorithm,
    draw,
    step_noise,
)
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


def _row(step_size):
    """A (B, 1) step as (B,), to scale a per-chain sum; else unchanged."""
    return step_size[:, 0] if isinstance(step_size, torch.Tensor) and step_size.ndim == 2 else step_size


def _transition_energy(logdensity_a, pos_a, grad_a, pos_b, step_size):
    theta = pos_b - pos_a - step_size * grad_a
    theta_dot = torch.sum(theta * theta, dim=-1)
    return -logdensity_a + 0.25 / _row(step_size) * theta_dot


def build_kernel(value_and_score: Callable) -> Callable:
    """``kernel(state, step_size, noise, u_accept) -> (state, info)``;
    ``step_size`` a number, a 0-d tensor or one step a chain, (B, 1) (a
    seed sweep's per-seed steps on its rows)."""

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
            prop_logdensity + 0.25 / _row(step_size) * torch.sum(theta * theta, dim=-1)
        )
        return sampled.state, ChainInfo(p_accept, accept, proposed, proposed_weight)

    return kernel


def mala(value_and_score: Callable, step_size: float) -> SamplingAlgorithm:
    """``init(position)``, ``step(noise, state)`` at a fixed step size."""
    kernel = build_kernel(value_and_score)

    def init_fn(position):
        return init(position, value_and_score)

    def step_fn(noise, state):
        B, d = state.position.shape
        noise = draw(noise, lambda g: draw_noise(g, B, d))
        return kernel(state, step_size, noise.noise, noise.u_accept)

    return SamplingAlgorithm(init_fn, step_fn)


def run_chain(noise, kernel: Callable, state: ChainState, step_size, n_steps: int):
    """``n_steps`` of ``kernel`` (``build_kernel``'s) from ``state``;
    ``noise`` a generator or a sequence of one ``MalaNoise`` a step (the
    reference's split keys). Returns the final state, the positions
    (n_steps, B, d) and the acceptance rates (n_steps, B)."""
    positions, acceptance = [], []
    for k in range(n_steps):
        B, d = state.position.shape
        nk = draw(step_noise(noise, k), lambda g: draw_noise(g, B, d))
        state, info = kernel(state, step_size, nk.noise, nk.u_accept)
        positions.append(state.position)
        acceptance.append(info.acceptance_rate)
    return state, torch.stack(positions), torch.stack(acceptance)
