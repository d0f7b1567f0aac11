"""The accept/reject combinators MALA uses (counterpart of the same two
functions in ``mfm_tpu.kernels.proposal``), vectorised over the ensemble.

Randomness is injected: ``static_binomial_sampling`` takes the uniform draw
``u_accept`` and accepts where ``u_accept < p_accept``, which is exactly
``jax.random.bernoulli``.
"""

from typing import NamedTuple, Tuple

import torch


class Proposal(NamedTuple):
    state: NamedTuple  # (B,)-leading tensors
    energy: torch.Tensor
    weight: torch.Tensor
    sum_log_p_accept: torch.Tensor


def _select(accept, new: Proposal, old: Proposal) -> Proposal:
    def pick(n, o):
        mask = accept.reshape(accept.shape + (1,) * (n.ndim - accept.ndim))
        return torch.where(mask, n, o)

    state = type(new.state)(*(pick(n, o) for n, o in zip(new.state, old.state)))
    return Proposal(
        state,
        torch.where(accept, new.energy, old.energy),
        new.weight,
        new.sum_log_p_accept,
    )


def proposal_from_energy_diff(
    prev_energy, new_energy, divergence_threshold: float, state
) -> Tuple[Proposal, torch.Tensor]:
    """Weight a proposal by the energy drop; a NaN drop becomes -inf."""
    delta = prev_energy - new_energy
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    is_divergent = torch.abs(delta) > divergence_threshold
    return Proposal(state, new_energy, delta, torch.clamp(delta, max=0.0)), is_divergent


def static_binomial_sampling(u_accept, proposal: Proposal, new_proposal: Proposal):
    """MH accept/reject for the ensemble with injected uniforms."""
    p_accept = torch.clamp(torch.exp(new_proposal.weight), max=1.0)
    accept = u_accept < p_accept
    return _select(accept, new_proposal, proposal), accept, p_accept
