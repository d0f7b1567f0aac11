"""Proposal algebra (counterpart of ``mfm_tpu.kernels.proposal``): the
accept/reject combinators of MH-type kernels, vectorised over the ensemble.
MALA and HMC take their accept from ``proposal_from_energy_diff`` and
``static_binomial_sampling``; the symmetric and asymmetric generators, the
progressive samplers of trajectory-building kernels and the non-reversible
slice accept are the rest of the public set.

Randomness is injected: each Bernoulli draw takes its uniforms
``u_accept`` (B,) and accepts where ``u_accept < p_accept``, which is
exactly ``jax.random.bernoulli``. A proposal's state is a tree of
(B,)-leading tensors (a NamedTuple or a dict).
"""

from typing import Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map


class Proposal(NamedTuple):
    state: NamedTuple  # (B,)-leading tensors
    energy: torch.Tensor
    weight: torch.Tensor
    sum_log_p_accept: torch.Tensor


def _select(accept, new: Proposal, old: Proposal) -> Proposal:
    def pick(n, o):
        mask = accept.reshape(accept.shape + (1,) * (n.ndim - accept.ndim))
        return torch.where(mask, n, o)

    state = tree_map(pick, new.state, old.state)
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


def proposal_generator(energy_fn: Callable, divergence_threshold: float):
    """Symmetric-proposal pair ``(new, update)``: ``new(state)`` a proposal
    at zero weight, ``update(initial_energy, state)`` weighs ``state`` by
    its energy drop."""

    def new(state) -> Proposal:
        e = energy_fn(state)
        return Proposal(state, e, torch.zeros_like(e), torch.full_like(e, -torch.inf))

    def update(initial_energy, state) -> Tuple[Proposal, torch.Tensor]:
        return proposal_from_energy_diff(
            initial_energy, energy_fn(state), divergence_threshold, state
        )

    return new, update


def asymmetric_proposal_generator(transition_energy_fn: Callable, divergence_threshold: float):
    """Asymmetric-proposal pair from the transition energy
    ``transition_energy_fn(a, b)`` of a move a -> b: the accept uses
    E(a -> b) - E(b -> a)."""

    def new(state) -> Proposal:
        leaf = tree_leaves(state)[0]
        zeros = torch.zeros(leaf.shape[:1], device=leaf.device)
        return Proposal(state, zeros, zeros, torch.full_like(zeros, -torch.inf))

    def update(initial_state, state, **energy_params) -> Tuple[Proposal, torch.Tensor]:
        fwd = transition_energy_fn(initial_state, state, **energy_params)
        bwd = transition_energy_fn(state, initial_state, **energy_params)
        return proposal_from_energy_diff(fwd, bwd, divergence_threshold, state)

    return new, update


def _progressive(u_accept, proposal: Proposal, new_proposal: Proposal, p_accept) -> Proposal:
    accept = u_accept < p_accept
    weight = torch.logaddexp(proposal.weight, new_proposal.weight)
    slp = torch.logaddexp(proposal.sum_log_p_accept, new_proposal.sum_log_p_accept)
    out = _select(accept, new_proposal, proposal)
    return Proposal(out.state, out.energy, weight, slp)


def progressive_uniform_sampling(u_accept, proposal: Proposal, new_proposal: Proposal):
    """Multinomial sampling along a trajectory: keep the new proposal with
    probability w_new / (w_old + w_new)."""
    p_accept = torch.sigmoid(new_proposal.weight - proposal.weight)
    return _progressive(u_accept, proposal, new_proposal, p_accept)


def progressive_biased_sampling(u_accept, proposal: Proposal, new_proposal: Proposal):
    """Biased progressive sampling, favouring the new subtree (Betancourt
    2017): keep it with probability min(1, w_new / w_old)."""
    p_accept = torch.clamp(torch.exp(new_proposal.weight - proposal.weight), max=1.0)
    return _progressive(u_accept, proposal, new_proposal, p_accept)


def nonreversible_slice_sampling(slice_var, proposal: Proposal, new_proposal: Proposal):
    """Non-reversible accept/reject driven by a persistent uniform slice
    variable (Neal 2020): accept where log|slice_var| <= the proposal's
    weight, and then rescale the slice variable by exp(-weight)."""
    delta = new_proposal.weight
    accept = torch.log(torch.abs(slice_var)) <= delta
    out = _select(accept, new_proposal, proposal)
    new_slice = torch.where(accept, slice_var * torch.exp(-delta), slice_var)
    return out, accept, new_slice
