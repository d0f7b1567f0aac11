"""Cross-chain and ensemble-chain adaptation scaffolding (counterpart of
``mfm_tpu/adaptation/chain_adaptation.py``).

- ``cross_chain``: re-fit the kernel's parameters (e.g. flow weights) from
  all chains each step, then advance all chains with the refreshed kernel.
- ``parallel_eca``: ensemble chain adaptation over a (num_batch,
  batch_size) chain grid. Each batch carries its own parameters, refits
  them on its own chains, and the refitted parameters rotate one batch
  down (batch b receives batch b+1's). Every batch then moves with the
  parameters it received, except batch ``step % num_batch``, which keeps
  its state (the reference's ``skip`` mask selects the moved state where it
  is true, and it is true for every other batch).

The reference vmaps both the refit and the move over the batches. Here a
Python loop runs them batch by batch, each with its own parameters and
noise: the fused field kernel and the fused score gate take raw pointers
and cannot run under ``torch.func.vmap``, and a loop is right for any
``kernel_factory``. The holding batch's move is not run at all, since its
result would be discarded. The sharded path (``mesh``) is not ported.

Kernels from ``kernel_factory`` are ``kernel(noise, states) -> (states,
info)``; ``update(noise, state, *params)`` hands the kernel ``noise`` as it
is (cross-chain) or, in ``parallel_eca``, batch b's entry of a sequence of
``num_batch`` noises (the reference's split keys), or the generator itself.
``step`` is a Python int: it decides the holding batch on the host.
"""

from typing import Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from mfm_tpu_torch.kernels.base import stack, step_noise


class AdaptState(NamedTuple):
    states: NamedTuple  # chain states, leading axis = chains (or batches)
    step: int


def check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("not ported yet: mesh")


def cross_chain(kernel_factory: Callable, parameter_gn: Callable, num_chain: int):
    """``kernel_factory(*params) -> kernel``; ``parameter_gn(states, step,
    *params) -> new params``. Returns ``(init, update)``."""

    def init(initial_states: NamedTuple) -> AdaptState:
        leading = {leaf.shape[0] for leaf in tree_leaves(initial_states)}
        if leading != {num_chain}:
            raise ValueError(
                f"cross_chain expects every state leaf to lead with "
                f"(num_chain={num_chain}, ...); got leading sizes {leading}"
            )
        return AdaptState(initial_states, 0)

    def update(noise, state: AdaptState, *params) -> Tuple[AdaptState, tuple, NamedTuple]:
        new_params = parameter_gn(state.states, state.step, *params)
        new_states, infos = kernel_factory(*new_params)(noise, state.states)
        return AdaptState(new_states, state.step + 1), new_params, infos

    return init, update


def _rotate(params):
    """Batch b receives the parameters batch b+1 just trained."""
    return tree_map(lambda p: torch.cat([p[1:], p[:1]], dim=0), params)


def parallel_eca(
    kernel_factory: Callable,
    parameter_gn: Callable,
    num_batch: int,
    batch_size: int,
    mesh=None,
):
    """Ensemble chain adaptation with parameter rotation. States lead with
    (num_batch, batch_size, ...), params with (num_batch, ...)."""
    check_mesh(mesh)

    def init(initial_states: NamedTuple) -> AdaptState:
        leading = {tuple(leaf.shape[:2]) for leaf in tree_leaves(initial_states)}
        if leading != {(num_batch, batch_size)}:
            raise ValueError(
                "parallel_eca expects state leaves leading with "
                f"(num_batch={num_batch}, batch_size={batch_size}, ...); got {leading}"
            )
        return AdaptState(initial_states, 0)

    def update(noise, state: AdaptState, *params) -> Tuple[AdaptState, tuple, None]:
        states, step = state.states, state.step
        batch = lambda tree, b: tree_map(lambda v: v[b], tree)
        new_params = stack([parameter_gn(batch(states, b), step, *batch(params, b))
                            for b in range(num_batch)])
        rotated = _rotate(new_params)
        holder = step % num_batch
        moved = []
        for b in range(num_batch):
            if b == holder:
                moved.append(batch(states, b))
            else:
                kernel = kernel_factory(*batch(rotated, b))
                moved.append(kernel(step_noise(noise, b), batch(states, b))[0])
        return AdaptState(stack(moved), step + 1), new_params, None

    return init, update
