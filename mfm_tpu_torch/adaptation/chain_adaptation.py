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
  is true, and it is true for every other batch). With ``mesh`` the
  batches are sharded over its ``ensemble`` axis
  (``mfm_tpu/adaptation/chain_adaptation.py:138-168``): each rank holds
  num_batch / S of them with their parameters, and the rotation is a
  local shift plus one ring step, each rank sending its first batch's
  fresh parameters to its left neighbour (``:69-89``).

The reference vmaps both the refit and the move over the batches. Here a
Python loop runs them batch by batch, each with its own parameters and
noise: the fused field kernel and the fused score gate take raw pointers
and cannot run under ``torch.func.vmap``, and a loop is right for any
``kernel_factory``. The holding batch's move is not run at all, since its
result would be discarded.

Kernels from ``kernel_factory`` are ``kernel(noise, states) -> (states,
info)``; ``update(noise, state, *params)`` hands the kernel ``noise`` as it
is (cross-chain) or, in ``parallel_eca``, batch b's entry of a sequence of
``num_batch`` noises (the reference's split keys), or the generator itself.
``step`` is a Python int: it decides the holding batch on the host. Under a
mesh a batch's noise is the entry of its global batch id, and the holding
batch is chosen by global id (``:153-154``); a generator is refused there,
since it is seeded alike on every rank and would give every rank's
batches the same draws.
"""

from typing import Callable, NamedTuple, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from mfm_tpu_torch.kernels.base import stack, step_noise


class AdaptState(NamedTuple):
    states: NamedTuple  # chain states, leading axis = chains (or batches)
    step: int


def ensemble_mesh(mesh, num_batch: int, axis: str = "ensemble"):
    """The 1-D mesh along ``axis`` that shards the batches (None without
    ``mesh``); ``num_batch`` must split evenly over it."""
    if mesh is None:
        return None
    ens = mesh.axis(axis)
    if num_batch % ens.size:
        raise ValueError(f"num_batch={num_batch} does not split over the {ens.size} shards "
                         f"of the mesh's {axis!r} axis")
    return ens


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


def _rotate(params, mesh=None):
    """Batch b receives the parameters batch b+1 just trained; under a mesh
    the first batch of the next rank arrives by one ring step."""
    if mesh is None:
        return tree_map(lambda p: torch.cat([p[1:], p[:1]], dim=0), params)
    recv = mesh.ring_shift_tree(tree_map(lambda p: p[:1], params), -1)
    return tree_map(lambda p, r: torch.cat([p[1:], r], dim=0), params, recv)


def parallel_eca(
    kernel_factory: Callable,
    parameter_gn: Callable,
    num_batch: int,
    batch_size: int,
    mesh=None,
    axis: str = "ensemble",
):
    """Ensemble chain adaptation with parameter rotation. States lead with
    (num_batch, batch_size, ...), params with (num_batch, ...); under
    ``mesh`` with this rank's num_batch / S batches of the ``axis`` axis
    (``parallel.mesh.shard_chains`` of the whole)."""
    ens = ensemble_mesh(mesh, num_batch, axis)
    n_local = num_batch if ens is None else num_batch // ens.size
    first = 0 if ens is None else ens.rank * n_local  # this rank's first global batch id

    def init(initial_states: NamedTuple) -> AdaptState:
        leading = {tuple(leaf.shape[:2]) for leaf in tree_leaves(initial_states)}
        if leading != {(n_local, batch_size)}:
            raise ValueError(
                "parallel_eca expects state leaves leading with "
                f"(num_batch={n_local}{' on this rank' if ens else ''}, "
                f"batch_size={batch_size}, ...); got {leading}"
            )
        return AdaptState(initial_states, 0)

    def update(noise, state: AdaptState, *params) -> Tuple[AdaptState, tuple, None]:
        if ens is not None and isinstance(noise, torch.Generator):
            raise ValueError(
                "parallel_eca under a mesh takes injected noise (one entry a global batch): "
                "a generator seeded alike on every rank gives every rank the same draws")
        states, step = state.states, state.step
        batch = lambda tree, b: tree_map(lambda v: v[b], tree)
        new_params = stack([parameter_gn(batch(states, b), step, *batch(params, b))
                            for b in range(n_local)])
        rotated = _rotate(new_params, ens)
        holder = step % num_batch
        moved = []
        for b in range(n_local):
            if first + b == holder:
                moved.append(batch(states, b))
            else:
                kernel = kernel_factory(*batch(rotated, b))
                moved.append(kernel(step_noise(noise, first + b), batch(states, b))[0])
        return AdaptState(stack(moved), step + 1), new_params, None

    return init, update
