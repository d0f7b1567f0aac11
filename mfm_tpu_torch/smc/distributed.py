"""Distributed systematic and stratified resampling and the ring gather
(counterpart of ``mfm_tpu.smc.distributed``), one rank a shard of the
particles.

The weights stay sharded. The algorithm is the reference's (exact: the
ancestors equal the single-device resampler's for the same uniform(s) in
float64):

1. **Canonical offsets** (``:73-99``). Every rank gets all S shard totals
   in one all-gather of scalars and runs the same sequential prefix, so
   that shard s + 1's offset is bit-equal to shard s's last cumulative
   weight.
2. **Local segment marking.** With its offset, a rank knows the global
   cumulative weight of each of its particles and the first output slot
   each fills, ``searchsorted(grid, C_{j-1}, right)``. ``cum_prev`` is a
   shift of ``cum``, not ``cum - w`` (``:124-131``), so that it reproduces
   the neighbour's value bit for bit. A particle that fills a slot marks
   its global id + 1 there.
3. **One reduce-scatter and a local cummax.** The marks are summed over
   ranks (each slot is marked by at most one particle) and each rank gets
   its slice of the slots; a local cummax and the exclusive max-carry of
   the ranks before it turn segment starts into ancestors. The u == 0
   clamp (``:153-156``) stays.

In float32 the per-shard cumsum brackets the prefix sums differently from
one global cumsum, so an ancestor whose grid point lies within an ulp of a
cumulative weight can move by one position (``:38-46``); both are valid
systematic resamples of the same weights.

``distributed_take`` moves the particle blocks once around the ring
(S - 1 ``ring_shift`` steps, ``:220-245``): no rank ever holds the full
particle matrix.

The uniform(s) are injected, as the port's resamplers take them: one 0-d
uniform (systematic) or ``num_samples`` (stratified), the same on every
rank.
"""

from typing import Callable

import torch

from mfm_tpu_torch.parallel.mesh import ChainMesh


def _canonical_offsets(local_sum: torch.Tensor, mesh: ChainMesh):
    """Every rank's exclusive weight offset, from one fixed sequential
    bracketing of all S shard totals shared by every rank."""
    sums = mesh.all_gather_rows(local_sum.reshape(1))
    offs = []
    carry = torch.zeros((), dtype=local_sum.dtype, device=local_sum.device)
    for t in range(mesh.size):
        offs.append(carry)
        carry = carry + sums[t]
    return torch.stack(offs), carry


def _distributed_offset_resample(u, weights, num_samples: int, mesh: ChainMesh):
    """This rank's slice of the (num_samples,) global ancestors; ``weights``
    is this rank's slice of the normalised weights."""
    if num_samples % mesh.size:  # every rank's particles are as many (shard_chains)
        raise ValueError(f"num_samples ({num_samples}) must divide the mesh's shard count "
                         f"{mesh.size}")
    n_local = weights.shape[0]
    dev = weights.device

    local_cum = torch.cumsum(weights, 0)
    offsets, _ = _canonical_offsets(local_cum[-1], mesh)
    offset = offsets[mesh.rank]

    grid = (torch.arange(num_samples, dtype=weights.dtype, device=dev) + u) / num_samples
    cum = offset + local_cum
    cum_prev = torch.cat([offset[None], cum[:-1]])
    s_start = torch.searchsorted(grid, cum_prev.contiguous(), right=True)
    s_end = torch.searchsorted(grid, cum.contiguous(), right=True)
    filled = s_end > s_start

    gid = mesh.rank * n_local + torch.arange(n_local, device=dev)
    marks = torch.zeros(num_samples, dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, torch.clamp(s_start, 0, num_samples - 1),
                          torch.where(filled, gid + 1, 0), reduce="amax")

    slice_marks = mesh.reduce_scatter_sum(marks)
    local_fill = torch.cummax(slice_marks, 0).values
    # the largest mark of every rank before this one
    last = mesh.all_gather_rows(local_fill[-1:])
    carry_excl = torch.max(last[:mesh.rank]) if mesh.rank else torch.zeros_like(local_fill[-1])
    # clamp to 0 for the measure-zero u == 0.0 draw, where grid[0] == 0.0
    # leaves slot 0 unmarked (the single-device resampler clips it to 0)
    return torch.clamp(torch.maximum(local_fill, carry_excl) - 1, min=0)


def distributed_systematic(u, weights, num_samples: int, mesh: ChainMesh) -> torch.Tensor:
    """Exact systematic resampling of weights sharded over ``mesh``: this
    rank's slice of the (num_samples,) global ancestor ids. ``u`` is one
    0-d uniform; the same ``u`` gives ``resampling.systematic``'s ancestors."""
    return _distributed_offset_resample(u, weights, num_samples, mesh)


def distributed_stratified(u, weights, num_samples: int, mesh: ChainMesh) -> torch.Tensor:
    """Stratified: ``u`` (num_samples,) uniforms, one a stratum, the same
    on every rank."""
    return _distributed_offset_resample(u, weights, num_samples, mesh)


def make_distributed_resampler(name: str, mesh: ChainMesh) -> Callable:
    """``resample(u, weights, num_samples)`` with the signature of
    ``smc.resampling``'s schemes."""
    fn = {"systematic": distributed_systematic, "stratified": distributed_stratified}.get(name)
    if fn is None:
        raise ValueError(
            f"distributed resampling supports systematic|stratified, got {name!r}")
    return lambda u, weights, num_samples: fn(u, weights, num_samples, mesh)


def distributed_take(particles: torch.Tensor, ancestors: torch.Tensor,
                     mesh: ChainMesh) -> torch.Tensor:
    """``particles[ancestors]`` with both sharded over ``mesh``: ``particles``
    this rank's (n_local, ...) block, ``ancestors`` its slice of the global
    ids. The blocks travel once around the ring; at each step a rank copies
    the rows whose ids live in the block passing through. Exact. Every
    rank holds as many particles (``shard_chains`` refuses N that does not
    split) and as many ancestors (the resampler refuses such M)."""
    size = mesh.size
    n_local = particles.shape[0]
    owner = torch.div(ancestors, n_local, rounding_mode="floor")
    out = None
    block = particles
    for r in range(size):
        src = (mesh.rank - r) % size  # the original owner of the block in hand
        rows = block[torch.clamp(ancestors - src * n_local, 0, n_local - 1)]
        mine = (owner == src).reshape((-1,) + (1,) * (particles.ndim - 1))
        out = rows if out is None else torch.where(mine, rows, out)
        if r < size - 1:
            block = mesh.ring_shift(block)
    return out


def make_distributed_gather(mesh: ChainMesh) -> Callable:
    """``gather_fn(particles, ancestors)`` for ``smc.base.step``'s hook."""
    return lambda particles, ancestors: distributed_take(particles, ancestors, mesh)
