"""The chain mesh as ``torch.distributed`` (counterpart of
``mfm_tpu.parallel.mesh``): one process a shard.

The reference lays devices out as a ``jax.sharding.Mesh`` with the axes
``("ensemble", "chains")`` and lets XLA insert every reduction across
chains. Here each rank is one process with its rows of the ensemble and a
full copy of the flow state; every reduction over chains is one of the
collectives below, called explicitly by the drivers.

- ``make_mesh`` wraps the initialised process group as a ``ChainMesh``;
  ``chain_sharding``, ``replicated``, ``shard_chains`` and ``replicate``
  keep the reference's names. Shards are rank-major over all mesh axes
  jointly: rank r holds rows [r n / S, (r + 1) n / S) of an n-row tree.
- The collectives: ``all_reduce_sum``, ``all_gather_rows``,
  ``reduce_scatter_sum``, ``ring_shift`` (one step of
  ``batch_isend_irecv``) and ``broadcast``.

The backend follows from the layout (``pick_backend``): NCCL where every
rank has a card of its own; gloo on the CPU and where ranks share a card,
since NCCL cannot put two ranks on one card. A NCCL request on shared
cards is refused by name. Under gloo a collective on a CUDA tensor copies
it to the host and back, here and explicitly; the compute never leaves
the card, only the collective's transport goes through the host.
"""

import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

AXIS_NAMES = ("ensemble", "chains")


def axis_names_of(shape: Sequence[int]) -> Tuple[str, ...]:
    """The reference's axis names for a mesh shape (``mfm_tpu/drivers/mfm.py:427``)."""
    return AXIS_NAMES[-len(shape):]


def pick_backend(device, backend: Optional[str] = None, local_world_size: int = 1) -> str:
    """The process group's backend for ranks on ``device``: NCCL where each
    of the ``local_world_size`` ranks on this host has a card of its own,
    else gloo (the CPU, or ranks sharing a card). ``backend`` names one; a
    NCCL request that the layout cannot take raises."""
    device = torch.device(device)
    own_cards = device.type == "cuda" and local_world_size <= torch.cuda.device_count()
    chosen = "nccl" if own_cards else "gloo"
    if backend is None:
        return chosen
    if backend == "nccl" and not own_cards:
        raise ValueError(
            f"backend nccl: NCCL cannot run {local_world_size} ranks on "
            f"{torch.cuda.device_count() if device.type == 'cuda' else 0} card(s) of "
            f"{device}; ranks that share a card (or the CPU) take backend gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    return backend


def device_of_rank(device, local_rank: int):
    """Rank ``local_rank``'s device: card ``local_rank % device_count`` for
    ``cuda``, else ``device`` itself."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_from_env(device, backend: Optional[str] = None) -> Tuple[int, int, str, torch.device]:
    """The group a launcher such as ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and
    ``MASTER_ADDR``/``MASTER_PORT``: (rank, world size, backend, this
    rank's device). Raises by name where the environment describes none. The
    group's timeout (``parallel.distributed.initialize_distributed``) turns
    a rank left waiting by a failed one into an error."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group: {', '.join(missing)} unset; start the ranks with torchrun "
            "(python -m torch.distributed.run --standalone --nproc-per-node N ...)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = device_of_rank(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from mfm_tpu_torch.parallel.distributed import initialize_distributed

    chosen = pick_backend(dev, backend, local_world)
    initialize_distributed("env://", world, rank, backend=chosen)
    return rank, world, chosen, dev


class ChainMesh:
    """A mesh of ``shape`` over the ranks of a process group. Rank r sits at
    the row-major index r of ``shape``; ``device`` is this rank's."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...], group, rank: int,
                 size: int, backend: str, device):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.group = group
        self.rank = rank
        self.size = size
        self.backend = backend
        self.device = torch.device(device)
        self._axis_groups = {}

    def __repr__(self):
        return (f"ChainMesh(shape={self.shape}, axes={self.axis_names}, rank={self.rank}/"
                f"{self.size}, backend={self.backend}, device={self.device})")

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row tensor; ``n`` must split evenly."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over the {self.size} shards of "
                             f"mesh {self.shape}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def axis(self, name: str) -> "ChainMesh":
        """The mesh along axis ``name`` alone: this rank and those that differ
        from it only in that axis, as a 1-D mesh. A collective call on every
        rank the first time a 2-D mesh with both axes above 1 is asked."""
        if name not in self.axis_names:
            raise ValueError(f"mesh {self.shape} has no axis {name!r} (axes {self.axis_names})")
        i = self.axis_names.index(name)
        n = self.shape[i]
        if n == 1:
            return ChainMesh((1,), (name,), None, 0, 1, self.backend, self.device)
        if n == self.size:
            return ChainMesh((n,), (name,), self.group, self.rank, self.size, self.backend,
                             self.device)
        if name not in self._axis_groups:
            import torch.distributed as dist

            index = [divmod(r, self.shape[1]) for r in range(self.size)]  # 2-D: (e, c)
            lines = {}
            for r, (e, c) in enumerate(index):
                lines.setdefault(c if i == 0 else e, []).append(r)
            mine, _ = dist.new_subgroups_by_enumeration(list(lines.values()))
            self._axis_groups[name] = mine
        e, c = divmod(self.rank, self.shape[1])
        return ChainMesh((n,), (name,), self._axis_groups[name], e if i == 0 else c, n,
                         self.backend, self.device)

    # --------------------------------------------------------- collectives
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer a collective takes: on the host under gloo."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks, on every rank (a NaN on one rank is a NaN on all)."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        buf = self._host(t).clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows along dim 0, in rank order, on every rank; all
        ranks pass the same shape."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        src = self._host(t)
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        # all_gather_single is all_gather_into_tensor's newer name
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(out, src, group=self.group)
        return out.to(t.device)

    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice (dim 0) of the sum over ranks of ``t``."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        src = self._host(t)
        if src.shape[0] % self.size:
            raise ValueError(f"reduce-scatter: {src.shape[0]} rows over {self.size} ranks")
        out = torch.empty((src.shape[0] // self.size,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        scatter(out, src, group=self.group)
        return out.to(t.device)

    def ring_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """The tensor rank ``rank - step`` (mod size) holds: each rank sends
        ``t`` ``step`` places up the ring and receives from ``step`` places
        down, in one ``batch_isend_irecv``."""
        import torch.distributed as dist

        step %= self.size
        if step == 0:
            return t
        src = self._host(t)
        out = torch.empty_like(src)
        peer = lambda r: dist.get_global_rank(self.group, r) if self.group is not None else r
        ops = [dist.P2POp(dist.isend, src, peer((self.rank + step) % self.size), self.group),
               dist.P2POp(dist.irecv, out, peer((self.rank - step) % self.size), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank."""
        import torch.distributed as dist

        if self.size == 1:
            return t
        buf = self._host(t).clone()
        root = dist.get_global_rank(self.group, src) if self.group is not None else src
        dist.broadcast(buf, root, group=self.group)
        return buf.to(t.device)

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.size > 1:
            dist.barrier(group=self.group)

    # --------------------------------------------------------- trees
    def _flat(self, tree, fn):
        """``fn`` applied to the tensors of ``tree`` as one flat buffer a
        dtype, so that a tree costs one collective a dtype."""
        leaves, spec = tree_flatten(tree)
        out = list(leaves)
        groups = {}
        for i, v in enumerate(leaves):
            if isinstance(v, torch.Tensor):
                groups.setdefault(v.dtype, []).append(i)
        for idx in groups.values():
            flat = fn(torch.cat([leaves[i].reshape(-1) for i in idx]))
            at = 0
            for i in idx:
                n = leaves[i].numel()
                out[i] = flat[at:at + n].view_as(leaves[i])
                at += n
        return tree_unflatten(out, spec)

    def all_reduce_tree(self, tree):
        """``all_reduce_sum`` of every tensor of ``tree``."""
        return tree if self.size == 1 else self._flat(tree, self.all_reduce_sum)

    def ring_shift_tree(self, tree, step: int = 1):
        """``ring_shift`` of every tensor of ``tree``."""
        return tree if step % self.size == 0 else self._flat(
            tree, lambda t: self.ring_shift(t, step))


def make_mesh(shape: Optional[Tuple[int, ...]] = None, axis_names: Optional[Sequence[str]] = None,
              group=None, device=None) -> ChainMesh:
    """The mesh of ``shape`` over the ranks of ``group`` (default: the
    initialised default group). Default shape: every rank on the last
    axis. Refuses a group that is not initialised and a shape whose
    product is not the group's world size."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"mesh_shape {tuple(shape) if shape else None}: no process group is initialised; "
            "start the ranks with torchrun (the CLI) or call "
            "mfm_tpu_torch.parallel.distributed.initialize_distributed first")
    size = dist.get_world_size(group)
    names = tuple(axis_names) if axis_names is not None else None
    if shape is None:
        names = names or AXIS_NAMES
        shape = (1,) * (len(names) - 1) + (size,)
    shape = tuple(int(s) for s in shape)
    names = names or axis_names_of(shape)
    if len(names) != len(shape) or len(shape) > 2:
        raise ValueError(f"mesh shape {shape} with axes {names}: one name an axis, at most 2")
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} does not cover the process group's {size} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return ChainMesh(shape, names, group, dist.get_rank(group), size, dist.get_backend(group),
                     device)


class RowSharding(NamedTuple):
    """The leading axis split over every mesh axis jointly, rank-major."""

    mesh: ChainMesh
    ndim: int = 2


class Replicated(NamedTuple):
    """One whole copy on every rank."""

    mesh: ChainMesh


def chain_sharding(mesh: ChainMesh, ndim: int = 2) -> RowSharding:
    return RowSharding(mesh, ndim)


def replicated(mesh: ChainMesh) -> Replicated:
    return Replicated(mesh)


def shard_chains(tree, mesh: ChainMesh):
    """This rank's rows of every tensor leaf of a global ``tree`` (its
    leading axis split rank-major); 0-d tensors and other leaves stay."""
    return tree_map(lambda v: v[mesh.rows(v.shape[0])]
                    if isinstance(v, torch.Tensor) and v.ndim >= 1 else v, tree)


def replicate(tree, mesh: ChainMesh):
    """Rank 0's copy of every tensor leaf of ``tree`` on every rank."""
    return tree_map(lambda v: mesh.broadcast(v) if isinstance(v, torch.Tensor) else v, tree)
