"""Checkpoint and resume (counterpart of ``mfm_tpu.utils.checkpoint``).

A checkpoint is a directory ``<directory>/step_<n, 8 digits>`` holding one
``torch.save`` of the state's leaves: plain tensors, ints and Nones, which
``torch.load(weights_only=True)`` reads back without running any pickled
code. The state's structure (named tuples, dicts) is not saved: a restore
takes it from a ``template`` of the same structure, and moves each leaf to
the device of the template's leaf. The reference saves through orbax, which
the port does not have.

A state can have a part split by rows, ``rows``: the chain ensemble of a
run (``drivers/mfm.py``). Its leaves lead with the chain axis and go to
``rows_<start>_<stop>.pt``, one file for each rank of a chain mesh, so
that no host holds the whole ensemble (as ``mfm_tpu/utils/checkpoint.py:8-12``);
rank 0 writes the replicated rest. A restore reads the files that cover
its own rows, so a checkpoint written by S ranks resumes under any S' that
divides the chains, one process included. Every rank of the mesh calls
``save_checkpoint`` together.
"""

import os
import re
import shutil
from typing import Any, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

_FILE = "state.pt"
_ROWS = re.compile(r"rows_(\d+)_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _cpu_leaves(tree):
    leaves, _ = tree_flatten(tree)
    return [v.detach().cpu() if isinstance(v, torch.Tensor) else v for v in leaves]


def save_checkpoint(directory: str, step: int, state: Any, rows: Any = None, mesh=None) -> str:
    """Save ``state`` (a tree of tensors, ints and Nones) as step ``step``,
    and ``rows``, a tree whose tensors lead with this rank's rows of the
    chain axis (all of them without ``mesh``); an existing checkpoint of
    that step is replaced. Returns its path."""
    path = _path(directory, step)
    tmp = path + ".tmp"
    primary = mesh is None or mesh.is_primary
    if primary:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if mesh is not None:
        mesh.barrier()
    if primary:
        torch.save({"step": step, "leaves": _cpu_leaves(state)}, os.path.join(tmp, _FILE))
    if rows is not None:
        n = tree_flatten(rows)[0][0].shape[0]
        start = mesh.rank * n if mesh is not None else 0
        torch.save({"leaves": _cpu_leaves(rows)},
                   os.path.join(tmp, f"rows_{start:010d}_{start + n:010d}.pt"))
    if mesh is not None:
        mesh.barrier()
    if primary:
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)  # a checkpoint is either whole or absent
    if mesh is not None:
        mesh.barrier()
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest saved step under ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and name.split("_")[1].isdigit()
        and os.path.isfile(os.path.join(directory, name, _FILE))
    ]
    return max(steps) if steps else None


def _restore_rows(path: str, template: Any, mesh=None):
    """The rows of ``template``'s tensors (this rank's, all without a mesh)
    from the row files under ``path``, whatever ranks wrote them."""
    spans = sorted((int(m.group(1)), int(m.group(2)), name) for name in os.listdir(path)
                   if (m := _ROWS.match(name)))
    if not spans:
        raise ValueError(f"checkpoint {path}: no row files")
    total = spans[-1][1]
    want = mesh.rows(total) if mesh is not None else slice(0, total)
    parts = []
    for start, stop, name in spans:
        lo, hi = max(start, want.start), min(stop, want.stop)
        if lo < hi:
            leaves = torch.load(os.path.join(path, name), map_location="cpu",
                                weights_only=True)["leaves"]
            parts.append([v[lo - start:hi - start] if isinstance(v, torch.Tensor) else v
                          for v in leaves])
    ref, spec = tree_flatten(template)
    if len(parts[0]) != len(ref):
        raise ValueError(f"checkpoint {path}: {len(parts[0])} row leaves, the template has "
                         f"{len(ref)}")
    leaves = [torch.cat([p[i] for p in parts]).to(r.device) if isinstance(r, torch.Tensor)
              else parts[0][i] for i, r in enumerate(ref)]
    return tree_unflatten(leaves, spec)


def restore_checkpoint(directory: str, step: Optional[int] = None, template: Any = None,
                       rows: Any = None, mesh=None):
    """(state, step) of the checkpoint at ``step`` (default: the latest), or
    (None, None) when there is none. With a ``template`` the state has its
    structure and devices; without one it is the list of saved leaves.
    With ``rows`` (the template of the row part, as given to
    ``save_checkpoint``) the state is the pair (state, rows), the rows this
    rank's of ``mesh`` (all of them without one)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = _path(directory, step)
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    leaves = saved["leaves"]
    if template is None:
        return leaves, step
    ref, spec = tree_flatten(template)
    if len(ref) != len(leaves):
        raise ValueError(f"checkpoint step {step}: {len(leaves)} leaves, the template has "
                         f"{len(ref)}")
    leaves = [v.to(r.device) if isinstance(r, torch.Tensor) else v for v, r in zip(leaves, ref)]
    state = tree_unflatten(leaves, spec)
    if rows is None:
        return state, step
    return (state, _restore_rows(path, rows, mesh)), step
