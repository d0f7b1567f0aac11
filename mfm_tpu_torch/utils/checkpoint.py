"""Checkpoint and resume (counterpart of ``mfm_tpu.utils.checkpoint``).

A checkpoint is a directory ``<directory>/step_<n, 8 digits>`` holding one
``torch.save`` of the state's leaves: plain tensors, ints and Nones, which
``torch.load(weights_only=True)`` reads back without running any pickled
code. The state's structure (named tuples, dicts) is not saved: a restore
takes it from a ``template`` of the same structure, and moves each leaf to
the device of the template's leaf. The reference saves through orbax, which
the port does not have.
"""

import os
import shutil
from typing import Any, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

_FILE = "state.pt"


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, state: Any) -> str:
    """Save ``state`` (a tree of tensors, ints and Nones) as step ``step``;
    an existing checkpoint of that step is replaced. Returns its path."""
    leaves, _ = tree_flatten(state)
    leaves = [v.detach().cpu() if isinstance(v, torch.Tensor) else v for v in leaves]
    path = _path(directory, step)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": step, "leaves": leaves}, os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)  # a checkpoint is either whole or absent
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


def restore_checkpoint(directory: str, step: Optional[int] = None, template: Any = None):
    """(state, step) of the checkpoint at ``step`` (default: the latest), or
    (None, None) when there is none. With a ``template`` the state has its
    structure and devices; without one it is the list of saved leaves."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    saved = torch.load(os.path.join(_path(directory, step), _FILE), map_location="cpu",
                       weights_only=True)
    leaves = saved["leaves"]
    if template is None:
        return leaves, step
    ref, spec = tree_flatten(template)
    if len(ref) != len(leaves):
        raise ValueError(f"checkpoint step {step}: {len(leaves)} leaves, the template has "
                         f"{len(ref)}")
    leaves = [v.to(r.device) if isinstance(r, torch.Tensor) else v for v, r in zip(leaves, ref)]
    return tree_unflatten(leaves, spec), step
