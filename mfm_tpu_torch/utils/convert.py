"""Carry parameters and target state from the reference into the port.

Conversion is one way, reference -> port; everything crosses as numpy (this
module imports nothing of the reference). Parameters: flax -> torch. The tree names are those of
``VectorFieldNet`` (and of ``field_pallas.split_params``): ``t_trunk`` /
``x_trunk`` / ``xt_trunk`` ``Dense_i``, ``gate_head``, ``field_head``. A
flax ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in).
"""

import numpy as np
import torch

_TRUNKS = ("t_trunk", "x_trunk", "xt_trunk")
_HEADS = ("gate_head", "field_head")


def params_from_flax(tree, fourier_freqs=None) -> dict:
    """The port's ``state_dict`` from a flax tree of (nested dicts of)
    arrays, with or without the top-level ``params`` key. The Fourier
    frequencies, if given, become the ``fourier_freqs`` buffer. Also
    converts trees of the same shape, such as AdamW moments."""
    p = tree["params"] if "params" in tree else tree
    dense = lambda d: (np.asarray(d["kernel"]).T, np.asarray(d["bias"]))
    layers = []
    for trunk in _TRUNKS:
        for i in range(len(p.get(trunk, {}))):
            layers.append((f"{trunk}.{i}", dense(p[trunk][f"Dense_{i}"])))
    layers += [(head, dense(p[head])) for head in _HEADS]
    out = {}
    for name, (w, b) in layers:
        out[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(w))
        out[f"{name}.bias"] = torch.tensor(b)
    if fourier_freqs is not None:
        out["fourier_freqs"] = torch.tensor(np.asarray(fourier_freqs))
    return out


COX_ARRAYS = ("_counts", "_chol", "_prec", "_mu_zero")
COX_SCALARS = ("_white_log_norm", "_latent_log_norm", "_bin_area", "prior_gaussian_mean")


def cox_state_from_reference(target, arrays: dict, load: bool = False) -> dict:
    """Hold a ``LogGaussianCoxPines`` of the port to the reference target's
    state, given as numpy: ``arrays`` maps ``COX_ARRAYS`` to arrays and
    ``COX_SCALARS`` to numbers. Returns the largest absolute difference per
    name (0.0 everywhere when both were built from the same data: the host
    code is the same float64 numpy). With ``load`` the port's arrays and
    scalars are then replaced by the given ones, on the device they lie on,
    so that both packages compute from the same bits."""
    diffs = {}
    for name in COX_ARRAYS:
        mine = getattr(target, name)
        theirs = np.asarray(arrays[name], np.float32)
        if tuple(mine.shape) != theirs.shape:
            raise ValueError(f"{name}: shape {tuple(mine.shape)} against {theirs.shape}")
        diffs[name] = float(np.max(np.abs(mine.detach().cpu().numpy() - theirs)))
        if load:
            setattr(target, name, torch.tensor(theirs, device=mine.device))
    for name in COX_SCALARS:
        diffs[name] = abs(float(getattr(target, name)) - float(arrays[name]))
        if load:
            setattr(target, name, float(arrays[name]))
    return diffs
