"""Carry parameters from the reference's flax trees into the port.

Conversion is one way, flax -> torch. The tree names are those of
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
