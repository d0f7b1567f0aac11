"""COCOB-Backprop, the parameter-free coin-betting optimizer (counterpart
of ``mfm_tpu/optimizers/cocob.py``; Orabona & Tommasi 2017, Algorithm 2),
as the port's ``GradientTransformation`` (``flows/train.py``). Used by
coin-SVGD.

Per coordinate, with gradient g and initial point w0:
    L   <- max(L, |g|)                  (observed gradient range; starts at eps)
    G   <- G + |g|                      (sum of absolute gradients)
    R   <- max(R - g (w - w0), 0)       (accumulated reward)
    C   <- C - g                        (sum of negative gradients)
    w   <- w0 + C / (L max(G + L, alpha L)) * (L + R)

returned as an update (a delta from w). Parameters are a tensor or a dict
of tensors.
"""

from typing import Any, NamedTuple

import torch
from torch.utils._pytree import tree_map

from mfm_tpu_torch.flows.train import GradientTransformation


class CocobState(NamedTuple):
    initial_params: Any
    grad_sum: Any  # C: sum of -g
    range_: Any  # L
    abs_sum: Any  # G
    reward: Any  # R


def cocob(alpha: float = 100.0, eps: float = 1e-8) -> GradientTransformation:
    def init_fn(params):
        zeros = lambda: tree_map(torch.zeros_like, params)
        return CocobState(params, zeros(), tree_map(lambda p: torch.full_like(p, eps), params),
                          zeros(), zeros())

    def update_fn(grads, state: CocobState, params=None):
        if params is None:
            raise ValueError("cocob requires params to be passed to update")
        range_ = tree_map(lambda L, g: torch.maximum(L, torch.abs(g)), state.range_, grads)
        abs_sum = tree_map(lambda G, g: G + torch.abs(g), state.abs_sum, grads)
        reward = tree_map(lambda R, g, w, w0: torch.clamp(R - g * (w - w0), min=0.0),
                          state.reward, grads, params, state.initial_params)
        grad_sum = tree_map(lambda C, g: C - g, state.grad_sum, grads)
        updates = tree_map(
            lambda w, w0, C, L, G, R: w0 + C / (L * torch.maximum(G + L, alpha * L)) * (L + R) - w,
            params, state.initial_params, grad_sum, range_, abs_sum, reward,
        )
        return updates, CocobState(state.initial_params, grad_sum, range_, abs_sum, reward)

    return GradientTransformation(init_fn, update_fn)
