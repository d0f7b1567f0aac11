"""The NaN-guarded optimizer loop of the adaptation algorithms (counterpart
of ``mfm_tpu/adaptation/optimize.py``).

``n_iter`` steps of a ``GradientTransformation`` (``flows/train.py``)
under ``torch.func.grad_and_value``. A step whose loss or any gradient is
not finite keeps the parameters and the optimizer state, and reports its
loss as NaN; the choice is a ``torch.where`` over every tensor, with no
host read.
"""

from typing import Callable, Optional

import torch
from torch.func import grad_and_value
from torch.utils._pytree import tree_leaves, tree_map

from mfm_tpu_torch.flows.train import apply_updates
from mfm_tpu_torch.kernels.base import step_noise


def _keep_if(ok: torch.Tensor, new, old):
    return tree_map(
        lambda n, o: torch.where(ok, n, o) if isinstance(n, torch.Tensor) else n, new, old)


def optimize(
    params,
    opt_state,
    loss_fn: Callable,
    optimizer,
    n_iter: int,
    positions: Optional[torch.Tensor] = None,
    noise=None,
):
    """Run ``n_iter`` steps of ``optimizer`` on ``loss_fn``.

    ``loss_fn(params, positions)`` when ``positions`` is given, else
    ``loss_fn(params, noise_k)``: the k-th entry of ``noise`` (a sequence of
    ``n_iter`` per-step noises, the reference's split keys), or ``noise``
    itself when it is a ``torch.Generator`` (the loss draws from it).
    Returns ``((params, opt_state), losses)``, losses (n_iter,).
    """
    if positions is None and noise is None:
        raise ValueError("optimize needs positions or noise")
    value_and_grad = grad_and_value(loss_fn)
    losses = []
    for k in range(n_iter):
        grads, loss = value_and_grad(params, positions if positions is not None
                                     else step_noise(noise, k))
        updates, new_state = optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        ok = torch.isfinite(loss) & torch.stack(
            [torch.isfinite(g).all() for g in tree_leaves(grads)]).all()
        params = _keep_if(ok, new_params, params)
        opt_state = _keep_if(ok, new_state, opt_state)
        losses.append(torch.where(ok, loss, torch.nan))
    return (params, opt_state), torch.stack(losses)
