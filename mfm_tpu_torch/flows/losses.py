"""(Conditional) flow-matching losses (counterpart of
``mfm_tpu.flows.losses``). The noise is injected: ``t`` (B,) uniform,
``x0`` (B, d) reference draws, ``eps`` (B, d) standard normal -- the draws
the reference takes from ``key_t``, ``key_ref`` and ``key_eps``. The loss is
the SUM of squared residuals over the batch, as in the reference.
Minibatch-OT coupling (Sinkhorn) is not ported yet.
"""

from typing import Callable, NamedTuple

import torch


class FMBatch(NamedTuple):
    times: torch.Tensor  # (B,)
    points: torch.Tensor  # (B, d)
    targets: torch.Tensor  # (B, d)


def fm_sample(samples, t, eps, sigma: float) -> FMBatch:
    """Path to a standard normal: x_t = t x1 + (1 - (1 - sigma) t) eps."""
    sd = 1.0 - (1.0 - sigma) * t
    points = t[:, None] * samples + sd[:, None] * eps
    return FMBatch(t, points, samples - (1.0 - sigma) * eps)


def cond_fm_sample(samples, t, x0, eps, sigma: float) -> FMBatch:
    """Conditional path: x_t = sigma eps + t x1 + (1 - t) x0, u_t = x1 - x0."""
    points = sigma * eps + t[:, None] * samples + (1.0 - t[:, None]) * x0
    return FMBatch(t, points, samples - x0)


def flow_matching_loss(apply_fn: Callable, batch: FMBatch) -> torch.Tensor:
    """sum |apply_fn(points, times) - targets|^2 over the batch."""
    resid = apply_fn(batch.points, batch.times) - batch.targets
    return torch.sum(resid * resid)
