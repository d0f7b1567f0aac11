"""(Conditional) flow-matching losses (counterpart of
``mfm_tpu.flows.losses``). The noise is injected: ``t`` (B,) uniform,
``x0`` (B, d) reference draws, ``eps`` (B, d) standard normal -- the draws
the reference takes from ``key_t``, ``key_ref`` and ``key_eps``. The loss is
the SUM of squared residuals over the batch, as in the reference.
Minibatch optimal-transport coupling (``ot_pair``) re-pairs (x1, x0) from a
log-domain Sinkhorn plan; its pair choice takes B uniforms ``ot_u``, which
it uses as ``jax.random.choice`` uses its own (inverse CDF of the
flattened plan at 1 - u).

Under a chain mesh the reference couples the whole batch
(``mfm_tpu/flows/losses.py:72-83``): ``cond_fm_sample(..., mesh=)``
gathers every rank's positions and reference draws, so that every rank
computes the same Sinkhorn plan, and draws the pairs of its own output
rows with its own uniforms. There is no partial plan per shard.
"""

import math
from typing import Callable, NamedTuple, Optional

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


def sinkhorn_plan(cost: torch.Tensor, n_iters: int = 50, epsilon: Optional[float] = None):
    """Entropic OT plan (B, B) between two uniform marginals, log-domain
    Sinkhorn with a fixed number of sweeps; epsilon defaults to
    0.05 mean(cost) + 1e-8."""
    B = cost.shape[0]
    if epsilon is None:
        epsilon = 0.05 * torch.mean(cost) + 1e-8
    logK = -cost / epsilon
    logu = torch.zeros(B, dtype=cost.dtype, device=cost.device)
    logv = torch.zeros_like(logu)
    log_marg = -math.log(B)
    for _ in range(n_iters):
        logu = log_marg - torch.logsumexp(logK + logv[None, :], dim=1)
        logv = log_marg - torch.logsumexp(logK + logu[:, None], dim=0)
    return torch.exp(logu[:, None] + logK + logv[None, :])


def ot_pair(samples, ref_samples, ot_u):
    """Minibatch-OT coupling: (x1, x0) index pairs drawn from the Sinkhorn
    plan of the squared distances of the B samples and B reference draws,
    one a uniform of ``ot_u`` (B of them, or a rank's share under a mesh).
    Returns (samples[i], ref_samples[j])."""
    B = samples.shape[0]
    diff = samples[:, None, :] - ref_samples[None, :, :]
    plan = sinkhorn_plan(torch.sum(diff * diff, dim=-1))
    flat = torch.clamp(plan.reshape(-1), min=1e-30)
    cdf = torch.cumsum(flat / flat.sum(), dim=0)
    choice = torch.searchsorted(cdf, cdf[-1] * (1.0 - ot_u)).clamp(max=B * B - 1)
    return samples[choice // B], ref_samples[choice % B]


def cond_fm_sample(samples, t, x0, eps, sigma: float, ot_u=None, mesh=None) -> FMBatch:
    """Conditional path: x_t = sigma eps + t x1 + (1 - t) x0, u_t = x1 - x0;
    with ``ot_u`` the pairs (x1, x0) are first re-drawn by ``ot_pair``, from
    the whole batch of every rank of ``mesh``."""
    if ot_u is not None:
        if mesh is not None:
            samples, x0 = mesh.all_gather_rows(samples), mesh.all_gather_rows(x0)
        samples, x0 = ot_pair(samples, x0, ot_u)
    points = sigma * eps + t[:, None] * samples + (1.0 - t[:, None]) * x0
    return FMBatch(t, points, samples - x0)


def flow_matching_loss(apply_fn: Callable, batch: FMBatch) -> torch.Tensor:
    """sum |apply_fn(points, times) - targets|^2 over the batch."""
    resid = apply_fn(batch.points, batch.times) - batch.targets
    return torch.sum(resid * resid)
