"""Generic SMC step: resample, move, reweigh (counterpart of
``mfm_tpu/smc/base.py:17-70``), with the waste-free hook (``num_resampled``
< N and a move that returns N particles) and the log normalising
constant's increment. The move is an ensemble move: one call on the whole
resampled block.

The noise is injected: ``resample_noise`` for ``resample_fn`` and
``update_noise`` for ``update_fn`` (the reference's ``key_resample`` and
``key_update``).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch


class SMCState(NamedTuple):
    particles: torch.Tensor  # (N, d)
    weights: torch.Tensor  # (N,), normalised


class SMCInfo(NamedTuple):
    ancestors: torch.Tensor  # (num_resampled,)
    log_likelihood_increment: torch.Tensor  # 0-d
    update_info: object


def init(particles: torch.Tensor) -> SMCState:
    n = particles.shape[0]
    return SMCState(particles, torch.full((n,), 1.0 / n, dtype=particles.dtype,
                                          device=particles.device))


def step(
    state: SMCState,
    update_fn: Callable,
    weigh_fn: Callable,
    resample_fn: Callable,
    resample_noise,
    update_noise,
    num_resampled: Optional[int] = None,
):
    """One Feynman-Kac step.

    update_fn(particles, noise) -> (new_particles, info)   [ensemble move]
    weigh_fn(particles)         -> (N,) log-weights        [potential]
    resample_fn(noise, weights, n) -> ancestor indices
    """
    n = state.weights.shape[0]
    if num_resampled is None:
        num_resampled = n
    ancestors = resample_fn(resample_noise, state.weights, num_resampled)
    particles, update_info = update_fn(state.particles[ancestors], update_noise)
    log_weights = weigh_fn(particles)
    log_sum = torch.logsumexp(log_weights, 0)
    log_z_increment = log_sum - math.log(n)
    weights = torch.exp(log_weights - log_sum)
    return SMCState(particles, weights), SMCInfo(ancestors, log_z_increment, update_info)
