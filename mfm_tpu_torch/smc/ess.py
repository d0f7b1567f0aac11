"""Effective sample size of importance weights and the tempering root
problem (counterpart of ``mfm_tpu/smc/ess.py:14-42``)."""

from typing import Callable

import torch


def log_ess(log_weights: torch.Tensor) -> torch.Tensor:
    """log ESS = 2 logsumexp(w) - logsumexp(2 w)."""
    return 2.0 * torch.logsumexp(log_weights, 0) - torch.logsumexp(2.0 * log_weights, 0)


def ess(log_weights: torch.Tensor) -> torch.Tensor:
    return torch.exp(log_ess(log_weights))


def ess_solver(loglik: torch.Tensor, target_ess: float, max_delta, root_solver: Callable):
    """delta in [0, max_delta] with ESS(delta * loglik) = target_ess * N, by
    ``root_solver(fun, start, min_delta, max_delta)``; the incremental
    weights of a tempering move of size delta are ``delta * loglik``."""
    n = loglik.shape[0]
    # log(n * target_ess) in float32, as the reference computes it
    target = float(torch.log(torch.tensor(n * target_ess, dtype=torch.float32)))

    def fun(delta):
        return log_ess(torch.nan_to_num(delta * loglik)) - target

    return root_solver(fun, 0.0, 0.0, max_delta)
