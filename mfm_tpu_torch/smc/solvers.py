"""Scalar root solvers for adaptive tempering (counterpart of
``mfm_tpu/smc/solvers.py``), in float32:

- ``bisection``: a fixed trip count, with no host round trip inside the
  loop (the MFM driver's tempering);
- ``dichotomy`` (:51-91): early-exit bisection (the SMC drivers' ESS
  solve), which reads its stopping condition on the host each trip.
"""

from typing import Callable

import torch


def bisection(fun: Callable, lower, upper, n_iters: int = 30, device=None):
    """Root of a decreasing ``fun`` on [lower, upper]. If fun(upper) >= 0
    the upper bound is returned; otherwise the midpoint after ``n_iters``
    halvings."""
    lower = torch.as_tensor(lower, dtype=torch.float32, device=device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=device)
    f_upper = fun(upper)
    a, b = lower, upper
    for _ in range(n_iters):
        mid = 0.5 * (a + b)
        right = fun(mid) >= 0
        a = torch.where(right, mid, a)
        b = torch.where(right, b, mid)
    return torch.where(f_upper >= 0, upper, 0.5 * (a + b))


def dichotomy(fun: Callable, _start, min_delta, max_delta, eps: float = 1e-4,
              max_iter: int = 100):
    """Early-exit bisection for a decreasing ``fun`` with fun(min_delta) > 0
    > fun(max_delta); returns max_delta if fun(max_delta) > 0, and NaN if
    fun(min_delta) <= 0 (or is NaN). The bracket halves while
    ``f(a) - f(b) > eps``, up to ``max_iter`` trips, and ``a`` is returned.

    The condition is read on the host each trip, where the reference runs a
    ``while_loop``: a trip is a handful of small launches, and the typical
    solve ends after ~15 of the 100 trips a masked loop would queue (the
    masked loop gives the same ``a``: a finished bracket stays put). The two
    were timed on the card (``tools/profile_slice.py --do-smc``)."""
    max_delta = torch.as_tensor(max_delta, dtype=torch.float32)
    a = torch.as_tensor(min_delta, dtype=torch.float32, device=max_delta.device)
    b = max_delta
    f_a, f_b = fun(a), fun(b)
    upper_ok, lower_ok = torch.stack([f_b > 0, f_a > 0]).tolist()
    if upper_ok:
        return b
    if not lower_ok:
        return torch.full_like(b, torch.nan)
    for _ in range(max_iter):
        if not bool(f_a - f_b > eps):
            break
        mid = 0.5 * (a + b)
        f_mid = fun(mid)
        low = f_mid < 0
        a, f_a = torch.where(low, a, mid), torch.where(low, f_a, f_mid)
        b, f_b = torch.where(low, mid, b), torch.where(low, f_mid, f_b)
    return a
