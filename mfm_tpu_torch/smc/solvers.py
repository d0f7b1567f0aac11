"""Fixed-iteration bisection for adaptive tempering (counterpart of
``mfm_tpu.smc.solvers.bisection``): a static trip count in float32, with no
host round trip inside the loop."""

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
