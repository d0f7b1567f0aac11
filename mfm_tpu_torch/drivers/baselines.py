"""Importance resampling (counterpart of ``is_resample`` in
``mfm_tpu.drivers.baselines``; the baseline adapters are not ported)."""

from typing import Optional

import torch


def is_resample(
    flow_samples: torch.Tensor,
    log_target: torch.Tensor,
    log_flow: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Self-normalised IS resampling in log space; NaN log-weights count as
    -inf. Returns (resampled, log_w).

    With ``gumbel`` (n, n) the indices are ``argmax(gumbel + log_w)`` per
    row, which is exactly ``jax.random.categorical(key, log_w, shape=(n,))``
    fed the same draw; otherwise they come from ``generator`` by inverse-CDF
    sampling in fp64, the same distribution without an (n, n) draw."""
    log_w = log_target if log_flow is None else log_target - log_flow
    log_w = torch.where(torch.isnan(log_w), -torch.inf, log_w)
    n = flow_samples.shape[0]
    if gumbel is not None:
        idx = torch.argmax(gumbel + log_w[None, :], dim=-1)
    else:
        cdf = torch.cumsum(torch.softmax(log_w.double(), dim=0), dim=0)
        u = torch.rand(n, generator=generator, dtype=torch.float64, device=log_w.device)
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp(max=n - 1)
    return flow_samples[idx], log_w
