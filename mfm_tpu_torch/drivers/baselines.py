"""The baselines' shared result and dispatch, and importance resampling
(counterpart of ``mfm_tpu.drivers.baselines``).

``run_baseline`` runs the in-repo FAB, flowMC and DDS (``drivers/fab.py``,
``flowmc.py``, ``dds.py``); the reference's adapters for the external JAX
packages ``fabjax``, ``flowMC`` and ``dds`` are not ported (only the in-repo
implementations have ever run).
"""

from typing import NamedTuple, Optional

import torch


class BaselineResult(NamedTuple):
    flow_samples: torch.Tensor  # (n_eval, d) the sampler's raw output
    exact_samples: torch.Tensor  # (n_eval, d) after the IS correction
    train_time: float
    extras: dict  # baseline-specific diagnostics


def categorical(log_w: torch.Tensor, draw: torch.Tensor) -> torch.Tensor:
    """Indices drawn from softmax(log_w) (n,) by ``draw``: a (k, n) Gumbel
    gives ``argmax(draw + log_w)`` per row, which is exactly
    ``jax.random.categorical(key, log_w, shape=(k,))`` fed the same draw; a
    (k,) float64 uniform gives the same distribution by the inverse CDF in
    fp64, without a (k, n) draw."""
    if draw.ndim == 2:
        return torch.argmax(draw + log_w[None, :], dim=-1)
    cdf = torch.cumsum(torch.softmax(log_w.double(), dim=0), dim=0)
    idx = torch.searchsorted(cdf, draw * cdf[-1], right=True)
    return idx.clamp(max=log_w.shape[0] - 1)


def is_resample(
    flow_samples: torch.Tensor,
    log_target: torch.Tensor,
    log_flow: Optional[torch.Tensor] = None,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Self-normalised IS resampling in log space; NaN log-weights count as
    -inf. Returns (resampled, log_w). ``gumbel`` (n, n) replays the
    reference's draw (see ``categorical``); otherwise ``generator`` draws the
    uniforms."""
    log_w = log_target if log_flow is None else log_target - log_flow
    log_w = torch.where(torch.isnan(log_w), -torch.inf, log_w)
    n = flow_samples.shape[0]
    if gumbel is None:
        gumbel = torch.rand(n, generator=generator, dtype=torch.float64, device=log_w.device)
    return flow_samples[categorical(log_w, gumbel)], log_w


def is_summary(log_w: torch.Tensor) -> dict:
    """The flow-IS log-normaliser estimate and the ESS fraction of the
    weights (the extras every baseline reports)."""
    n = log_w.shape[0]
    lse = torch.logsumexp(log_w, dim=0)
    return {
        "log_z_is": float(lse - torch.log(torch.tensor(float(n)))),
        "is_ess_frac": float(torch.exp(2 * lse - torch.logsumexp(2 * log_w, dim=0)) / n),
    }


BASELINES = ("fab", "flowmc", "dds")


def run_baseline(name: str, target, cfg, seed: int = 0, n_eval: Optional[int] = None,
                 device="cuda") -> BaselineResult:
    """Run the named in-repo baseline (``fab``, ``flowmc``, ``dds``)."""
    if name == "fab":
        from mfm_tpu_torch.drivers.fab import fab_baseline as fn
    elif name == "flowmc":
        from mfm_tpu_torch.drivers.flowmc import flowmc_baseline as fn
    elif name == "dds":
        from mfm_tpu_torch.drivers.dds import dds_baseline as fn
    else:
        raise ValueError(f"unknown baseline {name!r}; choose from {sorted(BASELINES)}")
    return fn(target, cfg, seed=seed, n_eval=n_eval, device=device)
