"""End-of-run evaluation (counterpart of ``mfm_tpu.drivers.eval``):
log-density, Stein discrepancies U/V, and MMD against exact target draws
when the target has a sampler; the floor of exact draws against themselves,
the summary-table row and the aggregate over seeds."""

from typing import Optional

import numpy as np
import torch

from mfm_tpu_torch.diagnostics import max_mean_disc, stein_disc
from mfm_tpu_torch.ops.pairwise import max_mean_disc_fused, stein_disc_fused
from mfm_tpu_torch.targets.base import Target


def _metric_fns(samples: torch.Tensor, fused_metrics: Optional[bool]):
    """(fused?, stein_fn, mmd_fn). ``None`` resolves to the pairwise CUDA
    kernels (K2a/K2b) for samples on a CUDA device, at every d, and to the
    tiled plain-PyTorch statistics otherwise. The reference turns its
    kernels off at d >= 1024 because they accumulate in fp32
    (``mfm_tpu/drivers/eval.py:59-62``); the port's kernels add their
    tiles in fp64 and need no such guard."""
    if fused_metrics is None:
        fused_metrics = samples.is_cuda
    if fused_metrics:
        return True, stein_disc_fused, max_mean_disc_fused
    return False, stein_disc, max_mean_disc


def evaluate_samples(
    target: Target,
    flow_samples: torch.Tensor,
    exact_samples: torch.Tensor,
    real_samples: Optional[torch.Tensor] = None,
    log_weights: Optional[torch.Tensor] = None,
    fused_metrics: Optional[bool] = None,
) -> dict:
    """The reference metric row for one run.

    ``fused_metrics`` picks the pairwise CUDA kernels (K2a/K2b); ``None``
    resolves as ``_metric_fns`` says. Every row records which path
    produced it (``metrics_kernel``). The weighted Stein statistics always
    take the plain path.
    """
    fused_metrics, stein_fn, mmd_fn = _metric_fns(flow_samples, fused_metrics)

    # the wrappers launch the kernels only for CUDA tensors
    out = {"metrics_kernel": "cuda" if fused_metrics and flow_samples.is_cuda else "torch"}
    out["logpdf"] = float(torch.mean(target.log_prob(flow_samples)))
    u, v = stein_fn(flow_samples, target.score)
    out["stein_u"], out["stein_v"] = float(u), float(v)

    out["logpdf_star"] = float(torch.mean(target.log_prob(exact_samples)))
    u_, v_ = stein_fn(exact_samples, target.score)
    out["stein_u_star"], out["stein_v_star"] = float(u_), float(v_)

    if log_weights is not None:
        w = torch.exp(log_weights - torch.max(log_weights))
        uw, vw = stein_disc(flow_samples, target.score, weights=w)
        out["stein_u_weighted"], out["stein_v_weighted"] = float(uw), float(vw)

    if real_samples is not None:
        out["mmd"] = float(mmd_fn(real_samples, flow_samples))
        out["mmd_star"] = float(mmd_fn(real_samples, exact_samples))
    else:
        out["mmd"] = out["mmd_star"] = 0.0
    return out


def check_floor(target: Target, real_samples: torch.Tensor,
                fused_metrics: Optional[bool] = None) -> dict:
    """Sanity floor: the metrics of exact samples against themselves."""
    _, stein_fn, mmd_fn = _metric_fns(real_samples, fused_metrics)
    u, v = stein_fn(real_samples, target.score)
    return {
        "logpdf_real": float(torch.mean(target.log_prob(real_samples))),
        "stein_u_real": float(u),
        "stein_v_real": float(v),
        "mmd_real": float(mmd_fn(real_samples, real_samples)),
    }


def report_row(cfg, metrics: dict, train_time: float) -> list:
    """The summary-table row layout of the reference."""
    row = [
        cfg.mcmc_per_flow_steps,
        cfg.learning_iter,
        train_time,
        metrics["logpdf"],
        metrics["logpdf_star"],
        metrics["stein_u"],
        metrics["stein_u_star"],
        metrics["stein_v"],
        metrics["stein_v_star"],
    ]
    if metrics.get("mmd") is not None:
        row += [metrics["mmd"], metrics["mmd_star"]]
    return row


def aggregate_seeds(rows: list) -> dict:
    """mean +/- 1.96 sigma over seeds."""
    arr = np.asarray(rows, dtype=np.float64)
    return {"mean": arr.mean(axis=0), "ci95": 1.96 * arr.std(axis=0)}
