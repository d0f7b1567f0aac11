"""End-of-run evaluation (counterpart of ``mfm_tpu.drivers.eval``):
log-density, Stein discrepancies U/V, and MMD against exact target draws
when the target has a sampler."""

from typing import Optional

import torch

from mfm_tpu_torch.diagnostics import max_mean_disc, stein_disc
from mfm_tpu_torch.ops.pairwise import max_mean_disc_fused, stein_disc_fused
from mfm_tpu_torch.targets.base import Target


def evaluate_samples(
    target: Target,
    flow_samples: torch.Tensor,
    exact_samples: torch.Tensor,
    real_samples: Optional[torch.Tensor] = None,
    log_weights: Optional[torch.Tensor] = None,
    fused_metrics: Optional[bool] = None,
) -> dict:
    """The reference metric row for one run.

    ``fused_metrics`` picks the pairwise CUDA kernels (K2a/K2b). ``None``
    resolves to ON for samples on a CUDA device with d < 1024, as the
    reference turns its Pallas kernels on for d < 1024 on a TPU; otherwise
    the tiled plain-PyTorch path. Every row records which path produced it
    (``metrics_kernel``). The weighted Stein statistics always take the
    plain path.
    """
    if fused_metrics is None:
        fused_metrics = flow_samples.is_cuda and flow_samples.shape[-1] < 1024
    if fused_metrics:
        stein_fn, mmd_fn = stein_disc_fused, max_mean_disc_fused
    else:
        stein_fn, mmd_fn = stein_disc, max_mean_disc

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
