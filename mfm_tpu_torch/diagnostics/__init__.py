from mfm_tpu_torch.diagnostics.metrics import (
    autocorrelation,
    effective_sample_size,
    max_mean_disc,
    potential_scale_reduction,
    stein_disc,
)

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "max_mean_disc",
    "potential_scale_reduction",
    "stein_disc",
]
