from mfm_tpu_torch.diagnostics.metrics import max_mean_disc, stein_disc

__all__ = ["max_mean_disc", "stein_disc"]
