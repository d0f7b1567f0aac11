from mfm_tpu_torch.adaptation.window import (
    DualAveragingState,
    WelfordState,
    build_schedule,
    da_init,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
    window_adaptation,
)

__all__ = [
    "DualAveragingState",
    "WelfordState",
    "build_schedule",
    "da_init",
    "da_update",
    "welford_init",
    "welford_update_batch",
    "welford_variance",
    "window_adaptation",
]
