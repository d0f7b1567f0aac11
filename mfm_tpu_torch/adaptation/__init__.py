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
from mfm_tpu_torch.adaptation.chain_adaptation import AdaptState, cross_chain, parallel_eca
from mfm_tpu_torch.adaptation.optimize import optimize
from mfm_tpu_torch.adaptation.atess import atess
from mfm_tpu_torch.adaptation.msc import msc
from mfm_tpu_torch.adaptation.msc_mala import msc_mala

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
    "AdaptState",
    "cross_chain",
    "parallel_eca",
    "optimize",
    "atess",
    "msc",
    "msc_mala",
]
