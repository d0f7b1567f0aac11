from mfm_tpu_torch.smc import adaptive_tempered, base, ess, resampling, solvers, tempered
from mfm_tpu_torch.smc.base import SMCInfo, SMCState
from mfm_tpu_torch.smc.resampling import (
    RESAMPLERS,
    get_resampler,
    multinomial,
    residual,
    stratified,
    systematic,
)
from mfm_tpu_torch.smc.solvers import bisection, dichotomy
from mfm_tpu_torch.smc.tempered import SMCStepNoise, TemperedSMCState

__all__ = [
    "adaptive_tempered",
    "base",
    "ess",
    "resampling",
    "solvers",
    "tempered",
    "SMCInfo",
    "SMCState",
    "RESAMPLERS",
    "get_resampler",
    "multinomial",
    "residual",
    "stratified",
    "systematic",
    "bisection",
    "dichotomy",
    "SMCStepNoise",
    "TemperedSMCState",
]
