from mfm_tpu_torch.smc import adaptive_tempered, base, ess, resampling, solvers, tempered
from mfm_tpu_torch.smc.adaptive_tempered import adaptive_tempered_smc
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
from mfm_tpu_torch.smc.tempered import SMCStepNoise, TemperedSMCState, tempered_smc

__all__ = [
    "adaptive_tempered",
    "base",
    "ess",
    "resampling",
    "solvers",
    "tempered",
    "adaptive_tempered_smc",
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
    "tempered_smc",
]
