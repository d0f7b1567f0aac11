from mfm_tpu_torch.kernels.base import (
    AdaptationAlgorithm,
    ChainInfo,
    ChainState,
    SamplingAlgorithm,
    inference_loop,
)
from mfm_tpu_torch.kernels import cis, hmc, mala, nuts, proposal, tess

__all__ = [
    "AdaptationAlgorithm",
    "ChainInfo",
    "ChainState",
    "SamplingAlgorithm",
    "inference_loop",
    "cis",
    "hmc",
    "mala",
    "nuts",
    "proposal",
    "tess",
]
