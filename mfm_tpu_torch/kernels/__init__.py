from mfm_tpu_torch.kernels import mala, proposal
from mfm_tpu_torch.kernels.base import ChainInfo, ChainState

__all__ = ["ChainInfo", "ChainState", "mala", "proposal"]
