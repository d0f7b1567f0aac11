from mfm_tpu_torch.kernels import hmc, mala, nuts, proposal
from mfm_tpu_torch.kernels.base import ChainInfo, ChainState

__all__ = ["ChainInfo", "ChainState", "hmc", "mala", "nuts", "proposal"]
