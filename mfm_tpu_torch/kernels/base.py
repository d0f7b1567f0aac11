"""Ensemble chain state containers (counterpart of ``mfm_tpu.kernels.base``).

Kernels act on a whole ``(n_chain, dim)`` ensemble at once.
"""

from typing import NamedTuple

import torch


class ChainState(NamedTuple):
    position: torch.Tensor  # (n_chain, dim)
    logdensity: torch.Tensor  # (n_chain,)
    logdensity_grad: torch.Tensor  # (n_chain, dim)


class ChainInfo(NamedTuple):
    acceptance_rate: torch.Tensor  # (n_chain,)
    is_accepted: torch.Tensor  # (n_chain,) bool
    proposed_position: torch.Tensor  # (n_chain, dim)
    proposed_weight: torch.Tensor  # (n_chain,)
