"""Flow-proposal chain refresh (counterpart of ``mfm_tpu.flows.flow_mh``).

Only pullback random-walk MH, the reference's default flow kernel, is
ported: it targets pi~(u) = pi(T(u)) |det dT/du| with the scale
2.38 / sqrt(d), and with a symmetric proposal accepts with
exp((log pi(x') + logdet') - (log pi(x) + logdet)). One inverse and one
forward transport carry the whole ensemble.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from mfm_tpu_torch.flows.cnf import Transport
from mfm_tpu_torch.kernels.base import ChainInfo, ChainState


class FlowTarget(NamedTuple):
    value_and_score: Callable  # (B, d) -> ((B,), (B, d)), tempered
    ref_log_prob: Callable
    ref_sample: Callable  # (generator, shape) -> shape + (d,)


def pullback_rwm(
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
    eps: torch.Tensor,
    u_accept: torch.Tensor,
    probe_inv: Optional[torch.Tensor] = None,
    probe_fwd: Optional[torch.Tensor] = None,
):
    """One ensemble step. ``eps`` (B, d) standard normal, ``u_accept`` (B,)
    uniform, Hutchinson probes for the inverse / forward transports."""
    B, d = state.position.shape
    u_cur, logdet_cur = transport.inverse(params, state.position, probe_inv)
    u_prop = u_cur + (2.38 / math.sqrt(d)) * eps
    x_prop, logdet_prop = transport.forward(params, u_prop, probe_fwd)

    prop_ld, prop_grad = tgt.value_and_score(x_prop)
    log_ratio = (prop_ld + logdet_prop) - (state.logdensity + logdet_cur)
    log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
    p_accept = torch.exp(torch.clamp(log_ratio, max=0.0))
    accept = u_accept < p_accept

    new_state = ChainState(
        torch.where(accept[:, None], x_prop, state.position),
        torch.where(accept, prop_ld, state.logdensity),
        torch.where(accept[:, None], prop_grad, state.logdensity_grad),
    )
    return new_state, ChainInfo(p_accept, accept, x_prop, torch.zeros_like(p_accept))


def select_flow_kernel(num_importance_samples: int) -> Callable:
    """Reference dispatch: 0 -> pullback RWM; CIS (> 0) and independence MH
    (< 0) are not ported yet."""
    if num_importance_samples > 0:
        raise NotImplementedError("the CIS flow kernel is not ported yet")
    if num_importance_samples < 0:
        raise NotImplementedError("the independence-MH flow kernel is not ported yet")
    return pullback_rwm
