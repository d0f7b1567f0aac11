"""Flow-proposal chain refresh (counterpart of ``mfm_tpu.flows.flow_mh``):
three ensemble kernels that refresh the MCMC chains through the CNF.

- ``pullback_rwm``: random-walk MH in pullback space with the scale
  2.38 / sqrt(d); it targets pi~(u) = pi(T(u)) |det dT/du| and, the
  proposal being symmetric, accepts with
  exp((log pi(x') + logdet') - (log pi(x) + logdet)).
- ``independence_mh``: the proposal is the push-forward of a fresh
  reference draw; the acceptance takes the flow density on both sides.
- ``cis_refresh``: conditional importance sampling over N fresh reference
  draws and the kept previous position.

Every kernel carries the whole ensemble through one inverse and one
forward transport; for CIS the (B, N) candidates ride the forward one as a
single (B N, d) batch. Transports return logdet = log|det dx/du| and
log q(x) = log q0(u) - logdet.

The noise is injected. Each kernel takes ``(state, params, transport, tgt,
*noise)`` with ``noise`` its own tuple (``RwmNoise``, ``IndepNoise``,
``CisNoise``), which ``flow_noise_sampler`` draws from a generator.
``select_flow_kernel`` and ``flow_noise_sampler`` dispatch on the sign of
``num_importance_samples``: positive CIS, negative independence MH, zero
pullback RWM.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from mfm_tpu_torch.flows.cnf import Transport, draw_probe
from mfm_tpu_torch.kernels.base import ChainInfo, ChainState
from mfm_tpu_torch.utils import profiling


class FlowTarget(NamedTuple):
    value_and_score: Callable  # (B, d) -> ((B,), (B, d)), tempered
    ref_log_prob: Callable
    ref_sample: Callable  # (generator, shape) -> shape + (d,)


class RwmNoise(NamedTuple):
    eps: torch.Tensor  # (B, d) standard normal
    u_accept: torch.Tensor  # (B,) uniform
    probe_inv: Optional[torch.Tensor] = None  # Hutchinson probes, else None
    probe_fwd: Optional[torch.Tensor] = None


class IndepNoise(NamedTuple):
    u_prop: torch.Tensor  # (B, d) reference draws
    u_accept: torch.Tensor  # (B,) uniform
    probe_inv: Optional[torch.Tensor] = None
    probe_fwd: Optional[torch.Tensor] = None


class CisNoise(NamedTuple):
    u_new: torch.Tensor  # (B N, d) reference draws
    gumbel: torch.Tensor  # (B, N + 1) standard Gumbel, for the choice
    probe_inv: Optional[torch.Tensor] = None  # for the (B, d) inverse
    probe_fwd: Optional[torch.Tensor] = None  # for the (B N, d) forward


def _mh_accept(state: ChainState, log_ratio, u_accept, x_prop, prop_ld, prop_grad):
    """Accept where u < min(1, exp(log_ratio)); a nan ratio rejects."""
    with profiling.span("flow.accept"):
        log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
        p_accept = torch.exp(torch.clamp(log_ratio, max=0.0))
        accept = u_accept < p_accept
        new_state = ChainState(
            torch.where(accept[:, None], x_prop, state.position),
            torch.where(accept, prop_ld, state.logdensity),
            torch.where(accept[:, None], prop_grad, state.logdensity_grad),
        )
        return new_state, ChainInfo(p_accept, accept, x_prop, torch.zeros_like(p_accept))


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
    with profiling.span("flow.inverse"):
        u_cur, logdet_cur = transport.inverse(params, state.position, probe_inv)
    u_prop = u_cur + (2.38 / math.sqrt(d)) * eps
    with profiling.span("flow.forward"):
        x_prop, logdet_prop = transport.forward(params, u_prop, probe_fwd)

    with profiling.span("flow.target"):
        prop_ld, prop_grad = tgt.value_and_score(x_prop)
    log_ratio = (prop_ld + logdet_prop) - (state.logdensity + logdet_cur)
    return _mh_accept(state, log_ratio, u_accept, x_prop, prop_ld, prop_grad)


def independence_mh(
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
    u_prop: torch.Tensor,
    u_accept: torch.Tensor,
    probe_inv: Optional[torch.Tensor] = None,
    probe_fwd: Optional[torch.Tensor] = None,
):
    """Whole-ensemble independence MH through the flow. ``u_prop`` (B, d)
    are fresh reference draws, ``u_accept`` (B,) uniform."""
    with profiling.span("flow.forward"):
        x_prop, logdet_prop = transport.forward(params, u_prop, probe_fwd)
    with profiling.span("flow.inverse"):
        u_cur, logdet_cur = transport.inverse(params, state.position, probe_inv)

    with profiling.span("flow.target"):
        prop_ld, prop_grad = tgt.value_and_score(x_prop)
    logq_prop = tgt.ref_log_prob(u_prop) - logdet_prop
    logq_cur = tgt.ref_log_prob(u_cur) - logdet_cur
    log_ratio = (prop_ld - logq_prop) - (state.logdensity - logq_cur)
    return _mh_accept(state, log_ratio, u_accept, x_prop, prop_ld, prop_grad)


def cis_refresh(
    state: ChainState,
    params,
    transport: Transport,
    tgt: FlowTarget,
    num_samples: int,
    u_new: torch.Tensor,
    gumbel: torch.Tensor,
    probe_inv: Optional[torch.Tensor] = None,
    probe_fwd: Optional[torch.Tensor] = None,
):
    """Conditional importance sampling refresh. Candidate 0 of a chain is
    its previous position (through the inverse map); its N fresh candidates
    are rows [b N, (b + 1) N) of the one (B N, d) forward batch ``u_new``.
    The choice is categorical over the N + 1 log-weights (nan counts as
    -inf), taken as ``argmax(gumbel + logw)``; the gradient is recomputed
    on the selected positions."""
    B, d = state.position.shape
    with profiling.span("flow.inverse"):
        u_cur, logdet_cur = transport.inverse(params, state.position, probe_inv)
    prev_logw = state.logdensity - (tgt.ref_log_prob(u_cur) - logdet_cur)

    with profiling.span("flow.forward"):
        x_new, logdet_new = transport.forward(params, u_new, probe_fwd)
    with profiling.span("flow.target"):
        new_ld = tgt.value_and_score(x_new)[0]
    logw = new_ld - (tgt.ref_log_prob(u_new) - logdet_new)

    with profiling.span("flow.accept"):
        all_logw = torch.cat([prev_logw[:, None], logw.reshape(B, num_samples)], dim=1)
        all_logw = torch.where(torch.isnan(all_logw), -torch.inf, all_logw)
        choice = torch.argmax(gumbel + all_logw, dim=1)  # (B,)

        cand_pos = torch.cat([state.position[:, None, :], x_new.reshape(B, num_samples, d)],
                             dim=1)
        cand_ld = torch.cat([state.logdensity[:, None], new_ld.reshape(B, num_samples)], dim=1)
        rows = torch.arange(B, device=choice.device)
        sel_pos, sel_ld = cand_pos[rows, choice], cand_ld[rows, choice]
    with profiling.span("flow.target"):
        sel_grad = tgt.value_and_score(sel_pos)[1]

    sel_w = torch.softmax(all_logw, dim=1)[rows, choice]
    return ChainState(sel_pos, sel_ld, sel_grad), ChainInfo(sel_w, choice != 0, sel_pos, sel_w)


def select_flow_kernel(num_importance_samples: int) -> Callable:
    """Reference dispatch: positive -> CIS with that many fresh candidates,
    negative -> independence MH, zero -> pullback RWM (the default)."""
    if num_importance_samples > 0:

        def kernel(state, params, transport, tgt, *noise):
            return cis_refresh(state, params, transport, tgt, num_importance_samples, *noise)

        return kernel
    if num_importance_samples < 0:
        return independence_mh
    return pullback_rwm


def flow_noise_sampler(num_importance_samples: int) -> Callable:
    """``draw(generator, transport, ref_sample, B, d) -> noise`` for the
    kernel ``select_flow_kernel`` returns for the same argument."""
    n = num_importance_samples

    def draw(gen: torch.Generator, transport: Transport, ref_sample: Callable, B: int, d: int):
        dev = gen.device
        if n > 0:
            gumbel = -torch.log(
                torch.empty((B, n + 1), device=dev).exponential_(generator=gen)
            )
            return CisNoise(
                ref_sample(gen, (B * n,)), gumbel,
                draw_probe(transport, gen, B, d), draw_probe(transport, gen, B * n, d),
            )
        first = (
            ref_sample(gen, (B,)) if n < 0 else torch.randn((B, d), generator=gen, device=dev)
        )
        noise_type = IndepNoise if n < 0 else RwmNoise
        return noise_type(
            first, torch.rand(B, generator=gen, device=dev),
            draw_probe(transport, gen, B, d), draw_probe(transport, gen, B, d),
        )

    return draw
