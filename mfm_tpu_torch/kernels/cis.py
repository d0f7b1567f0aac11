"""Conditional importance sampling kernel, standalone library form
(counterpart of ``mfm_tpu/kernels/cis.py``).

Keep each chain's pullback point, draw ``num_samples`` fresh standard-normal
reference points, push all B (N+1) candidates through the flow in one batch,
and pick per chain from the log-weights

    log w = log pi(x) + logdet + ||u||^2 / 2

(pi(x) / q_flow(x) for a standard-normal reference, up to a constant; NaN
counts as -inf). The pick is the reference's ``jax.random.categorical``:
``argmax(gumbel + log w)`` over the candidates. Unlike
``flows/flow_mh.py::cis_refresh`` it takes no reference density and no
cached target values: any flow callable will do.

The noise is injected (``CISNoise``); ``draw_noise`` takes it from a
generator.
"""

from typing import Callable, NamedTuple, Tuple

import torch

from mfm_tpu_torch.kernels.base import SamplingAlgorithm, draw


class CISState(NamedTuple):
    position: torch.Tensor  # (B, d)
    pullback_position: torch.Tensor  # (B, d)


class CISInfo(NamedTuple):
    positions: torch.Tensor  # (B, N+1, d) all candidates
    pullback_positions: torch.Tensor  # (B, N+1, d)
    log_weights: torch.Tensor  # (B, N+1)


class CISNoise(NamedTuple):
    fresh: torch.Tensor  # (B, N, d) standard normal: the new candidates
    gumbel: torch.Tensor  # (B, N+1) standard Gumbel: the pick


def init(pullback_position: torch.Tensor) -> CISState:
    return CISState(pullback_position, pullback_position)


def draw_noise(gen: torch.Generator, B: int, num_samples: int, d: int) -> CISNoise:
    dev = gen.device
    fresh = torch.randn((B, num_samples, d), generator=gen, device=dev)
    u = torch.rand((B, num_samples + 1), generator=gen, device=dev)
    tiny = torch.finfo(u.dtype).tiny
    return CISNoise(fresh, -torch.log(-torch.log(torch.clamp(u, min=tiny))))


def build_kernel(num_samples: int) -> Callable:
    """``kernel(state, logprob_fn, flow, noise) -> (state, info)`` with
    batched ``logprob_fn: (M, d) -> (M,)`` and ``flow: (M, d) -> ((M, d),
    (M,))``; ``noise`` a ``CISNoise`` or a generator to draw it from."""

    def kernel(
        state: CISState, logprob_fn: Callable, flow: Callable, noise
    ) -> Tuple[CISState, CISInfo]:
        B, d = state.pullback_position.shape
        noise = draw(noise, lambda g: draw_noise(g, B, num_samples, d))
        pullbacks = torch.cat([state.pullback_position[:, None, :], noise.fresh], dim=1)
        flat = pullbacks.reshape(B * (num_samples + 1), d)
        xs, logdets = flow(flat)
        log_w = (logprob_fn(xs) + logdets + 0.5 * torch.sum(flat * flat, dim=-1)).reshape(
            B, num_samples + 1)
        log_w = torch.where(torch.isnan(log_w), -torch.inf, log_w)
        choice = torch.argmax(noise.gumbel + log_w, dim=1)  # (B,)
        positions = xs.reshape(B, num_samples + 1, d)
        rows = torch.arange(B, device=choice.device)
        new_state = CISState(positions[rows, choice], pullbacks[rows, choice])
        return new_state, CISInfo(positions, pullbacks, log_w)

    return kernel


def cis(logprob_fn: Callable, flow: Callable, num_importance_samples: int = 1
        ) -> SamplingAlgorithm:
    """``init(pullback_position)``, ``step(noise, state)``."""
    kernel = build_kernel(num_importance_samples)

    def step_fn(noise, state):
        return kernel(state, logprob_fn, flow, noise)

    return SamplingAlgorithm(init, step_fn)
