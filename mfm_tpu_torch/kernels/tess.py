"""Transport elliptical slice sampler (TESS), ensemble-batched
(counterpart of ``mfm_tpu/kernels/tess.py``).

Slice sampling on an ellipse about 0 in the pullback space of a transport
``flow: u -> (x, log|det dx/du|)``; the slice function is
``logprob(T(u)) + logdet - ||m||^2 / 2``. One bracket-shrinking loop drives
the whole ensemble: every trip transports all B chains once, and a chain
that has accepted keeps its state by ``where``. The loop ends when no chain
is left to shrink, read on the host once a trip (each trip is a whole
transport), or after ``max_subiter`` trips, as the reference's masked
``while_loop`` does. After the loop one more transport of the accepted
``u`` gives the position.

This is not flow-SMC's latent TESS (``drivers/flow_smc.py``), whose ellipse
lies about the reference's mean and whose slice is ``ell(u) - log q0(u)``.

The noise is injected (``TESSNoise``); ``draw_noise`` takes it from a
generator. The reference draws the k-th shrink trip's uniforms from the
k-th split of its loop key; ``u_shrink[k]`` holds them.
"""

import math
from typing import Callable, NamedTuple, Tuple

import torch

from mfm_tpu_torch.kernels.base import SamplingAlgorithm, draw


class TESSState(NamedTuple):
    position: torch.Tensor  # (B, d) in data space
    pullback_position: torch.Tensor  # (B, d) in reference space


class TESSInfo(NamedTuple):
    momentum: torch.Tensor  # (B, d)
    slice_value: torch.Tensor  # (B,)
    theta: torch.Tensor  # (B,)
    subiter: torch.Tensor  # (B,) int32 shrinkage steps used per chain


class TESSNoise(NamedTuple):
    momentum: torch.Tensor  # (B, d) standard normal: the ellipse
    u_y: torch.Tensor  # (B,) uniform: the slice height
    u_theta: torch.Tensor  # (B,) uniform: the first angle
    u_shrink: torch.Tensor  # (max_subiter, B) uniform: one row a shrink trip


def init(pullback_position: torch.Tensor) -> TESSState:
    return TESSState(pullback_position, pullback_position)


def draw_noise(gen: torch.Generator, B: int, d: int, max_subiter: int = 100) -> TESSNoise:
    dev = gen.device
    return TESSNoise(
        torch.randn((B, d), generator=gen, device=dev),
        torch.rand(B, generator=gen, device=dev),
        torch.rand(B, generator=gen, device=dev),
        torch.rand((max_subiter, B), generator=gen, device=dev),
    )


def _ellipse(u0, m0, theta):
    """Rotate (u0, m0) by per-chain angles theta on their joint ellipse."""
    c = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    return u0 * c + m0 * s, m0 * c - u0 * s


def build_kernel(max_subiter: int = 100) -> Callable:
    """``kernel(state, logprob_fn, flow, noise) -> (state, info)`` with
    ``logprob_fn: (B, d) -> (B,)`` and ``flow: (B, d) -> ((B, d), (B,))``;
    ``noise`` a ``TESSNoise`` or a generator to draw it from."""

    def kernel(
        state: TESSState, logprob_fn: Callable, flow: Callable, noise
    ) -> Tuple[TESSState, TESSInfo]:
        u0 = state.pullback_position
        B, d = u0.shape
        noise = draw(noise, lambda g: draw_noise(g, B, d, max_subiter))
        momentum = noise.momentum

        def slice_fn(u, m):
            x, logdet = flow(u)
            return logprob_fn(x) + logdet - 0.5 * torch.sum(m * m, dim=-1)

        log_y = slice_fn(u0, momentum) + torch.log(noise.u_y)
        theta = 2.0 * math.pi * noise.u_theta
        tmin, tmax = theta - 2.0 * math.pi, theta
        u, m = _ellipse(u0, momentum, theta)
        s = slice_fn(u, m)
        subiter = torch.ones(B, dtype=torch.int32, device=u0.device)
        active = (s <= log_y) | ~torch.isfinite(s)
        for it in range(max_subiter):
            if not bool(active.any()):  # host read: every chain is on its slice
                break
            prop = torch.maximum(tmin, noise.u_shrink[it] * (tmax - tmin) + tmin)
            theta = torch.where(active, prop, theta)
            u_new, m_new = _ellipse(u0, momentum, theta)
            s_new = slice_fn(u_new, m_new)
            u = torch.where(active[:, None], u_new, u)
            m = torch.where(active[:, None], m_new, m)
            s = torch.where(active, s_new, s)
            tmin = torch.where(active & (theta < 0), theta, tmin)
            tmax = torch.where(active & (theta > 0), theta, tmax)
            subiter = subiter + active.to(torch.int32)
            active = active & ((s <= log_y) | ~torch.isfinite(s))
        position = flow(u)[0]
        return TESSState(position, u), TESSInfo(m, s, theta, subiter)

    return kernel


def tess(logprob_fn: Callable, flow: Callable) -> SamplingAlgorithm:
    """``init(pullback_position)``, ``step(noise, state)``."""
    kernel = build_kernel()

    def step_fn(noise, state):
        return kernel(state, logprob_fn, flow, noise)

    return SamplingAlgorithm(init, step_fn)
