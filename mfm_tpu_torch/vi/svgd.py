"""Stein variational gradient descent (SVGD) and coin-SVGD (counterpart of
``mfm_tpu/vi/svgd.py``).

RBF kernel ``K_ij = exp(-||p_i - p_j||^2 / l)`` (the reference's
convention: no factor 1/2) with the median-heuristic bandwidth, re-fitted
after every move. For this kernel the Stein functional gradient has a
closed matrix form,

    phi(p_j) = [ sum_i k_ij grad_i  +  (2 / l) sum_i (p_i - p_j) k_ij ] / N
             = [ K^T G + (2 / l) (K^T P - colsum(K) * P_j) ] / N,

three (N, N) x (N, d) products, which run in exact fp32 (TF32 off, the
reference's ``Precision.HIGHEST``). The particles move by a
``GradientTransformation`` (``flows/train.py``: ``sgd``, ``adam``) or, for
coin-SVGD, by COCOB.
"""

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from mfm_tpu_torch.flows.train import GradientTransformation, apply_updates
from mfm_tpu_torch.kernels.base import SamplingAlgorithm
from mfm_tpu_torch.optimizers import cocob
from mfm_tpu_torch.targets.cox import _matmul


class SVGDState(NamedTuple):
    particles: torch.Tensor  # (N, d)
    kernel_parameters: Dict[str, Any]
    opt_state: Any


def _sq_dists(particles: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(particles * particles, dim=-1)
    gram = _matmul(particles, particles.T)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)


def rbf_kernel_matrix(particles: torch.Tensor, length_scale) -> torch.Tensor:
    """K_ij = exp(-||p_i - p_j||^2 / l)."""
    return torch.exp(-_sq_dists(particles) / length_scale)


def stein_functional_gradient(particles: torch.Tensor, grads: torch.Tensor, length_scale
                              ) -> torch.Tensor:
    """What the optimizer takes as a gradient: -phi(p) (descending it moves
    the particles along the Stein direction)."""
    N = particles.shape[0]
    K = rbf_kernel_matrix(particles, length_scale)
    kg = _matmul(K.T, grads)  # sum_i k_ij grad_i
    kp = _matmul(K.T, particles)
    colsum = torch.sum(K, dim=0)[:, None]
    # sum_i grad_{p_i} k(p_i, p_j): the repulsive term
    grad_k = -(2.0 / length_scale) * (kp - colsum * particles)
    return -(kg + grad_k) / N


def median_heuristic(particles: torch.Tensor) -> torch.Tensor:
    """l = median(pairwise distance)^2 / log N over the N (N - 1) / 2
    distinct pairs. An even count takes the mean of the two middle values,
    as ``jnp.median`` does (``torch.median`` would take the lower one, and
    ``torch.quantile`` refuses more than 2^24 values)."""
    N = particles.shape[0]
    rows, cols = torch.tril_indices(N, N, -1, device=particles.device)
    dist = torch.sqrt(_sq_dists(particles)[rows, cols])
    s = torch.sort(dist).values
    n = s.shape[0]
    med = 0.5 * s[(n - 1) // 2] + 0.5 * s[n // 2]
    return med**2 / math.log(N)


def build_kernel(optimizer: GradientTransformation) -> Callable:
    def kernel(state: SVGDState, grad_logdensity_fn: Callable, **grad_params) -> SVGDState:
        particles, kernel_params, opt_state = state
        grads = grad_logdensity_fn(particles, **grad_params)  # (N, d)
        fg = stein_functional_gradient(particles, grads, kernel_params["length_scale"])
        updates, opt_state = optimizer.update(fg, opt_state, particles)
        return SVGDState(apply_updates(particles, updates), kernel_params, opt_state)

    return kernel


def update_median_heuristic(state: SVGDState) -> SVGDState:
    params = dict(state.kernel_parameters)
    params["length_scale"] = median_heuristic(state.particles)
    return SVGDState(state.particles, params, state.opt_state)


def _make(optimizer, grad_logdensity_fn, update_kernel_parameters):
    kernel = build_kernel(optimizer)

    def init_fn(initial_particles, kernel_parameters: Optional[dict] = None):
        if kernel_parameters is None:
            kernel_parameters = {"length_scale": torch.ones((), device=initial_particles.device)}
        return SVGDState(initial_particles, kernel_parameters, optimizer.init(initial_particles))

    def step_fn(state, **grad_params):
        return update_kernel_parameters(kernel(state, grad_logdensity_fn, **grad_params))

    return SamplingAlgorithm(init_fn, step_fn)


def svgd(
    grad_logdensity_fn: Callable,
    optimizer: GradientTransformation,
    update_kernel_parameters: Callable = update_median_heuristic,
) -> SamplingAlgorithm:
    """SVGD with a batched score function (N, d) -> (N, d)."""
    return _make(optimizer, grad_logdensity_fn, update_kernel_parameters)


def coin_svgd(
    grad_logdensity_fn: Callable,
    update_kernel_parameters: Callable = update_median_heuristic,
    alpha: float = 100.0,
) -> SamplingAlgorithm:
    """SVGD driven by the parameter-free COCOB optimizer."""
    return _make(cocob(alpha), grad_logdensity_fn, update_kernel_parameters)
