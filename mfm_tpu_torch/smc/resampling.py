"""Particle resampling with static shapes (counterpart of
``mfm_tpu/smc/resampling.py:20-95``): systematic, stratified, multinomial
(sorted uniforms from normalised exponential spacings) and residual, each
a weight cumsum and a ``searchsorted``.

The noise is injected. Each scheme takes ``(noise, weights, num_samples)``
and ``draw_noise(name, generator, num_samples)`` draws it: systematic one
uniform (a 0-d tensor), stratified ``num_samples`` uniforms, multinomial
``num_samples + 1``, residual a pair ``(uniforms (num_samples + 1,),
permutation (num_samples,))``, the permutation being what
``jax.random.permutation`` applies to the residual draws. ``searchsorted``
takes the left side, as ``jnp.searchsorted``, and the index is clipped to
[0, n - 1].
"""

from typing import Callable

import torch


def _search(cum, grid, n):
    return torch.clamp(torch.searchsorted(cum, grid.contiguous(), right=False), 0, n - 1)


def _offset_resample(u, weights, num_samples: int):
    n = weights.shape[0]
    cum = torch.cumsum(weights, 0)
    grid = (torch.arange(num_samples, dtype=weights.dtype, device=weights.device) + u) / num_samples
    return _search(cum, grid, n)


def systematic(u, weights, num_samples: int):
    """One shared uniform offset ``u`` (0-d): the lowest-variance O(n) scheme."""
    return _offset_resample(u, weights, num_samples)


def stratified(u, weights, num_samples: int):
    """One uniform offset a stratum, ``u`` (num_samples,)."""
    return _offset_resample(u, weights, num_samples)


def _sorted_uniforms(u):
    """len(u) - 1 sorted uniforms from len(u) uniforms, by normalised
    exponential spacings (no sort)."""
    z = torch.cumsum(-torch.log(u), 0)
    return z[:-1] / z[-1]


def multinomial(u, weights, num_samples: int):
    """IID categorical resampling, ``u`` (num_samples + 1,)."""
    n = weights.shape[0]
    return _search(torch.cumsum(weights, 0), _sorted_uniforms(u), n)


def residual(noise, weights, num_samples: int):
    """The deterministic floor part, then multinomial draws of the residuals
    in the remaining slots; ``noise`` = (uniforms, permutation)."""
    u, perm = noise
    n = weights.shape[0]
    scaled = num_samples * weights
    floor = torch.floor(scaled).to(torch.int64)
    n_det = torch.sum(floor)
    resid = scaled - floor
    resid_idx = multinomial(u, resid / torch.clamp(resid.sum(), min=1e-30), num_samples)
    resid_idx = resid_idx[perm]  # exchangeability: decouple the draws from slot order
    # index n is a sink for the slots the residual draws fill
    counts = torch.cat([floor, torch.clamp(num_samples - n_det, min=0)[None]])
    det_idx = torch.repeat_interleave(
        torch.arange(n + 1, device=weights.device), counts, output_size=num_samples
    )
    slots = torch.arange(num_samples, device=weights.device)
    return torch.where(slots < n_det, det_idx, resid_idx)


RESAMPLERS = {
    "systematic": systematic,
    "stratified": stratified,
    "multinomial": multinomial,
    "residual": residual,
}


def get_resampler(name: str) -> Callable:
    try:
        return RESAMPLERS[name]
    except KeyError:
        raise ValueError(f"unknown resampler {name!r}") from None


def draw_noise(name: str, gen: torch.Generator, num_samples: int):
    """The uniforms (and permutation) resampler ``name`` takes."""
    dev = gen.device
    if name == "systematic":
        return torch.rand((), generator=gen, device=dev)
    if name == "stratified":
        return torch.rand(num_samples, generator=gen, device=dev)
    if name == "multinomial":
        return torch.rand(num_samples + 1, generator=gen, device=dev)
    if name == "residual":
        return (torch.rand(num_samples + 1, generator=gen, device=dev),
                torch.randperm(num_samples, generator=gen, device=dev))
    raise ValueError(f"unknown resampler {name!r}")
