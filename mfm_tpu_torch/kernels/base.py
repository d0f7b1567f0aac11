"""Ensemble chain state containers, the sampler protocol and the loop
(counterpart of ``mfm_tpu.kernels.base``).

Kernels act on a whole ``(n_chain, dim)`` ensemble at once. A sampler's
``step`` takes its randomness first, as the reference's takes its key: a
``torch.Generator`` to draw from, or the noise itself, injected (``draw``).
"""

from typing import Callable, NamedTuple, Sequence, Union

import torch
from torch.utils._pytree import tree_map


class ChainState(NamedTuple):
    position: torch.Tensor  # (n_chain, dim)
    logdensity: torch.Tensor  # (n_chain,)
    logdensity_grad: torch.Tensor  # (n_chain, dim)


class ChainInfo(NamedTuple):
    acceptance_rate: torch.Tensor  # (n_chain,)
    is_accepted: torch.Tensor  # (n_chain,) bool
    proposed_position: torch.Tensor  # (n_chain, dim)
    proposed_weight: torch.Tensor  # (n_chain,)


class SamplingAlgorithm(NamedTuple):
    """A pair of functions (init, step) defining an ensemble sampler."""

    init: Callable
    step: Callable


class AdaptationAlgorithm(NamedTuple):
    """A warmup/adaptation procedure exposing a single ``run``."""

    run: Callable


def draw(noise, draw_fn: Callable):
    """``draw_fn(noise)`` when ``noise`` is a generator, else the injected
    noise as given."""
    return draw_fn(noise) if isinstance(noise, torch.Generator) else noise


def step_noise(noise: Union[torch.Generator, Sequence], k: int):
    """The k-th step's randomness: the generator itself, or the k-th entry
    of a sequence of per-step noises (the reference's k-th split key)."""
    return noise if isinstance(noise, torch.Generator) else noise[k]


def stack(trees: Sequence):
    """Trees of tensors stacked on a new leading axis (a scan's outputs)."""
    return tree_map(lambda *vs: torch.stack(vs), *trees)


def inference_loop(noise, step_fn: Callable, initial_state, n_steps: int):
    """``n_steps`` of ``step_fn(noise_k, state) -> (state, info)``, with
    ``noise_k`` from ``step_noise``; the per-step states and infos stacked
    on a leading time axis (the reference's ``lax.scan``)."""
    state, states, infos = initial_state, [], []
    for k in range(n_steps):
        state, info = step_fn(step_noise(noise, k), state)
        states.append(state)
        infos.append(info)
    return stack(states), stack(infos)
