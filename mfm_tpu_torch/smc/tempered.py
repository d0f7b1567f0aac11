"""Tempered SMC over pi_lambda(x) ∝ exp(log_prior + lambda * log_lik)
(counterpart of ``mfm_tpu/smc/tempered.py:34-168``), with waste-free SMC
(Dau & Chopin 2022).

The inner move is an ensemble kernel stepping the whole particle block
``num_mcmc_steps`` times. With ``waste_free_p`` = P >= 2, only M = N / P
ancestors are resampled, each runs P - 1 moves, and every state is kept:
the new system is the M chains of length P in chain-major order, (P, M, d)
-> (M, P, d) -> (M P, d) (:114-115), all reweighed by the same increment.

The noise is injected: ``SMCStepNoise`` holds the resampler's draw and one
noise tuple per inner move (``num_mcmc_steps`` of them, or P - 1).
"""

from typing import Callable, NamedTuple, Sequence

import torch

from mfm_tpu_torch.kernels.base import SamplingAlgorithm
from mfm_tpu_torch.smc import base as smc_base


class TemperedSMCState(NamedTuple):
    particles: torch.Tensor
    weights: torch.Tensor
    lmbda: torch.Tensor  # current inverse temperature in [0, 1]


class SMCStepNoise(NamedTuple):
    resample: object  # the resampler's draw (smc/resampling.py)
    moves: Sequence  # one inner-kernel noise tuple per move


def init(particles: torch.Tensor) -> TemperedSMCState:
    s = smc_base.init(particles)
    return TemperedSMCState(s.particles, s.weights, torch.zeros((), device=particles.device))


def num_moves(num_mcmc_steps: int, waste_free_p: int) -> int:
    """Inner moves a step: P - 1 waste-free, else ``num_mcmc_steps``."""
    return waste_free_p - 1 if waste_free_p else num_mcmc_steps


def build_kernel(
    target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    num_mcmc_steps: int = 10,
    waste_free_p: int = 0,
) -> Callable:
    """``kernel(state, lmbda, noise, mcmc_params=None) -> (state, SMCInfo)``.

    ``mcmc_kernel_builder(value_and_score[, mcmc_params])`` gives the inner
    ``kernel(chain_state, noise) -> (chain_state, info)``; the
    ``value_and_score`` it gets carries ``.value``, the tempered density
    alone, for moves that need no gradient;
    ``mcmc_init(positions, value_and_score)`` the chain state. ``update_info``
    stacks the inner acceptance: (num_mcmc_steps, N), or (P - 1, M)."""
    if waste_free_p == 1:
        raise ValueError(
            "waste_free_p=1 means zero inner moves per ancestor; "
            "use 0 to disable waste-free SMC or >= 2 to enable it"
        )

    def kernel(state: TemperedSMCState, lmbda, noise: SMCStepNoise, mcmc_params=None):
        delta = lmbda - state.lmbda

        # the moves target pi at the current lambda; reweighing bridges to lambda
        def vs(x):
            return target.tempered_value_and_score(x, state.lmbda)

        vs.value = lambda x: target.tempered_log_prob(x, state.lmbda)  # gradient-free moves

        inner = (mcmc_kernel_builder(vs) if mcmc_params is None
                 else mcmc_kernel_builder(vs, mcmc_params))

        def run_moves(particles, moves):
            chain = mcmc_init(particles, vs)
            hist, acc = [], []
            for move_noise in moves:
                chain, info = inner(chain, move_noise)
                hist.append(chain.position)
                acc.append(info.acceptance_rate)
            return chain, hist, torch.stack(acc)

        num_resampled = None
        if waste_free_p:
            n_total = state.particles.shape[0]
            if n_total % waste_free_p:
                raise ValueError(
                    f"waste-free SMC needs num_chain divisible by waste_free_p; "
                    f"got N={n_total}, P={waste_free_p}"
                )
            num_resampled = n_total // waste_free_p

            def update_fn(particles, moves):
                m, d = particles.shape
                _, hist, acc = run_moves(particles, moves)
                allp = torch.stack([particles, *hist])  # (P, M, d)
                return allp.transpose(0, 1).reshape(m * waste_free_p, d), acc

        else:

            def update_fn(particles, moves):
                chain, _, acc = run_moves(particles, moves)
                return chain.position, acc

        def weigh_fn(particles):
            return delta * target.log_lik(particles)

        smc_state, info = smc_base.step(
            smc_base.SMCState(state.particles, state.weights), update_fn, weigh_fn,
            resample_fn, noise.resample, noise.moves, num_resampled=num_resampled,
        )
        return TemperedSMCState(smc_state.particles, smc_state.weights, state.lmbda + delta), info

    return kernel


def tempered_smc(
    target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    num_mcmc_steps: int = 10,
    waste_free_p: int = 0,
) -> SamplingAlgorithm:
    """``init(particles)``, ``step(noise, state, lmbda, mcmc_params=None)``
    with ``noise`` an ``SMCStepNoise``."""
    kernel = build_kernel(
        target, mcmc_kernel_builder, mcmc_init, resample_fn, num_mcmc_steps, waste_free_p
    )

    def step_fn(noise, state, lmbda, mcmc_params=None):
        return kernel(state, lmbda, noise, mcmc_params)

    return SamplingAlgorithm(init, step_fn)
