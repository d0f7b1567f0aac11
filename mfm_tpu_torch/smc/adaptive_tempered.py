"""Adaptive tempered SMC (counterpart of
``mfm_tpu/smc/adaptive_tempered.py:19-67``): each tempering increment is
the root of the ESS rule (``ess.ess_solver`` with ``solvers.dichotomy``),
``clip(nan_to_num(delta), 0, 1 - lambda)``, then the tempered step."""

from typing import Callable

import torch

from mfm_tpu_torch.kernels.base import SamplingAlgorithm
from mfm_tpu_torch.smc import ess as smc_ess
from mfm_tpu_torch.smc import solvers, tempered


def build_kernel(
    target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    target_ess: float,
    num_mcmc_steps: int = 10,
    root_solver: Callable = solvers.dichotomy,
    waste_free_p: int = 0,
) -> Callable:
    """``kernel(state, noise, mcmc_params=None) -> (state, SMCInfo)``."""
    tempered_kernel = tempered.build_kernel(
        target, mcmc_kernel_builder, mcmc_init, resample_fn, num_mcmc_steps, waste_free_p
    )

    def kernel(state: tempered.TemperedSMCState, noise, mcmc_params=None):
        max_delta = 1.0 - state.lmbda
        loglik = target.log_lik(state.particles)
        delta = smc_ess.ess_solver(loglik, target_ess, max_delta, root_solver)
        delta = torch.minimum(torch.clamp(torch.nan_to_num(delta), min=0.0), max_delta)
        return tempered_kernel(state, state.lmbda + delta, noise, mcmc_params)

    return kernel


def adaptive_tempered_smc(
    target,
    mcmc_kernel_builder: Callable,
    mcmc_init: Callable,
    resample_fn: Callable,
    target_ess: float,
    num_mcmc_steps: int = 10,
    root_solver: Callable = solvers.dichotomy,
    waste_free_p: int = 0,
) -> SamplingAlgorithm:
    """``init(particles)``, ``step(noise, state, mcmc_params=None)`` with
    ``noise`` an ``SMCStepNoise``."""
    kernel = build_kernel(
        target, mcmc_kernel_builder, mcmc_init, resample_fn, target_ess, num_mcmc_steps,
        root_solver, waste_free_p,
    )

    def step_fn(noise, state, mcmc_params=None):
        return kernel(state, noise, mcmc_params)

    return SamplingAlgorithm(tempered.init, step_fn)
