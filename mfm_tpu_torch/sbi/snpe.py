"""Simulation-based inference scaffolding: a simulator and SNPE-A
(counterpart of ``mfm_tpu/sbi/snpe.py``).

The reference draws each simulation under ``vmap`` over split keys; here
the generators are batched on tensors: ``prior_gn(gen, n, *args,
**kwargs) -> theta (n, ...)`` and ``likelihood_gn(gen, theta) -> data
(n, ...)``, and ``approx_logprob_fn(approx_params, theta, data) -> (n,)``
scores the whole batch.
"""

import abc
from typing import Callable

import torch


def simulator(likelihood_gn: Callable) -> Callable:
    """``simulate(gen, n, prior_gn, *prior_args, **prior_kwargs) -> (theta,
    data)``: n parameters from the prior, then data from the likelihood."""

    def simulate(gen: torch.Generator, n: int, prior_gn: Callable, *prior_args, **prior_kwargs):
        params = prior_gn(gen, n, *prior_args, **prior_kwargs)
        return params, likelihood_gn(gen, params)

    return simulate


class SNPE(metaclass=abc.ABCMeta):
    """Sequential neural posterior estimation. The prior generator can be
    swapped between rounds (the ``update_*`` methods) to run the sequential
    scheme."""

    def __init__(self, approx_logprob_fn: Callable, num_obs: int, likelihood_gn: Callable,
                 prior_gn: Callable, *prior_args, **prior_kwargs):
        self.approx_logprob_fn = approx_logprob_fn
        self.num_obs = num_obs
        self.simulate = simulator(likelihood_gn)
        self.prior_gn = prior_gn
        self.prior_args = prior_args
        self.prior_kwargs = prior_kwargs

    def update_prior_generator(self, prior_gn: Callable):
        self.prior_gn = prior_gn

    def update_prior_params(self, *prior_args, **prior_kwargs):
        self.prior_args = prior_args
        self.prior_kwargs = prior_kwargs

    def update_approx_logprob_function(self, approx_logprob_fn: Callable):
        self.approx_logprob_fn = approx_logprob_fn

    @abc.abstractmethod
    def get_loss_function(self, gen: torch.Generator, num_particles: int) -> Callable:
        """Loss as a function of the approximation's parameters."""


class SNPE_A(SNPE):
    """SNPE-A: the summed approximate posterior log-density of
    ``num_particles`` (params, data) simulations."""

    def get_loss_function(self, gen: torch.Generator, num_particles: int) -> Callable:
        thetas, datas = self.simulate(gen, num_particles, self.prior_gn, *self.prior_args,
                                      **self.prior_kwargs)

        def loss(approx_params):
            return torch.sum(self.approx_logprob_fn(approx_params, thetas, datas))

        return loss
