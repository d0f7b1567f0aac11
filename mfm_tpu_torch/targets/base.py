"""Target-density protocol (counterpart of ``mfm_tpu.targets.base``).

Every density is batch-first: ``log_lik`` / ``log_prior`` take ``(..., d)``
and reduce the last axis. Scores come from ``torch.func.grad`` of the
batch sum, which is exact because rows never interact; being a function
transform, it composes with ``torch.func.jvp`` and ``vmap``, which the CNF
divergence uses to differentiate the score gate.

Samplers take an explicit ``torch.Generator`` and draw on its device.
"""

import torch
from torch.func import grad, grad_and_value


def _value_and_grad(fn, x):
    def total(v):
        lp = fn(v)
        return lp.sum(), lp

    g, (_, lp) = grad_and_value(total, has_aux=True)(x)
    return lp, g


class Target:
    """Base class for unnormalised target densities.

    Subclasses implement the batched ``log_lik`` (and ``log_prior`` when it
    is not flat); ``log_prob`` is always ``log_lik + log_prior``.
    """

    dim: int

    def log_lik(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def log_prior(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_lik(x) + self.log_prior(x)

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient of ``log_prob``, same shape as ``x``."""
        return grad(lambda v: self.log_prob(v).sum())(x)

    def value_and_score(self, x: torch.Tensor):
        return _value_and_grad(self.log_prob, x)

    def tempered_log_prob(self, x: torch.Tensor, beta) -> torch.Tensor:
        """``beta * log_lik + log_prior`` (the tempering path)."""
        return beta * self.log_lik(x) + self.log_prior(x)

    def tempered_value_and_score(self, x: torch.Tensor, beta):
        return _value_and_grad(lambda v: self.tempered_log_prob(v, beta), x)

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} has no exact sampler")

    @property
    def can_sample(self) -> bool:
        return type(self).sample is not Target.sample

    def init_positions(self, generator: torch.Generator, n_chain: int) -> torch.Tensor:
        """Initial chain positions (n_chain, dim); default N(0, I)."""
        return torch.randn(
            (n_chain, self.dim), generator=generator, device=generator.device
        )
