"""Target-density protocol (counterpart of ``mfm_tpu.targets.base``).

Every density is batch-first: ``log_lik`` / ``log_prior`` take ``(..., d)``
and reduce the last axis. Scores come from ``torch.func.grad`` of the
batch sum, which is exact because rows never interact; being a function
transform, it composes with ``torch.func.jvp`` and ``vmap``, which the CNF
divergence uses to differentiate the score gate.

Samplers take an explicit ``torch.Generator`` and draw on its device.

``Target.score_gate`` is what one transport stage adds for the field's
score gate ``gate * clip(score(x))`` and its x-tangents; the generic body
(``generic_score_gate``) differentiates ``score`` with ``vmap(jvp)``, and a
target with a fused kernel for it overrides the method (``PhiFour``).

The tempering level ``beta`` of ``tempered_log_prob`` and
``tempered_value_and_score`` is a number, a 0-d tensor or one level a row,
(B,) for x (B, d) (a seed sweep tempers each seed's rows on its own level);
``beta_column`` lines it up with a (B, d) score.

``GeometricPath`` re-splits a target's tempering path around N(0, I);
``PriorReference`` makes a target's own prior the flow's reference
distribution (``ref_dist='prior'``).
"""

import math

from typing import Callable, Optional

import torch
from torch.func import grad, grad_and_value, jvp, vmap


def _value_and_grad(fn, x):
    def total(v):
        lp = fn(v)
        return lp.sum(), lp

    g, (_, lp) = grad_and_value(total, has_aux=True)(x)
    return lp, g


def beta_column(beta):
    """``beta`` shaped to scale a (B, d) score: a (B,) level a row becomes
    (B, 1); a number or a 0-d tensor stays as it is."""
    return beta[..., None] if isinstance(beta, torch.Tensor) and beta.ndim else beta


def generic_score_gate(
    score_fn: Callable, x, gate, field, ex=None, dfield=None, clip: Optional[float] = None
):
    """(field + gate * clip(s), dfield + gate * m * (ds/dx . e)) for the
    score s = score_fn(x) (B, d) and tangents ex (K, B, d), m the clip's
    inside mask; the tangents by ``vmap(jvp(score_fn))``. dfield is None
    when ex is."""
    score = score_fn(x)
    dscore = None if ex is None else vmap(lambda e: jvp(score_fn, (x,), (e,))[1])(ex)
    if clip is not None:
        inside = (score > -clip) & (score < clip)
        dscore = None if dscore is None else dscore * inside
        score = torch.clamp(score, -clip, clip)
    return field + gate * score, None if ex is None else dfield + gate * dscore


class Target:
    """Base class for unnormalised target densities.

    Subclasses implement the batched ``log_lik`` (and ``log_prior`` when it
    is not flat); ``log_prob`` is always ``log_lik + log_prior``.
    """

    dim: int
    # False where ``score_gate`` is a forward-only kernel: a transport through
    # it cannot be differentiated in u (``flows/pullback.py`` refuses it)
    score_gate_differentiable = True
    # True where ``log_prob`` is a normalised density (a flow reference in a
    # defensive mixture must be); unknown, so False, unless a class says so
    normalised = False

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

    def score_gate(self, x, gate, field, ex=None, dfield=None, clip: Optional[float] = None):
        """One transport stage's score-gate term and its tangents (see
        ``generic_score_gate``); returns (field, dfield). An override may
        update field and dfield in place."""
        return generic_score_gate(self.score, x, gate, field, ex, dfield, clip)

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

    def prior_sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Exact sampler of the (normalised) prior, when the target has one;
        it makes the 'prior' flow reference possible."""
        raise NotImplementedError(f"{type(self).__name__} has no prior sampler")


def as_logprob_fn(target: Target, beta=None) -> Callable:
    """Single-sample ``(d,) -> scalar`` closure, optionally tempered."""
    if beta is None:
        return lambda x: target.log_prob(torch.atleast_1d(x))
    return lambda x: target.tempered_log_prob(torch.atleast_1d(x), beta)


class GeometricPath(Target):
    """A target with its tempering path re-split around q0 = N(0, I):

        log_prior'(x) = log N(x; 0, I)
        log_lik'(x)   = log_prob(x) - log N(x; 0, I)

    so that ``beta * log_lik' + log_prior'`` is the geometric bridge
    N(0, I)^(1 - beta) * p(x)^beta, whose beta = 0 end is the distribution
    the particles start from. ``log_prob`` and every beta = 1 quantity are
    the wrapped target's."""

    def __init__(self, target: Target):
        self.dim = target.dim
        self._target = target

    def _log_q0(self, x):
        return -0.5 * torch.sum(x * x, dim=-1) - 0.5 * self.dim * math.log(2.0 * math.pi)

    def log_lik(self, x):
        return self._target.log_prob(x) - self._log_q0(x)

    def log_prior(self, x):
        return self._log_q0(x)

    def log_prob(self, x):
        return self._target.log_prob(x)

    def score(self, x):
        return self._target.score(x)

    def value_and_score(self, x):
        return self._target.value_and_score(x)

    def score_gate(self, x, gate, field, ex=None, dfield=None, clip=None):
        return self._target.score_gate(x, gate, field, ex, dfield, clip)

    def tempered_value_and_score(self, x, beta):
        """(1 - beta) * q0 + beta * p, reusing p's own value and score."""
        value, grad = self._target.value_and_score(x)
        col = beta_column(beta)
        return beta * value + (1.0 - beta) * self._log_q0(x), col * grad - (1.0 - col) * x

    def sample(self, generator, shape=()):
        return self._target.sample(generator, shape)

    @property
    def can_sample(self) -> bool:
        return self._target.can_sample

    def init_positions(self, generator, n_chain):
        # the path's beta = 0 end, whatever the wrapped target starts from
        return torch.randn((n_chain, self.dim), generator=generator, device=generator.device)


class PriorReference(Target):
    """The flow reference made of a target's own prior: ``log_prob`` is the
    target's normalised ``log_prior``, ``sample`` its ``prior_sample``. With
    an informed prior the flow has only the likelihood update to learn."""

    def __init__(self, target: Target):
        if type(target).prior_sample is Target.prior_sample:
            raise NotImplementedError(
                f"ref_dist='prior': {type(target).__name__} has no prior sampler"
            )
        self.dim = target.dim
        self._target = target

    @property
    def normalised(self) -> bool:
        """Whether the wrapped target's ``log_prior`` carries its normaliser
        (its ``log_prior_normalised``, False if it does not say)."""
        return bool(getattr(self._target, "log_prior_normalised", False))

    @property
    def gaussian_mean(self):
        """Mean of the (Gaussian) prior, for elliptical-slice proposals; a
        target whose Gaussian prior is not centred has ``prior_gaussian_mean``."""
        return getattr(self._target, "prior_gaussian_mean", 0.0)

    def log_lik(self, x):
        return self._target.log_prior(x)

    def sample(self, generator, shape=()):
        return self._target.prior_sample(generator, shape)
