"""The latent-space (pullback) view of a trained CNF as a target
(counterpart of ``mfm_tpu/flows/pullback.py:35-100``).

Flow-annealed SMC (``drivers/flow_smc.py``) tempers in the latent space of
the transport T::

    rho_lambda(u) ∝ q0(u) exp(lambda ell(u)),
    ell(u) = log pi(T(u)) + log|det dT/du|(u) - log q0(u),

so lambda = 0 is the flow's reference q0 and lambda = 1 the pullback of
pi: ``log_prior`` is log q0 and ``log_lik`` is ell.

With a Hutchinson transport the logdet in ell is an estimate. The probes
are fixed per instance, one tensor a batch size (``probes`` maps B to the
(B, d) or (K, B, d) probe, as the reference draws them from one key at the
batch's shape), so that each instance is one deterministic surrogate
density; the driver draws new ones each tempering step.

``tempered_value_and_score`` is one forward transport and one reverse pass
(``torch.func.grad``) through the module field's hand-written tangent
pass and the target's score gate. A transport that cannot be
differentiated is refused by name before any transport runs
(``check_differentiable``): the fused field kernel (``pallas_field``) and a
target whose score gate is a forward-only kernel (``PhiFour``) are forward
only. ``log_lik`` and ``tempered_log_prob`` need no gradient and run on any
transport.
"""

from typing import Dict, Optional

import torch
from torch.func import grad

from mfm_tpu_torch.targets.base import Target


def check_differentiable(target: Target, pallas_field: bool) -> None:
    """Raise, naming the reason, if a transport of this run cannot be
    differentiated in u."""
    if pallas_field:
        raise ValueError(
            "a gradient through the transport: pallas_field=true runs the fused field "
            "kernel, which is forward only; use pallas_field=false or a gradient-free "
            "inner kernel (tess)"
        )
    if not target.score_gate_differentiable:
        raise ValueError(
            f"a gradient through the transport: {type(target).__name__}'s score gate is a "
            "forward-only kernel; use a gradient-free inner kernel (tess)"
        )


class FlowPullbackTarget(Target):
    """rho_1's (log_prior, log_lik) split over latent u, for tempering.

    ``transport`` and ``params`` define T, ``ref_dist`` is q0, ``probes``
    maps a batch size to its Hutchinson probe (None for an exact
    transport)."""

    def __init__(self, target: Target, transport, params, ref_dist: Target,
                 probes: Optional[Dict[int, torch.Tensor]] = None):
        self.dim = target.dim
        self._target = target
        self._transport = transport
        self._params = params
        self._ref = ref_dist
        self._probes = probes

    def push_forward(self, u: torch.Tensor):
        """(x, logdet) of the batched transport with this instance's probe."""
        probe = None if self._probes is None else self._probes[u.shape[0]]
        return self._transport.forward(self._params, u, probe)

    def log_lik(self, u: torch.Tensor) -> torch.Tensor:
        x, logdet = self.push_forward(u)
        return self._target.log_prob(x) + logdet - self._ref.log_prob(u)

    def log_prior(self, u: torch.Tensor) -> torch.Tensor:
        return self._ref.log_prob(u)

    def init_positions(self, generator: torch.Generator, n_chain: int) -> torch.Tensor:
        """lambda = 0 draws: the flow's reference itself."""
        return self._ref.sample(generator, (n_chain,))

    def tempered_log_prob(self, u: torch.Tensor, beta) -> torch.Tensor:
        """(1 - beta) log q0 + beta (log pi(T(u)) + logdet): the reference's
        form of log q0 + beta ell."""
        x, logdet = self.push_forward(u)
        return (1.0 - beta) * self._ref.log_prob(u) + beta * (self._target.log_prob(x) + logdet)

    def tempered_value_and_score(self, u: torch.Tensor, beta):
        """Value and gradient of ``tempered_log_prob`` in one forward
        transport and one reverse pass over the batch (rows never interact)."""

        def total(ub):
            vals = self.tempered_log_prob(ub, beta)
            return vals.sum(), vals.detach()

        grads, vals = grad(total, has_aux=True)(u)
        return vals, grads
