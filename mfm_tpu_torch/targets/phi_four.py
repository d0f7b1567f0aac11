"""1-D lattice phi^4 target and its Gaussian base approximation
(counterpart of ``mfm_tpu.targets.phi_four``).

log p(x) = -beta * (U(x) + V(x)): V is the on-site double well
sum (1 - x^2)^2 / (4 a d), plus an optional mean tilt; U is the a*d-weighted
squared first difference with a dirichlet or periodic boundary.

The stencil runs on kernel K3 (``ops.phi_four``), which returns the value
and the analytic score in one pass; the tilt, a function of the row mean,
is added around it in torch. The derivatives are analytic too: ``score``
and ``log_lik`` are ``autograd.Function``s whose ``jvp`` and ``backward``
are the Hessian-vector product H e (stencil plus the tilt's rank-one term),
and ``log_lik``'s derivative calls ``score`` again, never a saved tensor: a
second derivative through ``log_lik`` (forward over reverse) sees the
Hessian. ``value_and_score`` (MALA, the flow-MH accept) needs no derivative
and calls K3's launcher without the custom op's dispatch.

``score_gate`` does a transport stage's score gate with all its tangents
in one launch of the fused kernel (``ops.phi_four.phi_four_score_gate``),
which is forward only: a transport through it cannot be differentiated in
u (``score_gate_differentiable`` is False; the gate raises if asked).
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.autograd import Function

from mfm_tpu_torch.ops.phi_four import (
    phi_four,
    phi_four_hvp,
    phi_four_score_gate,
    phi_four_value_and_score,
)
from mfm_tpu_torch.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)


class _StencilFunction(Function):
    """Saves x (and the target) for both derivative modes."""

    generate_vmap_rule = True

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.target = inputs[1]
        ctx.save_for_backward(inputs[0])
        ctx.save_for_forward(inputs[0])


class _Score(_StencilFunction):
    """score(x) with H e as its derivative in both modes."""

    @staticmethod
    def forward(x, target):
        return target._value_and_score(x, with_score=True)[1]

    @staticmethod
    def jvp(ctx, ex, _):
        return ctx.target.hvp(ctx.saved_tensors[0], ex)

    @staticmethod
    def backward(ctx, g):
        return ctx.target.hvp(ctx.saved_tensors[0], g), None


class _LogLik(_StencilFunction):
    """log_lik(x) (value-only launch); its derivative is ``_Score``."""

    @staticmethod
    def forward(x, target):
        return target._value_and_score(x, with_score=False)[0]

    @staticmethod
    def jvp(ctx, ex, _):
        x = ctx.saved_tensors[0]
        return torch.sum(_Score.apply(x, ctx.target) * ex, -1)

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        return g[..., None] * _Score.apply(x, ctx.target), None


class PhiFour(Target):
    score_gate_differentiable = False  # the fused gate is forward only

    def __init__(
        self,
        dim: int,
        a: float = 0.1,
        beta: float = 20.0,
        bc: Tuple[str, float] = ("dirichlet", 0.0),
        tilt: Optional[dict] = None,
        device=None,  # taken as every target takes it; PhiFour holds no tensor
    ):
        if bc[0] not in ("dirichlet", "pbc"):
            raise ValueError("bc must be dirichlet or pbc")
        self.dim = dim
        self.a = a
        self.beta = beta
        self.bc = bc
        self.tilt = tilt

    def _value_and_score(self, x, with_score: bool, op=phi_four):
        """K3 plus the tilt -beta lam (val - mean x)^2 / (4d), whose
        gradient is beta lam (val - mean x) / (2 d^2) at every site. ``op``
        is the custom op (any leading shape, seen by ``torch.func``) or the
        bare launcher (rows (B, d))."""
        value, score = op(
            x, self.a, self.beta, self.bc[0] == "pbc", float(self.bc[1]), with_score
        )
        if self.tilt is None:
            return value, score
        lam, off = self.tilt["lambda"], self.tilt["val"] - torch.mean(x, dim=-1)
        value = value - self.beta * lam * off * off / (4.0 * self.dim)
        if with_score:
            score = score + (self.beta * lam / (2.0 * self.dim**2)) * off[..., None]
        return value, score

    def hvp(self, x, e):
        """The log-likelihood's Hessian at x times e."""
        he = phi_four_hvp(x, e, self.a, self.beta, self.bc[0] == "pbc")
        if self.tilt is not None:
            rank_one = self.beta * self.tilt["lambda"] / (2.0 * self.dim**3)
            he = he - rank_one * torch.sum(e, dim=-1, keepdim=True)
        return he

    def log_lik(self, x):
        return _LogLik.apply(x, self)

    def score(self, x):
        return _Score.apply(x, self)

    def value_and_score(self, x):
        """One K3 launch for both, x (B, d), straight from the launcher (not
        differentiable: MALA and the flow-MH accept only read them)."""
        return self._value_and_score(x, with_score=True, op=phi_four_value_and_score)

    def score_gate(self, x, gate, field, ex=None, dfield=None, clip=None):
        """One transport stage's score gate and its tangents on the fused
        kernel, one launch, in place on field and dfield."""
        lam, val = (self.tilt["lambda"], self.tilt["val"]) if self.tilt else (0.0, 0.0)
        return phi_four_score_gate(
            x, gate, field, ex, dfield, self.a, self.beta, self.bc[0] == "pbc",
            float(self.bc[1]), lam, val, clip,
        )

    def tempered_value_and_score(self, x, beta):
        value, score = self.value_and_score(x)
        return beta * value, beta * score

    def init_positions(self, generator, n_chain):
        """Uniform(-1, 1) initial fields."""
        u = torch.rand((n_chain, self.dim), generator=generator, device=generator.device)
        return u * 2.0 - 1.0


def _coupled_precision(dim: int, alpha: float, beta: float) -> np.ndarray:
    """Tridiagonal precision beta * [(3c + 1/c) I - c (offdiag)], c = alpha
    * dim (float64)."""
    c = alpha * dim
    off = -c * np.ones(dim - 1)
    prec = np.diag((3.0 * c + 1.0 / c) * np.ones(dim)) + np.diag(off, 1) + np.diag(off, -1)
    return beta * prec


def _coupled_pbc_precision(dim: int, dim_phys: int, beta: float) -> np.ndarray:
    """The periodic variant on a 1-D ring or a 2-D torus of
    ``dim // dim_phys`` sites a side (float64)."""
    dim_grid = dim // dim_phys
    quad = 4.0 + 0.1
    off = -np.ones(dim_grid - 1)
    sub = (1.0 + quad) * np.eye(dim_grid) + np.diag(off, 1) + np.diag(off, -1)
    sub[0, -1] = sub[-1, 0] = -1.0
    if dim_phys == 1:
        return beta * sub
    n = dim_grid * dim_grid
    prec = np.kron(np.eye(dim_grid), sub)
    eye_g = np.eye(dim_grid)
    for b in range(dim_grid - 1):
        s0, s1 = b * dim_grid, (b + 1) * dim_grid
        prec[s0 : s0 + dim_grid, s1 : s1 + dim_grid] -= eye_g
        prec[s1 : s1 + dim_grid, s0 : s0 + dim_grid] -= eye_g
    prec[:dim_grid, n - dim_grid :] = -eye_g
    prec[n - dim_grid :, :dim_grid] = -eye_g
    return beta * prec


class PhiFourBase(Target):
    """Gaussian approximation of the phi^4 prior, the 'phifour' flow
    reference distribution. The precision, its log-determinant and the
    covariance's Cholesky factor are built once in float64 on the host;
    the density and the sampler are fp32 products on ``device`` (TF32 off,
    see ``drivers.mfm.set_field_precision``)."""

    def __init__(
        self,
        dim: int,
        alpha: float = 0.1,
        beta: float = 20.0,
        prior_type: str = "coupled",
        dim_phys: int = 1,
        device=None,
    ):
        self.dim = dim
        if prior_type == "coupled":
            prec = _coupled_precision(dim, alpha, beta)
        elif prior_type == "coupled_pbc":
            prec = _coupled_pbc_precision(dim, dim_phys, beta)
        else:
            raise ValueError(f"unknown prior_type {prior_type!r}")
        sign, logabsdet = np.linalg.slogdet(prec)
        self._neg_logdet_prec = float(-sign * logabsdet)
        chol = np.linalg.cholesky(prec)
        # x = L^-T eps has covariance (L L^T)^-1
        chol_cov = np.linalg.solve(chol, np.eye(dim)).T
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.prec = as_t(prec)
        self.chol_cov = as_t(chol_cov)

    def log_lik(self, x):
        quad = torch.sum((x @ self.prec) * x, dim=-1)
        return -0.5 * (quad + self.dim * _LOG2PI + self._neg_logdet_prec)

    def sample(self, generator, shape=()):
        eps = torch.randn(
            tuple(shape) + (self.dim,), generator=generator, device=generator.device
        )
        return eps @ self.chol_cov.T
