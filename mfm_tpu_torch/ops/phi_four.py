"""K3: the phi^4 lattice log-likelihood and its score, and their plain
version.

Replaces ``mfm_tpu/ops/phi_four_pallas.py::phi_four_log_lik``. For x (B, d)
``phi_four_value_and_score`` returns ``(log_lik (B,), score (B, d))`` of
``-beta (U + V)`` with a Dirichlet boundary at ``bc_value`` or a periodic
one, the score only ``with_score`` (else None). It runs the plain version
for CPU tensors and launches ``csrc/phi_four.cu`` for CUDA tensors (or
raises). ``phi_four_hvp`` is the score's derivative, a few torch ops.

``phi_four`` is the same computation as a ``torch.library`` custom op for
any leading shape: ``torch.func`` transforms see it as one opaque op whose
``vmap`` rule flattens the batch dimensions into rows, so the CUDA launch
always receives a plain tensor. ``targets.phi_four`` gives it its
derivatives (an ``autograd.Function`` around it).
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mfm_tpu_torch.ops import build


def _neighbours(x, pbc: bool, bc_value: float):
    """(left, right) neighbours of every site: wrapped, or ``bc_value``
    beyond the ends."""
    if pbc:
        return torch.roll(x, 1, -1), torch.roll(x, -1, -1)
    return F.pad(x[..., :-1], (1, 0), value=bc_value), F.pad(x[..., 1:], (0, 1), value=bc_value)


def phi_four_value_and_score_plain(
    x, a: float = 0.1, beta: float = 20.0, pbc: bool = False, bc_value: float = 0.0,
    with_score: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: the stencil of
    ``targets/phi_four.py`` (no tilt) and its analytic gradient."""
    coef = a * x.shape[-1]
    left, right = _neighbours(x, pbc, bc_value)
    w = 1.0 - x * x
    v = torch.sum(w * w, -1) / (4.0 * coef)
    dr = right - x
    grad_sq = torch.sum(dr * dr, -1)
    if not pbc:
        grad_sq = grad_sq + (x[..., 0] - bc_value) ** 2
    value = -beta * (0.5 * coef * grad_sq + v)
    if not with_score:
        return value, None
    return value, -beta * (-x * w / coef + coef * (2.0 * x - left - right))


def phi_four_hvp(x, e, a: float = 0.1, beta: float = 20.0, pbc: bool = False):
    """H e, the score's derivative at x along e (the log-likelihood's
    Hessian, which is symmetric): -beta [(3x^2 - 1)/c e + c (2e - e_l - e_r)]
    with the tangent 0 beyond a Dirichlet end."""
    coef = a * x.shape[-1]
    left, right = _neighbours(e, pbc, 0.0)
    return -beta * ((3.0 * x * x - 1.0) / coef * e + coef * (2.0 * e - left - right))


def phi_four_value_and_score(
    x: torch.Tensor, a: float = 0.1, beta: float = 20.0, pbc: bool = False,
    bc_value: float = 0.0, with_score: bool = True,
):
    """(log_lik (B,), score (B, d) or None) for x (B, d)."""
    if x.device.type == "cpu":
        return phi_four_value_and_score_plain(x, a, beta, pbc, bc_value, with_score)
    if x.device.type != "cuda":
        raise ValueError(f"phi_four_value_and_score: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.ndim != 2 or x.numel() == 0:
        raise ValueError("phi_four_value_and_score: x must be a contiguous float32 (B, d)")
    B, d = x.shape
    coef = a * d
    value = torch.empty(B, device=x.device)
    score = torch.empty_like(x) if with_score else None
    lib = build.load_library()
    build.check(
        lib.mfm_phi_four(
            x.data_ptr(), B, d, coef, 1.0 / (4.0 * coef), beta, int(pbc), bc_value,
            value.data_ptr(), score.data_ptr() if with_score else None,
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "phi_four_value_and_score",
    )
    phi_four_value_and_score.launches += 1
    return value, score


phi_four_value_and_score.launches = 0


@torch.library.custom_op("mfm_tpu_torch::phi_four", mutates_args=())
def phi_four(
    x: torch.Tensor, a: float, beta: float, pbc: bool, bc_value: float, with_score: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(log_lik, score) for x (..., d); the score is an empty tensor
    unless ``with_score``."""
    d = x.shape[-1]
    value, score = phi_four_value_and_score(
        x.reshape(-1, d).contiguous(), a, beta, pbc, bc_value, with_score
    )
    value = value.reshape(x.shape[:-1])
    return value, score.reshape(x.shape) if with_score else x.new_empty(0)


@phi_four.register_fake
def _(x, a, beta, pbc, bc_value, with_score):
    return x.new_empty(x.shape[:-1]), x.new_empty(x.shape if with_score else (0,))


@phi_four.register_vmap
def _(info, in_dims, x, a, beta, pbc, bc_value, with_score):
    # rows never interact: the vmapped dimension is one more leading one
    value, score = phi_four(x.movedim(in_dims[0], 0), a, beta, pbc, bc_value, with_score)
    return (value, score), (0, 0 if with_score else None)
