"""K3: the phi^4 lattice log-likelihood and its score, the score gate of a
transport stage with its tangents, and their plain versions.

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
derivatives (an ``autograd.Function`` around it); calls that need none
(MALA, the flow-MH accept) take ``phi_four_value_and_score`` directly.

``phi_four_score_gate`` is what a transport stage adds for the score gate
``gate * clip(score(x))`` of the field: the term itself, and its
derivative ``gate * m * (H e)`` along every tangent (``m`` the clip's
inside mask), in one launch, in place (see ``csrc/phi_four.cu``). It is
forward only: the kernel writes through raw pointers, which no autograd
tape sees, so it and its plain version refuse inputs that require grad
(``torch.autograd`` or a ``torch.func`` transform such as ``grad``), as K1
does (``ops/field.py``).

``phi_four_cost`` and ``score_gate_cost`` count a launch's work, which the
wrappers report to an open roofline count (``diagnostics.roofline``).
"""

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mfm_tpu_torch.diagnostics import roofline
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


def _refuse_grad(name: str, *tensors) -> None:
    """The score gate is forward only: raise if any input carries a
    gradient, whether taped by autograd or traced by ``torch.func.grad``
    (both show as ``requires_grad``)."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name}: an input requires grad; the score gate is forward only "
            "(a gradient through a transport needs a target without the fused gate)"
        )


def _refuse_vmap(name: str, *tensors) -> None:
    """The score gate writes through its tensors' memory: raise on a tensor
    batched by ``torch.func.vmap`` (a seed sweep calls it once on all its
    rows, outside the seed vmap)."""
    if any(t is not None and torch._C._functorch.is_batchedtensor(t) for t in tensors):
        raise ValueError(
            f"{name}: called under torch.func.vmap; the fused score gate takes plain "
            "(B, d) rows: call it once on every row, outside the vmap"
        )


def phi_four_score_gate_plain(
    x, gate, field, ex=None, dfield=None, a: float = 0.1, beta: float = 20.0,
    pbc: bool = False, bc_value: float = 0.0, tilt_lambda: float = 0.0,
    tilt_val: float = 0.0, clip: Optional[float] = None,
):
    """Plain PyTorch version of the score-gate kernel, in place:
    ``field += gate * clip(s)`` and ``dfield += gate * m * (H ex)``, with the
    tangents (K, B, d) broadcast against x (B, d). Returns (field, dfield).
    Refuses inputs that require grad, as the kernel does."""
    _refuse_grad("phi_four_score_gate_plain", x, gate, field, ex, dfield)
    d = x.shape[-1]
    _, score = phi_four_value_and_score_plain(x, a, beta, pbc, bc_value)
    if tilt_lambda != 0.0:
        off = tilt_val - torch.mean(x, dim=-1, keepdim=True)
        score = score + (beta * tilt_lambda / (2.0 * d**2)) * off
    gate_m = gate
    if clip is not None:
        gate_m = gate * ((score > -clip) & (score < clip))
        score = torch.clamp(score, -clip, clip)
    field.add_(gate * score)
    if ex is not None:
        he = phi_four_hvp(x, ex, a, beta, pbc)
        if tilt_lambda != 0.0:
            he = he - (beta * tilt_lambda / (2.0 * d**3)) * torch.sum(ex, -1, keepdim=True)
        dfield.add_(gate_m * he)
    return field, dfield


def phi_four_cost(B: int, d: int, with_score: bool = True):
    """(flops, bytes) of one K3 call: ~16 operations a site for the value
    and the score; x read once, the value (and the score) written once."""
    return 16 * B * d, 4 * ((2 if with_score else 1) * B * d + B)


def score_gate_cost(B: int, d: int, K: int):
    """(flops, bytes) of one score-gate call with K tangents: ~10
    operations a site and tangent; x, gate and field read and field
    written, ex and dfield read and dfield written."""
    return 10 * K * B * d, 4 * (4 * B * d + 3 * K * B * d)


@functools.cache
def _launcher(name: str):
    """The kernel library's C function ``name``, looked up once."""
    return getattr(build.load_library(), name)


def _stream(x: torch.Tensor) -> int:
    # the raw cudaStream_t of the current stream, without building a
    # torch.cuda.Stream object on every call
    return torch._C._cuda_getCurrentRawStream(x.get_device())


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
    err = _launcher("mfm_phi_four")(
        x.data_ptr(), B, d, coef, 1.0 / (4.0 * coef), beta, int(pbc), bc_value,
        value.data_ptr(), score.data_ptr() if with_score else None, _stream(x),
    )
    if err:
        build.check(err, "phi_four_value_and_score")
    phi_four_value_and_score.launches += 1
    if roofline.counter is not None:
        roofline.counter.add_kernel("phi_four_value_and_score", *phi_four_cost(B, d, with_score))
    return value, score


phi_four_value_and_score.launches = 0


def phi_four_score_gate(
    x: torch.Tensor, gate: torch.Tensor, field: torch.Tensor,
    ex: Optional[torch.Tensor] = None, dfield: Optional[torch.Tensor] = None,
    a: float = 0.1, beta: float = 20.0, pbc: bool = False, bc_value: float = 0.0,
    tilt_lambda: float = 0.0, tilt_val: float = 0.0, clip: Optional[float] = None,
):
    """One transport stage's score gate, in place: ``field += gate *
    clip(s(x))`` and, with tangents ex (K, B, d), ``dfield += gate * m *
    (H ex)``; ``clip`` None clamps nothing and masks nothing. x, gate, field
    (B, d) and ex, dfield (K, B, d) contiguous float32. Returns (field,
    dfield). The plain version for CPU tensors, ``csrc/phi_four.cu`` for
    CUDA tensors (or raises). Forward only: raises if an input requires
    grad."""
    _refuse_grad("phi_four_score_gate", x, gate, field, ex, dfield)
    _refuse_vmap("phi_four_score_gate", x, gate, field, ex, dfield)
    if x.device.type == "cpu":
        return phi_four_score_gate_plain(
            x, gate, field, ex, dfield, a, beta, pbc, bc_value, tilt_lambda, tilt_val, clip
        )
    if x.device.type != "cuda":
        raise ValueError(f"phi_four_score_gate: unsupported device {x.device}")
    if x.ndim != 2 or x.numel() == 0:
        raise ValueError("phi_four_score_gate: x must be a non-empty (B, d)")
    B, d = x.shape
    K = 0 if ex is None else ex.shape[0]
    rows = (x, gate, field) + ((ex, dfield) if K else ())
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device
           for t in rows):
        raise ValueError("phi_four_score_gate: every tensor must be contiguous float32 "
                         "on x's device")
    if gate.shape != x.shape or field.shape != x.shape or (
        K and (ex.shape != (K, B, d) or dfield.shape != (K, B, d))
    ):
        raise ValueError("phi_four_score_gate: gate, field (B, d) and ex, dfield (K, B, d)")
    err = _launcher("mfm_phi_four_score_gate")(
        x.data_ptr(), gate.data_ptr(), field.data_ptr(), ex.data_ptr() if K else None,
        dfield.data_ptr() if K else None, B, d, K, a * d, beta, int(pbc), bc_value,
        tilt_lambda, tilt_val, int(clip is not None), 0.0 if clip is None else clip,
        _stream(x),
    )
    if err:
        build.check(err, "phi_four_score_gate")
    phi_four_score_gate.launches += 1
    if roofline.counter is not None:
        roofline.counter.add_kernel("phi_four_score_gate", *score_gate_cost(B, d, K))
    return field, dfield


phi_four_score_gate.launches = 0


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
