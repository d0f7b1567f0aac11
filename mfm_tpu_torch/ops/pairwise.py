"""K2a/K2b: the pairwise Stein and RBF sums, and their plain versions.

Replaces ``mfm_tpu/ops/pairwise_pallas.py::stein_pairwise_sum`` and
``::rbf_kernel_sum``. Each wrapper runs its plain PyTorch version for CPU
tensors and launches ``csrc/pairwise.cu`` for CUDA tensors (or raises).
The kernels write one fp64 partial per 64x64 tile and reduce the partials
in a second, deterministic launch; the sums come back as fp64 scalars. The
U/V and MMD^2 assembly stays here, as in ``pairwise_pallas.py:168-185``.
"""

import math

import torch

from mfm_tpu_torch.diagnostics.metrics import rbf_term, stein_term
from mfm_tpu_torch.ops import build


def stein_pairwise_sum_plain(X, S, beta: float = -0.5, tile: int = 256):
    """sum over all (i, j), diagonal included, of the IMQ Stein term,
    row tile by row tile (fp32 terms, fp64 sum)."""
    b = -beta
    sq, sxx = torch.sum(X * X, -1), torch.sum(S * X, -1)
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for i in range(0, X.shape[0], tile):
        sl = slice(i, i + tile)
        term = stein_term(X[sl], S[sl], sq[sl], sxx[sl], X, S, sq, sxx, b)
        total = total + term.sum(dtype=torch.float64)
    return total


def rbf_kernel_sum_plain(A, B, sigma2: float = 1.0, tile: int = 256):
    """sum_ij exp(-|a_i - b_j|^2 / (2 sigma2)), row tile by row tile."""
    sqb = torch.sum(B * B, -1)
    total = torch.zeros((), dtype=torch.float64, device=A.device)
    for i in range(0, A.shape[0], tile):
        ai = A[i : i + tile]
        term = rbf_term(ai, torch.sum(ai * ai, -1), B, sqb, sigma2)
        total = total + term.sum(dtype=torch.float64)
    return total


def _check_inputs(name, *tensors):
    dev = tensors[0].device
    for v in tensors:
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous() or v.ndim != 2:
            raise ValueError(f"{name}: inputs must be contiguous float32 (T, d) on {dev}")
        if v.requires_grad:
            raise ValueError(f"{name}: inputs require grad; the kernel is forward only")


def _reduce(lib, partials, what):
    out = torch.empty((), dtype=torch.float64, device=partials.device)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    build.check(
        lib.mfm_reduce_sum(partials.data_ptr(), partials.numel(), out.data_ptr(), stream),
        what,
    )
    return out


def stein_pairwise_sum(X: torch.Tensor, S: torch.Tensor, beta: float = -0.5):
    """Total IMQ-Stein pairwise sum (diagonal included) as an fp64 scalar."""
    if X.device.type == "cpu":
        return stein_pairwise_sum_plain(X, S, beta)
    if X.device.type != "cuda":
        raise ValueError(f"stein_pairwise_sum: unsupported device {X.device}")
    _check_inputs("stein_pairwise_sum", X, S)
    if X.shape != S.shape:
        raise ValueError("stein_pairwise_sum: X and S differ in shape")
    T, d = X.shape
    lib = build.load_library()
    n = math.ceil(T / lib.mfm_pairwise_tile())
    partials = torch.empty(n * n, dtype=torch.float64, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    build.check(
        lib.mfm_stein_partials(
            X.data_ptr(), S.data_ptr(), T, d, float(-beta), partials.data_ptr(), stream
        ),
        "stein_pairwise_sum",
    )
    out = _reduce(lib, partials, "stein_pairwise_sum")
    stein_pairwise_sum.launches += 1
    return out


def rbf_kernel_sum(A: torch.Tensor, B: torch.Tensor, sigma2: float = 1.0):
    """sum_ij exp(-|a_i - b_j|^2 / (2 sigma2)) as an fp64 scalar."""
    if A.device.type == "cpu":
        return rbf_kernel_sum_plain(A, B, sigma2)
    if A.device.type != "cuda":
        raise ValueError(f"rbf_kernel_sum: unsupported device {A.device}")
    _check_inputs("rbf_kernel_sum", A, B)
    if A.shape[1] != B.shape[1]:
        raise ValueError("rbf_kernel_sum: A and B differ in d")
    lib = build.load_library()
    tile = lib.mfm_pairwise_tile()
    n = math.ceil(A.shape[0] / tile) * math.ceil(B.shape[0] / tile)
    partials = torch.empty(n, dtype=torch.float64, device=A.device)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    build.check(
        lib.mfm_rbf_partials(
            A.data_ptr(), A.shape[0], B.data_ptr(), B.shape[0], A.shape[1],
            0.5 / sigma2, partials.data_ptr(), stream,
        ),
        "rbf_kernel_sum",
    )
    out = _reduce(lib, partials, "rbf_kernel_sum")
    rbf_kernel_sum.launches += 1
    return out


stein_pairwise_sum.launches = 0
rbf_kernel_sum.launches = 0


def stein_disc_fused(X, score_fn, beta: float = -0.5):
    """(U, V) statistics from the pairwise sum minus the closed-form
    diagonal 2 b d + |s_i|^2."""
    T, d = X.shape
    S = score_fn(X).contiguous()
    total = stein_pairwise_sum(X.contiguous(), S, beta)
    diag = torch.sum(2.0 * (-beta) * d + torch.sum(S * S, -1), dtype=torch.float64)
    return (total - diag) / (T * (T - 1)), total / (T * T)


def max_mean_disc_fused(X, Y, sigma2: float = 1.0):
    """Unbiased MMD^2 from three RBF sums (diagonals removed from XX/YY)."""
    X, Y = X.contiguous(), Y.contiguous()
    m = X.shape[0]
    xx = rbf_kernel_sum(X, X, sigma2) - m
    yy = rbf_kernel_sum(Y, Y, sigma2) - Y.shape[0]
    xy = rbf_kernel_sum(X, Y, sigma2)
    m2 = m * m
    return xx / (m2 - m) - 2.0 * xy / m2 + yy / (m2 - m)
