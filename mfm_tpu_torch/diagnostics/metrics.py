"""Kernelised Stein discrepancy and MMD (counterpart of
``mfm_tpu.diagnostics.metrics``), tiled plain PyTorch.

Every pairwise quantity comes from Gram products over a row tile,
``|x - y|^2 = |x|^2 + |y|^2 - 2 x.y`` and
``(sx - sy).(x - y) = sx.x - sx.y - sy.x + sy.y``, so memory stays at
tile x T. ``stein_term`` / ``rbf_term`` are shared with the plain versions
of the pairwise kernels (``mfm_tpu_torch.ops.pairwise``).
"""

import torch


def stein_term(xi, si, sqi, sxxi, X, S, sq, sxx, b: float):
    """(t, T) IMQ Stein kernel values k0(x_i, x_j), b = -beta."""
    d = X.shape[-1]
    r = torch.clamp(sqi[:, None] + sq[None, :] - 2.0 * (xi @ X.T), min=0.0)
    base = 1.0 + r
    cross = sxxi[:, None] - si @ X.T - xi @ S.T + sxx[None, :]
    return (
        -4.0 * b * (b + 1.0) * r / base ** (b + 2.0)
        + 2.0 * b * (d + cross) / base ** (b + 1.0)
        + (si @ S.T) / base**b
    )


def rbf_term(ai, sqa, B, sqb, sigma2: float):
    r = torch.clamp(sqa[:, None] + sqb[None, :] - 2.0 * (ai @ B.T), min=0.0)
    return torch.exp(-0.5 * r / sigma2)


def stein_disc(X, score_fn, beta: float = -0.5, tile: int = 128, weights=None):
    """(U, V) kernelised Stein discrepancy with the IMQ kernel
    (1 + |x - y|^2)^beta. ``weights`` (T,), normalised here, gives the
    importance-weighted statistics sum w_i w_j k0(x_i, x_j)."""
    T, d = X.shape
    b = -beta
    S = score_fn(X)
    sq, sxx = torch.sum(X * X, -1), torch.sum(S * X, -1)
    if weights is None:
        w = torch.full((T,), 1.0 / T, dtype=X.dtype, device=X.device)
    else:
        w = weights / torch.sum(weights)
    total = torch.zeros((), dtype=X.dtype, device=X.device)
    for i in range(0, T, tile):
        sl = slice(i, i + tile)
        term = stein_term(X[sl], S[sl], sq[sl], sxx[sl], X, S, sq, sxx, b)
        total = total + torch.sum(w[sl, None] * w[None, :] * term)
    diag_terms = 2.0 * b * d + torch.sum(S * S, -1)
    w2 = torch.sum(w * w)
    u_stat = (total - torch.sum(w * w * diag_terms)) / (1.0 - w2)
    return u_stat, total


def max_mean_disc(X, Y, sigma2: float = 1.0, tile: int = 256):
    """Unbiased MMD^2 with the RBF kernel exp(-|x - y|^2 / (2 sigma2))."""
    m = X.shape[0]

    def ksum(A, B):
        sqa, sqb = torch.sum(A * A, -1), torch.sum(B * B, -1)
        total = torch.zeros((), dtype=A.dtype, device=A.device)
        for i in range(0, A.shape[0], tile):
            sl = slice(i, i + tile)
            total = total + torch.sum(rbf_term(A[sl], sqa[sl], B, sqb, sigma2))
        return total

    xx = ksum(X, X) - m
    yy = ksum(Y, Y) - Y.shape[0]
    xy = ksum(X, Y)
    m2 = m * m
    return xx / (m2 - m) - 2.0 * xy / m2 + yy / (m2 - m)
