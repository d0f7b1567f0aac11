"""Kernelised Stein discrepancy and MMD (counterpart of
``mfm_tpu.diagnostics.metrics``), tiled plain PyTorch; and the chain
diagnostics (autocorrelation, ESS, split R-hat), host numpy on arrays or
tensors moved to the host, as the reference's are.

Every pairwise quantity comes from Gram products over a row tile,
``|x - y|^2 = |x|^2 + |y|^2 - 2 x.y`` and
``(sx - sy).(x - y) = sx.x - sx.y - sy.x + sy.y``, so memory stays at
tile x T. ``stein_term`` / ``rbf_term`` are shared with the plain versions
of the pairwise kernels (``mfm_tpu_torch.ops.pairwise``).
"""

import numpy as np
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


def _host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def autocorrelation(x, axis: int = 0) -> np.ndarray:
    """FFT-based autocorrelation along ``axis``, normalised to 1 at lag 0."""
    x = _host(x)
    N = x.shape[axis]
    M2 = 2 * _next_fast_len(N)
    x = np.swapaxes(x, axis, -1)
    centered = x - x.mean(axis=-1, keepdims=True)
    freq = np.fft.rfft(centered, n=M2, axis=-1)
    ac = np.fft.irfft(freq * np.conjugate(freq), n=M2, axis=-1)[..., :N]
    with np.errstate(invalid="ignore", divide="ignore"):
        ac = ac / ac[..., :1]
    return np.swapaxes(ac, axis, -1)


def potential_scale_reduction(chains) -> np.ndarray:
    """Split R-hat over a (n_steps, n_chains, d) sample block (a 2-D block
    is one dimension): each chain cut in two halves."""
    x = _host(chains)
    if x.ndim == 2:
        x = x[:, :, None]
    T = x.shape[0] - (x.shape[0] % 2)
    half = T // 2
    x = np.concatenate([x[:half], x[half:T]], axis=1)  # (half, 2m, d)
    n = x.shape[0]
    chain_means = x.mean(axis=0)  # (m, d)
    chain_vars = x.var(axis=0, ddof=1)  # (m, d)
    between = n * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_plus = (n - 1) / n * within + between / n
    return np.sqrt(var_plus / within)


def effective_sample_size(x) -> np.ndarray:
    """Per-dimension ESS of a (T, d) chain by Geyer's initial positive
    sequence on the FFT autocorrelations."""
    x = _host(x)
    if x.ndim == 1:
        x = x[:, None]
    T = x.shape[0]
    ac = autocorrelation(x, axis=0)  # (T, d)
    ess = np.empty(x.shape[1])
    for j in range(x.shape[1]):
        # pair consecutive lags; stop at the first negative pair sum
        pair = ac[: (T // 2) * 2, j].reshape(-1, 2).sum(axis=1)
        neg = np.nonzero(pair < 0)[0]
        stop = neg[0] if neg.size else pair.size
        tau = -1.0 + 2.0 * pair[:stop].sum()
        ess[j] = T / max(tau, 1.0 / T)
    return ess
