"""One end-of-run evaluation in plain PyTorch: latents through the flow
with the log-determinant, self-normalised importance resampling, and the
metric row (mean log-density, the IMQ Stein discrepancy's U and V
statistics, the RBF MMD^2 against exact draws) of the flow's draws and of
the resampled set. Pairwise sums are taken in float64, in blocks of rows.
"""

import math

import torch

from cardbench.reference.field import transport

ROWS = 1024  # rows of a block of pairs


def std_normal_log_prob(u):
    d = u.shape[-1]
    return -0.5 * (torch.sum(u * u, -1) + d * math.log(2.0 * math.pi))


def resample(x, log_w, draws):
    """x[i] with i from softmax(log_w) by the inverse CDF at the float64
    uniforms ``draws``; NaN log-weights count as -inf."""
    log_w = torch.where(torch.isnan(log_w), -torch.inf, log_w)
    cdf = torch.cumsum(torch.softmax(log_w.double(), 0), 0)
    idx = torch.searchsorted(cdf, draws * cdf[-1], right=True).clamp(max=x.shape[0] - 1)
    return x[idx], log_w


def stein_uv(x, score, b: float = 0.5):
    """(U, V) of the IMQ kernel (1 + |x - y|^2)^-b Stein discrepancy."""
    X, S = x.double(), score.double()
    T, d = X.shape
    sq, sxx = torch.sum(X * X, -1), torch.sum(S * X, -1)
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for i in range(0, T, ROWS):
        xi, si = X[i:i + ROWS], S[i:i + ROWS]
        r = torch.clamp(sq[i:i + ROWS, None] + sq[None] - 2.0 * xi @ X.T, min=0.0)
        base = 1.0 + r
        cross = sxx[i:i + ROWS, None] - si @ X.T - xi @ S.T + sxx[None]
        term = (-4.0 * b * (b + 1.0) * r / base ** (b + 2.0)
                + 2.0 * b * (d + cross) / base ** (b + 1.0) + (si @ S.T) / base**b)
        total = total + term.sum()
    diag = torch.sum(2.0 * b * d + torch.sum(S * S, -1))
    return float((total - diag) / (T * (T - 1))), float(total / (T * T))


def _rbf_sum(A, B):
    total = torch.zeros((), dtype=torch.float64, device=A.device)
    sqb = torch.sum(B * B, -1)
    for i in range(0, A.shape[0], ROWS):
        a = A[i:i + ROWS]
        r = torch.clamp(torch.sum(a * a, -1)[:, None] + sqb[None] - 2.0 * a @ B.T, min=0.0)
        total = total + torch.exp(-0.5 * r).sum()
    return total


def mmd2(X, Y):
    """(unbiased MMD^2 with the RBF kernel exp(-|x - y|^2 / 2), the scale its
    rounding is relative to: the largest of the three sums it is assembled
    from, the diagonals' ones included, each over its count)."""
    X, Y = X.double(), Y.double()
    m, n = X.shape[0], Y.shape[0]
    xx, yy, xy = _rbf_sum(X, X), _rbf_sum(Y, Y), _rbf_sum(X, Y)
    terms = (xx / (m * m - m), 2.0 * xy / (m * m), yy / (m * m - m))
    value = (xx - m) / (m * m - m) - terms[1] + (yy - n) / (m * m - m)
    return float(value), float(max(abs(t) for t in terms))


def metric_row(target, flow, exact, real):
    """(row, scales): the metric row, and for each entry the scale its
    rounding is relative to (itself; for a U statistic the V statistic
    too; for an MMD^2 its largest term)."""
    row = {"logpdf": float(torch.mean(target.log_prob(flow)))}
    row["stein_u"], row["stein_v"] = stein_uv(flow, target.score(flow))
    row["logpdf_star"] = float(torch.mean(target.log_prob(exact)))
    row["stein_u_star"], row["stein_v_star"] = stein_uv(exact, target.score(exact))
    (row["mmd"], mmd_scale), (row["mmd_star"], star_scale) = mmd2(real, flow), mmd2(real, exact)
    scales = {k: abs(v) for k, v in row.items()}
    scales["stein_u"] = max(scales["stein_u"], scales["stein_v"])
    scales["stein_u_star"] = max(scales["stein_u_star"], scales["stein_v_star"])
    scales["mmd"], scales["mmd_star"] = mmd_scale, star_scale
    return row, scales


def evaluate(target, params, freqs, u, draws, real, prec, n_steps, fault=None):
    """(flow draws, log-weights, (metric row, scales)) of one evaluation of the net
    ``params`` (one seed: leading axis 1) at latents ``u`` (n, d).
    ``fault`` plants one for the readings: 'half' takes the row over half
    of the draws, 'answer' moves one flow draw."""
    x, logdet = transport(params, freqs, target, u[None], prec, False, n_steps)
    x, logdet = x[0], logdet[0]
    if fault == "answer":
        x = x.clone()
        x[0] += 1.0
    log_w = target.log_prob(x) - (std_normal_log_prob(u) - logdet)
    exact, log_w = resample(x, log_w, draws)
    if fault == "half":
        keep = x.shape[0] // 2
        return x, log_w, metric_row(target, x[:keep], exact[:keep], real)
    return x, log_w, metric_row(target, x, exact, real)
