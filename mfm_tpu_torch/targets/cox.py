"""Log-Gaussian Cox process on the Finnish pines data, d = grid^2
(counterpart of ``mfm_tpu.targets.cox``). Discretisation after Heng et al.
2017 (controlled SMC), constants from Moller et al. 1998.

The construction (bin counts, the exponential-kernel Gram matrix, its
Cholesky factor, half log-determinant, inverse and the precision) runs once
in float64 numpy on the host and is cast to fp32 tensors on the device at
the end: at d = 1600 the Cholesky factor is the accuracy-critical step.

Per call, a (B, d) batch costs one (d, d) product (the precision in the
latent parameterisation, the Cholesky factor in the whitened one) and
elementwise work. Those products are exact fp32: ``_matmul`` turns TF32 off
around itself, whatever the process-wide setting. The score is analytic and
written in operations that ``torch.func.jvp`` and ``vmap`` take, because
the transport's score gate differentiates it every stage.

``exp(f)`` overflows in fp32 for a chain far out, and is left to: the
resulting inf/nan makes the MH accept reject.
"""

import os
from typing import Optional

import numpy as np
import torch

from mfm_tpu_torch.targets.base import Target, beta_column

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "finpines.csv")


def bin_counts(points: np.ndarray, num_bins: int) -> np.ndarray:
    """Count points of a [0,1]^2 cloud on a num_bins^2 grid (row-major);
    points on the upper edge fall into the last bin."""
    idx = np.floor(points * num_bins).astype(np.int64)
    idx = np.clip(idx, 0, num_bins - 1)
    counts = np.zeros((num_bins, num_bins))
    np.add.at(counts, (idx[:, 0], idx[:, 1]), 1.0)
    return counts


def bin_centers(num_bins: int) -> np.ndarray:
    """Grid coordinates (k // n, k % n) in row-major order, matching the
    flattened bin-count layout."""
    ii, jj = np.meshgrid(np.arange(num_bins), np.arange(num_bins), indexing="ij")
    return np.stack([ii.ravel(), jj.ravel()], axis=1).astype(np.float64)


def exponential_gram(
    coords: np.ndarray, signal_variance: float, num_grid: int, length_scale: float
) -> np.ndarray:
    """Gram matrix of K(m, n) = s^2 exp(-|m - n| / (num_grid * length_scale)),
    as one float64 pairwise pass."""
    diff = coords[:, None, :] - coords[None, :, :]
    dist = np.sqrt(np.sum(diff * diff, axis=-1))
    return signal_variance * np.exp(-dist / (num_grid * length_scale))


def poisson_log_likelihood(latents, bin_area, counts):
    """sum(f * counts - a * exp(f)) over the grid, batched over leading axes."""
    return torch.sum(latents * counts - bin_area * torch.exp(latents), dim=-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in exact fp32 (no TF32), whatever the process-wide setting."""
    if not a.is_cuda:
        return a @ b
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


class LogGaussianCoxPines(Target):
    """LGCP posterior over latent log-intensities on a sqrt(d) x sqrt(d) grid.

    ``whitened=False`` parameterises by the latent field f, whose prior
    whitens f through the Gram Cholesky factor. ``whitened=True``
    parameterises by white noise e with an N(0, I) prior and pushes e
    through the Cholesky factor inside the likelihood.

    Either way ``log_prior`` is the Gaussian prior with its log-normaliser
    (``_white_log_norm``, ``_latent_log_norm``), so the 'prior' flow
    reference made of it is a normalised density.
    """

    log_prior_normalised = True

    def __init__(
        self,
        dim: int = 1600,
        file_path: Optional[str] = None,
        whitened: bool = False,
        device=None,
    ):
        num_grid = int(np.sqrt(dim))
        if num_grid * num_grid != dim:
            raise ValueError(f"dim must be a perfect square, got {dim}")
        self.dim = dim
        self.whitened = whitened
        self._num_grid = num_grid

        points = np.genfromtxt(file_path or _DATA_PATH, delimiter=",")
        counts64 = bin_counts(points, num_grid).reshape(dim)

        # Moller et al. 1998 constants
        signal_variance = 1.91
        beta = 1.0 / 33.0
        self._bin_area = 1.0 / dim
        mu_zero = np.log(126.0) - 0.5 * signal_variance

        gram64 = exponential_gram(bin_centers(num_grid), signal_variance, num_grid, beta)
        chol64 = np.linalg.cholesky(gram64)
        half_logdet = np.sum(np.log(np.abs(np.diag(chol64))))
        # the precision, assembled in float64 then cast: a dense product per
        # gradient instead of two triangular solves
        inv_chol64 = np.linalg.solve(chol64, np.eye(dim))
        prec64 = inv_chol64.T @ inv_chol64

        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self._counts = as_t(counts64)
        # mean of the Gaussian prior, for elliptical-slice proposals (the
        # whitened prior is centred; the latent one is the constant mu_zero)
        self.prior_gaussian_mean = 0.0 if whitened else float(mu_zero)
        self._chol = as_t(chol64)
        self._prec = as_t(prec64)
        self._mu_zero = as_t(mu_zero)
        self._white_log_norm = -0.5 * dim * float(np.log(2.0 * np.pi))
        self._latent_log_norm = self._white_log_norm - float(half_logdet)

    # ---- shared pieces -------------------------------------------------------
    def _whiten(self, latents):
        """e = L^-1 (f - mu), one batched triangular solve."""
        y = latents - self._mu_zero
        if y.ndim == 1:
            return torch.linalg.solve_triangular(self._chol, y[:, None], upper=False)[:, 0]
        return torch.linalg.solve_triangular(self._chol, y.T, upper=False).T

    def _unwhiten(self, white):
        """f = L e + mu."""
        return _matmul(white, self._chol.T) + self._mu_zero

    # ---- density -------------------------------------------------------------
    def log_lik(self, x):
        latents = self._unwhiten(x) if self.whitened else x
        return poisson_log_likelihood(latents, self._bin_area, self._counts)

    def log_prior(self, x):
        if self.whitened:
            return -0.5 * torch.sum(x * x, dim=-1) + self._white_log_norm
        y = x - self._mu_zero
        py = _matmul(y, self._prec.T)
        return -0.5 * torch.sum(y * py, dim=-1) + self._latent_log_norm

    def score(self, x):
        """The analytic score: one (d, d) product and elementwise work."""
        return self.value_and_score(x)[1]

    def value_and_score(self, x):
        return self.tempered_value_and_score(x, 1.0)

    def tempered_value_and_score(self, x, beta):
        """(beta * log_lik + log_prior, its gradient) in one pass: the MALA
        and flow hot path.

        Latent:   grad = beta (counts - a e^f) - P (f - mu).
        Whitened: grad = beta L^T (counts - a e^f) - e.
        """
        if self.whitened:
            f = self._unwhiten(x)
            lik_resid = self._counts - self._bin_area * torch.exp(f)
            val = (
                beta * poisson_log_likelihood(f, self._bin_area, self._counts)
                - 0.5 * torch.sum(x * x, dim=-1)
                + self._white_log_norm
            )
            grad = beta_column(beta) * _matmul(lik_resid, self._chol) - x
        else:
            y = x - self._mu_zero
            py = _matmul(y, self._prec.T)
            val = (
                beta * poisson_log_likelihood(x, self._bin_area, self._counts)
                - 0.5 * torch.sum(y * py, dim=-1)
                + self._latent_log_norm
            )
            grad = beta_column(beta) * (self._counts - self._bin_area * torch.exp(x)) - py
        return val, grad

    def init_positions(self, generator, n_chain):
        """Prior draws f = mu + L eps."""
        return self.prior_sample(generator, (n_chain,))

    def prior_from_noise(self, eps):
        """The prior draw made of standard normals ``eps`` (..., d)."""
        return eps if self.whitened else self._unwhiten(eps)

    def prior_sample(self, generator, shape=()):
        eps = torch.randn(
            tuple(shape) + (self.dim,), generator=generator, device=generator.device
        )
        return self.prior_from_noise(eps)
