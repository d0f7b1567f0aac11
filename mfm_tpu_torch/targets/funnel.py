"""Neal's funnel and the many-well target (counterpart of
``mfm_tpu.targets.funnel``), both with exact samplers. Each sampler is
split: ``sample`` draws its noise from a generator and hands it to
``sample_from_noise``, which a test can feed another package's draws.
Neither target holds a tensor: ``device`` is taken as every target takes
it, and a sampler draws on its generator's device.
"""

import math

import torch

from mfm_tpu_torch.targets.base import Target

_LOG2PI = math.log(2.0 * math.pi)


class Funnel(Target):
    """Neal's funnel: v ~ N(0, sigma_v^2), x_i | v ~ N(0, exp(v)) for
    i < dim - 1. The funnel dimension is the last coordinate."""

    def __init__(self, dim: int = 10, sigma_v: float = 3.0, device=None):
        self.dim = dim
        self.sigma_v = sigma_v

    def log_lik(self, x):
        v = x[..., -1]
        rest = x[..., :-1]
        k = self.dim - 1
        lp_v = -0.5 * (v / self.sigma_v) ** 2 - 0.5 * (_LOG2PI + 2.0 * math.log(self.sigma_v))
        lp_rest = -0.5 * torch.sum(rest * rest, dim=-1) * torch.exp(-v) - 0.5 * k * (_LOG2PI + v)
        return lp_v + lp_rest

    def sample_from_noise(self, noise_v, noise_x):
        """The draw made of standard normals ``noise_v`` (..., 1) and
        ``noise_x`` (..., dim - 1)."""
        v = self.sigma_v * noise_v
        return torch.cat([torch.exp(0.5 * v) * noise_x, v], dim=-1)

    def sample(self, generator, shape=()):
        shape, dev = tuple(shape), generator.device
        noise_v = torch.randn(shape + (1,), generator=generator, device=dev)
        noise_x = torch.randn(shape + (self.dim - 1,), generator=generator, device=dev)
        return self.sample_from_noise(noise_v, noise_x)


class ManyWell(Target):
    """Product of double-well pairs: each consecutive coordinate pair
    (x1, x2) contributes log p = -x1^4 + 6 x1^2 + x1 / 2 - x2^2 / 2, so
    dim = 2 * n_wells gives 2^n_wells modes."""

    def __init__(self, dim: int = 32, device=None):
        if dim % 2:
            raise ValueError(f"ManyWell dim must be even, got {dim}")
        self.dim = dim

    def log_lik(self, x):
        pairs = x.reshape(x.shape[:-1] + (self.dim // 2, 2))
        x1, x2 = pairs[..., 0], pairs[..., 1]
        well = -(x1**4) + 6.0 * x1**2 + 0.5 * x1 - 0.5 * x2**2
        return torch.sum(well, dim=-1)

    # Inverse-CDF grid of the x1 marginal p(x1) ~ exp(-x1^4 + 6 x1^2 + x1/2):
    # outside |x1| <= 3.5 the density is below e^-80 of the mode, so a dense
    # trapezoid CDF on [-3.5, 3.5] is exact to fp32. Built in fp32, as the
    # reference builds it.
    _GRID_N = 8193
    _GRID_LIM = 3.5

    def _x1_cdf_grid(self, device=None):
        grid = torch.linspace(
            -self._GRID_LIM, self._GRID_LIM, self._GRID_N, dtype=torch.float32, device=device
        )
        logp = -(grid**4) + 6.0 * grid**2 + 0.5 * grid
        p = torch.exp(logp - torch.max(logp))
        cdf = torch.cat(
            [torch.zeros(1, device=device), torch.cumsum(0.5 * (p[1:] + p[:-1]), dim=0)]
        )
        return grid, cdf / cdf[-1]

    def sample_from_noise(self, u, noise_x2, table=None):
        """The draw made of uniforms ``u`` and standard normals ``noise_x2``,
        both (..., n_wells): x1 by the inverse CDF, x2 the normal. ``table``
        is another (grid, cdf) than ``_x1_cdf_grid``'s: where the density is
        low a cell's CDF step is a few fp32 ulps, so x1 there follows the
        table's last bits, which differ between two exp implementations."""
        grid, cdf = self._x1_cdf_grid(u.device) if table is None else table
        hi = torch.clamp(torch.searchsorted(cdf, u.contiguous()), 1, self._GRID_N - 1)
        c_lo, c_hi = cdf[hi - 1], cdf[hi]
        frac = (u - c_lo) / torch.clamp(c_hi - c_lo, min=1e-30)
        x1 = grid[hi - 1] + frac * (grid[hi] - grid[hi - 1])
        return torch.stack([x1, noise_x2], dim=-1).reshape(u.shape[:-1] + (self.dim,))

    def sample(self, generator, shape=()):
        shape, dev = tuple(shape) + (self.dim // 2,), generator.device
        u = torch.rand(shape, generator=generator, device=dev)
        return self.sample_from_noise(u, torch.randn(shape, generator=generator, device=dev))
