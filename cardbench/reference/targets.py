"""The two targets in plain PyTorch: each one's log-density, score and the
diagonal of the score's derivative (what an exact divergence adds for the
score gate), and many-well's exact sampler.

phi-four: the 1-D lattice phi^4 field with a Dirichlet boundary at 0
(Cabezas et al., Markovian Flow Matching, the phi-four example):
log p(x) = -beta (U + V), U = (a d / 2) [sum_i (x_{i+1} - x_i)^2 + x_1^2]
with x_{d+1} = 0, V = sum_i (1 - x_i^2)^2 / (4 a d).

many-well: 16 double-well pairs (Midgley et al., Flow Annealed Importance
Sampling Bootstrap): each pair (x1, x2) adds -x1^4 + 6 x1^2 + x1 / 2 -
x2^2 / 2.
"""

import torch


class PhiFour:
    def __init__(self, dim: int, a: float = 0.1, beta: float = 20.0):
        self.dim, self.a, self.beta = dim, a, beta

    def _neighbours(self, x):
        zero = torch.zeros_like(x[..., :1])
        return torch.cat([zero, x[..., :-1]], -1), torch.cat([x[..., 1:], zero], -1)

    def value_and_score(self, x):
        c = self.a * self.dim
        left, right = self._neighbours(x)
        w = 1.0 - x * x
        diff = right - x
        grad_sq = torch.sum(diff * diff, -1) + x[..., 0] ** 2
        value = -self.beta * (0.5 * c * grad_sq + torch.sum(w * w, -1) / (4.0 * c))
        score = -self.beta * (-x * w / c + c * (2.0 * x - left - right))
        return value, score

    def log_prob(self, x):
        return self.value_and_score(x)[0]

    def score(self, x):
        return self.value_and_score(x)[1]

    def hessian_diag(self, x):
        c = self.a * self.dim
        return -self.beta * ((3.0 * x * x - 1.0) / c + 2.0 * c)

    def init_positions(self, gen, n):
        """Uniform(-1, 1) fields, the sampler's starting law."""
        return torch.rand((n, self.dim), generator=gen, device=gen.device) * 2.0 - 1.0


class ManyWell:
    GRID_N, GRID_LIM = 8193, 3.5

    def __init__(self, dim: int = 32):
        self.dim = dim

    def _pairs(self, x):
        p = x.unflatten(-1, (self.dim // 2, 2))
        return p[..., 0], p[..., 1]

    def log_prob(self, x):
        x1, x2 = self._pairs(x)
        return torch.sum(-(x1**4) + 6.0 * x1**2 + 0.5 * x1 - 0.5 * x2**2, -1)

    def score(self, x):
        x1, x2 = self._pairs(x)
        return torch.stack([-4.0 * x1**3 + 12.0 * x1 + 0.5, -x2], -1).flatten(-2)

    def value_and_score(self, x):
        return self.log_prob(x), self.score(x)

    def hessian_diag(self, x):
        x1, x2 = self._pairs(x)
        return torch.stack([12.0 - 12.0 * x1**2, -torch.ones_like(x2)], -1).flatten(-2)

    def sample(self, gen, n):
        """Exact draws: x1 by the inverse of a trapezoid CDF on [-3.5, 3.5]
        (outside it the marginal is below e^-80 of its mode), x2 normal;
        the CDF is built in float64."""
        dev = gen.device
        grid = torch.linspace(-self.GRID_LIM, self.GRID_LIM, self.GRID_N, dtype=torch.float64,
                              device=dev)
        logp = -(grid**4) + 6.0 * grid**2 + 0.5 * grid
        p = torch.exp(logp - logp.max())
        cdf = torch.cat([torch.zeros(1, dtype=torch.float64, device=dev),
                         torch.cumsum(0.5 * (p[1:] + p[:-1]), 0)])
        cdf = cdf / cdf[-1]
        shape = (n, self.dim // 2)
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)
        x2 = torch.randn(shape, generator=gen, device=dev)
        hi = torch.clamp(torch.searchsorted(cdf, u), 1, self.GRID_N - 1)
        frac = (u - cdf[hi - 1]) / torch.clamp(cdf[hi] - cdf[hi - 1], min=1e-300)
        x1 = grid[hi - 1] + frac * (grid[hi] - grid[hi - 1])
        return torch.stack([x1.float(), x2], -1).flatten(-2)


TARGETS = {"phi_four": PhiFour, "many_well": ManyWell}
