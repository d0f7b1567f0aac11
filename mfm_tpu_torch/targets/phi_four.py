"""1-D lattice phi^4 target (counterpart of ``mfm_tpu.targets.phi_four``).

log p(x) = -beta * (U(x) + V(x)): V is the on-site double well
sum (1 - x^2)^2 / (4 a d), plus an optional mean tilt; U is the a*d-weighted
squared first difference with a dirichlet or periodic boundary. One batched
stencil over a (B, d) field batch.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mfm_tpu_torch.targets.base import Target


class PhiFour(Target):
    def __init__(
        self,
        dim: int,
        a: float = 0.1,
        beta: float = 20.0,
        bc: Tuple[str, float] = ("dirichlet", 0.0),
        tilt: Optional[dict] = None,
    ):
        if bc[0] not in ("dirichlet", "pbc"):
            raise ValueError("bc must be dirichlet or pbc")
        self.dim = dim
        self.a = a
        self.beta = beta
        self.bc = bc
        self.tilt = tilt
        self._coef = a * dim

    def _energy(self, x: torch.Tensor) -> torch.Tensor:
        diffs = 1.0 - torch.square(x)
        v = torch.sum(diffs * diffs, dim=-1) / (4.0 * self._coef)
        if self.tilt is not None:
            t = (self.tilt["val"] - torch.mean(x, dim=-1)) ** 2
            v = v + self.tilt["lambda"] * t / (4.0 * self.dim)
        if self.bc[0] == "dirichlet":
            x_ = F.pad(x, (1, 1), value=float(self.bc[1]))
        else:  # periodic: prepend the last site
            x_ = torch.cat([x[..., -1:], x], dim=-1)
        d1 = x_[..., 1:] - x_[..., :-1]
        u = 0.5 * torch.sum(d1 * d1, dim=-1) * self._coef
        return u + v

    def log_lik(self, x):
        return -self.beta * self._energy(x)

    def init_positions(self, generator, n_chain):
        """Uniform(-1, 1) initial fields."""
        u = torch.rand((n_chain, self.dim), generator=generator, device=generator.device)
        return u * 2.0 - 1.0
