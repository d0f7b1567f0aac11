"""Discrete coupling flows (counterpart of ``mfm_tpu.flows.coupling``):
affine (real-NVP) or monotone rational-quadratic spline coupling layers
with exact forward and inverse log-determinants, over a Gaussian base
N(0, base_scale^2 I).

The flow FAB and flowMC train. As in the reference:

- mask-based conditioning: the conditioner sees ``x * m`` and the transform
  applies where ``m == 0``; parity masks alternate per layer;
- the spline's bin is the count of interior knots at or below the point,
  after clipping it into ``[lo + 1e-6, hi - 1e-6]`` (not ``searchsorted``:
  the two differ at knot ties); outside ``[lo, hi]`` the layer is the
  identity, and the clip keeps the untaken branch of that ``where`` finite,
  so its gradient stays finite too;
- identity at init: the conditioner's output head is zero, and zeros map
  to uniform bins with unit derivatives (real-NVP: log-scale and shift 0).

The conditioner's hidden layers take flax's init (truncated
``lecun_normal``, zero biases) and ``jax.nn.gelu``'s tanh form. The module
defines the structure; the drivers carry its parameters as a ``{name:
tensor}`` dict and call ``make_coupling_flow``'s handle, which evaluates
the module with ``torch.func.functional_call``. Parameter names map to the
flax tree in ``mfm_tpu_torch.utils.convert.coupling_params_from_flax``.
Randomness is injected: ``sample`` takes the base's standard-normal draw.
"""

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from mfm_tpu_torch.flows.vector_field import _TRUNC_STD

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# raw derivative logits of zero -> softplus^-1(1 - min) + min = 1: the
# identity spline at init
_DERIV_BIAS = math.log(math.expm1(1.0 - _MIN_DERIV))
_LOG2PI = math.log(2.0 * math.pi)


def _spline_params(raw: torch.Tensor, n_bins: int, lo: float, hi: float):
    """(..., 3K-1) raw conditioner output -> knots xk, yk (..., K+1) and
    derivatives (..., K+1) with both boundary slopes 1."""
    w_raw = raw[..., :n_bins]
    h_raw = raw[..., n_bins : 2 * n_bins]
    d_raw = raw[..., 2 * n_bins :]
    span = hi - lo
    widths = (_MIN_BIN + (1.0 - _MIN_BIN * n_bins) * torch.softmax(w_raw, dim=-1)) * span
    heights = (_MIN_BIN + (1.0 - _MIN_BIN * n_bins) * torch.softmax(h_raw, dim=-1)) * span
    derivs = _MIN_DERIV + F.softplus(d_raw + _DERIV_BIAS)
    ones = torch.ones(derivs.shape[:-1] + (1,), dtype=derivs.dtype, device=derivs.device)
    derivs = torch.cat([ones, derivs, ones], dim=-1)
    zero = torch.zeros_like(widths[..., :1])
    xk = lo + _cumsum_last(torch.cat([zero, widths], dim=-1))
    yk = lo + _cumsum_last(torch.cat([zero, heights], dim=-1))
    return xk, yk, derivs


def _cumsum_last(t: torch.Tensor) -> torch.Tensor:
    """cumsum over the last dim, taken over the leading one: on the card a
    scan over a short innermost dim (K+1 = 9) is ~0.38 ms at (1024, 64, 9)
    and was 72 % of a FAB epoch's device time on phi-four (H100 80GB HBM3,
    700 W, tools/profile_slice.py --baseline fab); over the leading dim it
    is an ordinary column scan."""
    return torch.cumsum(t.movedim(-1, 0), dim=0).movedim(0, -1)


def _bin(v: torch.Tensor, knots: torch.Tensor) -> torch.Tensor:
    """(..., 1) index k with knots[k] <= v < knots[k+1]: the count of
    interior knots at or below v."""
    return torch.sum(v[..., None] >= knots[..., 1:-1], dim=-1, keepdim=True)


def _gather(knots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(knots, -1, idx)[..., 0]


def _bin_data(v, xk, yk, dk, knots):
    idx = _bin(v, knots)
    x0, y0 = _gather(xk, idx), _gather(yk, idx)
    w, h = _gather(xk, idx + 1) - x0, _gather(yk, idx + 1) - y0
    return x0, y0, w, h, _gather(dk, idx), _gather(dk, idx + 1)


def _log_slope(s, d0, d1, xi, denom):
    om = xi * (1.0 - xi)
    return (
        2.0 * torch.log(s)
        + torch.log(d1 * xi * xi + 2.0 * s * om + d0 * (1.0 - xi) ** 2)
        - 2.0 * torch.log(denom)
    )


def rq_spline_forward(x, raw, n_bins: int, lo: float, hi: float):
    """Monotone rational-quadratic spline y(x) and log|dy/dx| (Durkan et
    al. 2019, eqs. 4-5); the identity with zero log-det outside [lo, hi]."""
    xk, yk, dk = _spline_params(raw, n_bins, lo, hi)
    inside = (x > lo) & (x < hi)
    xc = torch.clamp(x, lo + 1e-6, hi - 1e-6)
    x0, y0, w, h, d0, d1 = _bin_data(xc, xk, yk, dk, xk)
    s = h / w
    xi = (xc - x0) / w
    om = xi * (1.0 - xi)
    denom = s + (d1 + d0 - 2.0 * s) * om
    y = y0 + h * (s * xi * xi + d0 * om) / denom
    ld = _log_slope(s, d0, d1, xi, denom)
    return torch.where(inside, y, x), torch.where(inside, ld, 0.0)


def rq_spline_inverse(y, raw, n_bins: int, lo: float, hi: float):
    """Inverse spline x(y) and log|dx/dy| by the stable quadratic root
    2c / (-b - sqrt(max(b^2 - 4ac, 0))) (Durkan et al. 2019, eqs. 6-8)."""
    xk, yk, dk = _spline_params(raw, n_bins, lo, hi)
    inside = (y > lo) & (y < hi)
    yc = torch.clamp(y, lo + 1e-6, hi - 1e-6)
    x0, y0, w, h, d0, d1 = _bin_data(yc, xk, yk, dk, yk)
    s = h / w
    dy = yc - y0
    t = d1 + d0 - 2.0 * s
    a = h * (s - d0) + dy * t
    b = h * d0 - dy * t
    c = -s * dy
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    xi = torch.clamp((2.0 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
    x = x0 + xi * w
    denom = s + t * (xi * (1.0 - xi))
    ld_fwd = _log_slope(s, d0, d1, xi, denom)
    return torch.where(inside, x, y), torch.where(inside, -ld_fwd, 0.0)


class _Conditioner(nn.Module):
    """Masked-input MLP emitting (..., dim, n_out) transform parameters;
    its zero output head makes every layer start as the identity."""

    def __init__(self, dim: int, hidden: Sequence[int], n_out: int):
        super().__init__()
        self.dim, self.n_out = dim, n_out
        self.hidden = nn.ModuleList()
        fan_in = dim
        for width in hidden:
            self.hidden.append(nn.Linear(fan_in, width))
            fan_in = width
        self.head = nn.Linear(fan_in, dim * n_out)

    def forward(self, x_masked):
        h = x_masked
        for layer in self.hidden:
            h = F.gelu(layer(h), approximate="tanh")  # jax.nn.gelu's default
        out = self.head(h)
        return out.reshape(out.shape[:-1] + (self.dim, self.n_out))


class CouplingStack(nn.Module):
    """Alternating-mask coupling flow u <-> x. ``forward(u)`` maps base
    noise to data (the sampling direction), ``forward(x, invert=True)``
    maps data to noise (the density direction); each returns (z, log-det)."""

    def __init__(
        self,
        dim: int,
        n_layers: int,
        hidden: Sequence[int],
        transform_type: str = "spline",
        n_bins: int = 8,
        lo: float = -10.0,
        hi: float = 10.0,
        act_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if transform_type not in ("real_nvp", "spline"):
            raise ValueError(f"unknown transform_type {transform_type!r}")
        self.dim, self.n_layers = dim, n_layers
        self.transform_type, self.n_bins, self.lo, self.hi = transform_type, n_bins, lo, hi
        self.act_norm = act_norm
        n_out = 2 if transform_type == "real_nvp" else 3 * n_bins - 1
        self.conditioners = nn.ModuleList(
            [_Conditioner(dim, tuple(hidden), n_out) for _ in range(n_layers)]
        )
        if act_norm:
            self.an_scale = nn.Parameter(torch.zeros(n_layers, dim))
            self.an_shift = nn.Parameter(torch.zeros(n_layers, dim))
        par = (torch.arange(dim) % 2).to(torch.float32)
        masks = torch.stack([par if i % 2 == 0 else 1.0 - par for i in range(n_layers)])
        self.register_buffer("masks", masks, persistent=False)
        self._init_params(generator)

    @torch.no_grad()
    def _init_params(self, generator):
        for cond in self.conditioners:
            for layer in cond.hidden:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(
                    layer.weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
                )
                layer.bias.zero_()
            cond.head.weight.zero_()
            cond.head.bias.zero_()

    def _couple(self, i: int, z, m):
        raw = self.conditioners[i](z * m)
        if self.transform_type == "real_nvp":
            # |log s| <= 4 (fabjax's stability bound for affine couplings)
            return 4.0 * torch.tanh(raw[..., 0] / 4.0), raw[..., 1]
        return raw

    def _layer(self, i: int, z, invert: bool):
        m = self.masks[i]
        free = 1.0 - m
        if not invert:
            if self.act_norm:
                z = z * torch.exp(self.an_scale[i]) + self.an_shift[i]
                ld_an = torch.sum(self.an_scale[i]) * torch.ones(z.shape[:-1], device=z.device)
            else:
                ld_an = torch.zeros(z.shape[:-1], device=z.device)
            if self.transform_type == "real_nvp":
                log_s, shift = self._couple(i, z, m)
                z = torch.where(free > 0, z * torch.exp(log_s) + shift, z)
                ld = torch.sum(free * log_s, dim=-1)
            else:
                y, ld_el = rq_spline_forward(z, self._couple(i, z, m), self.n_bins, self.lo,
                                             self.hi)
                z = torch.where(free > 0, y, z)
                ld = torch.sum(free * ld_el, dim=-1)
            return z, ld + ld_an
        # inverse order: undo the coupling (its conditioner input z*m is
        # untouched by it), then the act-norm
        if self.transform_type == "real_nvp":
            log_s, shift = self._couple(i, z, m)
            z = torch.where(free > 0, (z - shift) * torch.exp(-log_s), z)
            ld = -torch.sum(free * log_s, dim=-1)
        else:
            x, ld_el = rq_spline_inverse(z, self._couple(i, z, m), self.n_bins, self.lo, self.hi)
            z = torch.where(free > 0, x, z)
            ld = torch.sum(free * ld_el, dim=-1)
        if self.act_norm:
            z = (z - self.an_shift[i]) * torch.exp(-self.an_scale[i])
            ld = ld - torch.sum(self.an_scale[i])
        return z, ld

    def forward(self, z, invert: bool = False):
        ld = torch.zeros(z.shape[:-1], device=z.device)
        order = reversed(range(self.n_layers)) if invert else range(self.n_layers)
        for i in order:
            z, ldi = self._layer(i, z, invert)
            ld = ld + ldi
        return z, ld


class CouplingFlow(NamedTuple):
    """Functional handle over ``params``: Gaussian base N(0, base_scale^2 I)
    and the coupling stack. ``eps`` is the base's standard-normal draw, (n,
    d): ``u = base_scale * eps``."""

    forward: Callable  # (params, u) -> (x, log|det dx/du|)
    inverse: Callable  # (params, x) -> (u, log|det du/dx|)
    log_prob: Callable  # (params, x) -> (n,)
    sample: Callable  # (params, eps) -> (n, d)
    sample_and_log_prob: Callable  # (params, eps) -> ((n, d), (n,))
    dim: int
    module: CouplingStack


def normal_logpdf(u: torch.Tensor, scale: float) -> torch.Tensor:
    d = u.shape[-1]
    return (-0.5 * torch.sum(u * u, dim=-1) / (scale * scale) - 0.5 * d * _LOG2PI
            - d * math.log(scale))


def make_coupling_flow(
    dim: int,
    n_layers: int = 8,
    hidden: Sequence[int] = (128, 128),
    transform_type: str = "real_nvp",
    n_bins: int = 8,
    spline_range: Tuple[float, float] = (-10.0, 10.0),
    act_norm: bool = False,
    base_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[CouplingFlow, dict]:
    """The flow's handle and its initial parameters on ``device``;
    ``generator`` (on the CPU) draws the hidden layers' weights."""
    module = CouplingStack(
        dim, n_layers, tuple(hidden), transform_type, n_bins, float(spline_range[0]),
        float(spline_range[1]), act_norm, generator,
    ).to(device)
    params = {k: v.detach().clone() for k, v in module.named_parameters()}

    def forward(params, u):
        return functional_call(module, params, (u,))

    def inverse(params, x):
        return functional_call(module, params, (x,), {"invert": True})

    def log_prob(params, x):
        u, ld = inverse(params, x)
        return normal_logpdf(u, base_scale) + ld

    def sample(params, eps):
        return forward(params, base_scale * eps)[0]

    def sample_and_log_prob(params, eps):
        u = base_scale * eps
        x, ld = forward(params, u)
        return x, normal_logpdf(u, base_scale) - ld  # log q(x) = log N(u) - log|dx/du|

    flow = CouplingFlow(forward, inverse, log_prob, sample, sample_and_log_prob, dim, module)
    return flow, params
