"""CNF velocity field v(x, t) (counterpart of
``mfm_tpu.flows.vector_field.VectorFieldNet``).

Fourier time features [cos(2 pi f t), sin(2 pi f t)], a t-trunk, an x-trunk,
a joint trunk on [x-trunk, t-trunk], and two zero-initialised heads:
``field = field_head(joint) + gate_head(t-trunk) * clip(score(x))``.

The module defines the structure and the initial parameters; the drivers
carry the parameters as a plain ``{name: tensor}`` dict and evaluate the net
with ``torch.func.functional_call``, as the reference carries a flax tree.
Parameter names follow the flax tree (``t_trunk.0`` <-> ``t_trunk/Dense_0``),
see ``mfm_tpu_torch.utils.convert``.
"""

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

NON_LINEARITIES = {
    "tanh": torch.tanh,
    "elu": F.elu,
    "relu": F.relu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),  # jax.nn.gelu's default
    "swish": F.silu,
}

# flax's lecun_normal: a normal truncated at two standard deviations, scaled
# so that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _trunk(widths: Sequence[int], fan_in: int) -> nn.ModuleList:
    layers = nn.ModuleList()
    for width in widths:
        layers.append(nn.Linear(fan_in, width))
        fan_in = width
    return layers


class VectorFieldNet(nn.Module):
    def __init__(
        self,
        dim: int,
        fourier_freqs: torch.Tensor,
        hidden_x: Sequence[int],
        hidden_t: Sequence[int],
        hidden_xt: Sequence[int],
        act: str = "relu",
        score_fn: Optional[Callable] = None,
        score_clip: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dim = dim
        self.act_name = act
        self.act = NON_LINEARITIES[act]
        self.score_fn = score_fn
        self.score_clip = score_clip
        self.register_buffer("fourier_freqs", torch.as_tensor(fourier_freqs))
        n_feat = 2 * self.fourier_freqs.shape[0]
        self.t_trunk = _trunk(hidden_t, n_feat)
        self.x_trunk = _trunk(hidden_x, dim)
        ht = hidden_t[-1] if hidden_t else n_feat
        hx = hidden_x[-1] if hidden_x else dim
        self.xt_trunk = _trunk(hidden_xt, hx + ht)
        self.gate_head = nn.Linear(ht, dim)
        self.field_head = nn.Linear(hidden_xt[-1] if hidden_xt else hx + ht, dim)
        self._init_params(generator)

    @torch.no_grad()
    def _init_params(self, generator):
        for trunk in (self.t_trunk, self.x_trunk, self.xt_trunk):
            for layer in trunk:
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(
                    layer.weight, std=std, a=-2.0 * std, b=2.0 * std,
                    generator=generator,
                )
                layer.bias.zero_()
        for head in (self.gate_head, self.field_head):
            head.weight.zero_()
            head.bias.zero_()

    def mlp(self, x: torch.Tensor, t: torch.Tensor):
        """(field, gate) of the MLP alone, x (B, d), t (B,)."""
        ang = (2.0 * math.pi) * t[:, None] * self.fourier_freqs[None, :]
        h_t = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
        for layer in self.t_trunk:
            h_t = self.act(layer(h_t))
        h_x = x
        for layer in self.x_trunk:
            h_x = self.act(layer(h_x))
        gate = self.gate_head(h_t)
        h = torch.cat([h_x, h_t], dim=-1)
        for layer in self.xt_trunk:
            h = self.act(layer(h))
        return self.field_head(h), gate

    def clipped_score(self, x: torch.Tensor) -> torch.Tensor:
        score = self.score_fn(x)
        if self.score_clip is not None:
            score = torch.clamp(score, -self.score_clip, self.score_clip)
        return score

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        single = x.ndim == 1
        if single:
            x = x[None, :]
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
        t = t.expand(x.shape[0])
        field, gate = self.mlp(x, t)
        if self.score_fn is not None:
            field = field + gate * self.clipped_score(x)
        return field[0] if single else field


def field_params(net: nn.Module) -> dict:
    """The net's parameters as a detached ``{name: tensor}`` dict."""
    return {k: v.detach().clone() for k, v in net.named_parameters()}
