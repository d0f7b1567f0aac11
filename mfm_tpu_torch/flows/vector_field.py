"""CNF velocity field v(x, t) (counterpart of
``mfm_tpu.flows.vector_field.VectorFieldNet``).

Fourier time features [cos(2 pi f t), sin(2 pi f t)], a t-trunk, an x-trunk,
a joint trunk on [x-trunk, t-trunk], and two zero-initialised heads:
``field = field_head(joint) + gate_head(t-trunk) * clip(score(x))``.
``score_gate`` is that last term with its x-tangents for a transport
stage (``flows.cnf``): the one given (``Target.score_gate`` of the target
whose score is ``score_fn``, fused where the target has a kernel for it),
else ``targets.base.generic_score_gate`` over ``score_fn``; ``forward``
never uses it.

The module defines the structure and the initial parameters; the drivers
carry the parameters as a plain ``{name: tensor}`` dict and evaluate the net
with ``torch.func.functional_call``, as the reference carries a flax tree.
Parameter names follow the flax tree (``t_trunk.0`` <-> ``t_trunk/Dense_0``),
see ``mfm_tpu_torch.utils.convert``.

``precision`` is the reference's ``field_precision``, a property of every
``Dense`` layer of the net (trunks, gate head, field head): 'highest' is
fp32 throughout; 'default' multiplies bf16 operands (see ``Dense``). The
Fourier features, biases, activations and the score gate stay fp32.
"""

import functools
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mfm_tpu_torch.targets.base import generic_score_gate

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


PRECISIONS = ("highest", "default")


class Dense(nn.Linear):
    """``nn.Linear`` at a field precision.

    'default' is the reference's ``precision=None`` on a TPU: bf16 operands,
    fp32 accumulation, fp32 result. Both operands are rounded to bf16 and
    multiplied as fp32 tensors: a product of two bf16 values is exact in
    fp32, so with TF32 off (``drivers.mfm.set_field_precision``) this is the
    TPU's arithmetic, one code path on the CPU and the GPU. Under
    ``torch.func.jvp`` the tangent is rounded to bf16 the same way, as
    ``jax.jvp`` of a ``precision=None`` dot rounds it.
    """

    def __init__(self, in_features: int, out_features: int, precision: str = "highest"):
        super().__init__(in_features, out_features)
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if self.precision == "highest":
            return super().forward(h)
        return F.linear(h.bfloat16().float(), self.weight.bfloat16().float(), self.bias)


class MLP(nn.ModuleList):
    """``Dense`` layers of the given widths, each followed by the activation
    (the reference's ``MLP``); layer i is the flax tree's ``Dense_i``."""

    def __init__(self, fan_in: int, features: Sequence[int], act: str = "relu",
                 precision: str = "highest"):
        super().__init__()
        for width in features:
            self.append(Dense(fan_in, width, precision))
            fan_in = width
        self.act = NON_LINEARITIES[act]

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self:
            h = self.act(layer(h))
        return h


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
        precision: str = "highest",
        score_gate: Optional[Callable] = None,
    ):
        super().__init__()
        self.dim = dim
        self.act_name = act
        self.score_fn = score_fn
        self.score_clip = score_clip
        if score_gate is None and score_fn is not None:
            score_gate = functools.partial(generic_score_gate, score_fn)
        self.score_gate = score_gate
        self.register_buffer("fourier_freqs", torch.as_tensor(fourier_freqs))
        n_feat = 2 * self.fourier_freqs.shape[0]
        self.t_trunk = MLP(n_feat, hidden_t, act, precision)
        self.x_trunk = MLP(dim, hidden_x, act, precision)
        ht = hidden_t[-1] if hidden_t else n_feat
        hx = hidden_x[-1] if hidden_x else dim
        self.xt_trunk = MLP(hx + ht, hidden_xt, act, precision)
        self.gate_head = Dense(ht, dim, precision)
        self.field_head = Dense(hidden_xt[-1] if hidden_xt else hx + ht, dim, precision)
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
        h_t = self.t_trunk(torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1))
        h_x = self.x_trunk(x)
        h = self.xt_trunk(torch.cat([h_x, h_t], dim=-1))
        return self.field_head(h), self.gate_head(h_t)

    def forward(self, x: torch.Tensor, t, score: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The field at (x, t). ``score``, when given, is ``score_fn(x)``
        computed by the caller (DDS takes it outside its checkpointed step);
        it is clipped here all the same."""
        single = x.ndim == 1
        if single:
            x = x[None, :]
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device).reshape(-1)
        t = t.expand(x.shape[0])
        field, gate = self.mlp(x, t)
        if score is not None or self.score_fn is not None:
            score = self.score_fn(x) if score is None else score.reshape(x.shape)
            if self.score_clip is not None:
                score = torch.clamp(score, -self.score_clip, self.score_clip)
            field = field + gate * score
        return field[0] if single else field


def field_params(net: nn.Module) -> dict:
    """The net's parameters as a detached ``{name: tensor}`` dict."""
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def make_vector_field(
    generator: torch.Generator,
    dim: int,
    score_fn: Optional[Callable] = None,
    hidden_x: Sequence[int] = (128, 128),
    hidden_t: Sequence[int] = (128, 128),
    hidden_xt: Sequence[int] = (128, 128),
    fourier_dim: int = 128,
    fourier_std: float = 1.0,
    non_linearity: str = "relu",
    score_clip: Optional[float] = None,
    precision: str = "highest",
    score_gate: Optional[Callable] = None,
    device="cuda",
):
    """The net and its initial parameters, ``(net, params)``: the Fourier
    frequencies ``fourier_std * N(0, 1)`` and then the weights, drawn from
    ``generator`` (on the CPU), the net moved to ``device``; ``params`` is
    ``field_params(net)``, the dict ``utils.convert.params_from_flax`` makes
    of a flax tree. Evaluate with ``torch.func.functional_call(net, params,
    (x, t))``."""
    freqs = fourier_std * torch.randn(fourier_dim, generator=generator)
    net = VectorFieldNet(
        dim, freqs, tuple(hidden_x), tuple(hidden_t), tuple(hidden_xt), act=non_linearity,
        score_fn=score_fn, score_clip=score_clip, generator=generator, precision=precision,
        score_gate=score_gate,
    ).to(device)
    return net, field_params(net)
