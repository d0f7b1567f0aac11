"""The flow's velocity field, its exact divergence and the RK4 transport, in
plain PyTorch, for S nets at once (every tensor has a leading seed axis).

The field (Cabezas et al., Markovian Flow Matching): Fourier features
[cos 2 pi f t, sin 2 pi f t] into a t-trunk, x into an x-trunk, their
concatenation into a joint trunk, a field head on the joint trunk and a
gate head on the t-trunk; v(x, t) = field + gate * score(x). Trunks are
Dense layers each followed by relu. Parameters are a dict of (S, ...)
tensors named ``t_trunk.0.weight`` ... ``field_head.bias``.

``prec`` is how a Dense layer multiplies: 'highest' in fp32, 'default' with
both operands rounded to bf16 and fp32 accumulation; the lower precisions
the controls use: 'tf32' (operands rounded to TF32's 10-bit mantissa) and
'fp8' (each vector of an operand scaled into e4m3). Biases, activations, the
Fourier features and the score gate stay fp32. A tangent is rounded as its
primal operand is.

The divergence is exact: the (B, d, d) Jacobian of the MLP part is carried
layer by layer and its trace taken, and the score gate adds
sum_i gate_i d score_i / d x_i.
"""

import math

import torch

def round_operand(v, prec: str):
    if prec == "highest":
        return v
    if prec == "default":
        return v.bfloat16().float()
    if prec == "tf32":
        bits = v.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF  # round to nearest on the 10-bit mantissa
        return bits.view(torch.float32)
    if prec == "fp8":  # scaled per vector along the last axis, as fp8 GEMMs scale rows
        scale = torch.clamp(v.detach().abs().amax(-1, keepdim=True), min=1e-30) / 448.0
        return (v / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec!r}")


def layer_names(params, trunk):
    n = 0
    while f"{trunk}.{n}.weight" in params:
        n += 1
    return [f"{trunk}.{i}" for i in range(n)]


def dense(params, name, h, prec):
    """h (S, ..., in) -> (S, ..., out); weight (S, out, in), bias (S, out)."""
    w, b = params[f"{name}.weight"], params[f"{name}.bias"]
    hw = round_operand(h, prec).flatten(1, -2)
    out = torch.bmm(hw, round_operand(w, prec).transpose(1, 2)) + b[:, None, :]
    return out.reshape(h.shape[:-1] + (w.shape[1],))


def fourier(freqs, t):
    ang = (2.0 * math.pi) * t[..., None] * freqs[:, None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def mlp(params, freqs, x, t, prec, keep=False):
    """(field, gate) of the MLP part for x (S, B, d), t (S, B); with
    ``keep`` also each x-dependent layer's relu mask, for the Jacobian."""
    h_t = fourier(freqs, t)
    for name in layer_names(params, "t_trunk"):
        h_t = torch.relu(dense(params, name, h_t, prec))
    masks = []
    h = x
    for name in layer_names(params, "x_trunk"):
        z = dense(params, name, h, prec)
        masks.append(z > 0)
        h = torch.relu(z)
    h = torch.cat([h, h_t], -1)
    for name in layer_names(params, "xt_trunk"):
        z = dense(params, name, h, prec)
        masks.append(z > 0)
        h = torch.relu(z)
    out = dense(params, "field_head", h, prec), dense(params, "gate_head", h_t, prec)
    return out + (masks,) if keep else out


def jacobian_trace(params, masks, prec):
    """trace of d field / d x from the relu masks of ``mlp(keep=True)``: the
    d basis tangents pushed through the layers, (S, B, width, d)."""
    x_names, xt_names = layer_names(params, "x_trunk"), layer_names(params, "xt_trunk")
    S, B = masks[0].shape[:2]
    w0 = round_operand(params[f"{x_names[0]}.weight"], prec)  # a basis tangent picks a column
    jac = w0[:, None].expand(S, B, -1, -1) * masks[0][..., None]
    width_x = jac.shape[2]
    for i, name in enumerate(x_names[1:] + xt_names + ["field_head"]):
        w = round_operand(params[f"{name}.weight"], prec)
        if name == xt_names[0]:
            w = w[:, :, :width_x]  # the t-trunk half of its input has no x-tangent
        jac = torch.einsum("soi,sbid->sbod", w, round_operand(jac, prec))
        if i + 1 < len(masks):
            jac = jac * masks[i + 1][..., None]
    return torch.diagonal(jac, dim1=-2, dim2=-1).sum(-1)


def velocity_div(params, freqs, target, x, t, prec):
    """(v, div v) at x (S, B, d), t (S, B)."""
    field, gate, masks = mlp(params, freqs, x, t, prec, keep=True)
    score = target.score(x)
    div = jacobian_trace(params, masks, prec)
    div = div + torch.sum(gate * target.hessian_diag(x), -1)
    return field + gate * score, div


def velocity(params, freqs, target, x, t, prec):
    field, gate = mlp(params, freqs, x, t, prec)
    return field + gate * target.score(x)


def transport(params, freqs, target, y, prec, inverse=False, n_steps=24):
    """RK4 on the fixed grid of ``n_steps`` steps over [0, 1]: (x, logdet)
    with logdet = log|det dx/du| = int div v dt, forward from latents u or
    back from points x (``inverse``: the field reversed, t = 1 - s, the same
    quantity accumulated)."""
    dt = 1.0 / n_steps
    grid = (dt * torch.arange(n_steps, dtype=torch.float32)).tolist()
    sign = -1.0 if inverse else 1.0

    def dyn(x, s):
        tt = torch.full(x.shape[:-1], 1.0 - s if inverse else s, dtype=x.dtype,
                        device=x.device)
        v, div = velocity_div(params, freqs, target, x, tt, prec)
        return sign * v if inverse else v, div

    x = y
    logdet = torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)
    with torch.no_grad():
        for s in grid:
            k1 = dyn(x, s)
            k2 = dyn(x + (dt / 2) * k1[0], s + dt / 2)
            k3 = dyn(x + (dt / 2) * k2[0], s + dt / 2)
            k4 = dyn(x + dt * k3[0], s + dt)
            x = x + dt * ((k1[0] + 2.0 * k2[0] + 2.0 * k3[0] + k4[0]) / 6.0)
            logdet = logdet + dt * ((k1[1] + 2.0 * k2[1] + 2.0 * k3[1] + k4[1]) / 6.0)
    return x, logdet
