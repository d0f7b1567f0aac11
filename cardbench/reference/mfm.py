"""One MFM training iteration in plain PyTorch, for S seeds at once (every
tensor has a leading seed axis; chains are (S, B, d)).

An iteration is a data move, then one flow-matching gradient step with
AdamW: the move is a MALA step on the target at beta = 1, or, on a flow
iteration, pullback random-walk MH through the flow (latent step 2.38 /
sqrt(d)). The loss is the conditional flow-matching loss on the moved
chains, the sum over each seed's batch of |v(x_t, t) - (x1 - x0)|^2 with
x_t = sigma eps + t x1 + (1 - t) x0. AdamW (b1 0.9, b2 0.999, eps 1e-8,
decay 1e-4 on all but biases) takes its step at the learning rate
lr (1 - n / learning_iter) of the n steps applied before it, clips each
element of the update to the gradient clip, and skips a seed's step whose
gradient is not finite.

``fault`` plants one fault of the kind a training step can have, for the
readings that set the limits: 'half' leaves out half of each seed's batch
and scales the loss on the rest to the whole.
"""

import math
from typing import NamedTuple

import torch

from cardbench.reference.field import transport, velocity


class Chains(NamedTuple):
    position: torch.Tensor  # (S, B, d)
    logdensity: torch.Tensor  # (S, B)
    grad: torch.Tensor  # (S, B, d)


class Adam(NamedTuple):
    count: torch.Tensor  # (S,) int32, steps applied
    mu: dict
    nu: dict


def init_chains(target, position):
    ld, g = target.value_and_score(position)
    return Chains(position, ld, g)


def _accept(old: Chains, new: Chains, accept):
    m = accept[..., None]
    return Chains(torch.where(m, new.position, old.position),
                  torch.where(accept, new.logdensity, old.logdensity),
                  torch.where(m, new.grad, old.grad))


def mala_step(target, chains: Chains, h: float, noise, u_accept):
    x, ld, g = chains
    y = x + h * g + math.sqrt(2.0 * h) * noise
    ld_y, g_y = target.value_and_score(y)
    fwd = -ld + 0.25 / h * torch.sum((y - x - h * g) ** 2, -1)
    bwd = -ld_y + 0.25 / h * torch.sum((x - y - h * g_y) ** 2, -1)
    delta = fwd - bwd
    delta = torch.where(torch.isnan(delta), -torch.inf, delta)
    accept = u_accept < torch.clamp(torch.exp(delta), max=1.0)
    return _accept(chains, Chains(y, ld_y, g_y), accept)


def flow_step(target, chains: Chains, params, freqs, eps, u_accept, prec, n_steps):
    """Pullback random-walk MH; returns (chains, proposals, log ratios, the
    scale each ratio's rounding is relative to: the sum of the magnitudes
    of the four terms it is assembled from)."""
    d = chains.position.shape[-1]
    u_cur, ld_cur = transport(params, freqs, target, chains.position, prec, True, n_steps)
    u_prop = u_cur + (2.38 / math.sqrt(d)) * eps
    x_prop, ld_prop = transport(params, freqs, target, u_prop, prec, False, n_steps)
    lp, gp = target.value_and_score(x_prop)
    ratio = (lp + ld_prop) - (chains.logdensity + ld_cur)
    safe = torch.where(torch.isnan(ratio), -torch.inf, ratio)
    accept = u_accept < torch.exp(torch.clamp(safe, max=0.0))
    scale = lp.abs() + ld_prop.abs() + chains.logdensity.abs() + ld_cur.abs()
    return _accept(chains, Chains(x_prop, lp, gp), accept), x_prop, ratio, scale


def fm_loss_and_grad(target, params, freqs, x1, fm, sigma, prec, fault=None):
    """(loss (S,), grads) of the conditional flow-matching loss; ``fm`` is
    (t (S, B), x0 (S, B, d), eps (S, B, d))."""
    t, x0, eps = fm
    if fault == "half":
        keep = x1.shape[1] // 2
        x1, t, x0, eps = x1[:, :keep], t[:, :keep], x0[:, :keep], eps[:, :keep]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    points = sigma * eps + t[..., None] * x1 + (1.0 - t[..., None]) * x0
    with torch.enable_grad():
        resid = velocity(leaves, freqs, target, points, t, prec) - (x1 - x0)
        loss = torch.sum(resid * resid, dim=(1, 2))
        if fault == "half":
            loss = 2.0 * loss
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def adam_init(params):
    S = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    return Adam(torch.zeros(S, dtype=torch.int32, device=dev), zeros(), zeros())


def adamw_step(params, grads, state: Adam, opt):
    """(params, state) after one AdamW step; ``opt`` holds learning_rate,
    learning_iter, adam_beta1/2, adam_epsilon, weight_decay, gradient_clip."""
    b1, b2 = opt["adam_beta1"], opt["adam_beta2"]
    finite = torch.stack([torch.isfinite(g).flatten(1).all(1) for g in grads.values()]).all(0)
    count = state.count + finite.to(torch.int32)
    frac = 1.0 - torch.clamp(state.count, 0, opt["learning_iter"]) / opt["learning_iter"]
    lr = opt["learning_rate"] * frac
    cf = count.to(torch.float32)
    bc1, bc2 = 1.0 - b1**cf, 1.0 - b2**cf
    new_p, mu, nu = {}, {}, {}
    for k, g in grads.items():
        col = lambda v: v.reshape((-1,) + (1,) * (g.ndim - 1))
        ok, gate = col(finite), col(finite.to(torch.float32))
        g = torch.where(ok, g, 0.0)
        m = state.mu[k] + gate * (1.0 - b1) * (g - state.mu[k])
        v = state.nu[k] + gate * (1.0 - b2) * (g * g - state.nu[k])
        adam = (m / col(bc1)) / (torch.sqrt(v / col(bc2)) + opt["adam_epsilon"])
        decay = 0.0 if k.endswith("bias") else opt["weight_decay"] * params[k]
        u = -col(lr) * (adam + decay)
        u = torch.where(ok, torch.clamp(u, -opt["gradient_clip"], opt["gradient_clip"]), 0.0)
        new_p[k], mu[k], nu[k] = params[k] + u, m, v
    return new_p, Adam(count, mu, nu)
