"""The flow's optimizer (counterpart of ``mfm_tpu.flows.train``).

``adamw_finite`` is written by hand because ``torch.optim.AdamW`` is a
different update. Semantically it is optax's
``apply_if_finite(chain(adamw, clip), patience)`` as the reference fuses it:

- the clip is on the *update*, per element, not on the gradient norm;
- the learning-rate schedule is read at the pre-increment applied count,
  the bias correction at the post-increment one;
- a non-finite gradient leaves parameters and moments untouched and bumps
  a consecutive-failure counter; after ``nonfinite_patience`` failures in a
  row the NaN is let through so the blow-up surfaces.

Everything is tensor arithmetic (no host round trip); parameters are a
``{name: tensor}`` dict and every update returns new tensors.
"""

from typing import Callable, Dict, NamedTuple

import torch


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    params: Dict[str, torch.Tensor]
    opt_state: "AdamWFiniteState"


class AdamWFiniteState(NamedTuple):
    count: torch.Tensor  # int32 scalar: applied (finite) steps
    notfinite_count: torch.Tensor  # int32 scalar: consecutive skipped steps
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def decay_mask(params: dict) -> dict:
    """True for parameters that get weight decay: all but biases and norm
    scales."""

    def keep(name):
        parts = name.split(".")
        if parts[-1] == "bias":
            return False
        joined = "".join(parts).lower()
        return not any(tag in joined for tag in ("layernorm", "layer_norm", "ln"))

    return {k: keep(k) for k in params}


def _linear_schedule(init: float, end: float, steps: int):
    def schedule(count):
        c = torch.clamp(count, 0, steps)
        frac = 1.0 - c / steps
        return (init - end) * frac + end

    return schedule


def make_lr_schedule(num_train_steps: int, num_warmup_steps: int, learning_rate: float):
    """Linear warmup then linear decay to zero (optax.join_schedules of two
    linear schedules at the warmup boundary)."""
    warmup = _linear_schedule(0.0, learning_rate, max(num_warmup_steps, 1))
    decay = _linear_schedule(
        learning_rate, 0.0, max(num_train_steps - num_warmup_steps, 1)
    )

    def schedule(count):
        count = torch.as_tensor(count)
        return torch.where(
            count < num_warmup_steps, warmup(count), decay(count - num_warmup_steps)
        )

    return schedule


def adamw_finite(
    learning_rate_fn,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    gradient_clip: float = 1.0,
    nonfinite_patience: int = 10,
) -> GradientTransformation:
    """The reference's ``make_optimizer`` defaults; ``update(grads, state,
    params) -> (updates, state)``."""
    def init_fn(params):
        dev = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return AdamWFiniteState(
            zero, zero.clone(),
            {k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in params.items()},
        )

    def update_fn(grads, state: AdamWFiniteState, params):
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        gate = finite.to(torch.float32)
        poison = (~finite) & (state.notfinite_count >= nonfinite_patience)
        count = state.count + finite.to(torch.int32)
        lr = learning_rate_fn(state.count)
        cf = count.to(torch.float32)
        bc1 = 1.0 - b1**cf
        bc2 = 1.0 - b2**cf
        mask = decay_mask(params)
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            m, v, p = state.mu[k], state.nu[k], params[k]
            g = torch.where(finite, g, 0.0)
            m2 = m + gate * (1.0 - b1) * (g - m)
            v2 = v + gate * (1.0 - b2) * (g * g - v)
            adam = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            decay = weight_decay * p if mask[k] else 0.0
            u = -lr * (adam + decay)
            # where, not *gate: a skipped step before any applied one has a
            # 0/0 bias correction, and NaN * 0 stays NaN
            u = torch.where(finite, torch.clamp(u, -gradient_clip, gradient_clip), 0.0)
            mu[k], nu[k] = m2, v2
            updates[k] = torch.where(poison, torch.nan, u)
        notfinite = torch.where(
            finite, torch.zeros_like(state.notfinite_count), state.notfinite_count + 1
        )
        return updates, AdamWFiniteState(count, notfinite, mu, nu)

    return GradientTransformation(init_fn, update_fn)


def create_train_state(params: dict, tx: GradientTransformation) -> TrainState:
    dev = next(iter(params.values())).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params, tx.init(params))


def apply_gradients(state: TrainState, grads: dict, tx: GradientTransformation) -> TrainState:
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    params = {k: p + updates[k] for k, p in state.params.items()}
    return TrainState(state.step + 1, params, opt_state)
