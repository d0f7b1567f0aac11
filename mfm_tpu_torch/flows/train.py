"""The flow's optimizers (counterpart of ``mfm_tpu.flows.train``, and of
the optax transformations the baselines use).

``adamw_finite`` is written by hand because ``torch.optim.AdamW`` is a
different update. Semantically it is optax's
``apply_if_finite(chain(adamw, clip), patience)`` as the reference fuses it:

- the clip is on the *update*, per element, not on the gradient norm;
- the learning-rate schedule is read at the pre-increment applied count,
  the bias correction at the post-increment one;
- a non-finite gradient leaves parameters and moments untouched and bumps
  a consecutive-failure counter; after ``nonfinite_patience`` failures in a
  row the NaN is let through so the blow-up surfaces.

``adam``, ``clip_by_global_norm`` and ``chain`` are optax's, as FAB,
flowMC and DDS use them; ``sgd`` is optax's without momentum, as SVGD's
callers use it. Adam is ``mu_hat / (sqrt(nu_hat) + eps)`` with the
schedule read at the pre-increment count; a zeroed gradient (a step the
caller skipped) is still an update, so the moments decay and the count
advances, as in the reference.

Everything is tensor arithmetic (no host round trip); parameters are a
``{name: tensor}`` dict and every update returns new tensors.
"""

from typing import Callable, Dict, NamedTuple

import torch
from torch.utils._pytree import tree_map


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


def make_optimizer(
    learning_rate_fn,
    weight_decay: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    gradient_clip: float = 1.0,
    nonfinite_patience: int = 10,
) -> GradientTransformation:
    """``adamw_finite`` with the weight decay second, in the reference's
    order."""
    return adamw_finite(learning_rate_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                        gradient_clip=gradient_clip, nonfinite_patience=nonfinite_patience)


def create_train_state(params: dict, tx: GradientTransformation) -> TrainState:
    dev = next(iter(params.values())).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params, tx.init(params))


def apply_gradients(state: TrainState, grads: dict, tx: GradientTransformation) -> TrainState:
    updates, opt_state = tx.update(grads, state.opt_state, state.params)
    return TrainState(state.step + 1, apply_updates(state.params, updates), opt_state)


class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar: updates so far
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> GradientTransformation:
    """``optax.adam``: ``learning_rate`` a number or a schedule of the
    update count."""

    def init_fn(params):
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev), zeros(), zeros())

    def update_fn(grads, state: AdamState, params=None):
        count = state.count + 1
        cf = count.to(torch.float32)
        bc1, bc2 = 1.0 - b1**cf, 1.0 - b2**cf
        lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - b1) * g + b1 * state.mu[k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state.nu[k]
            updates[k] = -lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps))
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init_fn, update_fn)


def sgd(learning_rate: float) -> GradientTransformation:
    """``optax.sgd`` without momentum: the update is ``-learning_rate * g``;
    parameters a tensor or a dict of tensors."""

    def update_fn(grads, state, params=None):
        return tree_map(lambda g: -learning_rate * g, grads), state

    return GradientTransformation(lambda params: (), update_fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """``optax.clip_by_global_norm``: scale every update by max_norm / norm
    when the global norm reaches max_norm."""

    def update_fn(grads, state, params=None):
        norm = global_norm(grads)
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}, state

    return GradientTransformation(lambda params: (), update_fn)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """``optax.chain``: the transformations in order, one state each."""

    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params, updates):
    """``params + updates`` for a tensor or a dict of tensors."""
    if isinstance(params, torch.Tensor):
        return params + updates
    return {k: p + updates[k] for k, p in params.items()}
