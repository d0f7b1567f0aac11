"""Fixed-grid ODE integrators (counterpart of ``mfm_tpu.flows.ode``).

The reference scans a static step budget; here it is a Python loop. States
are tensors or tuples of tensors (the CNF carries (x, logdet)).
"""

from typing import Callable

import torch


def _map(fn, *trees):
    if isinstance(trees[0], tuple):
        return tuple(fn(*leaves) for leaves in zip(*trees))
    return fn(*trees)


def _axpy(a, x, y):
    return _map(lambda xi, yi: yi + a * xi, x, y)


def _rk4_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(_axpy(dt / 2, k1, y), t + dt / 2)
    k3 = f(_axpy(dt / 2, k2, y), t + dt / 2)
    k4 = f(_axpy(dt, k3, y), t + dt)
    comb = _map(lambda a, b, c, d: (a + 2.0 * b + 2.0 * c + d) / 6.0, k1, k2, k3, k4)
    return _axpy(dt, comb, y)


def _heun_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(_axpy(dt, k1, y), t + dt)
    return _axpy(dt / 2, _map(lambda a, b: a + b, k1, k2), y)


def _euler_step(f: Callable, y, t, dt):
    return _axpy(dt, f(y, t), y)


_STEPPERS = {"rk4": _rk4_step, "heun": _heun_step, "euler": _euler_step}


def odeint_grid(
    f: Callable, y0, t0: float = 0.0, t1: float = 1.0, n_steps: int = 20,
    method: str = "rk4",
):
    """Integrate dy/dt = f(y, t) on a fixed grid; returns the final state.
    The grid times are the float32 values the reference's scan visits."""
    step = _STEPPERS[method]
    dt = (t1 - t0) / n_steps
    ts = (t0 + dt * torch.arange(n_steps, dtype=torch.float32)).tolist()
    y = y0
    for t in ts:
        y = step(f, y, t, dt)
    return y
