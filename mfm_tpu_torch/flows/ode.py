"""ODE integrators (counterpart of ``mfm_tpu.flows.ode``): the fixed grid
the transport runs on (final state, or the states at given save times) and
an adaptive Dormand-Prince oracle.

The reference scans a static step budget; here it is a Python loop. States
are tensors or tuples of tensors (the CNF carries (x, logdet)).
"""

from typing import Callable

import torch

from mfm_tpu_torch.utils import profiling


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
_STAGES = {"rk4": 4, "heun": 2, "euler": 1}  # field evaluations a step


def odeint_grid(
    f: Callable, y0, t0: float = 0.0, t1: float = 1.0, n_steps: int = 20,
    method: str = "rk4",
):
    """Integrate dy/dt = f(y, t) on a fixed grid; returns the final state.
    The grid times are the float32 values the reference's scan visits."""
    step = _STEPPERS[method]
    dt = (t1 - t0) / n_steps
    ts = (t0 + dt * torch.arange(n_steps, dtype=torch.float32)).tolist()
    profiling.count("stages", n_steps * _STAGES[method])
    y = y0
    for t in ts:
        y = step(f, y, t, dt)
    return y


def odeint_grid_save(f: Callable, y0, save_ts, n_steps: int = 20, method: str = "rk4"):
    """Fixed-grid integration reporting the state at each time of
    ``save_ts``, which starts at the initial time; the step budget is split
    evenly over the segments. Returns the states stacked on a new first
    axis (each leaf of a tuple state on its own)."""
    save_ts = list(save_ts)
    n_seg = len(save_ts) - 1
    per_seg = max(1, n_steps // max(n_seg, 1))
    states = [y0]
    y = y0
    for a, b in zip(save_ts[:-1], save_ts[1:]):
        y = odeint_grid(f, y, a, b, per_seg, method)
        states.append(y)
    return _map(lambda *xs: torch.stack(xs), *states)


# Adaptive Dormand-Prince 5(4): an oracle to check the fixed grid against.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def odeint_dopri5(
    f: Callable, y0, t0: float = 0.0, t1: float = 1.0, rtol: float = 1e-5,
    atol: float = 1e-5, max_steps: int = 1000,
):
    """Adaptive Dormand-Prince 5(4) with the reference's step controller
    (grow or shrink by 0.9 err^(-1/5), clamped to [0.2, 5]); one error norm
    over the whole (flattened) state. A host loop that reads the error norm
    back every step: for verification, not for a hot path."""
    leaves = y0 if isinstance(y0, tuple) else (y0,)
    shapes = [v.shape for v in leaves]
    sizes = [v.numel() for v in leaves]

    def unravel(flat):
        parts = [p.reshape(s) for p, s in zip(torch.split(flat, sizes), shapes)]
        return tuple(parts) if isinstance(y0, tuple) else parts[0]

    def ravel(y):
        return torch.cat([v.reshape(-1) for v in (y if isinstance(y, tuple) else (y,))])

    def ff(flat, t):
        return ravel(f(unravel(flat), t))

    y = ravel(y0)
    b5, b4 = (torch.tensor(b, dtype=y.dtype, device=y.device) for b in (_DP_B5, _DP_B4))
    t, h, n = float(t0), (t1 - t0) * 0.05, 0
    while t < t1 and n < max_steps:
        h = min(h, t1 - t)
        ks = []
        for i in range(7):
            yi = y
            for a, k in zip(_DP_A[i], ks):
                yi = yi + h * a * k
            ks.append(ff(yi, t + h * _DP_C[i]))
        kmat = torch.stack(ks)
        y5 = y + h * torch.tensordot(b5, kmat, dims=1)
        yerr = h * torch.tensordot(b5 - b4, kmat, dims=1)
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
        err = float(torch.sqrt(torch.mean(torch.square(yerr / scale))))
        if err <= 1.0:
            t, y = t + h, y5
        h = h * min(max(0.9 * (err + 1e-10) ** -0.2, 0.2), 5.0)
        n += 1
    return unravel(y)
