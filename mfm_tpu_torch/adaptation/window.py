"""Stan-style window adaptation, ensemble-pooled (counterpart of
``mfm_tpu/adaptation/window.py:25-178``): dual averaging of the step size on
the mean acceptance of all chains, a Welford estimate of the diagonal mass
over pooled positions, and the fast | slow doubling | fast window schedule.

Everything is float32, as the reference computes without x64
(``jnp.result_type(float)``, :37). The dual-averaging state stays on the
device, so a caller never reads the step size back. The Welford count is a
Python number: it is the same in every run (it grows by the batch size per
update), and a caller decides a mass refresh from it on the host without a
device read.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    grad_avg: torch.Tensor
    count: torch.Tensor
    mu: torch.Tensor


def da_init(step_size, device=None) -> DualAveragingState:
    """``step_size`` a number or a 0-d tensor (the averaged step of a
    previous window, left on the device)."""
    step = torch.as_tensor(step_size, dtype=torch.float32, device=device)
    zero = torch.zeros((), device=step.device)
    return DualAveragingState(torch.log(step), torch.log(step), zero, zero, torch.log(10.0 * step))


def da_update(
    state: DualAveragingState,
    accept_prob: torch.Tensor,
    target: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DualAveragingState:
    count = state.count + 1.0
    w = 1.0 / (count + t0)
    grad_avg = (1.0 - w) * state.grad_avg + w * (target - accept_prob)
    log_step = state.mu - torch.sqrt(count) / gamma * grad_avg
    eta = count**-kappa
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_avg, count, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor  # (d,)
    m2: torch.Tensor  # (d,)
    count: int  # samples merged so far, a host value


def welford_init(dim: int, device=None) -> WelfordState:
    return WelfordState(torch.zeros(dim, device=device), torch.zeros(dim, device=device), 0)


def welford_update_batch(state: WelfordState, batch: torch.Tensor) -> WelfordState:
    """Merge a (B, d) batch into the running estimate (Chan et al. merge).
    The count's ratios are exact float32 values, as the reference's."""
    b = batch.shape[0]
    bmean = torch.mean(batch, dim=0)
    bm2 = torch.sum((batch - bmean) ** 2, dim=0)
    delta = bmean - state.mean
    total = state.count + b
    denom = max(total, 1)
    mean = state.mean + delta * (b / denom)
    m2 = state.m2 + bm2 + delta**2 * float(state.count) * float(b) / float(denom)
    return WelfordState(mean, m2, total)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    n = float(state.count)
    var = state.m2 / max(n - 1.0, 1.0)
    if regularize:  # Stan's shrinkage toward unit scale
        shrink = torch.tensor(1e-3, dtype=torch.float32) * (5.0 / (n + 5.0))
        var = (n / (n + 5.0)) * var + float(shrink)
    return var


def build_schedule(num_steps: int, init_buffer=75, term_buffer=50, first_window=25):
    """(is_slow, is_window_end) boolean numpy arrays of length num_steps."""
    is_slow = np.zeros(num_steps, bool)
    is_end = np.zeros(num_steps, bool)
    if num_steps < 20:
        return is_slow, is_end
    if init_buffer + first_window + term_buffer > num_steps:
        init_buffer = max(num_steps // 4, 1)
        term_buffer = max(num_steps // 4, 1)
        first_window = num_steps - init_buffer - term_buffer
    pos = init_buffer
    window = first_window
    while pos < num_steps - term_buffer:
        end = min(pos + window, num_steps - term_buffer)
        # final window absorbs a too-small remainder
        if num_steps - term_buffer - end < window * 2 and end != num_steps - term_buffer:
            end = num_steps - term_buffer
        is_slow[pos:end] = True
        is_end[end - 1] = True
        pos = end
        window *= 2
    return is_slow, is_end


def window_adaptation(
    kernel: Callable,
    init_fn: Callable,
    num_steps: int,
    initial_step_size: float = 0.1,
    target_acceptance: float = 0.8,
    adapt_mass: bool = True,
):
    """Adapt (step_size, diagonal inverse mass) for an ensemble kernel.

    ``kernel(chain_state, step_size, inverse_mass, noise) -> (state, info)``
    with ``info.acceptance_rate`` (B,); ``init_fn(positions)`` gives the
    chain state. Returns ``run(positions, noises)``, ``noises`` one noise
    tuple a step, which gives (last_state, (step_size, inverse_mass),
    per-step mean acceptance). The schedule is known on the host, so slow
    and end steps are Python branches."""
    is_slow, is_end = build_schedule(num_steps)

    def run(positions: torch.Tensor, noises):
        dim, dev = positions.shape[-1], positions.device
        state = init_fn(positions)
        da, wf = da_init(initial_step_size, dev), welford_init(dim, dev)
        inv_mass = torch.ones(dim, device=dev)
        accs = []
        for i in range(num_steps):
            state, info = kernel(state, torch.exp(da.log_step), inv_mass, *noises[i])
            mean_acc = torch.mean(info.acceptance_rate)
            da = da_update(da, mean_acc, target_acceptance)
            if adapt_mass:
                if is_slow[i]:
                    wf = welford_update_batch(wf, state.position)
                if is_end[i]:  # a window's end: new mass, fresh Welford, re-anchored step
                    inv_mass = welford_variance(wf)
                    wf = welford_init(dim, dev)
                    da = da_init(torch.exp(da.log_step_avg))
            accs.append(mean_acc)
        return state, (torch.exp(da.log_step_avg), inv_mass), torch.stack(accs)

    return run
