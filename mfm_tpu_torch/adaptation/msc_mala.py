"""Markovian score climbing with MALA-refreshed flow proposals
(counterpart of ``mfm_tpu/adaptation/msc_mala.py``).

Each step refits the flow on the chain positions, then draws fresh
positions by pushing reference noise through the refitted flow (one
batched transport) and runs ``num_mala_samples`` ensemble MALA steps from
them (``kernels/mala.py``). The kernel returns the MALA infos stacked over
those steps, as the reference's scan does.
"""

from typing import Callable, List, NamedTuple

import torch

from mfm_tpu_torch.adaptation import chain_adaptation
from mfm_tpu_torch.adaptation.optimize import optimize
from mfm_tpu_torch.kernels import mala
from mfm_tpu_torch.kernels.base import AdaptationAlgorithm, draw, stack, step_noise


class MSCMalaNoise(NamedTuple):
    init: torch.Tensor  # (B, d) standard normal: the reference draws pushed forward
    mala: List[mala.MalaNoise]  # one a MALA step


def draw_noise(gen: torch.Generator, B: int, d: int, num_mala_samples: int) -> MSCMalaNoise:
    init = torch.randn((B, d), generator=gen, device=gen.device)
    return MSCMalaNoise(init, [mala.draw_noise(gen, B, d) for _ in range(num_mala_samples)])


def msc_mala(
    value_and_score: Callable,
    optimizer,
    init_params,
    flow: Callable,
    loss_fn: Callable,
    num_chain: int,
    step_size: float,
    num_steps: int = 1000,
    n_opt_iter: int = 1,
    num_mala_samples: int = 1,
) -> AdaptationAlgorithm:
    """``value_and_score``: batched (B, d) -> ((B,), (B, d)) of the target.
    ``run(noise, positions)`` returns ``(last_state, kernel, params,
    infos)``; ``noise`` is a generator or a sequence of ``num_steps``
    ``MSCMalaNoise``."""
    mala_kernel = mala.build_kernel(value_and_score)

    def kernel_factory(params, opt_state):
        def kernel_fn(noise, state):
            B, d = state.position.shape
            noise = draw(noise, lambda g: draw_noise(g, B, d, num_mala_samples))
            fresh = mala.init(flow(noise.init, params)[0], value_and_score)
            infos = []
            for n in noise.mala:
                fresh, info = mala_kernel(fresh, step_size, n.noise, n.u_accept)
                infos.append(info)
            return fresh, stack(infos)

        return kernel_fn

    def parameter_gn(states, step, params, opt_state):
        (params, opt_state), _ = optimize(
            params, opt_state, loss_fn, optimizer, n_opt_iter, positions=states.position)
        return params, opt_state

    init_adapt, update = chain_adaptation.cross_chain(kernel_factory, parameter_gn, num_chain)
    params0 = (init_params, optimizer.init(init_params))

    def run(noise, positions):
        state, params, infos = init_adapt(mala.init(positions, value_and_score)), params0, []
        for k in range(num_steps):
            state, params, info = update(step_noise(noise, k), state, *params)
            infos.append(info)
        final_params = parameter_gn(state.states, state.step, *params)
        return state, kernel_factory(*final_params), final_params[0], stack(infos)

    return AdaptationAlgorithm(run)
