"""Markovian score climbing (MSC) with the CIS kernel (counterpart of
``mfm_tpu/adaptation/msc.py``).

Cross-chain adaptation: each step refits the flow on the chain positions
(``loss_fn``) or on a stochastic objective (``stochastic_loss``), then
refreshes the chains by conditional importance sampling through the
refitted flow.

The stochastic objective's randomness depends on the step alone, as the
reference's ``fold_in(PRNGKey(0), step)`` does: the step's loss calls draw
from a generator on the chains' device seeded with the step number, the
same in every run (``step_generator``). The values are not the reference's
stream.
"""

from typing import Callable, Optional

import torch

from mfm_tpu_torch.adaptation import chain_adaptation
from mfm_tpu_torch.adaptation.optimize import optimize
from mfm_tpu_torch.kernels import cis
from mfm_tpu_torch.kernels.base import AdaptationAlgorithm, stack, step_noise


def step_generator(step: int, device) -> torch.Generator:
    """The stochastic loss's generator at ``step``: a function of the step
    (and the device) only."""
    return torch.Generator(device=device).manual_seed(step)


def msc(
    logprob_fn: Callable,
    optimizer,
    init_params,
    flow: Callable,
    loss_fn: Callable,
    num_chain: int,
    num_steps: int = 1000,
    n_opt_iter: int = 1,
    num_importance_samples: int = 1,
    stochastic_loss: Optional[Callable] = None,
) -> AdaptationAlgorithm:
    """MSC warmup; ``run(noise, pullback_positions)`` returns
    ``(last_state, kernel, params, infos)``, the infos stacked over steps.

    ``flow(u, params) -> (x, logdet)``, batched. ``loss_fn(params,
    positions)``, or ``stochastic_loss(positions) -> loss(params, gen)``,
    whose ``gen`` is ``step_generator(step, device)``. ``noise`` is a generator or
    a sequence of ``num_steps`` ``cis.CISNoise``.
    """
    kernel = cis.build_kernel(num_importance_samples)

    def kernel_factory(params, opt_state):
        def kernel_fn(noise, state):
            return kernel(state, logprob_fn, lambda u: flow(u, params), noise)

        return kernel_fn

    def parameter_gn(states, step, params, opt_state):
        if stochastic_loss is None:
            (params, opt_state), _ = optimize(
                params, opt_state, loss_fn, optimizer, n_opt_iter, positions=states.position)
        else:
            (params, opt_state), _ = optimize(
                params, opt_state, stochastic_loss(states.position), optimizer, n_opt_iter,
                noise=step_generator(step, states.position.device))
        return params, opt_state

    init_adapt, update = chain_adaptation.cross_chain(kernel_factory, parameter_gn, num_chain)
    params0 = (init_params, optimizer.init(init_params))

    def run(noise, pullback_positions):
        state, params, infos = init_adapt(cis.init(pullback_positions)), params0, []
        for k in range(num_steps):
            state, params, info = update(step_noise(noise, k), state, *params)
            infos.append(info)
        final_params = parameter_gn(state.states, state.step, *params)
        return state, kernel_factory(*final_params), final_params[0], stack(infos)

    return AdaptationAlgorithm(run)
