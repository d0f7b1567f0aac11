"""ATESS: adaptive transport elliptical slice sampling warmup (counterpart
of ``mfm_tpu/adaptation/atess.py``).

TESS ensemble moves alternate with flow-parameter optimisation on the
chains' positions, cross-chain or by parallel ECA. ``flow(u, params) ->
(x, logdet)`` is a batched callable with logdet = log|det dx/du|, and
``loss_fn(params, positions)`` a scalar flow-fit loss. The two are the
caller's: on the card the move's transport can run on the fused field
kernel, while the loss, which needs a gradient through a transport, runs
on the module field (``flows/cnf.py``).

``mesh`` shards the batches of parallel ECA over its ``ensemble`` axis
(``mfm_tpu/adaptation/atess.py:31,75``; ``chain_adaptation.parallel_eca``).
Cross-chain adaptation has no sharded path and refuses a mesh.
"""

from typing import Callable

from mfm_tpu_torch.adaptation import chain_adaptation
from mfm_tpu_torch.adaptation.optimize import optimize
from mfm_tpu_torch.kernels import tess
from mfm_tpu_torch.kernels.base import AdaptationAlgorithm, stack, step_noise


def base(
    kernel_factory: Callable,
    optimizer,
    loss_fn: Callable,
    num_batch: int,
    batch_size: int,
    n_opt_iter: int = 10,
    eca: bool = True,
    mesh=None,
):
    """The adaptation loop ATESS and MSC share: ``(init, update, final)``."""
    if mesh is not None and not eca:
        raise ValueError("a mesh shards parallel ECA's batches; cross-chain adaptation "
                         "(eca=False) has no sharded path")

    def parameter_gn(batch_state, step, params, opt_state):
        (params, opt_state), _ = optimize(
            params, opt_state, loss_fn, optimizer, n_opt_iter, positions=batch_state.position)
        return params, opt_state

    if eca:
        init, update = chain_adaptation.parallel_eca(
            kernel_factory, parameter_gn, num_batch, batch_size, mesh)
    else:
        init, update = chain_adaptation.cross_chain(
            kernel_factory, parameter_gn, num_batch * batch_size)

    def final(last_state, param_state):
        if eca:
            return None, None
        params = parameter_gn(last_state.states, last_state.step, *param_state)
        return kernel_factory(*params), params[0]

    return init, update, final


def atess(
    logprob_fn: Callable,
    optimizer,
    init_params,
    flow: Callable,
    loss_fn: Callable,
    num_batch: int,
    batch_size: int,
    num_steps: int = 1000,
    n_opt_iter: int = 1,
    eca: bool = False,
    mesh=None,
) -> AdaptationAlgorithm:
    """Warmup whose ``run(noise, pullback_positions)`` returns
    ``(last_state, kernel, params)``: the refitted kernel and parameters
    without ``eca``; ``None`` and the stacked per-batch (params, opt_state)
    with it.

    ``pullback_positions`` is (num_batch * batch_size, d), or (num_batch,
    batch_size, d) with ``eca``. ``noise`` is a generator, or a sequence of
    ``num_steps`` per-step noises: a ``tess.TESSNoise`` each without
    ``eca``, a sequence of ``num_batch`` of them with it. Under ``mesh``
    (with ``eca``) the positions are this rank's batches and the noise is
    injected; the returned parameters are its batches'.
    """
    kernel = tess.build_kernel()

    def kernel_factory(params, opt_state):
        def kernel_fn(noise, state):
            return kernel(state, logprob_fn, lambda u: flow(u, params), noise)

        return kernel_fn

    init_adapt, update, final = base(
        kernel_factory, optimizer, loss_fn, num_batch, batch_size, n_opt_iter, eca, mesh)
    one = (init_params, optimizer.init(init_params))
    # with eca, one copy of the params and the optimizer state for each batch
    ens = chain_adaptation.ensemble_mesh(mesh, num_batch)
    n_local = num_batch if ens is None else num_batch // ens.size
    params0 = stack([one] * n_local) if eca else one

    def run(noise, pullback_positions):
        state, params = init_adapt(tess.init(pullback_positions)), params0
        for k in range(num_steps):
            state, params, _ = update(step_noise(noise, k), state, *params)
        kernel_fn, fitted = final(state, params)
        return state, kernel_fn, params if eca else fitted

    return AdaptationAlgorithm(run)
