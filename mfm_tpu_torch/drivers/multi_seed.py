"""Seeds as one program (counterpart of ``mfm_tpu.drivers.multi_seed``).

The reference replicates a benchmark over its seeds by ``jax.vmap`` of the
whole training run, because one small-seed run does not fill the chip. On
the card every run waits on host dispatch, so the seed axis matters more:
``run_mfm_seeds`` carries the S seeds' ensembles as S B rows through the
same launches (``build_mfm`` with one init generator a seed), so a launch
does S times the work of one seed's.

Seed s of a sweep computes what ``run_mfm`` computes at ``cfg.seed = s``:
it draws from the same generators, ``init_generator(s)`` for the net and
``make_generator(device, s, stream)`` for the rest, one a seed; the
reference has the same property (``single_seed`` splits ``PRNGKey(seed)``
as ``run_mfm`` does). ``seed_run`` gives one seed of a sweep as an
``MFMRun``, with its own evaluation transport.
"""

from typing import Callable, NamedTuple, Sequence

import torch
from torch.utils._pytree import tree_map

from mfm_tpu_torch.drivers.mfm import (
    MFMRun,
    WARM_STREAM,
    build_mfm,
    eval_transport,
    init_generator,
    make_generator,
    train_loop,
)
from mfm_tpu_torch.kernels import ChainState
from mfm_tpu_torch.targets.base import Target
from mfm_tpu_torch.flows.train import TrainState


class SeedSweep(NamedTuple):
    positions: torch.Tensor  # (S, n_chain, d) final chain positions
    params: dict  # per-seed flow parameters, leading S axis
    fourier: torch.Tensor  # (S, F) per-seed frequencies
    beta: torch.Tensor  # (S,)
    metrics: dict  # (S, n_iter) per iteration
    train_time: float  # all seeds together
    train: TrainState  # the stacked train state (parameters and AdamW moments)
    chain: ChainState  # the final chains on S n_chain seed-major rows
    net: torch.nn.Module  # the field's structure
    binder: Callable  # (net, freqs) -> one net's tangent field
    ref_dist: Target


def run_mfm_seeds(target: Target, cfg, seeds: Sequence[int], device="cuda") -> SeedSweep:
    """Train every seed of ``seeds`` in one seed-batched loop
    (``drivers.mfm.train_loop``: its warm-up, then the timed loop; no
    checkpoints). ``cfg.seed`` is not read."""
    if cfg.checkpoint_dir is not None:
        raise ValueError("run_mfm_seeds takes no checkpoint_dir; run_mfm resumes one seed")
    seeds = list(seeds)
    pieces = build_mfm(target, cfg, device, [init_generator(s) for s in seeds])
    gens = [make_generator(device, s) for s in seeds]
    init = torch.cat([target.init_positions(g, cfg.num_chain) for g in gens])
    carry = pieces.init_fn(init)
    warm = [make_generator(device, s, WARM_STREAM) for s in seeds]
    carry, metrics, train_time = train_loop(pieces, cfg, device, carry, gens, warm)
    S = len(seeds)
    return SeedSweep(
        carry.chain.position.unflatten(0, (S, cfg.num_chain)), carry.train.params,
        pieces.fourier, carry.beta, metrics, train_time, carry.train, carry.chain,
        pieces.net, pieces.binder, pieces.ref_dist,
    )


def seed_run(sweep: SeedSweep, cfg, s: int) -> MFMRun:
    """Seed ``s`` (an index into the sweep) as an ``MFMRun``: its parameters,
    chains and level, the evaluation transport of its own net (its own
    frequencies), and the sweep's ``train_time`` shared out evenly."""
    S = sweep.fourier.shape[0]
    train = tree_map(lambda v: v[s], sweep.train)
    rows = slice(s * cfg.num_chain, (s + 1) * cfg.num_chain)
    chain = ChainState(*(v[rows] for v in sweep.chain))
    metrics = {k: v[s] for k, v in sweep.metrics.items()}
    transport = eval_transport(cfg, sweep.binder(sweep.net, sweep.fourier[s]))
    return MFMRun(train, chain, sweep.beta[s], metrics, sweep.train_time / S, transport,
                  sweep.ref_dist, sweep.net)
