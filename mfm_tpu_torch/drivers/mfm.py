"""The MFM training driver (counterpart of ``mfm_tpu.drivers.mfm``).

Each iteration: one interleaved data move for the whole ensemble (an MCMC
step of ``cfg.mcmc_kernel``, MALA, HMC or NUTS, or a flow kernel through the
CNF every ``mcmc_per_flow_steps + 1`` iterations: pullback random-walk MH,
independence MH or CIS by ``num_importance_samples``), one flow-matching
gradient step with the hand-written AdamW, and ESS-bisection tempering while
beta < 1. After training, ``sample_flow_parts`` pushes reference draws
through the transport and importance-resamples them.

In-loop adaptation (``mfm_tpu/drivers/mfm.py:206-277,298-333``; on by
default for hmc and nuts): the step size by dual averaging on the
ensemble's mean acceptance, the diagonal inverse mass by Welford over
pooled positions, refreshed every ``mass_refresh_every`` MCMC steps
(counted through the Welford count) with the step re-anchored, and both
frozen after ``adapt_freeze_fraction * learning_iter`` iterations. Whether
an iteration is frozen or refreshes is known on the host from the
counters; the step size stays on the device.

The reference scans the loop on device; here it is a Python loop over
chunks, with the iteration's kind decided on the host from the counter.
Randomness is injected: ``step_fn`` takes the iteration's noise (the MCMC
kernel's noise tuple or the flow kernel's, and ``FMNoise``) and
``draw_step_noise`` draws it from a ``torch.Generator``. Parameters are a ``{name: tensor}``
dict carried in the state, as the reference carries its flax tree.

After training, ``sample_flow_move`` adds self-tuning MALA moves to the
IS-resampled set, and ``sample_flow_defensive`` draws through a defensive
mixture with a wide Gaussian.

A seed sweep (``drivers.multi_seed``, the reference's ``jax.vmap`` of
the whole run) is the same step with a seed axis: ``build_mfm`` given one
init generator a seed carries S ensembles of B chains as S B seed-major
rows (seed s owns rows s B ... s B + B - 1) through one move, one
transport (``flows.cnf``'s seed binders) and one score gate; the
parameters, optimizer state, tempering level and adaptation state have a
leading seed axis, the flow-matching gradient and the AdamW update run
under ``torch.func.vmap`` over seeds, and each seed's metrics are its own.
The interleave, the freeze and the mass refresh depend only on the shared
counter and stay host decisions; tempering is one host check (some seed
below 1) and a per-seed select.

``run_mfm`` resumes from ``cfg.checkpoint_dir`` and saves there every
``checkpoint_every_chunks`` chunks (``utils.checkpoint``): the carry and
the state of the noise generator, which fix the rest of the run.

Under a chain mesh (``cfg.mesh_shape``, ``mfm_tpu/drivers/mfm.py:423-436``;
``parallel.mesh``) each rank is one process with its rows of the
ensemble and a full copy of the flow state, and every reduction over
chains that XLA inserts in the reference is an explicit collective:

- the flow-matching loss is a sum over the batch, so the gradients and
  the loss are all-reduced summed, flattened into one buffer an
  iteration; the non-finite skip is decided on the reduced gradient, so
  every rank skips together and the parameters never part;
- the acceptances are gathered (N scalars) for the dual averaging and
  the metrics, the log-likelihoods (N scalars) for each tempering
  bisection, so every rank solves the same beta on the same data;
- Welford pools the positions of all ranks (two all-reduces of d floats);
- the OT coupling gathers positions and reference draws (``flows.losses``).

Each rank draws the iteration's global noise from the same generator and
keeps its rows (``shard_noise``), so a sharded run equals the one-process
run up to the order of the reductions. ``run_mfm`` checkpoints each
rank's rows apart and returns the gathered chain on every rank.
"""

import math
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.func import functional_call, grad_and_value, vmap
from torch.utils._pytree import tree_map

from mfm_tpu_torch.adaptation.window import (
    da_init,
    da_update,
    welford_init,
    welford_update_batch,
    welford_variance,
)
from mfm_tpu_torch.drivers.smc_run import _make_kernel_builder
from mfm_tpu_torch.flows import (
    FlowTarget,
    VectorFieldNet,
    adamw_finite,
    apply_gradients,
    cond_fm_sample,
    create_train_state,
    draw_probe,
    field_params,
    flow_matching_loss,
    flow_noise_sampler,
    fm_sample,
    kernel_tangent_field,
    make_lr_schedule,
    make_transport,
    module_tangent_field,
    select_flow_kernel,
)
from mfm_tpu_torch.flows.cnf import EXACT_DISC_MAX_D
from mfm_tpu_torch.flows.flow_mh import CisNoise, IndepNoise, RwmNoise  # noqa: F401
from mfm_tpu_torch.flows.train import TrainState
from mfm_tpu_torch.flows.vector_field import PRECISIONS, make_vector_field
from mfm_tpu_torch.kernels import ChainState, mala
from mfm_tpu_torch.kernels.mala import MalaNoise
from mfm_tpu_torch.kernels.nuts import NUTSNoise
from mfm_tpu_torch.ops.field import ACTIVATIONS, check_fits, field_layout
from mfm_tpu_torch.parallel.mesh import ChainMesh, make_mesh, shard_chains
from mfm_tpu_torch.smc.solvers import bisection
from mfm_tpu_torch.targets import make_ref_dist
from mfm_tpu_torch.targets.base import PriorReference, Target
from mfm_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


class MFMCarry(NamedTuple):
    chain: ChainState
    train: TrainState
    beta: torch.Tensor
    # in-loop adaptation (None when off): dual-averaging state, Welford mass
    # accumulator, diagonal inverse mass; one for the whole ensemble (one a
    # seed in a sweep)
    da: object = None
    wf: object = None
    inv_mass: Optional[torch.Tensor] = None


class MFMRun(NamedTuple):
    train: TrainState
    chain: ChainState
    beta: torch.Tensor
    metrics: dict  # per-iteration tensors
    train_time: float
    transport: object
    ref_dist: Target
    net: VectorFieldNet


class FMNoise(NamedTuple):
    t: torch.Tensor  # (B,) uniform
    x0: Optional[torch.Tensor]  # (B, d) reference draws (conditional path)
    eps: torch.Tensor  # (B, d) standard normal
    ot_u: Optional[torch.Tensor] = None  # (B,) uniform: the OT pair choice


class MFMPieces(NamedTuple):
    step_fn: Callable  # (carry, count, move_noise, fm_noise) -> (carry, metrics)
    init_fn: Callable  # init_positions -> carry
    draw_step_noise: Callable  # (generator, count) -> (move_noise, fm_noise)
    net: VectorFieldNet
    transport: object
    ref_dist: Target
    loss_fn: Callable  # (params, samples, fm_noise) -> loss
    lr_fn: Callable
    tx: object  # the optimizer (flows.train.GradientTransformation)
    field_bind: Callable  # the transport's tangent field (cnf.make_transport)
    fourier: torch.Tensor = None  # (F,), or (S, F) for a seed sweep
    binder: Callable = None  # (net, freqs) -> a tangent field (a binder of flows.cnf)
    mesh: Optional[ChainMesh] = None  # the chain mesh, or None for one process


class SeedAxis(NamedTuple):
    """Where a seed sweep's per-seed values meet its S B chain rows
    (seed-major); ``S`` None is one run with no seed axis."""

    S: Optional[int]
    B: int

    def rows(self, v, n: Optional[int] = None):
        """A per-seed value (S, ...) repeated over its seed's rows: B of
        them, or n / S of n seed-major rows (CIS's S B N candidates)."""
        if self.S is None or not isinstance(v, torch.Tensor):
            return v
        return v.repeat_interleave(self.B if n is None else n // self.S, dim=0)

    def split(self, v):
        """Per-row values (S B, ...) as (S, B, ...)."""
        return v if self.S is None else v.unflatten(0, (self.S, self.B))


def stack_trees(trees):
    """One tree of tensors stacked on a new leading axis from S alike trees;
    a leaf that is not a tensor (None, a Welford count) is shared and taken
    from the first."""
    return tree_map(lambda *vs: torch.stack(vs) if isinstance(vs[0], torch.Tensor) else vs[0],
                    *trees)


def cat_rows(noises):
    """S seeds' noise tuples (B rows each) as one on S B seed-major rows:
    along the chain axis, which is the last one of NUTS's (depth, B)
    uniforms and the first one elsewhere."""
    first = noises[0]
    out = []
    for name, v in zip(first._fields, zip(*noises)):
        if v[0] is None:
            out.append(None)
            continue
        dim = -1 if isinstance(first, NUTSNoise) and name != "eps" else 0
        out.append(torch.cat(v, dim=dim))
    return type(first)(*out)


def _vmap_dims(tree):
    """in_dims for ``torch.func.vmap`` over the leading axis of every tensor
    of ``tree`` (None for its None leaves)."""
    return tree_map(lambda v: None if v is None else 0, tree)


def ess_of(logw: torch.Tensor) -> torch.Tensor:
    """ESS of the weights over the last axis (one a seed for (S, B))."""
    w = torch.softmax(logw, dim=-1)
    return 1.0 / torch.sum(w * w, dim=-1)


def next_beta(prev_beta, logliks, alpha: float, n_chain: int, n_iters: int = 30):
    """Smallest beta in [prev_beta, 1] whose incremental weights keep
    ESS = alpha * n_chain (fixed-iteration bisection); 1 when even beta=1
    keeps the ESS above target. ``logliks`` (S, B) with ``prev_beta`` (S,)
    solves each seed's level at once, in the same 30 trips."""

    def gap(beta):
        return ess_of(logliks * (beta - prev_beta)[..., None]) - alpha * n_chain

    return bisection(gap, prev_beta, 1.0, n_iters=n_iters, device=logliks.device)


def tempered_value_and_score(target: Target) -> Callable:
    """``(x, beta) -> (logdensity, grad)`` of beta * log_lik + log_prior,
    batched: the target's own, which may be analytic (the Cox target's
    products, phi-four's K3)."""
    return target.tempered_value_and_score


def _interleave_is_flow(count: int, mcmc_per_flow_steps: float) -> bool:
    """Ratio in (0, 1): one MCMC step every int(1/ratio)+1 iterations (the
    rest flow); ratio >= 1: one flow step every int(ratio)+1 (the rest
    MCMC). Counts start at 1."""
    if 0 < mcmc_per_flow_steps < 1:
        return count % (int(1.0 / mcmc_per_flow_steps) + 1) != 0
    return count % (int(mcmc_per_flow_steps) + 1) == 0


def set_field_precision(field_precision: str) -> None:
    """Check ``field_precision`` and pin the process's fp32 products exact.

    The precision itself is a property of the net (``VectorFieldNet``'s
    ``precision``, per layer): 'highest' fp32, 'default' bf16 operands with
    fp32 accumulation. Either way, TF32 stays off for matmuls and cuDNN, so
    the targets' fp32 contractions stay exact, and cuBLAS may not reduce a
    bf16 product in reduced precision."""
    if field_precision not in PRECISIONS:
        raise ValueError(
            f"field_precision must be one of {PRECISIONS}, got {field_precision!r}"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def mesh_of(cfg, device, mesh: Optional[ChainMesh] = None) -> Optional[ChainMesh]:
    """The run's chain mesh: ``mesh``, or one of ``cfg.mesh_shape`` over the
    initialised process group (refused by name where there is none of that
    size); None for one process. ``cfg.num_chain`` must split evenly, which
    is checked here, on every rank, before the first collective."""
    if mesh is None and cfg.mesh_shape is not None:
        mesh = make_mesh(tuple(cfg.mesh_shape), device=device)
    if mesh is None:
        return None
    if cfg.mesh_shape is not None and tuple(cfg.mesh_shape) != mesh.shape:
        raise ValueError(f"mesh_shape {tuple(cfg.mesh_shape)} is not the mesh's {mesh.shape}")
    if cfg.num_chain % mesh.size:
        raise ValueError(f"num_chain={cfg.num_chain} does not split over the {mesh.size} "
                         f"ranks of mesh {mesh.shape}")
    return mesh


def shard_noise(noise, mesh: Optional[ChainMesh], B: int):
    """This rank's rows of one iteration's noise drawn for all ``B`` chains
    (a tensor or a noise tuple): along the chain axis, the last one of
    NUTS's (depth, B) uniforms and the first one elsewhere, k rows a chain
    where a field has k B of them (CIS's B N candidates, chain-major)."""
    if mesh is None or noise is None:
        return noise
    rows = mesh.rows(B)

    def cut(v, dim):
        k = v.shape[dim] // B
        return v.narrow(dim, rows.start * k, (rows.stop - rows.start) * k).contiguous()

    if isinstance(noise, torch.Tensor):
        return cut(noise, 0)
    nuts = isinstance(noise, NUTSNoise)
    return type(noise)(*(None if v is None else cut(v, -1 if nuts and name != "eps" else 0)
                         for name, v in zip(noise._fields, noise)))


def reference_of(target: Target, cfg, device) -> Target:
    """The flow's reference distribution ``cfg.ref_dist`` (``prior``: the
    target's own prior; raises if it has no sampler)."""
    if cfg.ref_dist == "prior":
        return PriorReference(target)
    return make_ref_dist(cfg.ref_dist, cfg.dim, device)


def build_mfm(
    target: Target, cfg, device, init_generator, mesh: Optional[ChainMesh] = None
) -> MFMPieces:
    """Construct the pieces of an MFM run. ``init_generator`` (on the CPU)
    draws the Fourier frequencies and the initial weights; a sequence of
    them, one a seed, builds a seed sweep (the module docstring): its
    ``step_fn`` carries every seed, ``init_fn`` takes the S B seed-major
    initial rows and ``draw_step_noise`` one generator a seed, each drawn
    as a run of that seed alone draws.

    Under a chain mesh (``mesh``, or ``cfg.mesh_shape`` over the
    initialised process group) ``init_fn`` and ``step_fn`` take this
    rank's rows and ``draw_step_noise`` returns them."""
    set_field_precision(cfg.field_precision)
    if cfg.divergence == "exact_disc" and cfg.dim > EXACT_DISC_MAX_D:
        raise ValueError(
            f"divergence_mode='exact_disc' is for d <= {EXACT_DISC_MAX_D} (a (B, d, d) "
            f"Jacobian), got dim={cfg.dim}"
        )
    use_real_samples = cfg.mcmc_per_flow_steps < 0
    B, d = cfg.num_chain, cfg.dim
    swept = not isinstance(init_generator, torch.Generator)
    mesh = mesh_of(cfg, device, mesh)
    if swept and mesh is not None:
        raise ValueError("a seed sweep under a chain mesh is not a path: run the seeds "
                         "one by one under the mesh, or the sweep in one process")
    gens = list(init_generator) if swept else [init_generator]
    axis = SeedAxis(len(gens) if swept else None, B)
    gather = (lambda v: v) if mesh is None else mesh.all_gather_rows

    nets = []
    for gen in gens:
        nets.append(make_vector_field(
            gen, d, target.score, cfg.hidden_x, cfg.hidden_t, cfg.hidden_xt, cfg.fourier_dim,
            cfg.fourier_std, cfg.non_linearity, cfg.score_clip, cfg.field_precision,
            score_gate=target.score_gate,  # the transport's: fused where the target has it
            device=device,
        )[0])
    net = nets[0]  # the structure; a sweep's parameters and frequencies are stacked
    fourier = (torch.stack([n.fourier_freqs for n in nets]) if swept else net.fourier_freqs)

    # pallas_field asks for the fused kernel: a net it cannot take is refused
    # (the reference falls back to its flax path; the port never falls back)
    if cfg.pallas_field:
        if cfg.field_precision != "highest":
            raise ValueError(
                "pallas_field: the fused field computes in exact fp32 only, got "
                f"field_precision={cfg.field_precision!r}; set pallas_field=false "
                "or field_precision=highest"
            )
        if cfg.non_linearity not in ACTIVATIONS:
            raise ValueError(
                f"pallas_field: the fused field supports activations {ACTIVATIONS}, "
                f"got {cfg.non_linearity!r}; set pallas_field=false"
            )
        check_fits(field_layout(dict(net.named_parameters()), cfg.fourier_dim))
        binder = kernel_tangent_field
    else:
        binder = module_tangent_field
    bind = binder(net, fourier if swept else None)
    transport = make_transport(
        bind, divergence=cfg.divergence, n_steps=cfg.ode_steps, method=cfg.ode_method
    )
    ref_dist = reference_of(target, cfg, device)
    lr_fn = make_lr_schedule(cfg.learning_iter, cfg.warmup_steps, cfg.learning_rate)
    tx = adamw_finite(
        lr_fn, weight_decay=cfg.weight_decay, b1=cfg.adam_beta1, b2=cfg.adam_beta2,
        eps=cfg.adam_epsilon, gradient_clip=cfg.gradient_clip,
    )
    vs_fn = target.tempered_value_and_score
    mcmc_builder, draw_mcmc_noise = _make_kernel_builder(cfg)
    adapt_step, adapt_mass, target_acc = cfg.resolved_adaptation()
    adapting = adapt_step or adapt_mass
    # adaptation stays live through this iteration (counts run 1..learning_iter)
    freeze_iter = int(cfg.adapt_freeze_fraction * cfg.learning_iter)
    flow_kernel = select_flow_kernel(cfg.num_importance_samples)
    draw_flow_noise = flow_noise_sampler(cfg.num_importance_samples)
    conditional = cfg.cond_flow or cfg.ot_cond_flow

    def loss_fn(params, samples, noise: FMNoise, freqs=None, over=None):
        """One seed's loss; ``freqs`` in place of the net's own frequencies.
        ``over`` a mesh: ``samples`` and ``noise`` are this rank's rows, and
        the loss is its share of the sum."""
        if conditional:
            batch = cond_fm_sample(
                samples, noise.t, noise.x0, noise.eps, cfg.sigma,
                noise.ot_u if cfg.ot_cond_flow else None, over,
            )
        else:
            batch = fm_sample(samples, noise.t, noise.eps, cfg.sigma)
        p = params if freqs is None else {**params, "fourier_freqs": freqs}
        return flow_matching_loss(lambda x, t: functional_call(net, p, (x, t)), batch)

    if swept:
        def loss_and_grad(params, samples, noise):
            return vmap(grad_and_value(loss_fn), in_dims=(0, 0, _vmap_dims(noise), 0))(
                params, axis.split(samples), noise, fourier)

        # each seed's update on its own gradient: a non-finite one skips only
        # that seed's step and counts only in its notfinite_count
        apply_grads = vmap(lambda state, grads: apply_gradients(state, grads, tx))
    else:
        local_loss_and_grad = grad_and_value(loss_fn)

        def loss_and_grad(params, samples, noise):
            grads, loss = local_loss_and_grad(params, samples, noise, None, mesh)
            if mesh is not None:  # the loss is a sum: every rank's gradient summed
                grads, loss = mesh.all_reduce_tree((grads, loss))
            return grads, loss

        apply_grads = lambda state, grads: apply_gradients(state, grads, tx)

    def vs_at(beta):
        return lambda x: vs_fn(x, axis.rows(beta, x.shape[0]))

    def init_fn(init_positions):
        """Tempering level from the ESS rule at beta=0; chains initialised
        at that tempered target."""
        dev = init_positions.device
        lead = () if axis.S is None else (axis.S,)
        if use_real_samples:
            beta = torch.ones(lead, device=dev)
        else:
            beta = next_beta(0.0, axis.split(gather(target.log_lik(init_positions))), cfg.alpha,
                             B)
        chain = mala.init(init_positions, vs_at(beta))
        states = [create_train_state(field_params(n), tx) for n in nets]
        train = stack_trees(states) if swept else states[0]
        if not adapting:
            return MFMCarry(chain, train, beta)
        step = cfg.step_size if axis.S is None else torch.full(lead, cfg.step_size)
        return MFMCarry(chain, train, beta, da_init(step, dev), welford_init(lead + (d,), dev),
                        torch.ones(lead + (d,), device=dev))

    def step_size_of(da, count: int):
        """The step the kernel takes at iteration ``count``: the averaged one
        once frozen (one a seed in a sweep)."""
        if not adapt_step:
            return cfg.step_size
        return torch.exp(da.log_step_avg if count > freeze_iter else da.log_step)

    def update_adaptation(acc, position, da, wf, inv_mass):
        """Dual averaging on the mean acceptance; Welford over the pooled
        positions, a mass refresh (and a re-anchored step) once the Welford
        count reaches ``mass_refresh_every`` MCMC steps. Called only before
        the freeze. Each seed of a sweep on its own B chains; the count is
        the same for all."""
        if adapt_step:
            mean_acc = torch.mean(axis.split(acc), dim=-1)
            da = da_update(da, torch.nan_to_num(mean_acc, nan=0.0), target_acc)
        if adapt_mass:
            wf = welford_update_batch(wf, axis.split(position), mesh)
            if wf.count >= cfg.mass_refresh_every * B:
                inv_mass = welford_variance(wf)
                wf = welford_init(inv_mass.shape, position.device)
                da = da_init(torch.exp(da.log_step_avg))
        return da, wf, inv_mass

    def draw_one(gen: torch.Generator, count: int):
        dev = gen.device
        if use_real_samples:
            move = target.sample(gen, (B,))
        elif _interleave_is_flow(count, cfg.mcmc_per_flow_steps):
            move = draw_flow_noise(gen, transport, ref_dist.sample, B, d)
        else:
            move = draw_mcmc_noise(gen, B, d)
        fm = FMNoise(
            torch.rand(B, generator=gen, device=dev),
            ref_dist.sample(gen, (B,)) if conditional else None,
            torch.randn((B, d), generator=gen, device=dev),
            torch.rand(B, generator=gen, device=dev) if cfg.ot_cond_flow else None,
        )
        return move, fm

    def draw_step_noise(gen, count: int):
        """The iteration's (move noise, FMNoise): from one generator, or
        from one a seed (``gen`` a sequence), each seed's drawn as its own
        run draws them, the move's on S B rows and the FMNoise (S, B, ...).
        Under a mesh: this rank's rows of the draws for all B chains."""
        if not swept:
            return tuple(shard_noise(v, mesh, B) for v in draw_one(gen, count))
        moves, fms = zip(*(draw_one(g, count) for g in gen))
        move = torch.cat(moves) if use_real_samples else cat_rows(moves)
        return move, stack_trees(fms)

    def data_step(carry: MFMCarry, count, noise):
        """(chain, acceptance, da, wf, inv_mass) after the iteration's move;
        the acceptance of every chain (of every rank under a mesh)."""
        chain, da, wf, inv_mass = carry.chain, carry.da, carry.wf, carry.inv_mass
        if use_real_samples:
            zeros = torch.zeros(noise.shape[0], device=noise.device)
            rows = noise.shape[0] * (1 if mesh is None else mesh.size)  # every rank's
            nan = torch.full((rows,), torch.nan, device=noise.device)
            return ChainState(noise, zeros, torch.zeros_like(noise)), nan, da, wf, inv_mass
        vs = vs_at(carry.beta)
        if _interleave_is_flow(count, cfg.mcmc_per_flow_steps):
            tgt = FlowTarget(vs, ref_dist.log_prob, ref_dist.sample)
            new, info = flow_kernel(chain, carry.train.params, transport, tgt, *noise)
            return new, gather(info.acceptance_rate), da, wf, inv_mass
        step = step_size_of(da, count)
        if axis.S is not None and isinstance(step, torch.Tensor):
            step = axis.rows(step)[:, None]
        kernel = mcmc_builder(vs, (step, axis.rows(inv_mass)))
        new, info = kernel(chain, noise)
        acc = gather(info.acceptance_rate)
        if adapting and count <= freeze_iter:
            da, wf, inv_mass = update_adaptation(acc, new.position, da, wf, inv_mass)
        return new, acc, da, wf, inv_mass

    def temper_step(chain, beta):
        """The ESS rule's next level and the chains re-initialised there; in
        a sweep, seeds already at 1 keep theirs (the reference's batched
        ``lax.cond`` is the same select)."""
        new_beta = next_beta(beta, axis.split(gather(target.log_lik(chain.position))), cfg.alpha,
                             B)
        fresh = mala.init(chain.position, vs_at(new_beta))
        if axis.S is None:
            return fresh, new_beta
        live = beta < 1.0
        rows = axis.rows(live)
        chain = ChainState(*(torch.where(rows.view((-1,) + (1,) * (n.ndim - 1)), n, o)
                             for n, o in zip(fresh, chain)))
        return chain, torch.where(live, new_beta, beta)

    def step_fn(carry: MFMCarry, count: int, move_noise, fm_noise: FMNoise):
        chain, acc, da, wf, inv_mass = data_step(carry, count, move_noise)
        grads, loss = loss_and_grad(carry.train.params, chain.position, fm_noise)
        train = apply_grads(carry.train, grads)
        beta = carry.beta
        if (not use_real_samples and count % cfg.iter_per_temp == 0
                and bool((beta < 1.0).any())):
            chain, beta = temper_step(chain, beta)
        per_seed = axis.split(acc)
        mean = torch.nanmean(per_seed, dim=-1)
        metrics = {
            "loss": loss.detach(),
            "learning_rate": lr_fn(carry.train.step),
            "acceptance_mean": mean,
            "acceptance_std": torch.sqrt(torch.nanmean((per_seed - mean[..., None]) ** 2, dim=-1)),
            "beta": beta,
        }
        if adapt_step:  # after this iteration's update (the averaged one once frozen)
            metrics["step_size"] = step_size_of(da, count)
        return MFMCarry(chain, train, beta, da, wf, inv_mass), metrics

    return MFMPieces(
        step_fn=step_fn, init_fn=init_fn, draw_step_noise=draw_step_noise, net=net,
        transport=transport, ref_dist=ref_dist, loss_fn=loss_fn, lr_fn=lr_fn, tx=tx,
        field_bind=bind, fourier=fourier, binder=binder, mesh=mesh,
    )


def make_generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named stream of a seeded run."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def eval_transport(cfg, bind, default=None):
    """The evaluation-facing transport of the tangent field ``bind``: more
    or other probes, or a finer grid, where ``cfg`` asks for them; else
    ``default`` (the training transport), or one built as training builds
    it."""
    if (
        cfg.eval_hutchinson_probes != 1
        or cfg.eval_probe_dist != "gaussian"
        or cfg.eval_ode_steps is not None
    ):
        return make_transport(
            bind, divergence=cfg.divergence, n_steps=cfg.eval_ode_steps or cfg.ode_steps,
            method=cfg.ode_method, num_probes=cfg.eval_hutchinson_probes,
            probe_dist=cfg.eval_probe_dist,
        )
    if default is not None:
        return default
    return make_transport(bind, divergence=cfg.divergence, n_steps=cfg.ode_steps,
                          method=cfg.ode_method)


def train_loop(pieces: MFMPieces, cfg, device, carry: MFMCarry, gen, warm_gen,
               logger=None, eval_loss=None):
    """(carry, metrics, train_time) of ``cfg.learning_iter`` iterations of
    ``pieces.step_fn`` from ``carry``, the noise drawn from ``gen`` (one
    generator, or one a seed for a sweep). Metrics are per iteration on
    the last axis ((n,), or (S, n) for a sweep).

    Before the timed loop, a warm-up runs the first MCMC and the first flow
    iteration on the carry with ``warm_gen`` and discards the result: it
    builds the CUDA kernels and initialises the libraries, so
    ``train_time`` measures the steady loop.

    With ``cfg.checkpoint_dir``, the loop resumes from the latest
    checkpoint there and saves one every ``checkpoint_every_chunks``
    chunks: the carry and the generators' states, which fix the rest of
    the run, the chain rows in a file of their own for each rank of a
    mesh. A run resumed at or past ``learning_iter`` returns empty
    metrics."""
    gens = list(gen) if isinstance(gen, (list, tuple)) else [gen]
    n_iter = cfg.learning_iter
    chunk = max(1, min(cfg.chunk_size, n_iter))
    mesh = pieces.mesh

    def replicated_part(c):
        return (c._replace(chain=None), [g.get_state() for g in gens])

    done = 0
    if cfg.checkpoint_dir is not None:
        restored, step = restore_checkpoint(cfg.checkpoint_dir, template=replicated_part(carry),
                                            rows=carry.chain, mesh=mesh)
        if restored is not None:
            (rest, states), chain = restored
            carry = rest._replace(chain=chain)
            for g, state in zip(gens, states):
                g.set_state(state)
            done = step

    if done < n_iter:
        seen = set()
        for count in range(1, n_iter + 1):
            kind = cfg.mcmc_per_flow_steps >= 0 and _interleave_is_flow(
                count, cfg.mcmc_per_flow_steps)
            if kind not in seen:
                seen.add(kind)
                pieces.step_fn(carry, count, *pieces.draw_step_noise(warm_gen, count))
            if len(seen) == 2 or cfg.mcmc_per_flow_steps < 0:  # exact draws: one kind
                break
    _synchronize(device)

    metrics_chunks = []
    train_start = time.perf_counter()
    chunks_done = 0
    while done < n_iter:
        take = min(chunk, n_iter - done)
        rows = []
        for count in range(done + 1, done + take + 1):
            carry, m = pieces.step_fn(carry, count, *pieces.draw_step_noise(gen, count))
            rows.append(m)
        m = {k: torch.stack([r[k] for r in rows], dim=-1) for k in rows[0]}
        metrics_chunks.append(m)
        done += take
        chunks_done += 1
        if logger is not None:
            chunk_mean = {k: float(torch.mean(v)) for k, v in m.items()}
            chunk_mean["iter"] = done
            chunk_mean["train_time"] = time.perf_counter() - train_start
            if eval_loss is not None:
                chunk_mean["target_loss"] = float(eval_loss(carry.train.params))
            logger.log(chunk_mean)
        if (cfg.checkpoint_dir is not None and cfg.checkpoint_every_chunks
                and chunks_done % cfg.checkpoint_every_chunks == 0):
            save_checkpoint(cfg.checkpoint_dir, done, replicated_part(carry), rows=carry.chain,
                            mesh=mesh)
    _synchronize(device)
    train_time = time.perf_counter() - train_start
    metrics = {}
    if metrics_chunks:  # none when resumed at (or past) learning_iter
        metrics = {k: torch.cat([c[k] for c in metrics_chunks], dim=-1)
                   for k in metrics_chunks[0]}
    return carry, metrics, train_time


def run_mfm(target: Target, cfg, device="cuda", logger=None,
            mesh: Optional[ChainMesh] = None) -> MFMRun:
    """Train an MFM sampler (``train_loop``: the warm-up, the timed loop,
    checkpoints). ``logger`` (optional) gets ``log(dict)`` once per chunk
    with the chunk-mean metrics. Under a chain mesh (``mesh`` or
    ``cfg.mesh_shape``) every rank calls it together; each trains its
    rows, and each returns the gathered chain of all ranks."""
    pieces = build_mfm(target, cfg, device, torch.Generator().manual_seed(cfg.seed), mesh)
    mesh = pieces.mesh
    gen = make_generator(device, cfg.seed)
    positions = target.init_positions(gen, cfg.num_chain)
    carry = pieces.init_fn(positions if mesh is None else shard_chains(positions, mesh))

    eval_loss = None
    if logger is not None and target.can_sample:
        probe_gen = make_generator(device, cfg.seed, 7)
        n_probe = min(cfg.eval_iter * cfg.num_chain, 4096)
        probe = target.sample(probe_gen, (n_probe,))
        probe_noise = FMNoise(
            torch.rand(n_probe, generator=probe_gen, device=probe_gen.device),
            pieces.ref_dist.sample(probe_gen, (n_probe,)),
            torch.randn(probe.shape, generator=probe_gen, device=probe_gen.device),
            torch.rand(n_probe, generator=probe_gen, device=probe_gen.device)
            if cfg.ot_cond_flow else None,
        )
        eval_loss = lambda params: pieces.loss_fn(params, probe, probe_noise)

    carry, metrics, train_time = train_loop(
        pieces, cfg, device, carry, gen, make_generator(device, cfg.seed, 1), logger, eval_loss)
    chain = carry.chain if mesh is None else ChainState(*map(mesh.all_gather_rows, carry.chain))
    return MFMRun(
        carry.train, chain, carry.beta, metrics, train_time,
        eval_transport(cfg, pieces.field_bind, pieces.transport), pieces.ref_dist, pieces.net,
    )


def sample_flow_parts(
    transport, params, ref_dist: Target, target: Target, u: torch.Tensor,
    probe: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Final sampling and self-normalised IS correction of reference draws
    ``u``. Returns (flow_samples, exact_samples, log_weights)."""
    from mfm_tpu_torch.drivers.baselines import is_resample

    flow_samples, logdet = transport.forward(params, u, probe)
    logpdf = target.log_prob(flow_samples)
    log_q = ref_dist.log_prob(u) - logdet
    exact_samples, log_w = is_resample(
        flow_samples, logpdf, log_q, gumbel=gumbel, generator=generator
    )
    return flow_samples, exact_samples, log_w


def sample_flow(run: MFMRun, n_samples: int, target: Target, generator: torch.Generator):
    u = run.ref_dist.sample(generator, (n_samples,))
    probe = draw_probe(run.transport, generator, n_samples, u.shape[-1])
    return sample_flow_parts(
        run.transport, run.train.params, run.ref_dist, target, u, probe,
        generator=generator,
    )


def mala_move_correct(
    positions: torch.Tensor,
    target: Target,
    noises: Sequence[MalaNoise],
    init_step: float = 0.01,
    target_acceptance: float = 0.574,
) -> torch.Tensor:
    """Self-tuning MALA move correction of an approximate sample set, one
    move a noise: the first half adapts the step by dual averaging on the
    mean acceptance (a NaN acceptance counts as 0), the second half runs at
    the frozen averaged step exp(log_step_avg), so the kernel that produces
    the returned positions is exactly target-invariant."""
    vs = target.value_and_score
    kernel = mala.build_kernel(vs)
    n_warm = len(noises) // 2
    state = mala.init(positions, vs)
    da = da_init(init_step, positions.device)
    for noise in noises[:n_warm]:
        state, info = kernel(state, torch.exp(da.log_step), *noise)
        acc = torch.nan_to_num(torch.mean(info.acceptance_rate), nan=0.0)
        da = da_update(da, acc, target_acceptance)
    frozen = torch.exp(da.log_step_avg)
    for noise in noises[n_warm:]:
        state, _ = kernel(state, frozen, *noise)
    return state.position


def draw_move_noise(gen: torch.Generator, n_moves: int, B: int, d: int) -> List[MalaNoise]:
    return [mala.draw_noise(gen, B, d) for _ in range(n_moves)]


def sample_flow_move(
    run: MFMRun, n_samples: int, target: Target, generator: torch.Generator,
    n_moves: int = 100, init_step: float = 0.01, target_acceptance: float = 0.574,
):
    """IS-resampled flow draws, then ``n_moves`` self-tuning MALA moves on
    the exact target (``mala_move_correct``): the moves restore the
    diversity the resampling loses at high d. Returns (moved,
    IS-resampled, log-weights)."""
    _, exact, log_w = sample_flow(run, n_samples, target, generator)
    noises = draw_move_noise(generator, n_moves, n_samples, exact.shape[-1])
    moved = mala_move_correct(exact, target, noises, init_step, target_acceptance)
    return moved, exact, log_w


def defensive_split(n_samples: int, alpha: float):
    """(n_flow, n_def): round((1 - alpha) n) draws from the defensive
    component, the rest through the flow. Refuses an alpha outside (0, 1]
    and one that leaves no flow draw (the reference would run the flow on an
    empty batch and take log 0)."""
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    n_def = int(round((1.0 - alpha) * n_samples))
    if n_samples - n_def < 1:
        raise ValueError(
            f"defensive alpha={alpha} leaves no flow draw of {n_samples} (n_flow < 1)")
    return n_samples - n_def, n_def


def check_normalised(ref_dist: Target) -> None:
    """The defensive mixture adds the flow's density to a normalised
    Gaussian's, so the flow's must be normalised too: its reference's
    ``log_prob`` must be a normalised density (``Target.normalised``)."""
    if not ref_dist.normalised:
        raise ValueError(
            f"the defensive mixture needs a normalised flow reference; "
            f"{type(ref_dist).__name__}.log_prob is not (flat, or a prior not declared "
            f"normalised): choose another ref_dist or drop --defensive-alpha")


def sample_flow_defensive_parts(
    transport, params, ref_dist: Target, target: Target, u: torch.Tensor,
    x_def: torch.Tensor, defensive_dist: Target, probe: Optional[torch.Tensor] = None,
    probe_def: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """IS through the defensive mixture q = a q_flow + (1 - a) q_def: the
    reference draws ``u`` (n_flow) go through the flow, ``x_def`` (n_def)
    are draws of ``defensive_dist`` (a normalised Gaussian), whose flow
    density one ``transport.inverse`` gives; a is the realised fraction
    n_flow / n. Returns (mixture samples, flow draws first; resampled;
    log-weights)."""
    from mfm_tpu_torch.drivers.baselines import is_resample

    check_normalised(ref_dist)
    n_flow, n_def = u.shape[0], x_def.shape[0]
    if n_flow < 1:
        raise ValueError("the defensive mixture needs at least one flow draw (n_flow < 1)")
    x_f, logdet_f = transport.forward(params, u, probe)
    log_qf_f = ref_dist.log_prob(u) - logdet_f
    u_d, logdet_d = transport.inverse(params, x_def, probe_def)
    log_qf_d = ref_dist.log_prob(u_d) - logdet_d
    x = torch.cat([x_f, x_def], dim=0)
    log_qf = torch.cat([log_qf_f, log_qf_d], dim=0)
    log_qd = defensive_dist.log_prob(x)
    a_real = n_flow / (n_flow + n_def)  # the realised fraction, not the nominal alpha
    log_qmix = torch.logaddexp(math.log(a_real) + log_qf, math.log1p(-a_real) + log_qd)
    exact, log_w = is_resample(x, target.log_prob(x), log_qmix, gumbel=gumbel,
                               generator=generator)
    return x, exact, log_w


def sample_flow_defensive(
    run: MFMRun, n_samples: int, target: Target, defensive_dist: Target, alpha: float,
    generator: torch.Generator,
):
    """``sample_flow_defensive_parts`` with the split of ``defensive_split``
    and draws from ``generator``; alpha == 1 (no defensive draw) is
    ``sample_flow``."""
    n_flow, n_def = defensive_split(n_samples, alpha)
    if n_def == 0:
        return sample_flow(run, n_samples, target, generator)
    d = run.ref_dist.dim
    u = run.ref_dist.sample(generator, (n_flow,))
    probe = draw_probe(run.transport, generator, n_flow, d)
    x_def = defensive_dist.sample(generator, (n_def,))
    probe_def = draw_probe(run.transport, generator, n_def, d)
    return sample_flow_defensive_parts(
        run.transport, run.train.params, run.ref_dist, target, u, x_def, defensive_dist,
        probe, probe_def, generator=generator,
    )
