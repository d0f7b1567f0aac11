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

Not ported yet: meshes and checkpoints.
"""

import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call, grad_and_value

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
from mfm_tpu_torch.flows.vector_field import PRECISIONS
from mfm_tpu_torch.kernels import ChainState, mala
from mfm_tpu_torch.kernels.mala import MalaNoise  # noqa: F401  (re-exported)
from mfm_tpu_torch.ops.field import ACTIVATIONS, check_fits, field_layout
from mfm_tpu_torch.smc.solvers import bisection
from mfm_tpu_torch.targets import make_ref_dist
from mfm_tpu_torch.targets.base import PriorReference, Target


class MFMCarry(NamedTuple):
    chain: ChainState
    train: TrainState
    beta: torch.Tensor
    # in-loop adaptation (None when off): dual-averaging state, Welford mass
    # accumulator, diagonal inverse mass; one for the whole ensemble
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


def ess_of(logw: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(logw, dim=-1)
    return 1.0 / torch.sum(w * w)


def next_beta(prev_beta, logliks, alpha: float, n_chain: int, n_iters: int = 30):
    """Smallest beta in [prev_beta, 1] whose incremental weights keep
    ESS = alpha * n_chain (fixed-iteration bisection); 1 when even beta=1
    keeps the ESS above target."""

    def gap(beta):
        return ess_of(logliks * (beta - prev_beta)) - alpha * n_chain

    return bisection(gap, prev_beta, 1.0, n_iters=n_iters, device=logliks.device)


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


def _check_ported(cfg) -> None:
    unported = {
        "mesh_shape": cfg.mesh_shape is not None,
        "checkpoint_dir": cfg.checkpoint_dir is not None,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


def build_mfm(
    target: Target, cfg, device, init_generator: torch.Generator
) -> MFMPieces:
    """Construct the pieces of an MFM run. ``init_generator`` (on the CPU)
    draws the Fourier frequencies and the initial weights."""
    _check_ported(cfg)
    set_field_precision(cfg.field_precision)
    if cfg.divergence == "exact_disc" and cfg.dim > EXACT_DISC_MAX_D:
        raise ValueError(
            f"divergence_mode='exact_disc' is for d <= {EXACT_DISC_MAX_D} (a (B, d, d) "
            f"Jacobian), got dim={cfg.dim}"
        )
    use_real_samples = cfg.mcmc_per_flow_steps < 0
    B, d = cfg.num_chain, cfg.dim

    fourier = cfg.fourier_std * torch.randn(cfg.fourier_dim, generator=init_generator)
    net = VectorFieldNet(
        d, fourier, tuple(cfg.hidden_x), tuple(cfg.hidden_t), tuple(cfg.hidden_xt),
        act=cfg.non_linearity, score_fn=target.score, score_clip=cfg.score_clip,
        generator=init_generator, precision=cfg.field_precision,
        score_gate=target.score_gate,  # the transport's: fused where the target has it
    ).to(device)

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
        bind = kernel_tangent_field(net)
    else:
        bind = module_tangent_field(net)
    transport = make_transport(
        bind, divergence=cfg.divergence, n_steps=cfg.ode_steps, method=cfg.ode_method
    )
    if cfg.ref_dist == "prior":  # the target's own prior; raises if it has no sampler
        ref_dist = PriorReference(target)
    else:
        ref_dist = make_ref_dist(cfg.ref_dist, d, device)
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

    def loss_fn(params, samples, noise: FMNoise):
        if conditional:
            batch = cond_fm_sample(
                samples, noise.t, noise.x0, noise.eps, cfg.sigma,
                noise.ot_u if cfg.ot_cond_flow else None,
            )
        else:
            batch = fm_sample(samples, noise.t, noise.eps, cfg.sigma)
        return flow_matching_loss(lambda x, t: functional_call(net, params, (x, t)), batch)

    loss_and_grad = grad_and_value(loss_fn)

    def init_fn(init_positions):
        """Tempering level from the ESS rule at beta=0; chains initialised
        at that tempered target."""
        if use_real_samples:
            beta = torch.ones((), device=init_positions.device)
        else:
            beta = next_beta(0.0, target.log_lik(init_positions), cfg.alpha, B)
        chain = mala.init(init_positions, lambda x: vs_fn(x, beta))
        train = create_train_state(field_params(net), tx)
        if not adapting:
            return MFMCarry(chain, train, beta)
        dev = init_positions.device
        return MFMCarry(chain, train, beta, da_init(cfg.step_size, dev), welford_init(d, dev),
                        torch.ones(d, device=dev))

    def step_size_of(da, count: int):
        """The step the kernel takes at iteration ``count``: the averaged one
        once frozen."""
        if not adapt_step:
            return cfg.step_size
        return torch.exp(da.log_step_avg if count > freeze_iter else da.log_step)

    def update_adaptation(acc, position, da, wf, inv_mass):
        """Dual averaging on the mean acceptance; Welford over the pooled
        positions, a mass refresh (and a re-anchored step) once the Welford
        count reaches ``mass_refresh_every`` MCMC steps. Called only before
        the freeze."""
        if adapt_step:
            da = da_update(da, torch.nan_to_num(torch.mean(acc), nan=0.0), target_acc)
        if adapt_mass:
            wf = welford_update_batch(wf, position)
            if wf.count >= cfg.mass_refresh_every * B:
                inv_mass = welford_variance(wf)
                wf = welford_init(d, position.device)
                da = da_init(torch.exp(da.log_step_avg))
        return da, wf, inv_mass

    def draw_step_noise(gen: torch.Generator, count: int):
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

    def data_step(carry: MFMCarry, count, noise):
        """(chain, acceptance, da, wf, inv_mass) after the iteration's move."""
        chain, da, wf, inv_mass = carry.chain, carry.da, carry.wf, carry.inv_mass
        if use_real_samples:
            zeros = torch.zeros(B, device=noise.device)
            nan = torch.full_like(zeros, torch.nan)
            return ChainState(noise, zeros, torch.zeros_like(noise)), nan, da, wf, inv_mass
        vs = lambda x: vs_fn(x, carry.beta)
        if _interleave_is_flow(count, cfg.mcmc_per_flow_steps):
            tgt = FlowTarget(vs, ref_dist.log_prob, ref_dist.sample)
            new, info = flow_kernel(chain, carry.train.params, transport, tgt, *noise)
            return new, info.acceptance_rate, da, wf, inv_mass
        kernel = mcmc_builder(vs, (step_size_of(da, count), inv_mass))
        new, info = kernel(chain, noise)
        if adapting and count <= freeze_iter:
            da, wf, inv_mass = update_adaptation(info.acceptance_rate, new.position, da, wf,
                                                 inv_mass)
        return new, info.acceptance_rate, da, wf, inv_mass

    def temper_step(chain, beta):
        new_beta = next_beta(beta, target.log_lik(chain.position), cfg.alpha, B)
        return mala.init(chain.position, lambda x: vs_fn(x, new_beta)), new_beta

    def step_fn(carry: MFMCarry, count: int, move_noise, fm_noise: FMNoise):
        chain, acc, da, wf, inv_mass = data_step(carry, count, move_noise)
        grads, loss = loss_and_grad(carry.train.params, chain.position, fm_noise)
        train = apply_gradients(carry.train, grads, tx)
        beta = carry.beta
        if not use_real_samples and count % cfg.iter_per_temp == 0 and bool(beta < 1.0):
            chain, beta = temper_step(chain, beta)
        mean = torch.nanmean(acc)
        metrics = {
            "loss": loss.detach(),
            "learning_rate": lr_fn(carry.train.step),
            "acceptance_mean": mean,
            "acceptance_std": torch.sqrt(torch.nanmean((acc - mean) ** 2)),
            "beta": beta,
        }
        if adapt_step:  # after this iteration's update (the averaged one once frozen)
            metrics["step_size"] = step_size_of(da, count)
        return MFMCarry(chain, train, beta, da, wf, inv_mass), metrics

    return MFMPieces(
        step_fn=step_fn, init_fn=init_fn, draw_step_noise=draw_step_noise, net=net,
        transport=transport, ref_dist=ref_dist, loss_fn=loss_fn, lr_fn=lr_fn, tx=tx,
        field_bind=bind,
    )


def make_generator(device, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one named stream of a seeded run."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_mfm(target: Target, cfg, device="cuda", logger=None) -> MFMRun:
    """Train an MFM sampler. ``logger`` (optional) gets ``log(dict)`` once
    per chunk with the chunk-mean metrics.

    Before the timed loop, a warm-up runs the first MCMC and the first flow
    iteration on the initial state with a separate generator and discards
    the result: it builds the CUDA kernels and initialises the libraries, so
    ``train_time`` measures the steady loop."""
    pieces = build_mfm(target, cfg, device, torch.Generator().manual_seed(cfg.seed))
    gen = make_generator(device, cfg.seed)
    carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
    n_iter = cfg.learning_iter
    chunk = max(1, min(cfg.chunk_size, n_iter))

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

    warm_gen = make_generator(device, cfg.seed, 1)
    seen = set()
    for count in range(1, n_iter + 1):
        kind = _interleave_is_flow(count, cfg.mcmc_per_flow_steps)
        if kind not in seen:
            seen.add(kind)
            pieces.step_fn(carry, count, *pieces.draw_step_noise(warm_gen, count))
        if len(seen) == 2:
            break
    _synchronize(device)

    metrics_chunks = []
    train_start = time.perf_counter()
    done = 0
    while done < n_iter:
        take = min(chunk, n_iter - done)
        rows = []
        for count in range(done + 1, done + take + 1):
            carry, m = pieces.step_fn(carry, count, *pieces.draw_step_noise(gen, count))
            rows.append(m)
        m = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        metrics_chunks.append(m)
        done += take
        if logger is not None:
            chunk_mean = {k: float(torch.mean(v)) for k, v in m.items()}
            chunk_mean["iter"] = done
            chunk_mean["train_time"] = time.perf_counter() - train_start
            if eval_loss is not None:
                chunk_mean["target_loss"] = float(eval_loss(carry.train.params))
            logger.log(chunk_mean)
    _synchronize(device)
    train_time = time.perf_counter() - train_start
    metrics = {k: torch.cat([c[k] for c in metrics_chunks]) for k in metrics_chunks[0]}

    # evaluation-facing transport: more or other probes, a finer grid
    transport = pieces.transport
    if (
        cfg.eval_hutchinson_probes != 1
        or cfg.eval_probe_dist != "gaussian"
        or cfg.eval_ode_steps is not None
    ):
        transport = make_transport(
            pieces.field_bind, divergence=cfg.divergence,
            n_steps=cfg.eval_ode_steps or cfg.ode_steps, method=cfg.ode_method,
            num_probes=cfg.eval_hutchinson_probes, probe_dist=cfg.eval_probe_dist,
        )
    return MFMRun(
        carry.train, carry.chain, carry.beta, metrics, train_time,
        transport, pieces.ref_dist, pieces.net,
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
