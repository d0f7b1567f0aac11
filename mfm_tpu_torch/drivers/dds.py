"""DDS: denoising diffusion sampler (counterpart of ``mfm_tpu.drivers.dds``;
Vargas, Grathwohl & Doucet, ICLR 2023), in its exact discrete-time form.

The reference chain is the discrete OU kernel, which leaves N(0, sigma^2 I)
invariant for any beta schedule; the learned chain is
x_{k+1} = sqrt(1 - beta_k) x_k + sqrt(beta_k) sigma (g(x_k, t_k) + eps_k),
x_0 ~ N(0, sigma^2 I), with g the control net; the loss is the pathwise KL
and the log-weights log q - log p_theta come out of the same rollout, so
the final IS correction and the log Z estimate are exact for the discrete
model. At g == 0 the path terms telescope to log pi(x_K) - log N(x_K; 0,
sigma^2 I).

The control net is ``VectorFieldNet`` with empty x- and t-trunks, gated by
the target's score taken on a **detached** input (clipped at
``score_clip``): the net is differentiated in its parameters only, through
its ``forward`` (field + gate * clip(score)), never through a target's
fused, forward-only ``score_gate``. Each step runs under
``torch.utils.checkpoint`` (activations recomputed in the backward pass,
memory O(K) positions); its noise ``eps`` and the detached score are
inputs, so nothing random, and no ``torch.func`` transform, runs inside the
checkpoint. Adam after a global-norm clip at 10, a
warmup/decay schedule, and an EMA gradient-spike skip (sentinel -1 until
the first finite norm); a skipped step is still an Adam update.

The reference scans the training on the device; here it is a Python loop
with every flag a tensor (no host read a step). Randomness is injected:
``train_step`` and ``rollout`` take a ``DDSNoise``, which ``draw_noise``
draws from a ``torch.Generator``.
"""

import math
import time
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from mfm_tpu_torch.drivers.baselines import BaselineResult, is_resample, is_summary
from mfm_tpu_torch.flows.train import (
    adam,
    apply_updates,
    chain,
    clip_by_global_norm,
    global_norm,
    make_lr_schedule,
)
from mfm_tpu_torch.flows.vector_field import VectorFieldNet, field_params
from mfm_tpu_torch.targets.base import Target


def cos_sq_betas(n_steps: int, beta_min: float = 1e-3, beta_max: float = 0.3,
                 device=None) -> torch.Tensor:
    """The cos^2 schedule: beta_max at the noise end (k = 0), decaying to
    beta_min at the target end."""
    t = torch.arange(n_steps, device=device) / max(n_steps - 1, 1)
    return beta_min + (beta_max - beta_min) * torch.cos(0.5 * math.pi * t) ** 2


class DDSNoise(NamedTuple):
    x0: torch.Tensor  # (batch, d) standard normal: the start, before sigma
    eps: torch.Tensor  # (n_steps, batch, d) standard normal


class DDSCarry(NamedTuple):
    params: dict
    opt_state: Any
    gnorm_ema: torch.Tensor  # -1 until the first finite gradient norm


class DDSPieces(NamedTuple):
    net: VectorFieldNet
    params: dict
    step_k: Callable  # (params, x, log_w, beta, t, eps) -> (x, log_w)
    rollout: Callable  # (params, DDSNoise, remat=True) -> (x_K, log_w)
    loss_and_grad: Callable  # (params, DDSNoise, remat=True) -> (loss, log_w, grads)
    train_step: Callable  # (carry, DDSNoise) -> (carry, (loss, log_z))
    init_carry: Callable  # params -> carry
    draw_noise: Callable  # (generator, batch) -> DDSNoise


class DDSResult(NamedTuple):
    params: dict
    losses: torch.Tensor  # (n_iter,)
    log_z: torch.Tensor  # (n_iter,) the IS log Z estimate of each iteration
    train_time: float
    sample_fn: Callable  # (params, noises) -> (x, log_w)
    draw_noise: Callable  # (generator, batch) -> DDSNoise


def build_dds(
    target: Target,
    seed: int = 0,
    n_iter: int = 1000,
    batch_size: int = 128,
    n_steps: int = 100,
    sigma: float = 1.0,
    learning_rate: float = 1e-3,
    hidden: tuple = (64, 64),
    beta_max: float = 0.3,
    score_clip: float = 100.0,
    control_clip: float = 100.0,
    device="cuda",
) -> DDSPieces:
    dim = target.dim
    dev = torch.device(device)
    betas = cos_sq_betas(n_steps, beta_max=beta_max, device=dev)
    ts = torch.arange(n_steps, dtype=torch.float32, device=dev) / n_steps
    init = torch.Generator().manual_seed(seed)
    fourier = torch.randn(128, generator=init)  # make_vector_field's 128 frequencies, std 1
    # both clips keep the gated score's feedback loop bounded (the reference
    # measured 4-mode diverging without them)
    net = VectorFieldNet(
        dim, fourier, (), (), tuple(hidden), act="relu",
        score_fn=target.score, score_clip=score_clip, generator=init,
    ).to(dev)
    params = field_params(net)
    log_norm = 0.5 * dim * math.log(2 * math.pi) + dim * math.log(sigma)

    def normal_logpdf(x):
        return -0.5 * torch.sum(x * x, dim=-1) / (sigma * sigma) - log_norm

    def detached_score(x):
        with torch.no_grad():
            return target.score(x.detach())

    def step_k(params, x, log_w, beta, t, eps, score=None):
        """One controlled OU step and its exact log-weight increment;
        ``score`` the target's score at x (taken here when not given)."""
        score = detached_score(x) if score is None else score
        g = functional_call(net, params, (x, t.expand(x.shape[0])), {"score": score})
        g = torch.clamp(g, -control_clip, control_clip)
        root1m = torch.sqrt(1.0 - beta)
        x_next = root1m * x + torch.sqrt(beta) * sigma * (g + eps)
        resid = torch.sqrt(beta) * x / sigma - root1m * (g + eps)
        inc = 0.5 * (torch.sum(eps * eps, dim=-1) - torch.sum(resid * resid, dim=-1))
        return x_next, log_w + inc

    def rollout(params, noise: DDSNoise, remat: bool = True):
        """The controlled chain: (x_K, log w), log w = log q(x_{0:K}) - log
        p_theta(x_{0:K}) with pi unnormalised."""
        x = sigma * noise.x0
        log_w = -normal_logpdf(x)
        for k in range(n_steps):
            # the score is a detached input of the step: torch.func's score
            # cannot run under the checkpoint's saved-tensor hooks, and a
            # recompute need not take it again
            args = (params, x, log_w, betas[k], ts[k], noise.eps[k], detached_score(x))
            if remat and torch.is_grad_enabled():
                x, log_w = checkpoint(step_k, *args, use_reentrant=False)
            else:
                x, log_w = step_k(*args)
        log_p = target.log_prob(x)
        return x, log_w + torch.where(torch.isnan(log_p), -torch.inf, log_p)

    def loss_and_grad(params, noise: DDSNoise, remat: bool = True):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            _, log_w = rollout(leaves, noise, remat)
            finite = torch.isfinite(log_w)
            safe = torch.where(finite, log_w, 0.0)
            n_finite = torch.clamp(torch.sum(finite), min=1).to(safe.dtype)
            # KL - log Z; an exploded trajectory is left out of the mean,
            # not averaged in as a zero
            loss = -torch.sum(safe) / n_finite
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), log_w.detach(), dict(zip(leaves, grads))

    lr_fn = make_lr_schedule(n_iter, max(n_iter // 20, 1), learning_rate)
    opt = chain(clip_by_global_norm(10.0), adam(lr_fn))

    def train_step(carry: DDSCarry, noise: DDSNoise):
        loss, log_w, grads = loss_and_grad(carry.params, noise)
        gnorm = global_norm(grads)
        # the EMA seeds itself from the first finite norm (sentinel < 0)
        ema = torch.where((carry.gnorm_ema < 0) & torch.isfinite(gnorm), gnorm,
                          carry.gnorm_ema)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm) & (gnorm < 5.0 * ema)
        grads = {k: torch.where(ok, g, 0.0) for k, g in grads.items()}
        updates, opt_state = opt.update(grads, carry.opt_state, carry.params)
        ema = torch.where(ok, 0.95 * ema + 0.05 * gnorm, ema)
        lw = torch.where(torch.isfinite(log_w), log_w, -torch.inf)
        log_z = torch.logsumexp(lw, dim=0) - math.log(batch_size)
        return DDSCarry(apply_updates(carry.params, updates), opt_state, ema), (loss, log_z)

    def init_carry(params) -> DDSCarry:
        return DDSCarry(params, opt.init(params), torch.full((), -1.0, device=dev))

    def draw_noise(gen: torch.Generator, batch: int = batch_size) -> DDSNoise:
        return DDSNoise(torch.randn((batch, dim), generator=gen, device=gen.device),
                        torch.randn((n_steps, batch, dim), generator=gen, device=gen.device))

    return DDSPieces(net, params, step_k, rollout, loss_and_grad, train_step, init_carry,
                     draw_noise)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_dds(target: Target, seed: int = 0, n_iter: int = 1000, device="cuda",
            **kwargs) -> DDSResult:
    """Train the sampler for ``n_iter`` iterations; ``kwargs`` are
    ``build_dds``'s. One loss and gradient with a separate generator runs
    first, untimed, and is discarded."""
    pieces = build_dds(target, seed, n_iter, device=device, **kwargs)
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003)
    warm = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1)
    carry = pieces.init_carry(pieces.params)
    pieces.loss_and_grad(carry.params, pieces.draw_noise(warm))
    _synchronize(device)

    t0 = time.perf_counter()
    losses, log_zs = [], []
    for _ in range(n_iter):
        carry, (loss, log_z) = pieces.train_step(carry, pieces.draw_noise(gen))
        losses.append(loss)
        log_zs.append(log_z)
    losses, log_zs = torch.stack(losses), torch.stack(log_zs)
    _synchronize(device)
    train_time = time.perf_counter() - t0

    def sample_fn(params, noises: List[DDSNoise]):
        """IS-weighted final sampling, one rollout a noise (batches of the
        training width, as the reference maps them)."""
        with torch.no_grad():
            xs, ws = zip(*(pieces.rollout(params, noise) for noise in noises))
        return torch.cat(xs), torch.cat(ws)

    return DDSResult(carry.params, losses, log_zs, train_time, sample_fn, pieces.draw_noise)


def dds_sigma(cfg, device=None) -> float:
    """The OU reference's std: the example's reference distribution's
    ``std`` where it has one (``REF_DISTS``), else 1."""
    from mfm_tpu_torch.targets import REF_DISTS

    factory = REF_DISTS.get(cfg.ref_dist)
    ref = factory(cfg.dim, device) if factory is not None else None
    return float(getattr(ref, "std", 1.0))


def dds_baseline(target: Target, cfg, seed: int = 0, n_eval: Optional[int] = None,
                 device="cuda") -> BaselineResult:
    """DDS with the shared result: the final rollouts IS-resampled by their
    log-weights; extras ``final_loss``, ``log_z_is``, ``is_ess_frac``."""
    res = run_dds(target, seed=seed, n_iter=cfg.learning_iter, device=device,
                  batch_size=cfg.num_chain, learning_rate=cfg.learning_rate,
                  hidden=tuple(cfg.hidden_xt), sigma=dds_sigma(cfg, device))
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 999)
    noises = [res.draw_noise(gen) for _ in range(-(-n_eval // cfg.num_chain))]
    x, log_w = res.sample_fn(res.params, noises)
    flow_samples, log_w = x[:n_eval], log_w[:n_eval]
    with torch.no_grad():
        exact, log_w = is_resample(flow_samples, log_w, generator=gen)
    extras = {"final_loss": float(res.losses[-1]), **is_summary(log_w)}
    return BaselineResult(flow_samples, exact, res.train_time, extras)
