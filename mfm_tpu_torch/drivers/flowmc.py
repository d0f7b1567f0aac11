"""flowMC: normalising-flow enhanced MCMC (counterpart of
``mfm_tpu.drivers.flowmc``; Gabrie, Rotskoff & Vanden-Eijnden, PNAS 2022).

Each round: ``n_local_steps`` ensemble MALA steps (``kernels/mala.py``),
``n_epochs`` maximum-likelihood epochs of the spline coupling flow on
minibatches of the chains' history (a ring buffer), then
``n_global_steps`` independence-MH moves proposed by the flow, which
refresh the chains' value and score. Adam at a constant rate.

The reference scans the rounds on the device; here they are a Python loop
with the acceptances and the skip flag kept as tensors; the buffer's fill
and pointer are Python ints (they grow by ``n_chain`` a step whatever the
data). Randomness is injected: ``one_loop`` takes a ``FlowMCLoopNoise``
(the MALA draws, the minibatch indices, the global moves' base draws and
uniforms), which ``draw_loop_noise`` draws from a ``torch.Generator``.
"""

import time
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.func import grad_and_value

from mfm_tpu_torch.drivers.baselines import BaselineResult, is_resample, is_summary
from mfm_tpu_torch.flows.coupling import make_coupling_flow
from mfm_tpu_torch.flows.train import adam, apply_updates, global_norm
from mfm_tpu_torch.kernels import ChainState, mala
from mfm_tpu_torch.targets.base import Target


class FlowMCLoopNoise(NamedTuple):
    local: List[mala.MalaNoise]  # n_local_steps MALA draws
    train_idx: Optional[torch.Tensor]  # (n_epochs, batch) minibatch indices
    global_eps: torch.Tensor  # (n_global, n_chain, d) the flow's base draws
    global_u: torch.Tensor  # (n_global, n_chain) uniform


class FlowMCCarry(NamedTuple):
    states: ChainState
    params: dict
    opt_state: Any
    buf: torch.Tensor  # (cap, d) chain positions
    buf_len: int  # filled prefix
    buf_ptr: int  # ring write pointer


class FlowMCPieces(NamedTuple):
    flow: Any
    params: dict
    init_carry: Callable  # (params, positions) -> carry (the buffer seeded)
    local_round: Callable  # (states, local noise) -> (states, mean acceptance)
    global_round: Callable  # (params, states, eps, u) -> (states, mean acceptance)
    train_round: Callable  # (carry, train_idx) -> (carry, losses)
    one_loop: Callable  # (carry, noise) -> (carry, (positions, acc_l, acc_g, losses))
    draw_loop_noise: Callable  # (generator, carry) -> FlowMCLoopNoise
    cap: int


class FlowMCResult(NamedTuple):
    params: dict
    flow: Any  # CouplingFlow handle
    positions: torch.Tensor  # (n_loop, n_chain, d) end-of-round positions
    local_accept: torch.Tensor  # (n_loop,)
    global_accept: torch.Tensor  # (n_loop,)
    losses: torch.Tensor  # (n_loop, n_epochs)
    train_time: float


def build_flowmc(
    target: Target,
    seed: int = 0,
    n_chain: int = 128,
    n_local_steps: int = 10,
    n_global_steps: int = 10,
    n_epochs: int = 10,
    step_size: float = 0.1,
    learning_rate: float = 1e-3,
    n_layers: int = 8,
    hidden: tuple = (64, 64),
    n_bins: int = 8,
    spline_range: tuple = (-10.0, 10.0),
    base_scale: float = 1.0,
    max_samples: Optional[int] = None,
    batch_size: Optional[int] = None,
    device="cuda",
) -> FlowMCPieces:
    """The pieces of a flowMC run (the reference's ``Sampler`` names)."""
    dim = target.dim
    cap = int(max_samples or n_chain * (n_local_steps + 1))
    cap = max(cap - cap % n_chain, n_chain)  # whole ensembles only
    batch = int(batch_size or n_chain)
    dev = torch.device(device)
    flow, params = make_coupling_flow(
        dim, n_layers=n_layers, hidden=hidden, transform_type="spline", n_bins=n_bins,
        spline_range=spline_range, base_scale=base_scale,
        generator=torch.Generator().manual_seed(seed), device=dev,
    )
    opt = adam(learning_rate)
    vs = target.value_and_score
    kernel = mala.build_kernel(vs)

    def local_round(states, noises):
        accs = []
        for noise in noises:
            states, info = kernel(states, step_size, *noise)
            accs.append(info.acceptance_rate.mean())
        return states, torch.stack(accs).mean()

    def global_round(params, states, eps, u):
        """Independence MH through the flow over the ensemble."""
        accs = []
        with torch.no_grad():
            for j in range(n_global_steps):
                y, log_q_y = flow.sample_and_log_prob(params, eps[j])
                log_p_y = target.log_prob(y)
                log_q_x = flow.log_prob(params, states.position)
                log_acc = (log_p_y - log_q_y) - (states.logdensity - log_q_x)
                log_acc = torch.where(torch.isnan(log_acc), -torch.inf, log_acc)
                acc = torch.log(u[j]) < log_acc
                pos = torch.where(acc[:, None], y, states.position)
                states = ChainState(pos, *vs(pos))  # one fused eval refreshes the score
                accs.append(acc.to(torch.float32).mean())
        return states, torch.stack(accs).mean()

    def buffer_insert(carry: FlowMCCarry, x) -> FlowMCCarry:
        idx = (carry.buf_ptr + torch.arange(n_chain, device=x.device)) % cap
        return carry._replace(buf=carry.buf.index_put((idx,), x),
                              buf_len=min(carry.buf_len + n_chain, cap),
                              buf_ptr=(carry.buf_ptr + n_chain) % cap)

    def nll(p, xb):
        lq = flow.log_prob(p, xb)
        loss = -torch.mean(torch.where(torch.isfinite(lq), lq, 0.0))
        return loss, loss.detach()

    nll_grad = grad_and_value(nll, has_aux=True)

    def train_round(carry: FlowMCCarry, train_idx):
        params, opt_state, losses = carry.params, carry.opt_state, []
        for idx in train_idx:  # uniform minibatches over the filled prefix
            grads, (_, loss) = nll_grad(params, carry.buf[idx])
            ok = torch.isfinite(loss) & torch.isfinite(global_norm(grads))
            grads = {k: torch.where(ok, g, 0.0) for k, g in grads.items()}
            updates, opt_state = opt.update(grads, opt_state, params)  # even when skipped
            params = apply_updates(params, updates)
            losses.append(loss)
        return carry._replace(params=params, opt_state=opt_state), torch.stack(losses)

    def one_loop(carry: FlowMCCarry, noise: FlowMCLoopNoise):
        states, acc_l = local_round(carry.states, noise.local)
        carry = buffer_insert(carry._replace(states=states), states.position)
        if n_epochs > 0:
            carry, losses = train_round(carry, noise.train_idx)
        else:  # sampling only (a fixed flow)
            losses = torch.zeros((0,), device=states.position.device)
        states, acc_g = global_round(carry.params, carry.states, noise.global_eps,
                                     noise.global_u)
        carry = buffer_insert(carry._replace(states=states), states.position)
        return carry, (states.position, acc_l, acc_g, losses)

    def init_carry(params, positions) -> FlowMCCarry:
        states = mala.init(positions, vs)
        carry = FlowMCCarry(states, params, opt.init(params),
                            torch.zeros((cap, dim), device=positions.device), 0, 0)
        # the initial ensemble seeds the buffer, so the first round's
        # minibatches are defined
        return buffer_insert(carry, positions)

    def draw_loop_noise(gen: torch.Generator, carry: FlowMCCarry) -> FlowMCLoopNoise:
        d = gen.device
        filled = min(carry.buf_len + n_chain, cap)  # after the local round's insert
        return FlowMCLoopNoise(
            [mala.draw_noise(gen, n_chain, dim) for _ in range(n_local_steps)],
            torch.randint(0, filled, (n_epochs, batch), generator=gen, device=d)
            if n_epochs > 0 else None,
            torch.randn((n_global_steps, n_chain, dim), generator=gen, device=d),
            torch.rand((n_global_steps, n_chain), generator=gen, device=d),
        )

    return FlowMCPieces(flow, params, init_carry, local_round, global_round, train_round,
                        one_loop, draw_loop_noise, cap)


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_flowmc(target: Target, seed: int = 0, n_loop: int = 10, device="cuda",
               **kwargs) -> FlowMCResult:
    """Train and run the NF-enhanced sampler for ``n_loop`` rounds;
    ``kwargs`` are ``build_flowmc``'s. One round on the initial carry with a
    separate generator runs first, untimed, and is discarded (it builds the
    kernels and initialises the libraries)."""
    pieces = build_flowmc(target, seed, device=device, **kwargs)
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003)
    warm = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1)
    carry = pieces.init_carry(pieces.params,
                              target.init_positions(gen, kwargs.get("n_chain", 128)))
    pieces.one_loop(carry, pieces.draw_loop_noise(warm, carry))
    _synchronize(device)

    t0 = time.perf_counter()
    outs = []
    for _ in range(n_loop):
        carry, out = pieces.one_loop(carry, pieces.draw_loop_noise(gen, carry))
        outs.append(out)
    positions, acc_l, acc_g, losses = (torch.stack(v) for v in zip(*outs))
    _synchronize(device)
    return FlowMCResult(carry.params, pieces.flow, positions, acc_l, acc_g, losses,
                        time.perf_counter() - t0)


def flowmc_n_layers(cfg) -> int:
    """``cfg.flowmc_n_layers``, else the reference's depth from the MLP
    widths (exe_others.py:132)."""
    if getattr(cfg, "flowmc_n_layers", None) is not None:
        return cfg.flowmc_n_layers
    return len(cfg.hidden_x) + len(cfg.hidden_t) + 4


def flowmc_baseline(target: Target, cfg, seed: int = 0, n_eval: Optional[int] = None,
                    device="cuda") -> BaselineResult:
    """flowMC with the shared result: ``cfg.learning_iter`` split into rounds
    of ``mcmc_per_flow_steps`` local steps, epochs and global steps each;
    the final flow draws IS-resampled in log space."""
    steps = max(int(cfg.mcmc_per_flow_steps), 1)
    res = run_flowmc(
        target, seed=seed, n_loop=max(cfg.learning_iter // steps, 1), device=device,
        n_chain=cfg.num_chain, n_local_steps=steps, n_global_steps=steps, n_epochs=steps,
        step_size=cfg.step_size, learning_rate=cfg.learning_rate,
        n_layers=flowmc_n_layers(cfg), hidden=tuple(cfg.hidden_xt),
        max_samples=cfg.num_chain * (steps + 1), batch_size=cfg.num_chain,
    )
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 999)
    with torch.no_grad():
        eps = torch.randn((n_eval, target.dim), generator=gen, device=gen.device)
        flow_samples, log_flow = res.flow.sample_and_log_prob(res.params, eps)
        exact, log_w = is_resample(flow_samples, target.log_prob(flow_samples), log_flow,
                                   generator=gen)
    extras = {"local_accs": res.local_accept, "global_accs": res.global_accept,
              "loss_vals": res.losses, "mean_accept": float(res.local_accept.mean()),
              "mean_global_accept": float(res.global_accept.mean()), **is_summary(log_w)}
    return BaselineResult(flow_samples, exact, res.train_time, extras)
