"""FAB: flow annealed importance sampling bootstrap (counterpart of
``mfm_tpu.drivers.fab``; Midgley et al., ICLR 2023).

A coupling flow q (``flows/coupling.py``) is trained toward the alpha = 2
target g = p^2 / q: an AIS bridge q -> g (K intermediate densities, HMC or
random-walk Metropolis transitions with Robbins-Monro step sizes) produces
weighted samples; a prioritised replay buffer keeps them; each gradient
step re-weights a buffer batch by clip(q_old / q_new, w_adjust_clip). Adam
with a warmup/decay schedule, and a gradient step skipped or clipped by an
EMA of the gradient norm.

The configuration is the reference's: ``configs/fab/{fab,flow,training}/
default.yaml`` composed with the example's file (``load_fab_config``), read
by the port's own parser of the YAML subset those files use (``read_yaml``),
which gives what ``yaml.safe_load`` gives, strings such as ``1.0e4``
included (PyYAML's float needs a signed exponent); ``run_fab`` then refuses
a non-integer ``n_epoch`` or ``batch_size`` by name.

The reference scans the run on the device; here it is a Python loop, with
every per-step flag (the skip, the EMA, the step sizes, the priorities) a
tensor, so a step reads nothing back to the host; the buffer's write
pointer is a Python int (it moves by ``batch`` a step whatever the data).
Randomness is injected: ``train_iter`` takes a ``FABIterNoise`` and
``prefill_one`` an ``AISNoise``, which ``draw_iter_noise`` and
``draw_ais_noise`` draw from a ``torch.Generator``. The buffer's
prioritised draw is a Gumbel argmax when a test replays the reference's
keys and an inverse CDF in fp64 otherwise (``baselines.categorical``).
"""

import math
import re
import time
from pathlib import Path
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.func import grad_and_value

from mfm_tpu_torch.drivers.baselines import BaselineResult, categorical, is_resample, is_summary
from mfm_tpu_torch.flows.coupling import make_coupling_flow
from mfm_tpu_torch.flows.train import adam, apply_updates, global_norm, make_lr_schedule
from mfm_tpu_torch.targets.base import Target

CONFIG_DIR = Path(__file__).resolve().parents[2] / "configs" / "fab"

_CONFIG_EXAMPLE = {
    # the reference's mapping (exe_others.py:49-56) and the two extras
    "pines": "cox",
    "4-mode": "funnel",
    "phi-four": "many_well",
    "gaussian-mixture": "gmm_v0",
    "funnel": "funnel",
    "many-well": "many_well",
}

# ---------------------------------------------------------------------------
# the configuration: a YAML subset, resolved as PyYAML resolves YAML 1.1

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_OCT = re.compile(r"[-+]?0[0-7_]+$")
_HEX = re.compile(r"[-+]?0x[0-9a-fA-F_]+$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")


def _scalar(text: str):
    """A plain or quoted scalar, typed as ``yaml.safe_load`` types it."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body.encode().decode(
            "unicode_escape")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    plain = text.replace("_", "")
    if _INT.match(text):
        return int(plain)
    if _OCT.match(text):
        return int(plain, 8)
    if _HEX.match(text):
        return int(plain, 16)
    if _FLOAT.match(text):
        return float(plain)
    m = _INF.match(text)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    return text


def _value(text: str):
    """A scalar or a flow sequence ``[a, b]`` of scalars."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unsupported YAML value {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(item.strip()) for item in inner.split(",")] if inner else []
    if text.startswith(("{", "&", "*", "!", "|", ">")):
        raise ValueError(f"unsupported YAML value {text!r}")
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    key, sep, rest = text.partition(":")
    if not sep or (rest and not rest.startswith(" ")):
        return None
    return key.strip(), rest.strip()


def _block(lines, i: int, indent: int):
    """Parse the block of lines at ``indent`` starting at ``i``; returns
    (node, next index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        seq = []
        while i < len(lines) and lines[i][0] == indent and lines[i][1][:1] == "-":
            item = lines[i][1][1:].strip()
            kv = _split_key(item)
            if kv is None:
                seq.append(_value(item))
                i += 1
                continue
            # a mapping item: its first pair on the dash line, the rest below
            sub = [(indent + 2, item)]
            i += 1
            while i < len(lines) and lines[i][0] > indent:
                sub.append(lines[i])
                i += 1
            seq.append(_block(sub, 0, indent + 2)[0])
        return seq, i
    node = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"unsupported YAML line {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            node[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1][:1] == "-")):
            node[key], i = _block(lines, i, lines[i][0])
        else:
            node[key] = None
    return node, i


def read_yaml(text: str):
    """The YAML subset of ``configs/fab/``: block mappings and sequences,
    flow sequences of scalars, plain and quoted scalars, comments."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if line.strip() and line.strip() != "---":
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError("tabs in YAML indentation")
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unsupported YAML structure at {lines[i][1]!r}")
    return node


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_fab_config(example: str, config_dir=None) -> dict:
    """The groups ``fab``, ``flow``, ``training`` (their ``default.yaml``),
    then the example's file over them, as hydra composes them."""
    config_dir = Path(config_dir) if config_dir is not None else CONFIG_DIR
    name = _CONFIG_EXAMPLE.get(example, example)
    cfg = {g: read_yaml((config_dir / g / "default.yaml").read_text())
           for g in ("fab", "flow", "training")}
    per_target = read_yaml((config_dir / f"{name}.yaml").read_text()) or {}
    per_target.pop("defaults", None)
    return _deep_merge(cfg, per_target)


def _as_int(value, field: str) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(
            f"FAB config: {field} must be an integer, got {value!r} "
            f"({type(value).__name__}; YAML reads 1.0e4 as a string, write 10000)"
        )
    return value


# ---------------------------------------------------------------------------
# the run


class AISNoise(NamedTuple):
    base: torch.Tensor  # (batch, d) standard normal: the flow's base draw
    moves: torch.Tensor  # (K+1, n_outer, batch, d) standard normal: momenta or proposals
    u_accept: torch.Tensor  # (K+1, n_outer, batch) uniform


class FABIterNoise(NamedTuple):
    ais: AISNoise
    # one draw a buffer update: a (batch, cap) Gumbel or a (batch,) fp64 uniform
    buffer: List[torch.Tensor]


class FABCarry(NamedTuple):
    params: dict
    opt_state: Any
    grad_norm_ema: torch.Tensor  # EMA of the accepted gradient norms
    step_sizes: torch.Tensor  # (K+1,)
    buf_x: torch.Tensor  # (cap, d)
    buf_log_w: torch.Tensor  # (cap,) AIS log-weights (priorities), -inf = empty
    buf_log_q: torch.Tensor  # (cap,) flow log-density at insertion
    buf_ptr: int  # ring write pointer
    step: int  # gradient updates so far


class FABPieces(NamedTuple):
    flow: Any
    params: dict  # initial flow parameters
    init_carry: Callable  # params -> carry
    ais_forward: Callable  # (params, step_sizes, AISNoise) -> (x, log_w, acc, step_sizes)
    prefill_one: Callable  # (carry, AISNoise) -> carry
    train_iter: Callable  # (carry, FABIterNoise) -> (carry, (loss, acc, log_z))
    draw_ais_noise: Callable  # generator -> AISNoise
    draw_iter_noise: Callable  # generator -> FABIterNoise
    log_gamma: Callable  # (params, beta, x) -> (batch,)
    transition: Callable  # (params, beta, step, x, moves, u_accept) -> (x, mean acceptance)
    buffer_insert: Callable  # (carry, x, log_w, log_q) -> carry
    grad_update: Callable  # (carry, x, w_norm, log_q_old) -> (carry, loss, log_q)
    n_epoch: int
    min_batches: int  # prefill AIS passes (0 without the buffer)
    use_buffer: bool
    batch: int
    cap: int


class FABResult(NamedTuple):
    params: dict
    flow: Any  # CouplingFlow handle
    losses: torch.Tensor  # (n_epoch,)
    accept: torch.Tensor  # (n_epoch,) mean AIS transition acceptance
    log_z_alpha2: torch.Tensor  # (n_epoch,) AIS estimate of log int p^2/q
    train_time: float


def build_fab(
    target: Target,
    example: str,
    seed: int = 0,
    n_epoch: Optional[int] = None,
    batch_size: Optional[int] = None,
    config_dir=None,
    overrides: Optional[dict] = None,
    device="cuda",
) -> FABPieces:
    """The pieces of a FAB run with the example's config (the three CLI
    overrides of the reference: epochs, batch, conditioner widths)."""
    cfg = load_fab_config(example, config_dir)
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    fab, flow_cfg, tr = cfg["fab"], cfg["flow"], cfg["training"]
    n_epoch = _as_int(n_epoch or tr["n_epoch"], "training.n_epoch")
    batch = _as_int(batch_size or tr["batch_size"], "training.batch_size")
    dim = target.dim
    dev = torch.device(device)

    flow, params = make_coupling_flow(
        dim,
        n_layers=int(flow_cfg["n_layers"]),
        hidden=tuple(flow_cfg["conditioner_mlp_units"]),
        transform_type=flow_cfg["transform_type"],
        n_bins=int(flow_cfg.get("spline_num_bins", 8)),
        spline_range=(float(flow_cfg.get("spline_min", -10.0)),
                      float(flow_cfg.get("spline_max", 10.0))),
        act_norm=bool(flow_cfg.get("act_norm", False)),
        base_scale=float(flow_cfg.get("base_scale", 1.0)),
        generator=torch.Generator().manual_seed(seed),
        device=dev,
    )

    # --- the AIS bridge ------------------------------------------------------
    K = int(fab["smc"]["n_intermediate_distributions"])
    if fab["smc"].get("spacing_type", "linear") == "linear":
        betas = torch.linspace(0.0, 1.0, K + 2, device=dev)[1:]  # (K+1,), ending at 1
    else:  # geometric: concentrated near beta = 0
        betas = torch.logspace(math.log10(1.0 / (K + 2)), 0.0, K + 1, device=dev)
    op = fab["smc"]["transition_operator"]
    op_cfg = fab["smc"][op]
    n_outer = int(op_cfg.get("n_outer_steps", 1))
    n_inner = int(op_cfg.get("n_inner_steps", 5)) if op == "hmc" else 1
    init_step = float(op_cfg.get("init_step_size", 1.0))
    tune = bool(op_cfg.get("tune_step_size", True))
    p_accept = float(op_cfg.get("target_p_accept", 0.65))
    alpha = float(fab.get("alpha", 2.0))
    w_clip = float(fab.get("w_adjust_clip", 10.0))

    def gamma_parts(params, x):
        """(log q, log p) at x, no gradient."""
        with torch.no_grad():
            return flow.log_prob(params, x), target.log_prob(x)

    def mix(lq, lp, beta):
        # (1 - beta) log q + beta log g, g = p^alpha / q^(alpha - 1)
        return lq + beta * alpha * (lp - lq)

    def log_gamma(params, beta, x):
        return mix(*gamma_parts(params, x), beta)

    def value_and_grad_x(params, beta, x):
        """log gamma_beta and its gradient in x (autograd through the flow
        and the target; for PhiFour through K3's analytic score)."""
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            lg = mix(flow.log_prob(params, v), target.log_prob(v), beta)
            (g,) = torch.autograd.grad(lg.sum(), v)
        return lg.detach(), g

    def hmc_one(params, beta, step, x, m0, u):
        """Velocity Verlet with the gradient carried across steps: n_inner+1
        gradients instead of 2 n_inner; the end values come with them."""
        lg_x, g = value_and_grad_x(params, beta, x)
        z, m = x, m0
        lg_z = lg_x
        for _ in range(n_inner):
            m = m + 0.5 * step * g
            z = z + step * m
            lg_z, g = value_and_grad_x(params, beta, z)
            m = m + 0.5 * step * g
        log_acc = (lg_z - lg_x - 0.5 * torch.sum(m * m, dim=-1)
                   + 0.5 * torch.sum(m0 * m0, dim=-1))
        acc = torch.log(u) < log_acc
        return torch.where(acc[:, None], z, x), acc

    def rwm_one(params, beta, step, x, eps, u):
        z = x + step * eps
        acc = torch.log(u) < log_gamma(params, beta, z) - log_gamma(params, beta, x)
        return torch.where(acc[:, None], z, x), acc

    one = hmc_one if op == "hmc" else rwm_one

    def transition(params, beta, step, x, moves, u_accept):
        """n_outer MH transitions targeting gamma_beta; the acceptance is
        averaged over all of them (the step-size tuning reacts to it)."""
        acc_sum = torch.zeros((), device=x.device)
        for j in range(n_outer):
            x, acc = one(params, beta, step, x, moves[j], u_accept[j])
            acc_sum = acc_sum + acc.to(torch.float32).mean()
        return x, acc_sum / n_outer

    def ais_forward(params, step_sizes, noise: AISNoise):
        """q -> AIS through the bridge: (positions, log-weights, mean
        acceptance, tuned step sizes). Not differentiated through."""
        params = {k: v.detach() for k, v in params.items()}
        with torch.no_grad():
            x, lq = flow.sample_and_log_prob(params, noise.base)
            log_w = log_gamma(params, betas[0], x) - lq
        accs = []
        for i in range(K + 1):
            x, acc = transition(params, betas[i], step_sizes[i], x, noise.moves[i],
                                noise.u_accept[i])
            accs.append(acc)
            if i < K:  # the increment gamma_{i+1}(x_i) - gamma_i(x_i); none after the last
                lq_i, lp_i = gamma_parts(params, x)
                log_w = log_w + (mix(lq_i, lp_i, betas[i + 1]) - mix(lq_i, lp_i, betas[i]))
        accs = torch.stack(accs)
        if tune:  # Robbins-Monro on the log step size toward the target acceptance
            step_sizes = step_sizes * torch.exp(0.15 * (accs - p_accept))
        return x, log_w, accs.mean(), step_sizes

    # --- the prioritised replay buffer ---------------------------------------
    use_buffer = bool(fab["buffer"].get("with_buffer", True))
    n_updates = int(fab["buffer"].get("n_updates_per_smc_forward_pass", 4))
    min_batches = int(fab["buffer"].get("buffer_min_length_in_batches", 40))
    max_batches = int(fab["buffer"].get("buffer_max_length_in_batches", 400))
    # bounded by the run's length, as in the reference
    max_batches = max(min(max_batches, n_epoch + min_batches), 2)
    min_batches = min(min_batches, max(n_epoch // 4, 1))
    cap = max_batches * batch

    def buffer_insert(carry: FABCarry, x, log_w, log_q) -> FABCarry:
        idx = (carry.buf_ptr + torch.arange(batch, device=x.device)) % cap
        return carry._replace(
            buf_x=carry.buf_x.index_put((idx,), x),
            buf_log_w=carry.buf_log_w.index_put((idx,), log_w),
            buf_log_q=carry.buf_log_q.index_put((idx,), log_q),
            buf_ptr=(carry.buf_ptr + batch) % cap,
        )

    # --- the optimiser --------------------------------------------------------
    opt_cfg = tr["optimizer"]
    if opt_cfg.get("use_schedule", True):
        # the horizon is the gradient steps: n_updates an epoch with the
        # buffer, one without
        steps_per_epoch = n_updates if use_buffer else 1
        lr = make_lr_schedule(n_epoch * max(steps_per_epoch, 1),
                              int(opt_cfg.get("warmup_n_epoch", 10)),
                              float(opt_cfg.get("peak_lr", 2e-4)))
    else:
        lr = float(opt_cfg.get("init_lr", 2e-5))
    opt = adam(lr)
    ignore_factor = float(opt_cfg.get("dynamic_grad_ignore_factor", 10.0))
    clip_factor = float(opt_cfg.get("dynamic_grad_norm_factor", 2.0))
    dynamic = bool(opt_cfg.get("dynamic_grad_ignore_and_clip", True))

    def loss_fn(params, x, w_norm, log_q_old):
        log_q = flow.log_prob(params, x)
        # the buffer correction: the weights were computed under q_old
        w_adj = torch.clamp(torch.exp((log_q_old - log_q).detach()), 0.0, w_clip)
        loss = -torch.sum(w_norm * w_adj * log_q)
        return loss, (loss.detach(), log_q.detach())

    loss_grad = grad_and_value(loss_fn, has_aux=True)

    def grad_update(carry: FABCarry, x, w_norm, log_q_old):
        grads, (_, (loss, log_q)) = loss_grad(carry.params, x, w_norm, log_q_old)
        gnorm = global_norm(grads)
        finite = torch.isfinite(gnorm) & torch.isfinite(loss)
        if dynamic:
            ema = torch.clamp(gnorm, min=1e-8) if carry.step == 0 else carry.grad_norm_ema
            keep = finite & (gnorm <= ignore_factor * ema)
            scale = torch.clamp(clip_factor * ema / torch.clamp(gnorm, min=1e-20), max=1.0)
            grads = {k: torch.where(keep, g * scale, 0.0) for k, g in grads.items()}
            ema = torch.where(keep, 0.99 * ema + 0.01 * gnorm, ema)
        else:
            grads = {k: torch.where(finite, g, 0.0) for k, g in grads.items()}
            ema = carry.grad_norm_ema
        # a skipped step is still an update (zero gradient): Adam's moments
        # decay and its count advances, as optax's
        updates, opt_state = opt.update(grads, carry.opt_state, carry.params)
        carry = carry._replace(params=apply_updates(carry.params, updates),
                               opt_state=opt_state, grad_norm_ema=ema, step=carry.step + 1)
        return carry, loss, log_q

    def flow_log_q(params, x):
        with torch.no_grad():
            return flow.log_prob(params, x)

    def finite_or_neg_inf(log_w):
        return torch.where(torch.isfinite(log_w), log_w, -torch.inf)

    def train_iter(carry: FABCarry, noise: FABIterNoise):
        x, log_w, acc, step_sizes = ais_forward(carry.params, carry.step_sizes, noise.ais)
        log_w = finite_or_neg_inf(log_w)
        log_z = torch.logsumexp(log_w, dim=0) - math.log(batch)  # AIS log Z_g
        carry = carry._replace(step_sizes=step_sizes)
        if use_buffer:
            carry = buffer_insert(carry, x, log_w, flow_log_q(carry.params, x))
            losses = []
            w_norm = torch.full((batch,), 1.0 / batch, device=x.device)  # priority-sampled
            for draw in noise.buffer:
                idx = categorical(carry.buf_log_w, draw)
                lqo = carry.buf_log_q[idx]
                carry, loss, log_q = grad_update(carry, carry.buf_x[idx], w_norm, lqo)
                # refresh the stored density and the priorities of the batch
                # just re-scored; a set (not an add), so a slot drawn twice
                # is adjusted once
                dlw = torch.clamp(lqo - log_q, -math.log(w_clip), math.log(w_clip))
                carry = carry._replace(
                    buf_log_q=carry.buf_log_q.index_put((idx,), log_q),
                    buf_log_w=carry.buf_log_w.index_put((idx,), carry.buf_log_w[idx] + dlw),
                )
                losses.append(loss)
            loss = torch.stack(losses).mean()
        else:  # on-policy: self-normalised AIS weights
            w_norm = torch.softmax(log_w, dim=0)
            carry, loss, _ = grad_update(carry, x, w_norm, flow_log_q(carry.params, x))
        return carry, (loss, acc, log_z)

    def prefill_one(carry: FABCarry, noise: AISNoise) -> FABCarry:
        x, log_w, _, step_sizes = ais_forward(carry.params, carry.step_sizes, noise)
        return buffer_insert(carry._replace(step_sizes=step_sizes), x,
                             finite_or_neg_inf(log_w), flow_log_q(carry.params, x))

    def init_carry(params) -> FABCarry:
        return FABCarry(
            params=params, opt_state=opt.init(params),
            grad_norm_ema=torch.zeros((), device=dev),
            step_sizes=torch.full((K + 1,), init_step, device=dev),
            buf_x=torch.zeros((cap, dim), device=dev),
            buf_log_w=torch.full((cap,), -torch.inf, device=dev),
            buf_log_q=torch.zeros((cap,), device=dev),
            buf_ptr=0, step=0,
        )

    def draw_ais_noise(gen: torch.Generator) -> AISNoise:
        d = gen.device
        return AISNoise(
            torch.randn((batch, dim), generator=gen, device=d),
            torch.randn((K + 1, n_outer, batch, dim), generator=gen, device=d),
            torch.rand((K + 1, n_outer, batch), generator=gen, device=d),
        )

    def draw_iter_noise(gen: torch.Generator) -> FABIterNoise:
        ais = draw_ais_noise(gen)
        n_draws = n_updates if use_buffer else 0
        return FABIterNoise(ais, [torch.rand(batch, generator=gen, dtype=torch.float64,
                                             device=gen.device) for _ in range(n_draws)])

    return FABPieces(
        flow=flow, params=params, init_carry=init_carry, ais_forward=ais_forward,
        prefill_one=prefill_one, train_iter=train_iter, draw_ais_noise=draw_ais_noise,
        draw_iter_noise=draw_iter_noise, log_gamma=log_gamma, transition=transition,
        buffer_insert=buffer_insert, grad_update=grad_update, n_epoch=n_epoch,
        min_batches=min_batches if use_buffer else 0, use_buffer=use_buffer, batch=batch,
        cap=cap,
    )


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_fab(
    target: Target,
    example: str,
    seed: int = 0,
    n_epoch: Optional[int] = None,
    batch_size: Optional[int] = None,
    config_dir=None,
    overrides: Optional[dict] = None,
    device="cuda",
) -> FABResult:
    """Train a FAB sampler on ``target`` with the example's config.

    Before the timed run, one AIS pass and one gradient step on the initial
    carry, with a separate generator, build the kernels and initialise the
    libraries; their result is discarded. ``train_time`` covers the buffer's
    prefill and the epochs."""
    pieces = build_fab(target, example, seed, n_epoch, batch_size, config_dir, overrides,
                       device)
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003)
    warm = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 1)
    carry = pieces.init_carry(pieces.params)
    warm_carry = pieces.prefill_one(carry, pieces.draw_ais_noise(warm))
    pieces.train_iter(warm_carry, pieces.draw_iter_noise(warm))
    _synchronize(device)

    t0 = time.perf_counter()
    for _ in range(pieces.min_batches):
        carry = pieces.prefill_one(carry, pieces.draw_ais_noise(gen))
    losses, accs, log_zs = [], [], []
    for _ in range(pieces.n_epoch):
        carry, (loss, acc, log_z) = pieces.train_iter(carry, pieces.draw_iter_noise(gen))
        losses.append(loss)
        accs.append(acc)
        log_zs.append(log_z)
    losses, accs, log_zs = torch.stack(losses), torch.stack(accs), torch.stack(log_zs)
    _synchronize(device)
    return FABResult(carry.params, pieces.flow, losses, accs, log_zs,
                     time.perf_counter() - t0)


def fab_baseline(target: Target, cfg, seed: int = 0, n_eval: Optional[int] = None,
                 device="cuda") -> BaselineResult:
    """FAB with the shared result: the final flow draws, IS-resampled in
    log space, and the extras ``final_loss``, ``mean_accept``,
    ``log_z_alpha2`` (the mean of the last ten AIS estimates), ``log_z_is``
    and ``is_ess_frac``."""
    res = run_fab(
        target, cfg.example, seed=seed, n_epoch=cfg.learning_iter, batch_size=cfg.num_chain,
        overrides={"flow": {"conditioner_mlp_units": list(cfg.hidden_xt)}}, device=device,
    )
    n_eval = n_eval or cfg.eval_iter * cfg.num_chain
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + 999)
    with torch.no_grad():
        eps = torch.randn((n_eval, target.dim), generator=gen, device=gen.device)
        flow_samples, log_flow = res.flow.sample_and_log_prob(res.params, eps)
        log_p = target.log_prob(flow_samples)
        exact, log_w = is_resample(flow_samples, log_p, log_flow, generator=gen)
    extras = {
        "final_loss": float(res.losses[-1]),
        "mean_accept": float(res.accept.mean()),
        "log_z_alpha2": float(res.log_z_alpha2[-min(10, len(res.log_z_alpha2)):].mean()),
        **is_summary(log_w),
    }
    return BaselineResult(flow_samples, exact, res.train_time, extras)
