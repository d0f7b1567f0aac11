"""Traffic kind ``train_sweep``: S seeds of MFM training in one seed-batched
sweep, as ``drivers/multi_seed.py::run_mfm_seeds`` builds it, in whole
cycles of ``mcmc_per_flow_steps + 1`` iterations (that many MALA
iterations, then a flow iteration).

Set-up builds the program's sweep (``drivers/mfm.py::build_mfm`` with one
net a seed), gives it the benchmark's weights, frequencies and initial
chains, and drives it through its first cycle by the window's own call
and feed: the warm-up of both kinds of iteration, and the steps the
reference follows from the inputs.
The window continues the same object. Every iteration's noise is the
feed's: drawn from the seed on the device in the layout of the program's
``draw_step_noise``, a few large draws an iteration. At the start of each
window cycle and before its flow iteration the program's state is copied
aside (two multi-tensor copies of a few MB), so that the last cycle of the
window can be followed once it has closed.

The check (after the window, the program's state freed) covers two
cycles: the first, from the inputs, and the window's last, from the
program's state at its start. In each the reference (``reference/mfm.py``)
runs the MALA iterations on its own with the same noise: each step's loss,
each leaf's change over those steps, and in the first cycle the first
gradient as AdamW holds it (its first moment over 1 - b1). The flow
iteration that closes each cycle it follows from the program's chain
positions and parameters before it: where both sides accepted, the moved
positions against the reference's proposals; the accept decisions that
differ beyond a near-tie; the loss on the chains the program moved; and
each leaf's change by that iteration's AdamW step.
"""

import math
from typing import NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from cardbench import inputs

# an accept decision whose reference log ratio lies within TIE times its
# rounding scale of log u may fall either way (sound runs' log ratios read
# at most 4.0e-5 of that scale from the reference's, the control's 5.2e-3);
# such rows are left out of the decisions and proposals compared
TIE = 1e-3


class State(NamedTuple):
    config: dict
    traffic: dict
    cfg: object
    S: int
    cycle: int
    device: str
    feed_gen: torch.Generator
    box: dict  # mutable: the program, its carry, the count, the window's counters
    kept: dict  # what the check needs


def _is_flow(count: int, cycle: int) -> bool:
    return count % cycle == 0


def _tensors(tree):
    leaves, spec = tree_flatten(tree)
    return [v for v in leaves if isinstance(v, torch.Tensor)], leaves, spec


def _copy_into(buf: Optional[list], tree) -> list:
    """The tensors of ``tree`` copied into ``buf`` (made on first use)."""
    src = _tensors(tree)[0]
    if buf is None:
        return [v.clone() for v in src]
    torch._foreach_copy_(buf, src)
    return buf


def _rebuild(like, buf: list):
    """``like``'s structure over the copied tensors ``buf``."""
    _, leaves, spec = _tensors(like)
    it = iter(buf)
    return tree_unflatten([next(it) if isinstance(v, torch.Tensor) else v for v in leaves], spec)


def _clone(tree):
    return _rebuild(tree, _copy_into(None, tree))


def feed(state: State, count: int):
    """The iteration's (move noise, FMNoise) for all S B chains."""
    from mfm_tpu_torch.drivers.mfm import FMNoise
    from mfm_tpu_torch.flows.flow_mh import RwmNoise
    from mfm_tpu_torch.kernels.mala import MalaNoise

    g, S, B, d = state.feed_gen, state.S, state.cfg.num_chain, state.cfg.dim
    dev = g.device
    normals = torch.randn((3, S * B, d), generator=g, device=dev)
    uniforms = torch.rand((2, S * B), generator=g, device=dev)
    move = (RwmNoise(normals[0], uniforms[0], None, None) if _is_flow(count, state.cycle)
            else MalaNoise(normals[0], uniforms[0]))
    fm = FMNoise(uniforms[1].view(S, B), normals[1].view(S, B, d), normals[2].view(S, B, d))
    return move, fm


def setup(cell, seed: int, device, clock, overrides: dict):
    from mfm_tpu_torch.drivers.mfm import build_mfm, stack_trees
    from mfm_tpu_torch.flows.train import create_train_state
    from mfm_tpu_torch.ops import build
    from mfm_tpu_torch.targets import PhiFour

    config = {**cell.config, "config": {**cell.config["config"], **overrides.get("config", {})}}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    if torch.device(device).type == "cuda":
        build.load_library()
    clock.part("build")

    cfg = inputs.program_config(config)
    S, B, d = traffic["seeds"], cfg.num_chain, cfg.dim
    tconf = config["target"]
    target = PhiFour(d, a=tconf["a"], beta=tconf["beta"], bc=(tconf["boundary"],
                                                              tconf["boundary_value"]))
    # the nets' structure (its CPU initialisation is replaced below)
    pieces = build_mfm(target, cfg, device, [torch.Generator().manual_seed(s) for s in range(S)])
    clock.part("program")

    conf = inputs.flat_conf(config)
    params, freqs = inputs.make_field(conf, S, inputs.generator(device, seed, "weights"))
    got = {k: tuple(v.shape) for k, v in pieces.net.named_parameters()}
    want = {k: tuple(v.shape[1:]) for k, v in params.items()}
    if got != want:
        raise RuntimeError(f"the program's field has other parameters: {got} != {want}")
    pieces.fourier.copy_(freqs)  # the sweep's frequencies, bound into its transport and loss
    pos_gen = inputs.generator(device, seed, "positions")
    positions = torch.rand((S * B, d), generator=pos_gen, device=pos_gen.device) * 2.0 - 1.0
    carry = pieces.init_fn(positions)
    carry = carry._replace(train=stack_trees([
        create_train_state({k: v[s] for k, v in params.items()}, pieces.tx) for s in range(S)]))
    clock.part("inputs")

    cycle = int(cfg.mcmc_per_flow_steps) + 1
    state = State(config, traffic, cfg, S, cycle, device,
                  inputs.generator(device, seed, "feed"),
                  {"pieces": pieces, "carry": carry, "count": 0, "failed": None,
                   "kinds": {"mcmc": 0, "flow": 0}, "events": []},
                  {"positions": positions, "params0": params, "freqs": freqs})

    # the first cycle, through the window's own call and feed
    first = {"noises": []}
    losses = []
    for count in range(1, cycle + 1):
        noise = feed(state, count)
        before = state.box["carry"]
        if count == cycle:
            first["before_flow"] = _clone(before)
        carry, m = pieces.step_fn(before, count, *noise)
        state.box["carry"] = carry
        state.box["count"] = count
        first["noises"].append(noise)
        losses.append(m["loss"].clone())
        if count == 1:
            first["mu1"] = _clone(carry.train.opt_state.mu)
    first["after"] = _clone(state.box["carry"])
    first["losses"] = torch.stack(losses)
    state.kept["first"] = first
    beta = state.box["carry"].beta
    if not bool((beta == 1.0).all()):
        raise RuntimeError(f"a seed's beta is below 1 when the window opens: {beta.tolist()}")
    state.box["failed"] = torch.zeros((), dtype=torch.int64, device=positions.device)
    state.box["losses"] = torch.empty((cycle,) + tuple(first["losses"].shape[1:]),
                                      dtype=first["losses"].dtype, device=positions.device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    clock.part("warm")
    return state


def unit(state: State, spans) -> None:
    """One whole cycle of the window; its start, the state before its flow
    iteration, its noise and its losses are kept until the next."""
    box = state.box
    step = box["pieces"].step_fn
    cuda = torch.device(state.device).type == "cuda"
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else []
    box["start"] = _copy_into(box.get("start"), box["carry"])
    box["noises"] = []
    if cuda:
        events[0].record()
    for k in range(state.cycle):
        count = box["count"] + 1
        noise = spans.run("feed", feed, state, count)
        kind = "flow" if _is_flow(count, state.cycle) else "mcmc"
        if kind == "flow":
            box["before_flow"] = _copy_into(box.get("before_flow"), box["carry"])
            if cuda:
                events[1].record()
        box["carry"], m = spans.run(f"iter.{kind}", step, box["carry"], count, *noise)
        box["failed"] += (~torch.isfinite(m["loss"])).any()
        box["losses"][k].copy_(m["loss"])
        box["noises"].append(noise)
        box["count"] = count
        box["kinds"][kind] += 1
    if cuda:
        events[2].record()
        box["events"].append(events)


def summarize(state: State, units: int, seconds: float) -> dict:
    iters = units * state.cycle
    events = state.box["events"]
    if events:  # the window has synchronised: device time of each part of a cycle
        mcmc = [a.elapsed_time(b) for a, b, _ in events]
        flow = [b.elapsed_time(c) for _, b, c in events]
        print(f"cardbench: cycle parts by CUDA events (ms): mcmc mean {sum(mcmc) / len(mcmc):.3f} "
              f"min {min(mcmc):.3f} max {max(mcmc):.3f}; flow mean {sum(flow) / len(flow):.3f} "
              f"min {min(flow):.3f} max {max(flow):.3f}; of {len(events)} cycles", flush=True)
    return {
        "attempted": iters,
        "failed": int(state.box["failed"]),
        "e2e": {"train_iters_per_s": iters / seconds},
        "window": {"iterations": iters, "cycles": units, "seconds": seconds,
                   "mcmc": units * (state.cycle - 1), "flow": units,
                   "multiple_of_cycle": iters % state.cycle == 0},
    }


def release(state: State) -> None:
    """Keep the window's last cycle (copies of a few MB), free the program."""
    box = state.box
    carry = box["carry"]
    state.kept["window"] = {
        "start": _rebuild(carry, box["start"]),
        "before_flow": _rebuild(carry, box["before_flow"]),
        "after": _clone(carry),
        "noises": box["noises"],
        "losses": box["losses"],
    }
    box.clear()


def _leaf_gap(prog: dict, ref: dict, mask: Optional[dict] = None) -> float:
    """The worst leaf's gap of norms: |norm(prog) - norm(ref)| over the
    larger of norm(ref) and the median leaf's norm, leaf by leaf and seed by
    seed; ``mask`` (leaf -> (S,) bool) leaves some out."""
    worst = 0.0
    ref_norms = torch.stack([v.flatten(1).norm(dim=1) for v in ref.values()])  # (leaves, S)
    median = ref_norms.median(dim=0).values
    for i, k in enumerate(ref):
        p = prog[k].flatten(1).norm(dim=1)
        gap = (p - ref_norms[i]).abs() / torch.maximum(ref_norms[i], median)
        if mask is not None:
            gap = torch.where(mask[k], gap, torch.zeros_like(gap))
        gap = torch.where(torch.isnan(gap), torch.full_like(gap, math.inf), gap)
        worst = max(worst, float(gap.max()))
    return worst


def _moving(grads: dict) -> dict:
    """leaf -> (S,) bool: the leaves whose gradient, in the reference, is at
    least a thousandth of the median leaf's (the others move under AdamW by
    round-off alone)."""
    norms = torch.stack([v.flatten(1).norm(dim=1) for v in grads.values()])
    floor = 1e-3 * norms.median(dim=0).values
    return {k: norms[i] >= floor for i, k in enumerate(grads)}


def _rel_gap(prog, ref) -> float:
    """max |prog - ref| / |ref| over the entries finite on both sides; inf
    where one side is finite and the other not, or where both are not
    finite and differ."""
    both = torch.isfinite(prog) & torch.isfinite(ref)
    alike = both | (torch.isnan(prog) & torch.isnan(ref)) | (prog == ref)
    if not bool(alike.all()):
        return math.inf
    if not bool(both.any()):
        return 0.0
    return float(((prog - ref).abs() / ref.abs())[both].max())


def _max_over(gap, rows) -> float:
    """The largest of ``gap`` over ``rows``; NaN reads inf."""
    if not bool(rows.any()):
        return 0.0
    worst = float(gap[rows].max())
    return math.inf if math.isnan(worst) else worst


def _cycle_readings(state: State, run: dict, start, prec_ref: str, prec: Optional[str],
                    fault: Optional[str]) -> dict:
    """The numbers compared over one cycle. ``run`` holds what the program
    produced in it (its losses, its state before the flow iteration and
    after the cycle, its noise; the first cycle also AdamW's first moment
    after step 1); ``start`` is (positions, params, AdamW state) the cycle
    began from. ``prec`` or ``fault`` puts the reference in the program's
    place (the control and the planted faults)."""
    from cardbench.reference import mfm as ref
    from cardbench.reference.targets import PhiFour as RefPhiFour

    cfg, S, B, d, cycle = state.cfg, state.S, state.cfg.num_chain, state.cfg.dim, state.cycle
    tconf = state.config["target"]
    target = RefPhiFour(d, tconf["a"], tconf["beta"])
    opt = {k: getattr(cfg, k) for k in ("learning_rate", "learning_iter", "adam_beta1",
                                        "adam_beta2", "adam_epsilon", "weight_decay",
                                        "gradient_clip")}
    freqs = state.kept["freqs"]
    rows = lambda v: v.view(S, B, *v.shape[1:])
    noises = run["noises"]
    positions0, params0, adam0 = start
    judged = prec is not None or fault is not None

    def follow(prec_run, fault_run):
        """The MALA iterations: (losses, first gradient, params, adam)."""
        chains = ref.init_chains(target, positions0)
        params, adam = params0, adam0
        losses, g1 = [], None
        for k in range(cycle - 1):
            move, fm = noises[k]
            chains = ref.mala_step(target, chains, cfg.step_size, rows(move.noise),
                                   rows(move.u_accept))
            loss, grads = ref.fm_loss_and_grad(target, params, freqs, chains.position,
                                               (fm.t, fm.x0, fm.eps), cfg.sigma, prec_run,
                                               fault_run)
            if k == 0:
                g1 = grads
            if fault_run != "unchanged":
                params, adam = ref.adamw_step(params, grads, adam, opt)
            losses.append(loss)
        return losses, g1, params

    before = run["before_flow"]
    x_before = rows(before.chain.position)
    p_before = before.train.params
    o_before = before.train.opt_state
    adam_before = ref.Adam(o_before.count, o_before.mu, o_before.nu)
    move, fm = noises[cycle - 1]
    u_accept = rows(move.u_accept)
    fm_noise = (fm.t, fm.x0, fm.eps)

    def flow_move(prec_run):
        """The flow move from the program's positions before it."""
        chains = ref.init_chains(target, x_before)
        return ref.flow_step(target, chains, p_before, freqs, rows(move.eps), u_accept,
                             prec_run, cfg.ode_steps)

    def flow_train(moved, prec_run, fault_run):
        """(loss, gradient, params) of the flow iteration's training step on
        the moved chains ``moved``."""
        loss, grads = ref.fm_loss_and_grad(target, p_before, freqs, moved, fm_noise, cfg.sigma,
                                           prec_run, fault_run)
        if fault_run == "unchanged":
            return loss, grads, p_before
        return loss, grads, ref.adamw_step(p_before, grads, adam_before, opt)[0]

    with torch.no_grad():
        losses_r, g1_r, p_r = follow(prec_ref, None)
        _, x_r, ratio_r, ratio_scale = flow_move(prec_ref)
        if judged:
            losses_p, g1_p, p_p = follow(prec or prec_ref, fault)
            moved = flow_move(prec or prec_ref)[0].position
            loss_f_p, _, after_p = flow_train(moved, prec or prec_ref, fault)
        else:
            losses_p = list(run["losses"][:cycle - 1])
            if "mu1" in run:
                b1 = cfg.adam_beta1
                g1_p = {k: v / (1.0 - b1) for k, v in run["mu1"].items()}
            p_p = p_before
            loss_f_p = run["losses"][cycle - 1]
            moved = rows(run["after"].chain.position)
            after_p = run["after"].train.params
        # the reference's step on the judged side's moved chains: an accept
        # decision that rounding tips moves a whole row, which the loss and
        # the gradient would read as a gap
        loss_f_r, grads_f_r, after_r = flow_train(moved, prec_ref, None)
    change = lambda p, p0: {k: p[k] - p0[k] for k in p}
    # accept decisions: the judged side's (its chain left its position)
    # against the reference's, where the reference's log ratio lies beyond
    # TIE of its scale from log u
    scale = torch.clamp(ratio_scale, min=1.0)
    safe_r = torch.where(torch.isnan(ratio_r), -torch.inf, ratio_r)
    took_r = u_accept < torch.exp(torch.clamp(safe_r, max=0.0))
    took_p = (moved != x_before).any(-1)
    clear = ((torch.log(u_accept) - safe_r).abs() > TIE * scale) | (safe_r >= 0)
    gap_x = ((moved - x_r).abs() / torch.clamp(x_r.abs(), min=1.0)).amax(-1)
    compared = took_p & took_r & clear
    out = {
        "rows": f"{int(compared.sum())} moved on both sides of {S * B}",
        "loss_gap": _rel_gap(torch.stack(losses_p + [loss_f_p]),
                             torch.stack(losses_r + [loss_f_r])),
        "change_gap": max(_leaf_gap(change(p_p, params0), change(p_r, params0), _moving(g1_r)),
                          _leaf_gap(change(after_p, p_before), change(after_r, p_before),
                                    _moving(grads_f_r))),
        "proposal_gap": _max_over(gap_x, compared),
        "accept_rows": float(((took_p != took_r) & clear).sum()),
    }
    if "mu1" in run:  # the first cycle's
        out["grad_gap"] = _leaf_gap(g1_p, g1_r)
    return out


def reference_readings(state: State, side: dict, limits: dict, prec: Optional[str] = None,
                       fault: Optional[str] = None) -> dict:
    """The numbers compared, the worst of the first cycle (from the inputs)
    and of the window's last (from the program's state at its start);
    ``side`` holds what the program produced in both. ``prec`` and
    ``fault`` make the reference the side judged (the control and the
    planted faults)."""
    from cardbench.reference import mfm as ref

    S, B = state.S, state.cfg.num_chain
    prec_ref = state.cfg.field_precision  # 'default' (bf16 operands) or 'highest'
    kept = state.kept
    params0 = kept["params0"]
    first = _cycle_readings(
        state, side["first"],
        (kept["positions"].view(S, B, -1), params0, ref.adam_init(params0)),
        prec_ref, prec, fault)
    w = side["window"]["start"]
    o = w.train.opt_state
    last = _cycle_readings(
        state, side["window"],
        (w.chain.position.view(S, B, -1), w.train.params, ref.Adam(o.count, o.mu, o.nu)),
        prec_ref, prec, fault)
    print(f"cardbench: readings of the first cycle {first}; of the window's last {last}",
          flush=True)
    first.pop("rows"), last.pop("rows")
    return {k: (v + last[k] if k == "accept_rows" else max(v, last.get(k, v)))
            for k, v in first.items()}


def check(state: State, limits: dict) -> dict:
    return reference_readings(state, state.kept, limits)
