"""CNF transport: batched push-forward / inverse with the log-determinant
(counterpart of ``mfm_tpu.flows.cnf``).

``forward`` maps u -> x and returns logdet = int_0^1 div v(x_t, t) dt =
log|det dx/du|, so log q(x) = log q0(u) - logdet; ``inverse`` maps x -> u
and returns the same quantity accumulated along the reverse path.

The field is a *tangent field* ``f(x, t, ex) -> (v, jv)``: the velocity
(B, d) and its x-derivative along K tangents ``ex`` (K, B, d), the
reference's ``jax.jvp`` of ``net.apply``. Two of them, which differ only in
the MLP part:

- ``module_tangent_field``: the net's MLP (no score term) and its
  tangents by a forward-mode pass written out in tensor ops: the primal
  once, then the K tangents as one batch of rows through the layers that
  depend on x, each rounded as its ``Dense`` rounds an operand;
- ``kernel_tangent_field``: K1 (``ops.field.field_apply``, one launch per
  stage for all K tangents).

Both then add the score gate gate * clip(s(x)) and its derivative
d/dx [gate * clip(s(x))] . e = gate * mask * (H e) (the gate depends on t
only) through the net's ``score_gate`` (None without a score): the
target's fused kernel where it has one, else ``vmap(jvp)`` of the score
(see ``VectorFieldNet``).
Leaving the derivative out would silently bias the logdet once the gate
head is trained.

Both binders take the frequencies as ``freqs`` (default: the net's own).
Frequencies (S, F) bind a seed sweep: ``bind(params)`` then takes
parameters stacked on a leading seed axis, and ``f`` takes seed-major rows,
x (S B, d), t (S B,), ex (K, S B, d), seed s owning rows s B ... s B + B -
1 (the reference's field under ``jax.vmap`` over seeds). K1 covers every
seed in one launch; the module path multiplies each seed's rows by its
own weights in one batched product a layer. The score gate runs once on all
S B rows, outside any ``vmap``: a fused gate writes through the tensors'
memory and cannot take a batched tensor.

Divergence estimators: ``exact`` pushes the d basis vectors (in chunks of
``EXACT_CHUNK`` tangents, built contiguous once per transport) and sums
the diagonal; ``hutchinson`` takes
probes (B, d) or (K, B, d) supplied by the caller and averages
p . (J p) over them. Both estimate the continuous flow's logdet.
``exact_disc`` is the exact log|det| of the discrete integrator map that
moves the particles: the d basis tangents ride the RK4/Heun/Euler map
itself (each stage's tangent is J . E at that stage's point, combined with
the step's own weights), and a batched ``slogdet`` of the assembled
(B, d, d) Jacobian closes it; d <= ``EXACT_DISC_MAX_D``. ``forward`` and
``inverse`` of ``exact`` and ``hutchinson`` are differentiable in their
input through ``torch.autograd`` and ``torch.func.grad`` (nothing is taped
when no input requires grad); ``exact_disc`` and ``forward_traj`` run
without autograd.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.func import jvp, vmap

from mfm_tpu_torch.flows.ode import odeint_grid, odeint_grid_save
from mfm_tpu_torch.flows.vector_field import NON_LINEARITIES, Dense
from mfm_tpu_torch.ops.field import (
    field_apply,
    field_layout,
    pack_field_params,
)
from mfm_tpu_torch.utils import profiling

EXACT_CHUNK = 64  # basis tangents per field call in the exact divergence
# exact_disc carries d tangents of d entries a sample and ends in a (B, d, d)
# slogdet: small d only, as the configuration says
EXACT_DISC_MAX_D = 128


def _round(v: torch.Tensor, precision: str) -> torch.Tensor:
    """A product operand as a ``Dense`` of this precision rounds it."""
    return v.bfloat16().float() if precision == "default" else v


def _act_and_slope(act_name: str, z: torch.Tensor):
    """(act(z), its derivative at z), the factor the activation's jvp puts
    on a tangent: relu's 0/1 mask z > 0, any other's ``torch.func.jvp``
    with a unit tangent."""
    act = NON_LINEARITIES[act_name]
    if act_name == "relu":
        return act(z), (z > 0).to(z.dtype)
    return jvp(act, (z,), (torch.ones_like(z),))


def _tangent_into(y: torch.Tensor, slope: torch.Tensor, precision: str, step: bool):
    """The tangent a Dense layer multiplies: its predecessor's tangent ``y``
    (S, K, B, w) times that layer's activation derivative ``slope`` (S, 1,
    B, w), rounded as the layer rounds an operand. A ``step`` slope (relu's
    0/1 mask z > 0) commutes with the rounding of a finite tangent, so at
    'default' the tangent is rounded first and the product casts it back to
    fp32: one pass less, the same value."""
    if step and precision == "default":
        return y.bfloat16() * slope
    return _round(y * slope, precision)


def module_tangent_field(net: torch.nn.Module, freqs: Optional[torch.Tensor] = None) -> Callable:
    """``bind(params) -> f(x, t, ex)``: the net's MLP and its tangents by a
    forward-mode pass written out in tensor ops, at ``params``, then the
    score gate. ``freqs`` (S, F) binds a seed sweep (see the module
    docstring).

    Every tensor of the pass has a leading seed axis (S = 1 for a single
    net), and ``bmm``/``baddbmm`` multiply seed s's rows by seed s's
    weights. ``bind`` rounds each weight once, as its ``Dense`` would at
    every call. The primal runs once on (S, B, .) rows and keeps each
    layer's activation derivative (``_act_and_slope``). The K
    tangents ride as K B rows a seed (one reorder of ``ex`` in and one of
    ``dfield`` out, none at S = 1) through the layers that depend on x:
    the x-trunk, the joint trunk and the field head, each rounding its
    incoming tangent as ``Dense`` rounds an operand. The net's
    concatenations ([cos, sin] into the t-trunk, [x-trunk, t-trunk] into
    the joint trunk) are taken as column blocks of the weight that
    multiplies them, so nothing copies them together; a tangent meets only
    the x-trunk's block, since the t-trunk's tangent is zero. Plain
    differentiable ops: ``torch.autograd`` and ``torch.func.grad`` run
    through the pass."""
    dense = {name: m for name, m in net.named_modules() if isinstance(m, Dense)}
    x_names, t_names, xt_names = (
        [f"{trunk}.{i}" for i in range(len(getattr(net, trunk)))]
        for trunk in ("x_trunk", "t_trunk", "xt_trunk"))
    n_f = net.fourier_freqs.shape[-1]
    t_widths = [dense[t_names[-1]].out_features] if t_names else [n_f, n_f]
    joint_widths = [dense[x_names[-1]].out_features if x_names else net.dim] + t_widths
    act_name = net.act_name
    act, step = NON_LINEARITIES[act_name], act_name == "relu"
    seeds = freqs is not None and freqs.ndim == 2

    def bind(params):
        gate_fn = net.score_gate
        fr = freqs if freqs is not None else params.get("fourier_freqs", net.fourier_freqs)
        S = fr.shape[0] if seeds else 1
        fr = fr.reshape(S, 1, n_f)

        def layer(name, widths=None):
            """(the rounded weight (S, in, out) as column blocks of these
            input widths, the bias (S, 1, out), the precision)."""
            w, b, p = params[f"{name}.weight"], params[f"{name}.bias"], dense[name].precision
            w = _round(w, p).reshape(S, *w.shape[-2:]).mT
            return (w.split(widths, 1) if widths else (w,)), b.reshape(S, 1, -1), p

        t_layers = [layer(n, [n_f, n_f] if i == 0 else None) for i, n in enumerate(t_names)]
        x_layers = [layer(n) for n in x_names]
        xt_layers = [layer(n, joint_widths if i == 0 else None) for i, n in enumerate(xt_names)]
        gate_head = layer("gate_head", t_widths)
        field_head = layer("field_head", None if xt_names else joint_widths)
        tangent_layers = x_layers + xt_layers + [field_head]

        def apply(spec, blocks):
            """One Dense on its input's column blocks: their products summed
            into the first (which no autograd node keeps), then the bias."""
            ws, b, p = spec
            z = torch.bmm(_round(blocks[0], p), ws[0])
            for h, w in zip(blocks[1:], ws[1:]):
                z = z.baddbmm_(_round(h, p), w)
            return z + b

        def f(x, t, ex):
            with profiling.span("stage.field"):
                profiling.count("field.tangent_pass")
                (K, _, d), B = ex.shape, x.shape[0] // S
                ang = (2.0 * math.pi) * t.reshape(S, B, 1) * fr
                h_t = [torch.cos(ang), torch.sin(ang)]
                for spec in t_layers:
                    h_t = [act(apply(spec, h_t))]
                slopes = []

                def trunk(specs, h):
                    """The trunk's output blocks; each layer's activation
                    derivative kept in ``slopes``."""
                    for spec in specs:
                        a, slope = _act_and_slope(act_name, apply(spec, h))
                        h = [a]
                        slopes.append(slope[:, None])
                    return h

                h = trunk(xt_layers, trunk(x_layers, [x.reshape(S, B, d)]) + h_t)
                field = apply(field_head, h).reshape(S * B, d)
                gate = apply(gate_head, h_t).reshape(S * B, d)

                e = ex.reshape(K, S, B, d).transpose(0, 1)  # (S, K, B, d)
                if tangent_layers[0][2] == "default":  # reordered by the rounding's cast
                    e = e.to(torch.bfloat16, memory_format=torch.contiguous_format).float()
                else:
                    e = e.contiguous()
                for i, (ws, _, p) in enumerate(tangent_layers):
                    if i:
                        e = _tangent_into(y.view(S, K, B, -1), slopes[i - 1], p, step)
                    y = torch.bmm(e.view(S, K * B, -1), ws[0])
                dfield = y.view(S, K, B, d).transpose(0, 1).reshape(K, S * B, d)
            if gate_fn is None:
                return field, dfield
            with profiling.span("stage.gate"):
                return gate_fn(x.contiguous(), gate, field, ex.contiguous(), dfield.contiguous(),
                               net.score_clip)

        return f

    return bind


def kernel_tangent_field(net: torch.nn.Module, freqs: Optional[torch.Tensor] = None) -> Callable:
    """``bind(params) -> f(x, t, ex)`` through the fused field kernel; the
    weights are packed once per ``bind`` (once per transport call).
    ``freqs`` (S, F) binds a seed sweep: one launch for every seed."""
    layout = field_layout(dict(net.named_parameters()), net.fourier_freqs.shape[0])

    def bind(params):
        packed = pack_field_params(params, layout)
        fr = (net.fourier_freqs if freqs is None else freqs).contiguous()
        gate_fn = net.score_gate

        def f(x, t, ex):
            with profiling.span("stage.field"):
                x, ex = x.contiguous(), ex.contiguous()
                field, gate, dfield = field_apply(packed, layout, net.act_name, fr, x, t, ex)
            if gate_fn is None:
                return field, dfield
            with profiling.span("stage.gate"):
                return gate_fn(x, gate, field, ex, dfield, net.score_clip)

        return f

    return bind


def exact_basis(x: torch.Tensor):
    """The d basis tangents of x (B, d) in chunks of ``EXACT_CHUNK``: a list
    of contiguous (k, B, d), which the tangent fields take without a copy."""
    B, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    return [eye[i0 : i0 + EXACT_CHUNK, None, :].expand(-1, B, d).contiguous()
            for i0 in range(0, d, EXACT_CHUNK)]


def exact_divergence(f, x, t, basis=None):
    """(v, div v) with div = sum_i (J e_i)_i over the d basis vectors;
    ``basis`` is ``exact_basis(x)``, built here when None."""
    B, d = x.shape
    if basis is None:
        basis = exact_basis(x)
    div = torch.zeros(B, dtype=x.dtype, device=x.device)
    for i0, chunk in zip(range(0, d, EXACT_CHUNK), basis):
        v, jv = f(x, t, chunk)
        with profiling.span("stage.divergence"):
            k = chunk.shape[0]
            idx = torch.arange(i0, i0 + k, device=x.device)
            div = div + jv[torch.arange(k, device=x.device), :, idx].sum(0)
    return v, div


def hutchinson_divergence(f, x, t, probe):
    """(v, p^T J p), averaged over K probes when ``probe`` is (K, B, d)."""
    probes = probe[None] if probe.ndim == x.ndim else probe
    v, jv = f(x, t, probes)
    with profiling.span("stage.divergence"):
        return v, torch.mean(torch.sum(probes * jv, dim=-1), dim=0)


_DIVERGENCES = {"exact": exact_divergence, "hutchinson": hutchinson_divergence}


class Transport(NamedTuple):
    """forward(params, u, probe=None) -> (x, logdet);
    inverse(params, x, probe=None) -> (u, logdet);
    probe_shape(B, d) -> the shape of the probe draw, or None;
    forward_traj(params, u, save_ts, probe=None) -> (S, B, d) positions at
    the times ``save_ts``."""

    forward: Callable
    inverse: Callable
    probe_shape: Callable
    probe_dist: str
    forward_traj: Callable


def _times(x, t: float):
    return torch.full(x.shape[:1], t, dtype=x.dtype, device=x.device)


def discrete_map_logdet(pos_map: Optional[Callable], u: torch.Tensor,
                        tangent_map: Optional[Callable] = None):
    """(x, log|det d pos_map / du|) of a batched discrete map, exactly: the
    d basis tangents pushed through the map give the (B, d, d) Jacobian a
    column at a time, closed by a batched ``slogdet``. ``tangent_map(u, E)
    -> (x, J E)``, for E (d, B, d), pushes them alongside the map itself
    (a transport carries them through its integrator); without it they
    are ``torch.func.jvp`` of ``pos_map``. The map must be batch-decoupled:
    sample b's output may depend on sample b's input alone, else the column
    pushes with e_i across the whole batch do not give each sample's
    Jacobian."""
    B, d = u.shape
    basis = torch.eye(d, dtype=u.dtype, device=u.device)[:, None, :].expand(d, B, d).contiguous()
    with torch.no_grad():
        if tangent_map is None:
            x = pos_map(u)
            cols = vmap(lambda e: jvp(pos_map, (u,), (e,))[1])(basis)
        else:
            x, cols = tangent_map(u, basis)
        # cols[i] = J e_i, (B, d): jac[b, :, i]
        return x, torch.linalg.slogdet(cols.permute(1, 2, 0))[1]


def _make_exact_disc_transport(bind: Callable, n_steps: int, method: str) -> Transport:
    """Transport whose logdet is the exact log-Jacobian of the discrete map,
    with the contract and sign convention of the other paths: ``forward``
    returns log|det dx/du| of the forward map, ``inverse`` the same
    quantity, that is -log|det du/dx| of the reverse map. Probes are taken
    and ignored."""

    def _run(params, y, sign):
        B, d = y.shape
        if d > EXACT_DISC_MAX_D:
            raise ValueError(
                f"divergence 'exact_disc' carries d tangents and a (B, d, d) Jacobian: "
                f"d <= {EXACT_DISC_MAX_D}, got {d}; use 'exact' or 'hutchinson'"
            )
        f = bind(params)

        def dyn(state, s):  # the map's own tangents: d(stage) = J(stage point) . E
            x, tangents = state
            v, jv = f(x, _times(x, s if sign > 0 else 1.0 - s), tangents.contiguous())
            return (v, jv) if sign > 0 else (-v, -jv)

        return discrete_map_logdet(
            None, y, lambda y0, basis: odeint_grid(dyn, (y0, basis), 0.0, 1.0, n_steps, method))

    def forward(params, u, probe=None):
        return _run(params, u, +1)

    def inverse(params, x, probe=None):
        u, logdet_rev = _run(params, x, -1)
        return u, -logdet_rev

    def forward_traj(params, u, save_ts, probe=None):
        f = bind(params)
        no_tangent = torch.zeros((1,) + u.shape, dtype=u.dtype, device=u.device)
        with torch.no_grad():
            return odeint_grid_save(
                lambda x, t: f(x, _times(x, t), no_tangent)[0], u, save_ts, n_steps, method
            )

    return Transport(forward, inverse, lambda B, d: None, "gaussian", forward_traj)  # no probes


def make_transport(
    bind: Callable,
    divergence: str = "exact",
    n_steps: int = 24,
    method: str = "rk4",
    num_probes: int = 1,
    probe_dist: str = "gaussian",
) -> Transport:
    """Whole-ensemble transport for a tangent field ``bind(params)``."""
    if divergence == "exact_disc":
        return _make_exact_disc_transport(bind, n_steps, method)
    if divergence not in _DIVERGENCES:
        raise ValueError(
            f"unknown divergence {divergence!r} (known: {sorted(_DIVERGENCES)}, 'exact_disc')"
        )
    div_fn = _DIVERGENCES[divergence]
    needs_probe = divergence == "hutchinson"

    def probe_shape(B, d):
        if not needs_probe:
            return None
        return (B, d) if num_probes == 1 else (num_probes, B, d)

    def _check_probe(probe):
        if needs_probe and probe is None:
            raise ValueError("hutchinson divergence requires a probe")

    def _problem(params, y, probe, sign):
        f = bind(params)
        if not needs_probe:  # the exact basis, the same at every stage
            probe = exact_basis(y)

        def dyn(state, s):
            x, _ = state
            v, div = div_fn(f, x, _times(x, s if sign > 0 else 1.0 - s), probe)
            return (v if sign > 0 else -v), div

        return dyn, (y, torch.zeros(y.shape[:1], dtype=y.dtype, device=y.device))

    def _run(params, y, probe, sign):
        # no no_grad here: a caller that differentiates in u (the pullback
        # target, ``flows/pullback.py``) takes its gradient through the solve
        _check_probe(probe)
        dyn, y0 = _problem(params, y, probe, sign)
        return odeint_grid(dyn, y0, 0.0, 1.0, n_steps, method)

    def forward(params, u, probe: Optional[torch.Tensor] = None):
        return _run(params, u, probe, +1)

    def inverse(params, x, probe: Optional[torch.Tensor] = None):
        return _run(params, x, probe, -1)

    def forward_traj(params, u, save_ts, probe: Optional[torch.Tensor] = None):
        _check_probe(probe)
        dyn, y0 = _problem(params, u, probe, +1)
        with torch.no_grad():
            return odeint_grid_save(dyn, y0, save_ts, n_steps, method)[0]

    return Transport(forward, inverse, probe_shape, probe_dist, forward_traj)


def draw_probe(transport: Transport, generator: torch.Generator, B: int, d: int):
    """The probe a Hutchinson transport needs (None for exact)."""
    shape = transport.probe_shape(B, d)
    if shape is None:
        return None
    if transport.probe_dist == "rademacher":
        bits = torch.randint(0, 2, shape, generator=generator, device=generator.device)
        return bits.to(torch.float32) * 2.0 - 1.0
    return torch.randn(shape, generator=generator, device=generator.device)


def flow_log_density(ref_log_prob: Callable, u: torch.Tensor, logdet: torch.Tensor):
    """log q(x) of a push-forward sample: log q0(u) - log|det dx/du|."""
    return ref_log_prob(u) - logdet
