"""CNF transport: batched push-forward / inverse with the log-determinant
(counterpart of ``mfm_tpu.flows.cnf``).

``forward`` maps u -> x and returns logdet = int_0^1 div v(x_t, t) dt =
log|det dx/du|, so log q(x) = log q0(u) - logdet; ``inverse`` maps x -> u
and returns the same quantity accumulated along the reverse path.

The field is a *tangent field* ``f(x, t, ex) -> (v, jv)``: the velocity
(B, d) and its x-derivative along K tangents ``ex`` (K, B, d), the
reference's ``jax.jvp`` of ``net.apply``. Two of them, which differ only in
the MLP part:

- ``module_tangent_field``: the net's MLP (no score term) under
  ``torch.func.jvp``;
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
seed in one launch; the module path puts a ``torch.func.vmap`` over seeds
outside its tangent ``vmap`` of ``jvp``. The score gate runs once on all
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

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call, jvp, vmap

from mfm_tpu_torch.flows.ode import odeint_grid, odeint_grid_save
from mfm_tpu_torch.ops.field import (
    field_apply,
    field_layout,
    pack_field_params,
)

EXACT_CHUNK = 64  # basis tangents per field call in the exact divergence
# exact_disc carries d tangents of d entries a sample and ends in a (B, d, d)
# slogdet: small d only, as the configuration says
EXACT_DISC_MAX_D = 128


class _MLP(torch.nn.Module):
    """The net's ``mlp`` (field and gate, without the score term) as a
    module, for ``functional_call`` at the parameters ``net.<name>``."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x, t):
        return self.net.mlp(x, t)


def _seed_rows(S: int, *tensors):
    """Seed-major rows (S B, ...) as (S, B, ...); ex (K, S B, d) as (K, S, B, d)."""
    return [v.unflatten(-2 if v.ndim == 3 else 0, (S, -1)) for v in tensors]


def module_tangent_field(net: torch.nn.Module, freqs: Optional[torch.Tensor] = None) -> Callable:
    """``bind(params) -> f(x, t, ex)``: the net's MLP under
    ``torch.func.jvp`` at ``params`` (its primal computed once, inside the
    jvp), then the score gate. ``freqs`` (S, F) binds a seed sweep (see
    the module docstring)."""
    mlp = _MLP(net)
    seeds = freqs is not None and freqs.ndim == 2

    def tangents(mlp_params, x, t, ex):
        def apply(u):
            return functional_call(mlp, mlp_params, (u, t))  # (field, gate as aux)

        def one(e):
            field, dfield, gate = jvp(apply, (x,), (e,), has_aux=True)
            return dfield, field, gate

        # field and gate do not depend on e: vmap returns them expanded over
        # the K tangents (out_dims=None refuses a tensor batched over seeds)
        dfield, field, gate = vmap(one)(ex)
        return dfield, field[0], gate[0]

    def bind(params):
        gate_fn = net.score_gate
        mlp_params = {f"net.{k}": v for k, v in params.items()}
        if freqs is not None:
            mlp_params["net.fourier_freqs"] = freqs

        def f(x, t, ex):
            if seeds:
                S = freqs.shape[0]
                dfield, field, gate = vmap(tangents, in_dims=(0, 0, 0, 1), out_dims=(1, 0, 0))(
                    mlp_params, *_seed_rows(S, x, t, ex))
                dfield, field, gate = dfield.flatten(1, 2), field.flatten(0, 1), gate.flatten(0, 1)
            else:
                dfield, field, gate = tangents(mlp_params, x, t, ex)
            if gate_fn is None:
                return field, dfield
            return gate_fn(
                x.contiguous(), gate, field, ex.contiguous(), dfield.contiguous(), net.score_clip
            )

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
            x, ex = x.contiguous(), ex.contiguous()
            field, gate, dfield = field_apply(packed, layout, net.act_name, fr, x, t, ex)
            if gate_fn is None:
                return field, dfield
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
        idx = torch.arange(i0, i0 + chunk.shape[0], device=x.device)
        v, jv = f(x, t, chunk)
        div = div + jv[torch.arange(len(idx), device=x.device), :, idx].sum(0)
    return v, div


def hutchinson_divergence(f, x, t, probe):
    """(v, p^T J p), averaged over K probes when ``probe`` is (K, B, d)."""
    probes = probe[None] if probe.ndim == x.ndim else probe
    v, jv = f(x, t, probes)
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
        basis = torch.eye(d, dtype=y.dtype, device=y.device)[:, None, :].expand(d, B, d)

        def dyn(state, s):  # the map's own tangents: d(stage) = J(stage point) . E
            x, tangents = state
            v, jv = f(x, _times(x, s if sign > 0 else 1.0 - s), tangents.contiguous())
            return (v, jv) if sign > 0 else (-v, -jv)

        with torch.no_grad():
            out, tangents = odeint_grid(dyn, (y, basis.contiguous()), 0.0, 1.0, n_steps, method)
            # tangents[i] = J e_i, one (B, d) column set: jac[b, :, i]
            logdet = torch.linalg.slogdet(tangents.permute(1, 2, 0))[1]
        return out, logdet

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
