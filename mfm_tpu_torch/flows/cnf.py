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

Divergence estimators: ``exact`` pushes the d basis vectors (in chunks of
``EXACT_CHUNK`` tangents, built contiguous once per transport) and sums
the diagonal; ``hutchinson`` takes
probes (B, d) or (K, B, d) supplied by the caller and averages
p . (J p) over them. The transport runs without autograd.
"""

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import functional_call, jvp, vmap

from mfm_tpu_torch.flows.ode import odeint_grid
from mfm_tpu_torch.ops.field import (
    field_apply,
    field_layout,
    pack_field_params,
)

EXACT_CHUNK = 64  # basis tangents per field call in the exact divergence


class _MLP(torch.nn.Module):
    """The net's ``mlp`` (field and gate, without the score term) as a
    module, for ``functional_call`` at the parameters ``net.<name>``."""

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x, t):
        return self.net.mlp(x, t)


def module_tangent_field(net: torch.nn.Module) -> Callable:
    """``bind(params) -> f(x, t, ex)``: the net's MLP under
    ``torch.func.jvp`` at ``params`` (its primal computed once, inside the
    jvp), then the score gate."""
    mlp = _MLP(net)

    def bind(params):
        gate_fn = net.score_gate
        mlp_params = {f"net.{k}": v for k, v in params.items()}

        def f(x, t, ex):
            def apply(u):
                return functional_call(mlp, mlp_params, (u, t))  # (field, gate as aux)

            def one(e):
                field, dfield, gate = jvp(apply, (x,), (e,), has_aux=True)
                return dfield, field, gate

            dfield, field, gate = vmap(one, out_dims=(0, None, None))(ex)
            if gate_fn is None:
                return field, dfield
            return gate_fn(
                x.contiguous(), gate, field, ex.contiguous(), dfield.contiguous(), net.score_clip
            )

        return f

    return bind


def kernel_tangent_field(net: torch.nn.Module) -> Callable:
    """``bind(params) -> f(x, t, ex)`` through the fused field kernel; the
    weights are packed once per ``bind`` (once per transport call)."""
    layout = field_layout(dict(net.named_parameters()), net.fourier_freqs.shape[0])

    def bind(params):
        packed = pack_field_params(params, layout)
        freqs = net.fourier_freqs.contiguous()
        gate_fn = net.score_gate

        def f(x, t, ex):
            x, ex = x.contiguous(), ex.contiguous()
            field, gate, dfield = field_apply(packed, layout, net.act_name, freqs, x, t, ex)
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
    probe_shape(B, d) -> the shape of the probe draw, or None."""

    forward: Callable
    inverse: Callable
    probe_shape: Callable
    probe_dist: str


def make_transport(
    bind: Callable,
    divergence: str = "exact",
    n_steps: int = 24,
    method: str = "rk4",
    num_probes: int = 1,
    probe_dist: str = "gaussian",
) -> Transport:
    """Whole-ensemble transport for a tangent field ``bind(params)``."""
    if divergence not in _DIVERGENCES:
        raise NotImplementedError(
            f"divergence {divergence!r} is not ported yet (ported: {sorted(_DIVERGENCES)})"
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

    def _run(params, y, probe, sign):
        f = bind(params)
        if not needs_probe:  # the exact basis, the same at every stage
            probe = exact_basis(y)

        def dyn(state, s):
            x, _ = state
            t = s if sign > 0 else 1.0 - s
            tb = torch.full(x.shape[:1], t, dtype=x.dtype, device=x.device)
            v, div = div_fn(f, x, tb, probe)
            return (v if sign > 0 else -v), div

        y0 = (y, torch.zeros(y.shape[:1], dtype=y.dtype, device=y.device))
        with torch.no_grad():
            return odeint_grid(dyn, y0, 0.0, 1.0, n_steps, method)

    def forward(params, u, probe: Optional[torch.Tensor] = None):
        _check_probe(probe)
        return _run(params, u, probe, +1)

    def inverse(params, x, probe: Optional[torch.Tensor] = None):
        _check_probe(probe)
        return _run(params, x, probe, -1)

    return Transport(forward, inverse, probe_shape, probe_dist)


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
