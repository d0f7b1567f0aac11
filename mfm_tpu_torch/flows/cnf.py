"""CNF transport: batched push-forward / inverse with the log-determinant
(counterpart of ``mfm_tpu.flows.cnf``).

``forward`` maps u -> x and returns logdet = int_0^1 div v(x_t, t) dt =
log|det dx/du|, so log q(x) = log q0(u) - logdet; ``inverse`` maps x -> u
and returns the same quantity accumulated along the reverse path.

The field is a *tangent field* ``f(x, t, ex) -> (v, jv)``: the velocity
(B, d) and its x-derivative along K tangents ``ex`` (K, B, d). Two of them:

- ``module_tangent_field``: the ``VectorFieldNet`` under ``torch.func.jvp``
  (the reference's ``jax.jvp`` of ``net.apply``), score gate included;
- ``kernel_tangent_field``: K1 (``ops.field.field_apply``, one launch per
  stage for all K tangents) plus the score gate, whose derivative the
  kernel does not see: d/dx [gate * clip(s(x))] . e = gate * mask * (H e),
  with H e from ``torch.func.jvp`` of the target score. Leaving it out
  would silently bias the logdet once the gate head is trained.

Divergence estimators: ``exact`` pushes the d basis vectors (in chunks of
``EXACT_CHUNK`` tangents) and sums the diagonal; ``hutchinson`` takes
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


def module_tangent_field(net: torch.nn.Module) -> Callable:
    """``bind(params) -> f(x, t, ex)`` through ``torch.func.jvp`` of the
    net's ``forward`` at ``params``."""

    def bind(params):
        def f(x, t, ex):
            def apply(u):
                return functional_call(net, params, (u, t))

            def one(e):
                return jvp(apply, (x,), (e,))[1]

            return apply(x), vmap(one)(ex)

        return f

    return bind


def kernel_tangent_field(net: torch.nn.Module) -> Callable:
    """``bind(params) -> f(x, t, ex)`` through the fused field kernel; the
    weights are packed once per ``bind`` (once per transport call)."""
    layout = field_layout(dict(net.named_parameters()), net.fourier_freqs.shape[0])

    def bind(params):
        packed = pack_field_params(params, layout)
        freqs = net.fourier_freqs.contiguous()

        def f(x, t, ex):
            x = x.contiguous()
            field, gate, dfield = field_apply(
                packed, layout, net.act_name, freqs, x, t, ex.contiguous()
            )
            if net.score_fn is None:
                return field, dfield
            score = net.score_fn(x)
            dscore = vmap(lambda e: jvp(net.score_fn, (x,), (e,))[1])(ex)
            if net.score_clip is not None:
                inside = (score > -net.score_clip) & (score < net.score_clip)
                dscore = dscore * inside
                score = torch.clamp(score, -net.score_clip, net.score_clip)
            return field + gate * score, dfield + gate * dscore

        return f

    return bind


def exact_divergence(f, x, t, probe=None):
    """(v, div v) with div = sum_i (J e_i)_i over the d basis vectors."""
    B, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    div = torch.zeros(B, dtype=x.dtype, device=x.device)
    for i0 in range(0, d, EXACT_CHUNK):
        idx = torch.arange(i0, min(d, i0 + EXACT_CHUNK), device=x.device)
        basis = eye[idx][:, None, :].expand(len(idx), B, d)
        v, jv = f(x, t, basis)
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
