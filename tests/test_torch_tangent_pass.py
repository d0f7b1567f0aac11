"""The module field's forward-mode pass (``flows.cnf.module_tangent_field``)
against ``torch.func.jvp`` of the net's MLP under ``vmap``, the way the
field computed its tangents before the pass was written out by hand (the
twin below, built in this file).

Tolerances, relative to the largest entry of each output:

- 'highest': 1e-5. The products are the same; only the summation order of
  the split joint layer and of the GEMMs' grouping differs (measured up to
  4.3e-7).
- 'default', relu: 1e-5 on every entry. Its tangent is the rounded one
  times a 0/1 mask on both sides (measured: equal).
- 'default', the other activations: 1e-5 for all but 1 % of the entries,
  and 2^-8 (one bf16 step) for those. An fp32 value that lies within an
  ulp of a bf16 rounding boundary may round to the neighbouring bf16
  value on one side only, once its product or sum was taken in another
  order, and that one operand then moves the entries that depend on it by
  up to ~2^-8 of their size. Measured over 48 cases: at most 0.39 % of
  the entries beyond 1e-5, at most 6.8e-4. A tangent left unrounded moves
  95-99 % of the entries past 1e-5, and a derivative 10 % wrong on the
  0.1-0.5 % of preactivations nearest its kink or zero moves 7-24 % of
  them, up to 7.7e-3 or more (``test_a_wrong_slope_on_a_narrow_band_fails``).
"""

import itertools

import pytest
import torch
from torch.func import functional_call, jvp, vmap

from mfm_tpu_torch.flows import (
    VectorFieldNet,
    cnf,
    field_params,
    kernel_tangent_field,
    make_transport,
    module_tangent_field,
)
from mfm_tpu_torch.flows.vector_field import NON_LINEARITIES
from mfm_tpu_torch.utils import profiling

torch.set_num_threads(1)

D, W, F, B = 8, 32, 8, 64
RTOL = 1e-5
FLIP_SHARE, FLIP_MAX = 1e-2, 2.0**-8  # 'default' but relu (see above)


class _MLP(torch.nn.Module):
    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, t):
        return self.net.mlp(x, t)


def twin_tangent_field(net, freqs=None):
    """The field's tangents as ``torch.func.jvp`` of ``net.mlp`` under
    ``vmap`` over tangents, and over seeds for freqs (S, F); the same
    ``bind(params) -> f(x, t, ex)`` contract, the score gate after it."""
    mlp = _MLP(net)
    seeds = freqs is not None and freqs.ndim == 2

    def tangents(mlp_params, x, t, ex):
        def one(e):
            field, dfield, gate = jvp(lambda u: functional_call(mlp, mlp_params, (u, t)),
                                      (x,), (e,), has_aux=True)
            return dfield, field, gate

        dfield, field, gate = vmap(one)(ex)
        return dfield, field[0], gate[0]

    def bind(params):
        mlp_params = {f"net.{k}": v for k, v in params.items()}
        if freqs is not None:
            mlp_params["net.fourier_freqs"] = freqs

        def f(x, t, ex):
            if seeds:
                S = freqs.shape[0]
                dfield, field, gate = vmap(tangents, in_dims=(0, 0, 0, 1), out_dims=(1, 0, 0))(
                    mlp_params, x.unflatten(0, (S, -1)), t.unflatten(0, (S, -1)),
                    ex.unflatten(1, (S, -1)))
                dfield, field, gate = dfield.flatten(1, 2), field.flatten(0, 1), gate.flatten(0, 1)
            else:
                dfield, field, gate = tangents(mlp_params, x, t, ex)
            if net.score_gate is None:
                return field, dfield
            return net.score_gate(x, gate, field, ex, dfield, net.score_clip)

        return f

    return bind


def _score(x):
    return -x * torch.abs(x)


def nets(act, precision, S, score_fn=None, seed=0, d=D, width=W, n_fourier=F):
    """(net, freqs or None, params): one net (S None) or S nets' parameters
    and frequencies stacked on a leading seed axis; every parameter
    perturbed, so that no head is zero."""
    gen = torch.Generator().manual_seed(seed)
    made, params = [], []
    for _ in range(S or 1):
        net = VectorFieldNet(d, torch.randn(n_fourier, generator=gen), (width, width),
                             (width, width), (width, width), act=act, score_fn=score_fn,
                             generator=gen, precision=precision)
        made.append(net)
        params.append({k: v + 0.05 * torch.randn(v.shape, generator=gen)
                       for k, v in field_params(net).items()})
    if S is None:
        return made[0], None, params[0]
    return (made[0], torch.stack([n.fourier_freqs for n in made]),
            {k: torch.stack([p[k] for p in params]) for k in params[0]})


def _inputs(rows, K, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, D, generator=gen), torch.rand(rows, generator=gen),
            torch.randn(K, rows, D, generator=gen))


def captured(bind, net, params, x, t, ex):
    """(field, dfield, gate) as the field hands them to the score gate."""
    got = {}

    def capture(x_, gate, field, ex_, dfield, clip):
        got.update(field=field, dfield=dfield, gate=gate)
        return field, dfield

    net.score_gate = capture
    bind(params)(x, t, ex)
    return got


def assert_close(got, ref, precision, act="tanh", flips=None):
    """Within the tolerances above; ``flips`` (default: 'default' and not
    relu) lets 1 % of the entries be one bf16 step apart."""
    err = (got.double() - ref.double()).abs() / ref.double().abs().max().clamp_min(1e-30)
    if flips is None:
        flips = precision == "default" and act != "relu"
    if not flips:
        assert float(err.max()) <= RTOL
    else:
        assert float((err > RTOL).double().mean()) <= FLIP_SHARE
        assert float(err.max()) <= FLIP_MAX


@pytest.mark.parametrize("act,precision,S,K", list(itertools.product(
    sorted(NON_LINEARITIES), ["highest", "default"], [None, 3], [1, 3, 64])))
def test_pass_matches_vmap_jvp(act, precision, S, K):
    """field, dfield and gate of one net and of a 3-seed sweep (seed-major
    rows), at 1, 3 and 64 tangents."""
    net, freqs, params = nets(act, precision, S)
    x, t, ex = _inputs(B * (S or 1), K)
    got = captured(module_tangent_field(net, freqs), net, params, x, t, ex)
    ref = captured(twin_tangent_field(net, freqs), net, params, x, t, ex)
    for k in ("field", "dfield", "gate"):
        assert got[k].shape == ref[k].shape
        assert_close(got[k], ref[k], precision, act)


@pytest.mark.parametrize("act,precision", list(itertools.product(
    sorted(NON_LINEARITIES), ["highest", "default"])))
def test_a_wrong_slope_on_a_narrow_band_fails(act, precision, monkeypatch):
    """The tolerances catch an activation derivative 10 % wrong on a narrow
    band only: relu's mask on 0 < z < 1e-3, any other's |z| < 1e-3 (0.1-0.5 %
    of the preactivations)."""
    right = cnf._act_and_slope

    def wrong(name, z):
        h, slope = right(name, z)
        band = (z > 0) & (z < 1e-3) if name == "relu" else z.abs() < 1e-3
        return h, torch.where(band, 0.9 * slope, slope)

    monkeypatch.setattr(cnf, "_act_and_slope", wrong)
    net, freqs, params = nets(act, precision, 3)
    x, t, ex = _inputs(3 * B, 64)
    got = captured(module_tangent_field(net, freqs), net, params, x, t, ex)
    ref = captured(twin_tangent_field(net, freqs), net, params, x, t, ex)
    assert_close(got["field"], ref["field"], precision, act)
    with pytest.raises(AssertionError):
        assert_close(got["dfield"], ref["dfield"], precision, act)


@pytest.mark.parametrize("hidden_x,hidden_t,hidden_xt,precision", list(itertools.product(
    [(), (16,)], [(), (16,)], [(), (16, 16)], ["highest", "default"])))
def test_pass_with_empty_trunks(hidden_x, hidden_t, hidden_xt, precision):
    """A trunk without layers passes its input on: x, or the Fourier
    features, or the joint input straight into the field head."""
    gen = torch.Generator().manual_seed(2)
    net = VectorFieldNet(4, torch.randn(6, generator=gen), hidden_x, hidden_t, hidden_xt,
                         act="tanh", generator=gen, precision=precision)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
              for k, v in field_params(net).items()}
    x, t, ex = torch.randn(8, 4, generator=gen), torch.rand(8, generator=gen), torch.randn(
        3, 8, 4, generator=gen)
    got = captured(module_tangent_field(net), net, params, x, t, ex)
    ref = captured(twin_tangent_field(net), net, params, x, t, ex)
    for k in ("field", "dfield", "gate"):
        assert_close(got[k], ref[k], precision)


@pytest.mark.parametrize("S", [None, 3])
def test_dfield_leaves_in_the_gates_layout(S):
    """dfield comes out contiguous as (K, S B, d), which the gate takes
    without a copy; with ex the exact basis (the transport's tangents)."""
    net, freqs, params = nets("relu", "default", S)
    x, t, _ = _inputs(B * (S or 1), 1)
    ex = torch.eye(D)[:, None, :].expand(D, x.shape[0], D).contiguous()
    got = captured(module_tangent_field(net, freqs), net, params, x, t, ex)
    assert got["dfield"].shape == (D, x.shape[0], D) and got["dfield"].is_contiguous()
    assert got["field"].is_contiguous() and got["gate"].is_contiguous()


@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_gradient_through_a_transport(act):
    """A gradient through an exact forward transport, in its input (with
    ``torch.func.grad``, as the pullback target takes it) and in the
    parameters (``torch.autograd``), against the same transport on the
    twin; a score gate (the generic one) with its derivative."""
    net, _, params = nets(act, "highest", None, score_fn=_score)
    u, _, _ = _inputs(16, 1, seed=4)
    u = 0.5 * u
    w = torch.randn(16, D, generator=torch.Generator().manual_seed(5))

    def objective(transport, p, uu):
        x, logdet = transport.forward(p, uu)
        return torch.sum(w * x) + torch.sum(logdet)

    grads = []
    for binder in (module_tangent_field, twin_tangent_field):
        transport = make_transport(binder(net), divergence="exact", n_steps=3)
        g_u = torch.func.grad(lambda uu: objective(transport, params, uu))(u)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        g_p = torch.autograd.grad(objective(transport, p, u), list(p.values()))
        grads.append([g_u, *g_p])
    for got, ref in zip(*grads):
        assert float((got - ref).abs().max()) <= 1e-5 * max(float(ref.abs().max()), 1.0)
    assert any(float(g.abs().max()) > 0 for g in grads[0][1:])


def _counted(bind, params, u):
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        make_transport(bind, divergence="exact", n_steps=2).forward(params, u)
    return profiling.counters()


def test_tangent_pass_counter_equals_stages():
    """One ``field.tangent_pass`` a field call: at d <= 64 (one chunk of
    the exact basis) as many as the solve's ``stages``; none on K1."""
    net, _, params = nets("relu", "highest", None, score_fn=_score)
    u = 0.5 * _inputs(B, 1)[0]
    counters = _counted(module_tangent_field(net), params, u)
    assert counters["stages"] == 2 * 4
    assert counters["field.tangent_pass"] == counters["stages"]
    assert "field.tangent_pass" not in _counted(kernel_tangent_field(net), params, u)
    profiling.reset()
