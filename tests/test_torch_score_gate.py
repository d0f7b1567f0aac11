"""Port parity: the phi^4 score gate of a transport stage
(``ops.phi_four.phi_four_score_gate``, ``PhiFour.score_gate``) and the route
that takes it, against mfm_tpu.

The reference never computes the score gate on its own: it is the
``gate * clip(score(x))`` term of ``VectorFieldNet.apply``, and a transport
stage differentiates it with ``jax.jvp`` along every tangent. So the plain
version is held to ``jax.jvp`` of ``gate * clip(mfm_tpu PhiFour.score)``
plus the given field and dfield, and both tangent fields of a small fp32
net with the fused gate to ``jax.jvp`` of the reference net's ``apply``
over the basis.

Tolerance: 1e-5 relative to each output's largest entry -- fp32 on both
sides; the score and each H e entry are sums of three terms (stencil,
double well, tilt) taken in another order, the net's products too. The
clip is set in the widest gap between the scores, so no rounding moves a
site across it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
import mfm_tpu_torch.targets.base as pbase
import mfm_tpu_torch.targets.phi_four as ptphi
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers.mfm import _interleave_is_flow, build_mfm, make_generator
from mfm_tpu_torch.flows import field_params, kernel_tangent_field, module_tangent_field
from mfm_tpu_torch.ops import phi_four as K3
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

REL = 1e-5
TILT = {"val": 0.3, "lambda": 2.0}


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(npy(got), ref, atol=REL * float(np.abs(ref).max()), rtol=0)


def _clip_in_gap(score):
    """A clip inside the widest gap between the middle half of |score|'s
    sorted values: about half the sites inside, none near the edge."""
    a = np.sort(np.abs(np.asarray(score)).ravel())
    lo, hi = len(a) // 4, 3 * len(a) // 4
    i = lo + int(np.argmax(np.diff(a[lo:hi])))
    return float(0.5 * (a[i] + a[i + 1]))


def _jax_score_gate(jtarget, x, gate, field, ex, dfield, clip):
    def term(xx):
        s = jtarget.score(xx)
        return gate * (s if clip is None else jnp.clip(s, -clip, clip))

    tang = jax.vmap(lambda e: jax.jvp(term, (x,), (e,))[1])(ex)
    return field + term(x), dfield + tang


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("tilt", [None, TILT], ids=["notilt", "tilt"])
@pytest.mark.parametrize("bc", [("dirichlet", 0.5), ("pbc", 0.0)], ids=["dirichlet", "pbc"])
@pytest.mark.parametrize("d,K", [(8, 1), (8, 8), (64, 1), (64, 64)])
def test_plain_matches_jvp_of_reference(d, K, bc, tilt, clip):
    rng = np.random.default_rng(d + K)
    B = 16
    x = rng.uniform(-1.5, 1.5, (B, d)).astype(np.float32)
    gate = (0.1 * rng.standard_normal((B, d))).astype(np.float32)
    field = rng.standard_normal((B, d)).astype(np.float32)
    ex = rng.standard_normal((K, B, d)).astype(np.float32)
    dfield = rng.standard_normal((K, B, d)).astype(np.float32)
    jtarget = jt.PhiFour(d, bc=bc, tilt=tilt)
    clip_v = _clip_in_gap(jtarget.score(jnp.asarray(x))) if clip else None
    ref_f, ref_d = _jax_score_gate(
        jtarget, *(jnp.asarray(a) for a in (x, gate, field, ex, dfield)), clip_v
    )
    lam, val = (tilt["lambda"], tilt["val"]) if tilt else (0.0, 0.0)
    f, df = tt(field), tt(dfield)
    got_f, got_d = K3.phi_four_score_gate_plain(
        tt(x), tt(gate), f, tt(ex), df, 0.1, 20.0, bc[0] == "pbc", bc[1], lam, val, clip_v
    )
    assert got_f is f and got_d is df  # in place
    _close(got_f, ref_f)
    _close(got_d, ref_d)
    # the same through the target, which the transport calls
    got = pt.PhiFour(d, bc=bc, tilt=tilt).score_gate(
        tt(x), tt(gate), tt(field), tt(ex), tt(dfield), clip_v
    )
    _close(got[0], ref_f)
    _close(got[1], ref_d)
    if clip:  # the mask is not all one way
        s = np.abs(np.asarray(jtarget.score(jnp.asarray(x))))
        assert (s < clip_v).any() and (s > clip_v).any()


def test_plain_without_tangents_does_the_field_only():
    rng = np.random.default_rng(0)
    x, gate, field = (rng.standard_normal((5, 8)).astype(np.float32) for _ in range(3))
    ref_f, _ = _jax_score_gate(jt.PhiFour(8), x, gate, field, np.zeros((1, 5, 8), np.float32),
                               np.zeros((1, 5, 8), np.float32), None)
    got_f, got_d = K3.phi_four_score_gate(tt(x), tt(gate), tt(field))
    assert got_d is None
    _close(got_f, ref_f)
    with pytest.raises(ValueError, match="unsupported device"):
        K3.phi_four_score_gate(*(torch.empty(4, 8, device="meta") for _ in range(3)))


D, W, F, B = 8, 16, 8, 12
NET_CASES = [
    (("dirichlet", 0.0), None, False),
    (("dirichlet", 0.5), TILT, False),
    (("pbc", 0.0), None, True),
    (("pbc", 0.0), TILT, True),
]
NET_IDS = ["dirichlet", "dirichlet-bc-tilt", "pbc-clip", "pbc-tilt-clip"]


@pytest.mark.parametrize("path", ["module", "kernel"])
@pytest.mark.parametrize("bc,tilt,clip", NET_CASES, ids=NET_IDS)
def test_tangent_fields_with_fused_gate_match_reference(path, bc, tilt, clip):
    """v and J e over the basis, through K1's plain version or the module
    under jvp, plus PhiFour's fused score gate, against jax.jvp of the
    reference net's apply."""
    jtarget, ptarget = jt.PhiFour(D, bc=bc, tilt=tilt), pt.PhiFour(D, bc=bc, tilt=tilt)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1.2, 1.2, (B, D)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    clip_v = _clip_in_gap(jtarget.score(jnp.asarray(x))) if clip else None
    net_j, params, freqs = flax_field(
        jax.random.PRNGKey(3), D, W, F, "tanh", jtarget.score, clip_v, gate_perturb=0.05
    )
    net_p, pparams = torch_field(params, freqs, D, W, "tanh", ptarget.score, clip_v)
    net_p.score_gate = ptarget.score_gate
    basis = np.broadcast_to(np.eye(D, dtype=np.float32)[:, None, :], (D, B, D))
    apply = lambda u: net_j.apply(params, u, jnp.asarray(t))
    ref_v = apply(jnp.asarray(x))
    ref_jv = jax.vmap(lambda e: jax.jvp(apply, (jnp.asarray(x),), (e,))[1])(jnp.asarray(basis))
    bind = module_tangent_field(net_p) if path == "module" else kernel_tangent_field(net_p)
    with torch.no_grad():
        v, jv = bind(pparams)(tt(x), tt(t), tt(np.array(basis)))
    _close(v, ref_v)
    _close(jv, ref_jv)


def _tiny_cfg(example, pallas):
    return MFMConfig(
        example=example, dim=4 if example == "phi-four" else 2, num_chain=8,
        hidden_x=(8,), hidden_t=(8,), hidden_xt=(8,), fourier_dim=4, ode_steps=2,
        field_precision="highest" if pallas else "default", pallas_field=pallas,
        mcmc_per_flow_steps=1,
    )


@pytest.mark.parametrize("pallas", [False, True], ids=["module", "kernel"])
def test_route_phi_four_fused_four_mode_generic(monkeypatch, pallas):
    """build_mfm gives PhiFour's nets the fused gate: a flow-type step (an
    inverse and a forward transport) never reaches PhiFour.hvp or the
    generic gate; a 4-mode one takes the generic route."""
    calls = {"fused": 0, "generic": 0}

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    def no_hvp(*args, **kwargs):
        raise AssertionError("a phi^4 transport reached PhiFour.hvp")

    monkeypatch.setattr(ptphi, "phi_four_score_gate", count("fused", ptphi.phi_four_score_gate))
    monkeypatch.setattr(pbase, "generic_score_gate", count("generic", pbase.generic_score_gate))
    monkeypatch.setattr(pt.PhiFour, "hvp", no_hvp)
    for target, example in ((pt.PhiFour(4), "phi-four"), (pt.four_mode_mixture(), "4-mode")):
        cfg = _tiny_cfg(example, pallas)
        pieces = build_mfm(target, cfg, "cpu", torch.Generator().manual_seed(0))
        gen = make_generator("cpu", 0)
        carry = pieces.init_fn(target.init_positions(gen, cfg.num_chain))
        count_ = next(c for c in range(1, 10) if _interleave_is_flow(c, cfg.mcmc_per_flow_steps))
        before = dict(calls)
        carry, _ = pieces.step_fn(carry, count_, *pieces.draw_step_noise(gen, count_))
        assert torch.isfinite(carry.chain.position).all()
        params = {k: v + 0.01 for k, v in field_params(pieces.net).items()}
        x, logdet = pieces.transport.forward(params, carry.chain.position)
        assert torch.isfinite(logdet).all()
        fused, generic = (calls[k] - before[k] for k in ("fused", "generic"))
        if example == "phi-four":
            assert fused > 0 and generic == 0
        else:
            assert fused == 0 and generic > 0


def test_value_and_score_skips_the_custom_op(monkeypatch):
    """MALA's and the flow-MH accept's call goes to K3's launcher, not
    through the torch.library op (which only the derivatives need)."""

    def no_op(*args, **kwargs):
        raise AssertionError("value_and_score went through the custom op")

    target = pt.PhiFour(8, tilt=TILT)
    x = tt(np.random.default_rng(1).uniform(-1, 1, (6, 8)).astype(np.float32))
    ref_v, ref_s = target._value_and_score(x, with_score=True)
    monkeypatch.setattr(ptphi, "phi_four", no_op)
    v, s = target.value_and_score(x)
    tv, ts = target.tempered_value_and_score(x, 0.5)
    assert torch.equal(v, ref_v) and torch.equal(s, ref_s)
    assert torch.equal(tv, 0.5 * ref_v) and torch.equal(ts, 0.5 * ref_s)
