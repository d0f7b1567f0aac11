"""Port parity: the field precision (flows.vector_field ``precision``,
drivers.mfm ``set_field_precision``).

'default' is the reference's ``precision=None`` on a TPU: bf16 operands,
fp32 accumulation, fp32 result. XLA:CPU computes ``precision=None`` in
fp32, so the package's own net cannot show bf16 here; the tests hold the
port to a JAX twin of the net written with explicit bf16 operands and
``preferred_element_type=float32``, and to the package's fp32 net.

Tolerances, relative to each output's largest entry:
- 1e-6 for one ``Dense`` against the bf16-operand, fp32-accumulate dot:
  products of bf16 values are exact in fp32, so only the order of the
  fp32 sum differs (measured 3e-7).
- 1e-3 (``FLIP``) for the forward field and its tangents against the
  twin. Both round the same operands; the only difference is the order of
  each fp32 sum, ~1e-7 relative, which is harmless unless it moves a
  later layer's input across a bf16 rounding boundary. Such a flipped
  rounding changes that operand by one bf16 ulp (2^-8 of it, on average)
  and so one output by that fraction of one of the ~32 products it sums:
  below 1e-3 of the largest entry at these widths. (Measured: forward 4e-8,
  tangents up to 1.5e-4 over four seeds. An extra bf16 rounding of each
  product's output would give 3e-3 to 6e-3 and fail.)
- 2e-3 for the loss gradient against the twin: on top of the flips,
  JAX's transpose of a bf16 dot rounds each cotangent product to bf16
  (2^-9 relative), which the port's fp32 backward does not. (Measured up
  to 7.7e-4; the extra rounding above gives 7e-3 to 1.3e-2.)
- 2e-2 for the forward field against the package's fp32 net: this is bf16
  against fp32, five layers of 2^-8 operand rounding, not a port error.
The tangent and gradient checks use tanh: a smooth activation keeps the
differences at rounding size (relu's derivative is a step: a rounding
that moves a pre-activation across 0 flips a unit, and the tangents then
differ by O(w)). ``test_default_rounds_every_product_operand_to_bf16``
checks the rounding itself, exactly, on inputs where fp32 gives 2^-7 and
bf16 gives 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad, jvp, vmap

import mfm_tpu_torch.targets as pt
from mfm_tpu_torch.config import MFMConfig
from mfm_tpu_torch.drivers.mfm import build_mfm, set_field_precision
from mfm_tpu_torch.flows.vector_field import Dense
from mfm_tpu_torch.utils.convert import params_from_flax
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

D, W, F, B = 8, 32, 8, 64
FLIP = 1e-3  # one flipped bf16 operand rounding in a later layer (see above)


def _dense_bf16(p, h):
    return jnp.dot(h.astype(jnp.bfloat16), p["kernel"].astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32) + p["bias"]


def _twin(params, freqs, x, t, act, score_fn):
    """mfm_tpu's VectorFieldNet with every Dense at bf16 operands."""
    p = params["params"]
    ang = (2.0 * jnp.pi) * t[:, None] * freqs[None, :]
    h_t = jnp.concatenate([jnp.cos(ang), jnp.sin(ang)], -1)
    for i in range(len(p["t_trunk"])):
        h_t = act(_dense_bf16(p["t_trunk"][f"Dense_{i}"], h_t))
    h_x = x
    for i in range(len(p["x_trunk"])):
        h_x = act(_dense_bf16(p["x_trunk"][f"Dense_{i}"], h_x))
    gate = _dense_bf16(p["gate_head"], h_t)
    h = jnp.concatenate([h_x, h_t], -1)
    for i in range(len(p["xt_trunk"])):
        h = act(_dense_bf16(p["xt_trunk"][f"Dense_{i}"], h))
    return _dense_bf16(p["field_head"], h) + gate * score_fn(x)


def _jscore(x):
    return -x * jnp.abs(x)


def _pscore(x):
    return -x * torch.abs(x)


def _setup(act):
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), D, W, F, act, _jscore)
    net_p, pparams = torch_field(params, freqs, D, W, act, _pscore, precision="default")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, D)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    return net_j, params, freqs, net_p, pparams, x, t, rng


def _assert_close(got, ref, rel):
    np.testing.assert_allclose(got, ref, atol=rel * float(np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("n,k,m", [(64, 128, 128), (7, 33, 5)])
def test_default_dense_matches_bf16_dot(n, k, m):
    """One Dense('default') against jnp.dot of bf16 operands with an fp32
    result: the TPU's arithmetic, with no rounding of the output."""
    rng = np.random.default_rng(n + k + m)
    h = rng.standard_normal((n, k)).astype(np.float32)
    w = (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    layer = Dense(k, m, "default")
    with torch.no_grad():
        layer.weight.copy_(tt(w.T))
        layer.bias.copy_(tt(b))
    ref = np.asarray(_dense_bf16({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                                 jnp.asarray(h)))
    _assert_close(npy(layer(tt(h))), ref, 1e-6)


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_default_net_matches_bf16_twin_and_fp32_net(act):
    net_j, params, freqs, net_p, pparams, x, t, _ = _setup(act)
    jact = jax.nn.relu if act == "relu" else jnp.tanh
    twin = np.asarray(_twin(params, freqs, jnp.asarray(x), jnp.asarray(t), jact, _jscore))
    got = npy(functional_call(net_p, pparams, (tt(x), tt(t))))
    fp32 = np.asarray(net_j.apply(params, jnp.asarray(x), jnp.asarray(t)))
    _assert_close(got, twin, FLIP)
    _assert_close(got, fp32, 2e-2)
    # the bf16 path ran, not the fp32 one (measured 2e-3 to 7e-3 apart)
    assert np.abs(got - fp32).max() > 1e-4 * np.abs(fp32).max()


def test_default_tangents_and_loss_gradient_match_bf16_twin():
    """The transport's vmap(jvp) over tangents and the FM loss gradient,
    both through the bf16 products."""
    _, params, freqs, net_p, pparams, x, t, rng = _setup("tanh")
    ex = rng.standard_normal((16, B, D)).astype(np.float32)
    y = rng.standard_normal((B, D)).astype(np.float32)
    twin = lambda p, xx: _twin(p, freqs, xx, jnp.asarray(t), jnp.tanh, _jscore)
    ref = np.stack([
        np.asarray(jax.jvp(lambda xx: twin(params, xx), (jnp.asarray(x),), (jnp.asarray(e),))[1])
        for e in ex
    ])
    apply = lambda u: functional_call(net_p, pparams, (u, tt(t)))
    got = vmap(lambda e: jvp(apply, (tt(x),), (e,))[1])(tt(ex))
    _assert_close(npy(got), ref, FLIP)

    g_ref = jax.grad(lambda p: jnp.sum((twin(p, jnp.asarray(x)) - y) ** 2))(params)
    g_ref = params_from_flax(jax.tree_util.tree_map(np.asarray, g_ref))
    g = grad(lambda p: torch.sum((functional_call(net_p, p, (tt(x), tt(t))) - tt(y)) ** 2))(pparams)
    for k, v in g.items():
        _assert_close(npy(v), npy(g_ref[k]), 2e-3)


@pytest.mark.parametrize("precision,expected", [("default", 0.0), ("highest", 2.0**-7)])
def test_default_rounds_every_product_operand_to_bf16(precision, expected):
    """h = 1 + 2^-10 on even inputs and 1 on odd ones, against weights +1
    / -1: fp32 products sum to 8 * 2^-10 = 2^-7, while bf16 operands round
    1 + 2^-10 to 1 and sum to exactly 0. The same for 64 tangents under
    vmap(jvp), and for the weight gradient."""
    K = 16
    layer = Dense(K, 1, precision)
    sign = torch.tensor([1.0, -1.0] * (K // 2))
    with torch.no_grad():
        layer.weight.copy_(sign[None, :])
        layer.bias.zero_()
    h = torch.where(sign > 0, 1.0 + 2.0**-10, 1.0).expand(2, K).contiguous()
    assert torch.equal(layer(h), torch.full((2, 1), expected))
    tangents = h.expand(64, 2, K)
    out = vmap(lambda e: jvp(layer, (h,), (e,))[1])(tangents)
    assert torch.equal(out, torch.full((64, 2, 1), expected))
    # d/dW of out_0 - out_1 at rows (h, ones): h - 1 per input, 2^-10 on even
    rows = torch.stack([h[0], torch.ones(K)])
    params = dict(layer.named_parameters())
    g = grad(lambda p: (functional_call(layer, p, (rows,)) * torch.tensor([[1.0], [-1.0]])).sum())(
        params
    )
    assert float(g["weight"].abs().sum()) == (0.0 if precision == "default" else 8 * 2.0**-10)


def test_set_field_precision_pins_exact_fp32_and_refuses_unknown():
    set_field_precision("default")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    with pytest.raises(ValueError, match="field_precision"):
        set_field_precision("bf16")
    with pytest.raises(ValueError, match="precision"):
        Dense(4, 4, "fast")


def test_pallas_field_with_default_precision_raises():
    """The fused kernel computes in exact fp32 only: asking for it with the
    bf16 field raises (the reference quietly runs its flax path there)."""
    cfg = MFMConfig(
        example="phi-four", dim=4, num_chain=8, hidden_x=(8,), hidden_t=(8,), hidden_xt=(8,),
        fourier_dim=4, field_precision="default", pallas_field=True,
    )
    with pytest.raises(ValueError, match="exact fp32"):
        build_mfm(pt.PhiFour(4), cfg, "cpu", torch.Generator().manual_seed(0))
    cfg.pallas_field = False
    pieces = build_mfm(pt.PhiFour(4), cfg, "cpu", torch.Generator().manual_seed(0))
    assert {m.precision for m in pieces.net.modules() if isinstance(m, Dense)} == {"default"}
