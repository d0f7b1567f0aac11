"""Port parity: the vector field (flows.vector_field, utils.convert) and
the plain version of kernel K1 (ops.field) against the flax net, the
Pallas twin ``_reference_apply``, ``jax.jvp``, and the Pallas kernel in
interpret mode.

Tolerance: atol 1e-5 -- fp32 on both sides (JAX at 'highest'), the same
products summed in another order, outputs O(1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfm_tpu.ops.field_pallas import _reference_apply, make_pallas_field_apply, split_params
from mfm_tpu_torch.ops import field as K1
from torch_parity import flax_field, npy, torch_field, tt

torch.set_num_threads(1)

ATOL = 1e-5
D, W, F = 4, 16, 8


def _inputs(seed, B=12, K=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    t = rng.uniform(size=B).astype(np.float32)
    ex = rng.standard_normal((K, B, D)).astype(np.float32)
    return x, t, ex


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_vector_field_net_matches_flax(act):
    """nn.Module forward == flax apply, score gate and clip included."""
    score = lambda x: -x * jnp.abs(x)  # non-trivial, some entries beyond the clip
    pscore = lambda x: -x * torch.abs(x)
    net_j, params, freqs = flax_field(jax.random.PRNGKey(0), D, W, F, act, score, 1.0)
    net_p, pparams = torch_field(params, freqs, D, W, act, pscore, 1.0)
    x, t, _ = _inputs(0)
    ref = net_j.apply(params, jnp.asarray(x), jnp.asarray(t))
    got = torch.func.functional_call(net_p, pparams, (tt(x), tt(t)))
    np.testing.assert_allclose(npy(got), np.asarray(ref), atol=ATOL)
    # single sample and scalar time
    ref1 = net_j.apply(params, jnp.asarray(x[0]), 0.3)
    np.testing.assert_allclose(npy(net_p(tt(x[0]), 0.3)), np.asarray(ref1), atol=ATOL)


def test_fresh_net_has_zero_heads_and_flax_init_scale():
    from mfm_tpu_torch.flows import VectorFieldNet

    gen = torch.Generator().manual_seed(0)
    net = VectorFieldNet(D, torch.randn(F, generator=gen), (W, W), (W, W), (W, W), generator=gen)
    net.requires_grad_(False)
    assert float(net.field_head.weight.abs().sum()) == 0.0
    assert float(net.gate_head.weight.abs().sum()) == 0.0
    w = net.xt_trunk[0].weight  # lecun normal: std 1/sqrt(fan_in), truncated at 2 sd
    fan_in = w.shape[1]
    assert abs(float(w.std()) * np.sqrt(fan_in) - 1.0) < 0.15
    assert float(w.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6


def test_params_from_flax_layout():
    _, params, freqs = flax_field(jax.random.PRNGKey(1), D, W, F)
    from mfm_tpu_torch.utils.convert import params_from_flax

    state = params_from_flax(jax.tree_util.tree_map(np.asarray, params), np.asarray(freqs))
    k = np.asarray(params["params"]["xt_trunk"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(npy(state["xt_trunk.0.weight"]), k.T)  # (out, in)
    assert state["t_trunk.0.weight"].shape == (W, 2 * F)
    assert state["field_head.weight"].shape == (D, W)
    np.testing.assert_array_equal(npy(state["fourier_freqs"]), np.asarray(freqs))


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_plain_field_apply_matches_reference_and_jvp(act):
    """K1's plain version: (field, gate) == _reference_apply, and each of
    the K tangents == jax.jvp of the flax MLP (no score gate)."""
    net_j, params, freqs = flax_field(jax.random.PRNGKey(2), D, W, F, act)
    _, pparams = torch_field(params, freqs, D, W, act)
    layout = K1.field_layout(pparams, F)
    packed = K1.pack_field_params(pparams, layout)
    x, t, ex = _inputs(1)
    flat, meta = split_params(params)
    jf, jg = _reference_apply(flat, meta, act, freqs, jnp.asarray(x), jnp.asarray(t))
    pf, pg, pdf = K1.field_apply(packed, layout, act, tt(freqs), tt(x), tt(t), tt(ex))
    np.testing.assert_allclose(npy(pf), np.asarray(jf), atol=ATOL)
    np.testing.assert_allclose(npy(pg), np.asarray(jg), atol=ATOL)
    for k in range(ex.shape[0]):
        _, jt_ = jax.jvp(
            lambda xx: net_j.apply(params, xx, jnp.asarray(t)), (jnp.asarray(x),),
            (jnp.asarray(ex[k]),),
        )
        np.testing.assert_allclose(npy(pdf[k]), np.asarray(jt_), atol=ATOL)


def test_plain_field_apply_matches_pallas_interpret():
    """The primal against the Pallas kernel itself (interpret mode on the
    CPU), at a batch that does not fill its 256-row tile."""
    _, params, freqs = flax_field(jax.random.PRNGKey(3), D, W, F)
    _, pparams = torch_field(params, freqs, D, W)
    layout = K1.field_layout(pparams, F)
    x, t, _ = _inputs(2, B=7)
    apply_pl = make_pallas_field_apply(params, freqs, "relu")
    ref = apply_pl(params, jnp.asarray(x), jnp.asarray(t))
    pf, _ = K1.field_apply(K1.pack_field_params(pparams, layout), layout, "relu",
                           tt(freqs), tt(x), tt(t))
    np.testing.assert_allclose(npy(pf), np.asarray(ref), atol=ATOL)


def test_layout_and_limits():
    _, params, freqs = flax_field(jax.random.PRNGKey(4), D, W, F)
    _, pparams = torch_field(params, freqs, D, W)
    layout = K1.field_layout(pparams, F)
    flat, meta = split_params(params)
    assert (layout.n_t - 1, layout.n_x, layout.n_xt - 1) == meta
    assert layout.size == sum(int(np.prod(a.shape)) for a in flat)
    packed = K1.pack_field_params(pparams, layout)
    # the packed buffer holds split_params' arrays in order: [wc; ws] is w0
    np.testing.assert_array_equal(npy(packed[: 2 * F * W]),
                                  np.concatenate([np.asarray(flat[0]), np.asarray(flat[1])]).ravel())
    wide = dict(pparams)
    wide["field_head.weight"] = torch.zeros(256, W)
    wide["field_head.bias"] = torch.zeros(256)
    K1.check_fits(layout)
    with pytest.raises(ValueError, match="widths"):
        K1.check_fits(K1.field_layout(wide, F))
    # the kernel's weight schedule streams, in TILE_ROWS-row tiles, every
    # weight of the primal once and of each tangent chunk once
    primal, chunk = K1.weight_tiles(layout)
    assert all(0 < rows <= K1.TILE_ROWS for _, rows, _ in primal + chunk)
    assert sum(rows * n for _, rows, n in primal) * 2 == K1.field_flops(layout, 1, 0)
    assert sum(rows * n for _, rows, n in chunk) * 2 == (
        K1.field_flops(layout, 1, 1) - K1.field_flops(layout, 1, 0))
    assert primal[0] == (0, min(K1.TILE_ROWS, 2 * F), W) and primal[-1][0] + primal[-1][1] * D == (
        layout.b_off[-1])
    assert len(K1.kernel_meta(layout, "tanh")) == 13 + 4 * K1.MAX_LAYERS + 3 * K1.MAX_TILES
    with pytest.raises(ValueError, match="activations"):
        K1.field_apply(packed, layout, "gelu", tt(freqs), *map(tt, _inputs(0)[:2]))


def test_cpu_tensors_take_the_plain_version():
    _, params, freqs = flax_field(jax.random.PRNGKey(5), D, W, F)
    _, pparams = torch_field(params, freqs, D, W)
    layout = K1.field_layout(pparams, F)
    before = K1.field_apply.launches
    x, t, _ = _inputs(3)
    K1.field_apply(K1.pack_field_params(pparams, layout), layout, "relu", tt(freqs), tt(x), tt(t))
    assert K1.field_apply.launches == before


def _slice_layout():
    """The phi-four slice's field: d=64, trunks (128, 128) x 3, F=128."""
    from mfm_tpu_torch.flows import VectorFieldNet, field_params

    gen = torch.Generator().manual_seed(0)
    net = VectorFieldNet(64, torch.randn(128, generator=gen), (128, 128), (128, 128),
                         (128, 128), generator=gen)
    return K1.field_layout(field_params(net), 128)


def test_field_work_matches_the_hand_count():
    """Per row: primal 139,264 multiply-adds (t-trunk 49,152, x-trunk
    24,576, joint 49,152, heads 8,192 each), each tangent 65,536; at
    B=1024, K=64 that is 8.875 GFLOP and ~34.9 MB."""
    layout = _slice_layout()
    assert K1.field_flops(layout, 1024, 0) == 2 * 1024 * 139_264
    assert K1.field_flops(layout, 1024, 64) == 2 * 1024 * (139_264 + 64 * 65_536)
    assert abs(K1.field_flops(layout, 1024, 64) / 8.875e9 - 1) < 1e-4
    weights = 139_264 + 6 * 128 + 2 * 64  # matrices and biases
    assert layout.size == weights
    expected = 4 * (2 * 64 * 1024 * 64 + 3 * 1024 * 64 + 1024 + 128 + weights)
    assert K1.field_bytes(layout, 1024, 64) == expected
    assert abs(expected / 34.9e6 - 1) < 2e-3
    assert K1.field_bytes(layout, 1024, 0) == 4 * (3 * 1024 * 64 + 1024 + 128 + weights)


def _tf32(v):
    """TF32 as csrc/field.cu rounds: add half a TF32 ulp to the fp32 bits,
    then mask the low 13 mantissa bits."""
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def test_3xtf32_product_is_fp32_accurate():
    """The kernel's 3xTF32 split on one 128 x 128 product at the slice's
    scale: hi = tf32(v), lo = tf32(v - hi), hi*hi + hi*lo + lo*hi with fp32
    sums, against float64. It stays within 1e-5 of the largest entry (the
    1e-4 tolerance of the card tests has headroom), where one TF32 pass
    does not. (The card's tensor cores also truncate their accumulation,
    which the kernel bounds by short chains; see csrc/field.cu.)"""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(np.maximum(rng.standard_normal((128, 128)), 0).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 128)) / np.sqrt(128)).astype(np.float32))
    ref = a.double() @ w.double()
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    three = a_lo @ w_hi + a_hi @ w_lo + a_hi @ w_hi
    one = a_hi @ w_hi
    scale = float(ref.abs().max())
    err3 = float((three.double() - ref).abs().max()) / scale
    err1 = float((one.double() - ref).abs().max()) / scale
    assert err3 <= 1e-5 and err1 > 1e-4, (err3, err1)
