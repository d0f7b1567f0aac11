"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips when no CUDA device is present
(decided in the ``cuda`` fixture, never while the module is imported). The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` configures JAX for the CPU suite.)
The first test builds the kernels with nvcc.

Tolerances: K1 to 1e-4 relative to the output's largest entry -- sums of
<= 256 products per output in three TF32 passes (3xTF32, ~5e-7 relative
to fp64 on the card, as cuBLAS's fp32; tests/test_torch_field.py emulates
the split), in another order than cuBLAS's; a relu unit whose z lies
within ~1e-7 of 0 may take the other side of the kink, which these seeds
do not meet; K2a/K2b to
1e-4 relative -- the kernel takes differences directly and reduces in
fp64, the plain version takes Gram products in fp32 tiles; K3 and its
Hessian-vector product to 1e-5 relative -- fp32 sums of d terms in another
order (warp shuffles), and the same per-site stencil.
"""

import pytest
import torch

from mfm_tpu_torch.flows import (
    VectorFieldNet,
    field_params,
    kernel_tangent_field,
    make_transport,
    module_tangent_field,
)
from mfm_tpu_torch.ops import field, pairwise, phi_four
from mfm_tpu_torch.targets import PhiFour, four_mode_mixture

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel_err(got, ref):
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _net(dev, dim, width, n_fourier, act="relu", score_fn=None, gate_scale=0.05, seed=0):
    """A net with every parameter perturbed: zero heads would hide a head
    bug. A stiff score (phi-four) needs a small gate for a stable ODE."""
    gen = torch.Generator().manual_seed(seed)
    net = VectorFieldNet(
        dim, torch.randn(n_fourier, generator=gen), (width, width), (width, width),
        (width, width), act=act, score_fn=score_fn, generator=gen,
    )
    params = {
        k: v + (gate_scale if k.startswith("gate_head") else 0.05)
        * torch.randn(v.shape, generator=gen)
        for k, v in field_params(net).items()
    }
    return net.to(dev), {k: v.to(dev) for k, v in params.items()}


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("B,d,width,n_fourier,K", [
    (1024, 64, 128, 128, 64),  # the phi-four slice, exact divergence
    (1000, 64, 128, 128, 0),   # primal only, a ragged last row tile
    (1000, 64, 128, 128, 63),  # ragged rows and a ragged last tangent chunk
    (1024, 64, 128, 128, 1),   # one Hutchinson probe at the slice's width
    (37, 5, 24, 6, 13),        # ragged rows and tangent chunks, odd widths
])
def test_field_kernel_matches_plain(cuda, act, B, d, width, n_fourier, K):
    _, params = _net(cuda, d, width, n_fourier, act)
    layout = field.field_layout(params, n_fourier)
    packed = field.pack_field_params(params, layout)
    gen = torch.Generator(device=cuda).manual_seed(1)
    freqs = torch.randn(n_fourier, generator=gen, device=cuda)
    x = torch.randn((B, d), generator=gen, device=cuda)
    t = torch.rand(B, generator=gen, device=cuda)
    ex = torch.randn((K, B, d), generator=gen, device=cuda) if K else None
    before = field.field_apply.launches
    got = field.field_apply(packed, layout, act, freqs, x, t, ex)
    ref = field.field_apply_plain(packed, layout, act, freqs, x, t, ex)
    torch.cuda.synchronize()
    assert field.field_apply.launches == before + 1
    assert len(got) == (3 if K else 2)
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= RTOL


def test_field_kernel_refuses_what_it_cannot_run(cuda):
    _, params = _net(cuda, 4, 16, 8)
    layout = field.field_layout(params, 8)
    packed = field.pack_field_params(params, layout)
    x, t = torch.randn(8, 4, device=cuda), torch.rand(8, device=cuda)
    freqs = torch.randn(8, device=cuda)
    with pytest.raises(ValueError, match="forward only"):
        field.field_apply(packed, layout, "relu", freqs, x.requires_grad_(), t)
    with pytest.raises(ValueError, match="float32"):
        field.field_apply(packed, layout, "relu", freqs, x.detach().double(), t)
    wide = dict(params)
    wide["field_head.weight"] = torch.zeros(256, 16, device=cuda)
    wide["field_head.bias"] = torch.zeros(256, device=cuda)
    with pytest.raises(ValueError, match="widths"):
        field.field_apply(packed, field.field_layout(wide, 8), "relu", freqs, x.detach(), t)


def test_kernel_transport_matches_module_transport(cuda):
    """Forward + inverse with the phi-four score gate: K1 plus the score's
    JVP against torch.func.jvp of the whole nn.Module. The draws stay in
    (-1, 1), inside the double well: with a gate of either sign the cubic
    phi-four score would blow up a start far outside it within t < 1."""
    target = PhiFour(8)
    net, params = _net(cuda, 8, 32, 16, score_fn=target.score, gate_scale=1e-3, seed=2)
    gen = torch.Generator(device=cuda).manual_seed(3)
    u = 2.0 * torch.rand((256, 8), generator=gen, device=cuda) - 1.0
    out = {}
    for name, bind in (("kernel", kernel_tangent_field(net)),
                       ("module", module_tangent_field(net))):
        tr = make_transport(bind, divergence="exact", n_steps=4)
        x, ld_f = tr.forward(params, u)
        u_back, ld_i = tr.inverse(params, x)
        out[name] = (x, ld_f, u_back, ld_i)
    torch.cuda.synchronize()
    for a, b in zip(out["kernel"], out["module"]):
        assert torch.isfinite(a).all()
        # atol: 16 stage evaluations in fp32, summation order differs
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("T,d", [(1000, 3), (300, 64), (64, 2), (65, 70)])
def test_stein_kernel_matches_plain(cuda, T, d):
    gen = torch.Generator(device=cuda).manual_seed(T + d)
    X = 2.0 * torch.randn((T, d), generator=gen, device=cuda)
    S = -X / 4.0 + 0.1 * torch.randn((T, d), generator=gen, device=cuda)
    before = pairwise.stein_pairwise_sum.launches
    got = pairwise.stein_pairwise_sum(X, S)
    again = pairwise.stein_pairwise_sum(X, S)
    ref = pairwise.stein_pairwise_sum_plain(X, S)
    assert pairwise.stein_pairwise_sum.launches == before + 2
    assert got.dtype == torch.float64
    assert float(got) == float(again)  # a fixed reduction order: bitwise repeatable
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))


@pytest.mark.parametrize("Ta,Tb,d", [(1000, 700, 2), (300, 300, 33), (1, 65, 4)])
def test_rbf_kernel_matches_plain(cuda, Ta, Tb, d):
    gen = torch.Generator(device=cuda).manual_seed(Ta + Tb + d)
    A = 1.5 * torch.randn((Ta, d), generator=gen, device=cuda)
    Bm = 1.5 * torch.randn((Tb, d), generator=gen, device=cuda) + 0.3
    before = pairwise.rbf_kernel_sum.launches
    got = pairwise.rbf_kernel_sum(A, Bm)
    ref = pairwise.rbf_kernel_sum_plain(A, Bm)
    assert pairwise.rbf_kernel_sum.launches == before + 1
    assert abs(float(got) - float(ref)) <= RTOL * abs(float(ref))


def test_fused_metrics_match_plain_statistics(cuda):
    """U/V and MMD^2 assembled from the kernels' sums against the tiled
    plain statistics, on 4-mode draws (the eval path of every example with
    an exact sampler)."""
    from mfm_tpu_torch.diagnostics import max_mean_disc, stein_disc

    four = four_mode_mixture(cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    X, Y = four.sample(gen, (2000,)), four.sample(gen, (1500,))
    fu, fv = pairwise.stein_disc_fused(X, four.score)
    u, v = stein_disc(X, four.score)
    # U is V's pairwise sum less the diagonal: its error is on V's scale
    assert abs(float(fu) - float(u)) <= RTOL * abs(float(v))
    assert abs(float(fv) - float(v)) <= RTOL * abs(float(v))
    # MMD^2 is a small difference of O(1) sums: absolute tolerance
    assert abs(float(pairwise.max_mean_disc_fused(X, Y)) - float(max_mean_disc(X, Y))) <= 1e-5


@pytest.mark.parametrize("with_score", [True, False])
@pytest.mark.parametrize("pbc,bc_value", [(False, 0.0), (False, 0.5), (True, 0.0)])
@pytest.mark.parametrize("B,d", [(1001, 8), (1024, 64), (37, 1600)])
def test_phi_four_kernel_matches_plain(cuda, B, d, pbc, bc_value, with_score):
    gen = torch.Generator(device=cuda).manual_seed(B + d)
    x = 1.5 * torch.randn((B, d), generator=gen, device=cuda)
    before = phi_four.phi_four_value_and_score.launches
    value, score = phi_four.phi_four_value_and_score(x, 0.1, 20.0, pbc, bc_value, with_score)
    ref_v, ref_s = phi_four.phi_four_value_and_score_plain(x, 0.1, 20.0, pbc, bc_value)
    torch.cuda.synchronize()
    assert phi_four.phi_four_value_and_score.launches == before + 1
    assert _rel_err(value, ref_v) <= 1e-5
    if with_score:
        assert _rel_err(score, ref_s) <= 1e-5
    else:
        assert score is None


def test_phi_four_kernel_refuses_what_it_cannot_run(cuda):
    x = torch.randn(8, 16, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        phi_four.phi_four_value_and_score(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        phi_four.phi_four_value_and_score(x.t())


@pytest.mark.parametrize("bc,tilt", [(("dirichlet", 0.0), None),
                                     (("pbc", 0.0), {"val": 0.3, "lambda": 2.0})])
def test_phi_four_hvp_matches_autodiff(cuda, bc, tilt):
    """The K3-backed score's tangent (the transport's vmap(jvp)) and
    reverse mode through log_lik, against autodiff of the plain value."""
    from torch.func import grad, jacrev, jvp, vmap

    target = PhiFour(64, bc=bc, tilt=tilt)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = 1.5 * torch.rand((256, 64), generator=gen, device=cuda) - 0.75
    ex = torch.randn((8, 256, 64), generator=gen, device=cuda)

    def plain_log_lik(y):
        v, _ = phi_four.phi_four_value_and_score_plain(y, 0.1, 20.0, bc[0] == "pbc", bc[1])
        if tilt is not None:
            v = v - 20.0 * tilt["lambda"] * (tilt["val"] - y.mean(-1)) ** 2 / (4.0 * 64)
        return v

    ref = vmap(lambda e: jvp(grad(lambda y: plain_log_lik(y).sum()), (x,), (e,))[1])(ex)
    got = vmap(lambda e: jvp(target.score, (x,), (e,))[1])(ex)
    assert _rel_err(got, ref) <= 1e-5
    fwd_over_rev = vmap(lambda e: jvp(grad(lambda y: target.log_lik(y).sum()), (x,), (e,))[1])(ex)
    assert _rel_err(fwd_over_rev, ref) <= 1e-5
    rows = x[:4]
    jac = vmap(jacrev(target.score))(rows)  # x batched: the op's vmap rule
    assert _rel_err(jac, vmap(jacrev(grad(plain_log_lik)))(rows)) <= 1e-5


def test_cuda_phi_four_launches_k3(cuda):
    target = PhiFour(64)
    x = torch.rand((128, 64), device=cuda)
    counter = phi_four.phi_four_value_and_score
    for call in (target.log_lik, target.score, target.value_and_score,
                 lambda y: target.tempered_value_and_score(y, 0.5)):
        before = counter.launches
        call(x)
        assert counter.launches == before + 1
