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
1e-5 relative to the float64 plain version (fp32 terms of one
rsqrt.approx / ex2.approx a pair, summed in fp64; the Gram route as the
test says), the fp32 plain version itself to 1e-4 of it (its Gram
products in fp32 tiles); K3 and its
Hessian-vector product to 1e-5 relative -- fp32 sums of d terms in another
order (warp shuffles), and the same per-site stencil; the fused score
gate to 1e-5 relative -- the same sums of three terms per site.
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
from mfm_tpu_torch.targets import (
    Funnel,
    LogGaussianCoxPines,
    ManyWell,
    PhiFour,
    four_mode_mixture,
)

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


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("S", [1, 3, 10])
@pytest.mark.parametrize("B", [100, 1024])
def test_field_kernel_seed_axis_matches_plain(cuda, S, B, act):
    """K1 with a seed axis: S nets (weights and frequencies that differ by
    seed) on S B seed-major rows and 64 tangents in one launch, bit for bit
    against S single-seed launches (the same block body on the same rows),
    and against the plain version seed by seed. With relu the tangents are
    held to the plain version only through the single-seed launches: over
    10 x 1024 rows some unit's z lies within the two summation orders'
    rounding of 0 and takes the other side of the kink (act' 0 against 1);
    tanh has no kink and holds every output to the plain version."""
    d, width, n_fourier, K = 64, 128, 128, 64
    nets = [_net(cuda, d, width, n_fourier, act, seed=s)[1] for s in range(S)]
    stacked = {k: torch.stack([p[k] for p in nets]) for k in nets[0]}
    layout = field.field_layout(nets[0], n_fourier)
    packed = field.pack_field_params(stacked, layout)
    assert packed.shape == (S, layout.size)
    gen = torch.Generator(device=cuda).manual_seed(1)
    freqs = torch.randn((S, n_fourier), generator=gen, device=cuda)
    x = torch.randn((S * B, d), generator=gen, device=cuda)
    t = torch.rand(S * B, generator=gen, device=cuda)
    ex = torch.randn((K, S * B, d), generator=gen, device=cuda)
    before = field.field_apply.launches
    got = field.field_apply(packed, layout, act, freqs, x, t, ex)
    torch.cuda.synchronize()
    assert field.field_apply.launches == before + 1
    ref = field.field_apply_plain(packed, layout, act, freqs, x, t, ex)
    for g, r in zip(got if act == "tanh" else got[:2], ref):
        assert g.shape == r.shape and _rel_err(g, r) <= RTOL
    for s in range(S):
        rows = slice(s * B, (s + 1) * B)
        one = field.field_apply(packed[s].contiguous(), layout, act, freqs[s].contiguous(),
                                x[rows], t[rows], ex[:, rows].contiguous())
        for g, o in zip(got, one):
            assert torch.equal(g[..., rows, :], o), s


def test_seed_sweep_launches_k1_once_a_stage_for_all_seeds(cuda):
    """``run_mfm_seeds`` on the fused field: three seeds make exactly the K1
    launches of one seed's ``run_mfm`` (one a transport stage for all
    seeds), and finite results."""
    from mfm_tpu_torch.config import MFMConfig
    from mfm_tpu_torch.drivers import run_mfm, run_mfm_seeds

    cfg = MFMConfig(example="phi-four", dim=8, num_chain=64, hidden_x=(32, 32),
                    hidden_t=(32, 32), hidden_xt=(32, 32), fourier_dim=8, ode_steps=3,
                    mcmc_per_flow_steps=3.0, learning_iter=8, chunk_size=4, step_size=1e-3,
                    field_precision="highest", pallas_field=True)
    before = field.field_apply.launches
    run = run_mfm(PhiFour(8), cfg, cuda)
    one = field.field_apply.launches - before
    sweep = run_mfm_seeds(PhiFour(8), cfg, [0, 1, 2], cuda)
    assert field.field_apply.launches - before - one == one > 0
    assert sweep.positions.shape == (3, 64, 8) and bool(torch.isfinite(sweep.positions).all())
    assert all(v.shape == (3, 8) for v in sweep.metrics.values())
    assert bool(torch.isfinite(run.chain.position).all())


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


def _flow_pair(cuda, d=8):
    """One flow on K1 and on the module field (no score gate), forward only."""
    net, params = _net(cuda, d, 32, 16, seed=4)
    flows = []
    for bind in (kernel_tangent_field(net), module_tangent_field(net)):
        tr = make_transport(bind, divergence="exact", n_steps=4)
        flows.append(lambda u, tr=tr: tr.forward(params, u))
    return flows


@torch.no_grad()
def test_tess_step_on_k1_matches_the_module_field(cuda):
    """One TESS step (kernels/tess.py) through K1 and through the module
    field on the same noise: the same shrink counts; positions to 1e-4
    (16 stage evaluations in fp32), slice values to 1e-4 absolute at
    |value| ~ 10."""
    from mfm_tpu_torch.kernels import tess
    from mfm_tpu_torch.targets import IndepGaussian

    target = IndepGaussian(8, mean=0.5, var=0.5)
    gen = torch.Generator(device=cuda).manual_seed(5)
    state = tess.init(torch.randn((256, 8), generator=gen, device=cuda))
    noise = tess.draw_noise(gen, 256, 8)
    kernel = tess.build_kernel()
    (sk, ik), (sm, im) = (kernel(state, target.log_prob, f, noise) for f in _flow_pair(cuda))
    assert torch.equal(ik.subiter, im.subiter) and int(ik.subiter.max()) >= 2
    assert float((sk.position - sm.position).abs().max()) <= 1e-4
    assert float((ik.slice_value - im.slice_value).abs().max()) <= 1e-4


@torch.no_grad()
def test_cis_step_on_k1_matches_the_module_field(cuda):
    """One CIS step (kernels/cis.py), 4 candidates a chain in one 1280-row
    transport, through K1 and through the module field: the same picks,
    log-weights to 1e-4 absolute."""
    from mfm_tpu_torch.kernels import cis
    from mfm_tpu_torch.targets import IndepGaussian

    target = IndepGaussian(8, mean=0.5, var=0.5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    state = cis.init(torch.randn((256, 8), generator=gen, device=cuda))
    noise = cis.draw_noise(gen, 256, 4, 8)
    kernel = cis.build_kernel(4)
    (sk, ik), (sm, im) = (kernel(state, target.log_prob, f, noise) for f in _flow_pair(cuda))
    assert torch.equal(sk.pullback_position, sm.pullback_position)
    assert float((ik.log_weights - im.log_weights).abs().max()) <= 1e-4


WIDE = pairwise.GRAM_MIN_D  # from this d on the Stein sum takes the tensor cores


@pytest.mark.parametrize("T,d,beta", [
    (1000, 3, -0.5), (300, 64, -0.5), (64, 2, -0.5), (65, 70, -0.5),
    (300, WIDE - 1, -0.5), (300, WIDE, -0.5),  # each side of the route threshold
    (257, 1600, -0.5),
    (1000, 3, -0.3), (300, 64, -0.3), (257, 200, -0.3),  # the general-b instances
])
def test_stein_kernel_matches_plain(cuda, T, d, beta):
    """Against the plain version in float64, relative to the sum: 1e-5 on
    the differences routes; on the Gram route the larger of that and the
    fp32 plain version's own error (both take the Gram form)."""
    gen = torch.Generator(device=cuda).manual_seed(T + d)
    X = 2.0 * torch.randn((T, d), generator=gen, device=cuda)
    S = -X / 4.0 + 0.1 * torch.randn((T, d), generator=gen, device=cuda)
    before = pairwise.stein_pairwise_sum.launches
    got = pairwise.stein_pairwise_sum(X, S, beta)
    again = pairwise.stein_pairwise_sum(X, S, beta)
    ref = float(pairwise.stein_pairwise_sum_plain(X.double(), S.double(), beta))
    plain = float(pairwise.stein_pairwise_sum_plain(X, S, beta))
    assert pairwise.stein_pairwise_sum.launches == before + 2
    assert got.dtype == torch.float64
    assert torch.equal(got, again)  # a fixed reduction order: bitwise repeatable
    if d < WIDE:
        assert abs(plain - ref) <= RTOL * abs(ref)
    tol = max(1e-5, abs(plain - ref) / abs(ref)) if d >= WIDE else 1e-5
    assert abs(float(got) - ref) <= tol * abs(ref)


@pytest.mark.parametrize("route", ["diff", "gram"])
def test_stein_routes_agree(cuda, route):
    """Either route takes any d: both against float64 at a d between them."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    X = 1.5 * torch.randn((333, 96), generator=gen, device=cuda) + 3.0
    S = -X / 2.0 + 0.3 * torch.randn((333, 96), generator=gen, device=cuda)
    ref = float(pairwise.stein_pairwise_sum_plain(X.double(), S.double()))
    got = float(pairwise.stein_pairwise_sum(X, S, route=route))
    assert abs(got - ref) <= 1e-5 * abs(ref)


def _stein_with_route(X, S, **kw):
    """(sum, the route the call took), from the wrapper's route counts."""
    counts = pairwise.stein_pairwise_sum.route_counts
    before = dict(counts)
    out = pairwise.stein_pairwise_sum(X, S, **kw)
    (route,) = [k for k in counts if counts[k] != before[k]]
    return out, route


def _far_modes(dev, T, d, offset, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    modes = offset * (2.0 * torch.randint(0, 2, (T, 1), generator=gen, device=dev) - 1.0)
    X = torch.randn((T, d), generator=gen, device=dev) + modes
    return X.contiguous(), (modes - X).contiguous()


def test_stein_gram_route_on_two_far_modes(cuda):
    """Modes at +-8 in every coordinate: the centring removes no offset and
    the norms are 65 times a within-mode distance. The Gram route asked for
    by name still holds 1e-5 of float64 here; the default route is the
    differences form, which the data-driven bound sends such input to."""
    X, S = _far_modes(cuda, 700, 64, 8.0, 12)
    ref = float(pairwise.stein_pairwise_sum_plain(X.double(), S.double()))
    assert abs(float(pairwise.stein_pairwise_sum(X, S, route="gram")) - ref) <= 1e-5 * abs(ref)
    got, route = _stein_with_route(X, S)
    assert abs(float(got) - ref) <= 1e-5 * abs(ref) and route == "diff"


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("offset", [1.0, 16.0, 32.0])
def test_stein_default_route_on_far_modes(cuda, d, offset):
    """The route the bound picks stays within 1e-5 of float64, with equal
    bits twice, and it is the decision of ``pick_stein_route``."""
    X, S = _far_modes(cuda, 12800, d, offset, int(offset) + d)
    ref = float(pairwise.stein_pairwise_sum_plain(X.double(), S.double()))
    (got, route), again = _stein_with_route(X, S), pairwise.stein_pairwise_sum(X, S)
    assert torch.equal(got, again)
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)
    assert route == pairwise.pick_stein_route(X) == ("gram" if offset == 1.0 else "diff")
    forced, forced_route = _stein_with_route(X, S, route="gram")  # route= still overrides
    assert forced_route == "gram" and torch.equal(forced, got) == (route == "gram")


def test_stein_on_many_well_draws(cuda):
    """Exact many-well draws at the eval size (T=12800, d=32, 2^16 modes)."""
    target = ManyWell(32)
    X = target.sample(torch.Generator(device=cuda).manual_seed(0), (12800,)).contiguous()
    S = target.score(X).contiguous()
    ref = float(pairwise.stein_pairwise_sum_plain(X.double(), S.double()))
    got, again = pairwise.stein_pairwise_sum(X, S), pairwise.stein_pairwise_sum(X, S)
    assert torch.equal(got, again) and abs(float(got) - ref) <= 1e-5 * abs(ref)
    for route in ("diff", "gram"):
        forced = float(pairwise.stein_pairwise_sum(X, S, route=route))
        assert abs(forced - ref) <= 1e-5 * abs(ref), route


def test_stein_at_the_pines_eval_shape(cuda):
    """(128, 1600): two tiles of rows, 50 chunks of columns; distinct points
    take the Gram route, an IS-resampled set with repeats the differences."""
    target = LogGaussianCoxPines(1600, device=cuda)
    X = target.prior_sample(torch.Generator(device=cuda).manual_seed(1), (128,)).contiguous()
    for points, route in ((X, "gram"), (X[torch.arange(128, device=cuda) // 32].contiguous(),
                                       "diff")):
        S = target.score(points).contiguous()
        ref = float(pairwise.stein_pairwise_sum_plain(points.double(), S.double()))
        (got, took), again = _stein_with_route(points, S), pairwise.stein_pairwise_sum(points, S)
        assert took == route
        assert torch.equal(got, again) and abs(float(got) - ref) <= 1e-5 * abs(ref), route


@pytest.mark.parametrize("target", [Funnel(10), ManyWell(32)], ids=["funnel", "many-well"])
def test_rbf_general_kernel_on_exact_draws(cuda, target):
    """K2b at d = 10 and 32 (``rbf_general_kernel``): the MMD of a funnel or
    many-well run, three sums in one launch."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    X, Y = (target.sample(gen, (3000,)).contiguous() for _ in range(2))
    got, again = pairwise.rbf_mmd_sums(X, Y), pairwise.rbf_mmd_sums(X, Y)
    ref = pairwise.rbf_mmd_sums_plain(X.double(), Y.double())
    assert torch.equal(got, again)
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5


@pytest.mark.parametrize("whitened", [False, True])
def test_cox_value_and_score_on_the_card(cuda, whitened):
    """The Cox target's value, score and score tangent on the card against
    the CPU: exact fp32 products on both (TF32 off around each)."""
    from torch.func import jvp

    on_cpu = LogGaussianCoxPines(1600, whitened=whitened)
    on_card = LogGaussianCoxPines(1600, whitened=whitened, device=cuda)
    x = on_cpu.prior_sample(torch.Generator().manual_seed(3), (16,))
    x = 0.5 * x if whitened else x
    e = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    torch.backends.cuda.matmul.allow_tf32 = True  # the target must not depend on it
    try:
        v, g = on_card.tempered_value_and_score(x.to(cuda), 0.7)
        tangent = jvp(on_card.score, (x.to(cuda),), (e.to(cuda),))[1]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    v_ref, g_ref = on_cpu.tempered_value_and_score(x, 0.7)
    assert _rel_err(v.cpu(), v_ref) <= 1e-5
    assert _rel_err(g.cpu(), g_ref) <= 1e-4
    assert _rel_err(tangent.cpu(), jvp(on_cpu.score, (x,), (e,))[1]) <= 1e-4


def test_exact_disc_over_the_kernel_matches_the_module(cuda):
    """The discrete map's exact logdet with K1 carrying the d tangents,
    against torch.func.jvp of the nn.Module, with the phi-four score gate."""
    target = PhiFour(8)
    net, params = _net(cuda, 8, 32, 16, score_fn=target.score, gate_scale=1e-3, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    u = 2.0 * torch.rand((256, 8), generator=gen, device=cuda) - 1.0
    out = {}
    before = field.field_apply.launches
    for name, bind in (("kernel", kernel_tangent_field(net)),
                       ("module", module_tangent_field(net))):
        tr = make_transport(bind, divergence="exact_disc", n_steps=4)
        x, ld_f = tr.forward(params, u)
        u_back, ld_i = tr.inverse(params, x)
        out[name] = (x, ld_f, u_back, ld_i)
    assert field.field_apply.launches == before + 32  # 2 transports x 4 steps x 4 stages
    for a, b in zip(out["kernel"], out["module"]):
        assert torch.isfinite(a).all() and float((a - b).abs().max()) <= 1e-4
    exact = make_transport(kernel_tangent_field(net), divergence="exact", n_steps=64)
    assert float((exact.forward(params, u)[1] - make_transport(
        kernel_tangent_field(net), divergence="exact_disc", n_steps=64
    ).forward(params, u)[1]).abs().max()) <= 1e-3


@pytest.mark.parametrize("Ta,Tb,d", [
    (1000, 700, 2), (300, 300, 33), (1, 65, 4),
    (1000, None, 2), (300, None, 33), (130, None, 3),  # A with itself: half the pairs
])
def test_rbf_kernel_matches_plain(cuda, Ta, Tb, d):
    gen = torch.Generator(device=cuda).manual_seed(Ta + (Tb or 0) + d)
    A = 1.5 * torch.randn((Ta, d), generator=gen, device=cuda)
    Bm = A if Tb is None else 1.5 * torch.randn((Tb, d), generator=gen, device=cuda) + 0.3
    before = pairwise.rbf_kernel_sum.launches
    got = pairwise.rbf_kernel_sum(A, Bm)
    again = pairwise.rbf_kernel_sum(A, Bm)
    ref = float(pairwise.rbf_kernel_sum_plain(A.double(), Bm.double()))
    assert pairwise.rbf_kernel_sum.launches == before + 2
    assert got.dtype == torch.float64 and torch.equal(got, again)
    assert abs(float(pairwise.rbf_kernel_sum_plain(A, Bm)) - ref) <= RTOL * abs(ref)
    assert abs(float(got) - ref) <= 1e-5 * abs(ref)
    if Tb is None:  # an equal copy takes every ordered pair: the same sum
        full = pairwise.rbf_kernel_sum(A, A.clone())
        assert abs(float(full) - float(got)) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("Tx,Ty,d,sigma2", [(1000, 700, 2, 1.0), (300, 300, 33, 20.0),
                                            (65, 1, 4, 0.5)])
def test_rbf_mmd_sums_match_plain(cuda, Tx, Ty, d, sigma2):
    """The three sums of an MMD from one launch."""
    gen = torch.Generator(device=cuda).manual_seed(Tx + Ty + d)
    X = 1.5 * torch.randn((Tx, d), generator=gen, device=cuda)
    Y = 1.5 * torch.randn((Ty, d), generator=gen, device=cuda) + 0.3
    before = pairwise.rbf_kernel_sum.launches
    got = pairwise.rbf_mmd_sums(X, Y, sigma2)
    again = pairwise.rbf_mmd_sums(X, Y, sigma2)
    ref = pairwise.rbf_mmd_sums_plain(X.double(), Y.double(), sigma2)
    assert pairwise.rbf_kernel_sum.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == (3,) and torch.equal(got, again)
    assert float(((got - ref).abs() / ref.abs()).max()) <= 1e-5
    single = torch.stack([pairwise.rbf_kernel_sum(X, X, sigma2),
                          pairwise.rbf_kernel_sum(Y, Y, sigma2),
                          pairwise.rbf_kernel_sum(X, Y, sigma2)])
    assert torch.equal(got, single) or float(((got - single).abs() / ref.abs()).max()) <= 1e-12


@pytest.mark.parametrize("d", [2, 1600])
def test_evaluate_samples_takes_the_kernels_at_every_d(cuda, d):
    from mfm_tpu_torch.drivers import check_floor, evaluate_samples

    target = four_mode_mixture(cuda) if d == 2 else PhiFour(d)
    gen = torch.Generator(device=cuda).manual_seed(d)
    X = 0.5 * torch.randn((130, d), generator=gen, device=cuda)
    counters = (pairwise.stein_pairwise_sum, pairwise.rbf_kernel_sum)
    before = [f.launches for f in counters]
    row = evaluate_samples(target, X, X + 0.01)
    assert row["metrics_kernel"] == "cuda"
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 0]
    on_cpu = four_mode_mixture() if d == 2 else target
    assert evaluate_samples(on_cpu, X.cpu(), X.cpu())["metrics_kernel"] == "torch"
    floor = check_floor(target, X)
    assert [f.launches - b for f, b in zip(counters, before)] == [3, 1]
    plain = check_floor(target, X, fused_metrics=False)
    for k, v in plain.items():
        assert abs(floor[k] - v) <= RTOL * max(abs(plain["stein_v_real"]), abs(v)), k


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


def _gate_inputs(dev, B, d, K, seed, shift=0):
    """x in (-1, 1), a small gate, random field and tangents; ``shift``
    offsets every tensor by that many floats into its storage (a pointer
    not 16-byte aligned)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(*shape, scale=1.0):
        n = 1
        for s in shape:
            n *= s
        return scale * torch.randn(n + shift, generator=gen, device=dev)[shift:].view(shape)

    x = (2.0 * torch.rand((B, d), generator=gen, device=dev) - 1.0)
    if shift:
        x = draw(B, d).copy_(x)
    ex = draw(K, B, d) if K else None
    dfield = draw(K, B, d) if K else None
    return x, draw(B, d, scale=0.05), draw(B, d), ex, dfield


@pytest.mark.parametrize("B,d,K,kw,shift", [
    (1024, 64, 64, {}, 0),                                     # the slice's stage
    (1024, 64, 64, {"pbc": True, "tilt_lambda": 2.0, "tilt_val": 0.3}, 0),
    (37, 64, 64, {"clip": 60.0, "bc_value": 0.5}, 0),
    (1000, 37, 5, {"pbc": True, "clip": 80.0}, 0),             # d not a multiple of 4
    (300, 1024, 2, {"tilt_lambda": 1.0, "tilt_val": -0.2}, 0), # the widest tiled row, 8 chunks
    (40, 2048, 3, {"tilt_lambda": 1.0, "tilt_val": -0.2}, 0),  # wider: one warp a row
    (33, 258, 2, {"pbc": True, "clip": 60.0}, 0),              # wider at 1 site a lane
    (20, 512, 2, {"pbc": True}, 1),                            # unaligned, wider at 1 site
    (77, 300, 3, {"pbc": True}, 0),                            # 3 of 4 chunks used
    (50, 64, 3, {"pbc": True, "clip": 60.0}, 1),               # unaligned: 1 site a lane
    (129, 8, 0, {"clip": 30.0}, 0),                            # no tangents
    (3, 1, 2, {"pbc": True}, 0),                               # one site
])
def test_score_gate_kernel_matches_plain(cuda, B, d, K, kw, shift):
    x, gate, field, ex, dfield = _gate_inputs(cuda, B, d, K, B + d + K, shift)
    ref = phi_four.phi_four_score_gate_plain(
        x, gate, field.clone(), ex, None if dfield is None else dfield.clone(), **kw
    )
    before = phi_four.phi_four_score_gate.launches
    got = phi_four.phi_four_score_gate(x, gate, field, ex, dfield, **kw)
    torch.cuda.synchronize()
    assert phi_four.phi_four_score_gate.launches == before + 1
    assert got[0] is field and got[1] is dfield  # in place
    assert _rel_err(got[0], ref[0]) <= 1e-5
    if K:
        assert _rel_err(got[1], ref[1]) <= 1e-5


def test_score_gate_kernel_refuses_what_it_cannot_run(cuda):
    x, gate, field, ex, dfield = _gate_inputs(cuda, 8, 16, 2, 0)
    with pytest.raises(ValueError, match="float32"):
        phi_four.phi_four_score_gate(x, gate, field.double(), ex, dfield)
    with pytest.raises(ValueError, match="contiguous"):
        phi_four.phi_four_score_gate(x, gate, field, ex.transpose(1, 2), dfield)
    with pytest.raises(ValueError, match=r"\(K, B, d\)"):
        phi_four.phi_four_score_gate(x, gate, field, ex, dfield[:1])


def test_phi_four_transport_takes_the_fused_gate(cuda, monkeypatch):
    """Both tangent fields with PhiFour's fused gate against the same
    transport on the generic route (vmap(jvp) of the K3-backed score);
    the fused one never reaches PhiFour.hvp."""
    target = PhiFour(64)
    net, params = _net(cuda, 64, 64, 16, score_fn=target.score, gate_scale=1e-3, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    u = 2.0 * torch.rand((256, 64), generator=gen, device=cuda) - 1.0
    generic = make_transport(kernel_tangent_field(net), divergence="exact", n_steps=3)
    ref = generic.forward(params, u)
    net.score_gate = target.score_gate

    def no_hvp(*args, **kwargs):
        raise AssertionError("the fused route reached PhiFour.hvp")

    monkeypatch.setattr(PhiFour, "hvp", no_hvp)
    for bind in (kernel_tangent_field(net), module_tangent_field(net)):
        before = phi_four.phi_four_score_gate.launches
        x, logdet = make_transport(bind, divergence="exact", n_steps=3).forward(params, u)
        torch.cuda.synchronize()
        assert phi_four.phi_four_score_gate.launches == before + 12  # 3 RK4 steps
        # fp32, 12 stages, summation order differs (x); the logdet sums
        # 12 x 64 diagonal terms
        assert float((x - ref[0]).abs().max()) <= 1e-4
        assert float((logdet - ref[1]).abs().max()) <= 1e-3


@pytest.mark.parametrize("route", ["autograd", "func.grad"])
def test_score_gate_kernel_refuses_autograd(cuda, route):
    """The kernel writes field and dfield through raw pointers, which no
    tape sees: an input that requires grad is refused on either route."""
    x, gate, field, ex, dfield = _gate_inputs(cuda, 8, 16, 2, 0)
    if route == "autograd":
        with pytest.raises(ValueError, match="requires grad"):
            phi_four.phi_four_score_gate(x.requires_grad_(True), gate, field, ex, dfield)
    else:
        from torch.func import grad

        with pytest.raises(ValueError, match="requires grad"):
            grad(lambda y: phi_four.phi_four_score_gate(y, gate, field, ex, dfield)[0].sum())(x)


def _phi_four_chains(dev, B, seed):
    from mfm_tpu_torch.kernels import ChainState

    target = PhiFour(64)
    gen = torch.Generator().manual_seed(seed)
    x = (1.6 * torch.rand((B, 64), generator=gen) - 0.8).to(dev)
    return target, ChainState(x, *target.value_and_score(x)), gen


@pytest.mark.parametrize("variant,depth", [("static", 6), ("iterative", 8)])
def test_nuts_step_on_k3_matches_the_plain_version(cuda, variant, depth):
    """A NUTS step on PhiFour(64), every leapfrog a K3 launch, against the
    same step on the CPU plain version with the same noise: positions to
    1e-4 (fp32 sums in another order, through up to 2^depth - 1
    leapfrogs), the trees' depths, u-turn and divergence flags equal."""
    from mfm_tpu_torch.kernels import nuts

    B = 256
    target, state, gen = _phi_four_chains(cuda, B, 7)
    noise = nuts.draw_noise(gen, B, 64, depth, variant)
    inv_mass = 0.5 + torch.rand(64, generator=gen)
    out = {}
    for dev in ("cpu", cuda):
        kernel = nuts.build_kernel(target.value_and_score, depth, variant=variant)
        st = type(state)(*(v.to(dev) for v in state))
        before = phi_four.phi_four_value_and_score.launches
        new, info = kernel(st, 0.02, inv_mass.to(dev), type(noise)(*(v.to(dev) for v in noise)))
        out[str(dev)] = (new, info, phi_four.phi_four_value_and_score.launches - before)
    (cpu, cpu_info, _), (gpu, gpu_info, launches) = out["cpu"], out[str(cuda)]
    assert launches >= 2 ** int(gpu_info.num_doublings.max()) - 1
    assert float((gpu.position.cpu() - cpu.position).abs().max()) <= 1e-4
    for f in ("num_doublings", "is_turning", "is_divergent"):
        assert torch.equal(getattr(gpu_info, f).cpu(), getattr(cpu_info, f)), f
    assert int(gpu_info.num_doublings.max()) >= 3


def test_smc_step_on_k3_matches_the_plain_version(cuda):
    """One adaptive tempered SMC step (ESS solve, systematic resampling,
    two MALA moves, reweighing) on PhiFour(64), K3 on the card against the
    CPU plain version with the same noise."""
    from mfm_tpu_torch.config import MFMConfig
    from mfm_tpu_torch.drivers.smc_run import build_smc

    cfg = MFMConfig(example="phi-four", dim=64, num_chain=512, step_size=1e-4,
                    anneal_iter=400, num_anneal_temp=200)
    gen = torch.Generator().manual_seed(3)
    out = {}
    for dev in ("cpu", cuda):
        pieces = build_smc(PhiFour(64), cfg)
        g = torch.Generator().manual_seed(3)
        carry = pieces.init_fn(pieces.target.init_positions(g, cfg.num_chain).to(dev))
        noise = pieces.draw_step_noise(gen.manual_seed(4))
        noise = type(noise)(noise.resample.to(dev), [type(m)(*(v.to(dev) for v in m))
                                                     for m in noise.moves])
        before = phi_four.phi_four_value_and_score.launches
        carry, info = pieces.step_fn(carry, noise)
        out[str(dev)] = (carry, info, phi_four.phi_four_value_and_score.launches - before)
    (cpu, cpu_info, _), (gpu, gpu_info, launches) = out["cpu"], out[str(cuda)]
    assert launches >= 4  # the ESS solve's log-likelihood, two moves and their init, reweighing
    assert abs(float(gpu.state.lmbda) - float(cpu.state.lmbda)) <= 1e-5
    assert 0.0 < float(cpu.state.lmbda) < 1.0
    assert torch.equal(gpu_info.ancestors.cpu(), cpu_info.ancestors)
    assert float((gpu.state.particles.cpu() - cpu.state.particles).abs().max()) <= 1e-4
    assert _rel_err(gpu.state.weights.cpu(), cpu.state.weights) <= 1e-4


def test_pullback_gradient_on_pines_matches_central_differences(cuda):
    """The latent target's score on pines (d=1600, a small module field,
    Hutchinson with a fixed probe): one forward and one reverse pass
    through the transport, against central differences of the value along
    4 random unit directions. The field is tanh (a relu field's kinks break
    central differences); the values are ~2e3 in fp32, so rounding rules
    below h = 0.1, where the CPU measured at most 2.6e-3 of the largest
    derivative: 1e-2."""
    from mfm_tpu_torch.flows.pullback import FlowPullbackTarget
    from mfm_tpu_torch.targets import PriorReference

    target = LogGaussianCoxPines(1600, device=cuda)
    net, params = _net(cuda, 1600, 32, 8, act="tanh", score_fn=target.score, gate_scale=1e-4,
                       seed=6)
    transport = make_transport(module_tangent_field(net), divergence="hutchinson", n_steps=3)
    ref = PriorReference(target)
    gen = torch.Generator(device=cuda).manual_seed(6)
    B = 8
    u = ref.sample(gen, (B,))
    probes = {B: torch.randn((B, 1600), generator=gen, device=cuda)}
    latent = FlowPullbackTarget(target, transport, params, ref, probes)
    beta = 0.5
    value, score = latent.tempered_value_and_score(u, beta)
    assert torch.allclose(value, latent.tempered_log_prob(u, beta), rtol=1e-6, atol=1e-3)
    h = 0.1
    for i in range(4):
        v = torch.randn((B, 1600), generator=gen, device=cuda)
        v = v / v.norm(dim=-1, keepdim=True)
        fd = (latent.tempered_log_prob(u + h * v, beta)
              - latent.tempered_log_prob(u - h * v, beta)) / (2 * h)
        dd = torch.sum(score * v, -1)
        assert float((fd - dd).abs().max()) <= 1e-2 * float(dd.abs().max()), i


def _coupling(dev, dim=8, transform_type="spline", act_norm=True, seed=0):
    """A coupling flow with every parameter perturbed (the zero heads would
    make it the identity), on ``dev``."""
    from mfm_tpu_torch.flows.coupling import make_coupling_flow

    gen = torch.Generator().manual_seed(seed)
    flow, params = make_coupling_flow(dim, 4, (32, 32), transform_type, 8, (-5.0, 5.0),
                                      act_norm, 1.5, generator=gen, device=dev)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
              for k, v in params.items()}
    return flow, params


@pytest.mark.parametrize("transform_type", ["spline", "real_nvp"])
def test_coupling_flow_on_the_card_matches_the_cpu(cuda, transform_type):
    """The same flow and inputs on the card and on the CPU: fp32 GEMMs with
    TF32 off in another order, 1e-5 relative to the largest entry."""
    from mfm_tpu_torch.drivers.mfm import set_field_precision

    set_field_precision("highest")
    flow_g, params_g = _coupling(cuda, transform_type=transform_type)
    flow_c, _ = _coupling("cpu", transform_type=transform_type)
    params_c = {k: v.cpu() for k, v in params_g.items()}
    gen = torch.Generator().manual_seed(1)
    x = 2.0 * torch.randn(256, 8, generator=gen)
    for name in ("forward", "inverse"):
        got, ref = getattr(flow_g, name)(params_g, x.to(cuda)), getattr(flow_c, name)(params_c, x)
        assert _rel_err(got[0].cpu(), ref[0]) <= 1e-5 and _rel_err(got[1].cpu(), ref[1]) <= 1e-5
    assert _rel_err(flow_g.log_prob(params_g, x.to(cuda)).cpu(),
                    flow_c.log_prob(params_c, x)) <= 1e-5


def _fab_pair(cuda, target_g, target_c, example, **kw):
    from mfm_tpu_torch.drivers import fab

    kw = {"n_epoch": 3, "batch_size": 64,
          "overrides": {"flow": {"conditioner_mlp_units": [32], "n_layers": 2}}, **kw}
    return (fab.build_fab(target_g, example, device=cuda, **kw),
            fab.build_fab(target_c, example, device="cpu", **kw))


def test_fab_iteration_on_the_card_matches_the_cpu(cuda):
    """One prefill pass and one FAB epoch with the 4-mode config, from the
    same parameters and noise, card against CPU: 1e-4. The flow starts at
    its identity (zero heads; the first gradient steps move them) and the
    target is a Gaussian: an AIS pass through a perturbed spline flow on
    4-mode is chaotic on one device already (a 3e-7 relative change of the
    parameters moves 17 of 64 log-weights by up to 0.08 on the CPU: the
    gradient of a spline's log-det jumps at its knots, and 4-mode's score
    flips across mode boundaries). The buffer's rows are forced (a "Gumbel"
    of 1e6 at chosen filled slots), as an ulp can flip an argmax over 2,752
    slots between near-equal priorities."""
    from mfm_tpu_torch.drivers import fab
    from mfm_tpu_torch.drivers.mfm import set_field_precision
    from mfm_tpu_torch.targets import IndepGaussian

    set_field_precision("highest")
    target_c = IndepGaussian(2, mean=1.0, var=9.0)
    pg, pc = _fab_pair(cuda, target_c, target_c, "4-mode")
    gen = torch.Generator().manual_seed(2)
    carry_c = pc.init_carry(pc.params)
    carry_g = pg.init_carry({k: v.to(cuda) for k, v in pc.params.items()})
    ais = pc.draw_ais_noise(gen)
    carry_c = pc.prefill_one(carry_c, ais)
    carry_g = pg.prefill_one(carry_g, fab.AISNoise(*(v.to(cuda) for v in ais)))
    for name in ("buf_x", "buf_log_w", "buf_log_q", "step_sizes"):
        got, ref = getattr(carry_g, name)[:64].cpu(), getattr(carry_c, name)[:64]
        assert _rel_err(got, ref) <= 1e-4, (name, _rel_err(got, ref))
    it = pc.draw_iter_noise(gen)
    gumbels = []
    for _ in it.buffer:
        forced = torch.zeros(64, pc.cap)
        forced[torch.arange(64), torch.randint(0, 128, (64,), generator=gen)] = 1e6
        gumbels.append(forced)
    carry_c, out_c = pc.train_iter(carry_c, fab.FABIterNoise(it.ais, gumbels))
    carry_g, out_g = pg.train_iter(carry_g, fab.FABIterNoise(
        fab.AISNoise(*(v.to(cuda) for v in it.ais)), [g.to(cuda) for g in gumbels]))
    for name, a, b in zip(("loss", "acc", "log_z"), out_g, out_c):
        assert abs(float(a) - float(b)) <= 1e-4 * max(1.0, abs(float(b))), (name, a, b)
    pts = 6.0 * torch.randn(256, 2, generator=gen)
    assert _rel_err(pg.flow.log_prob(carry_g.params, pts.to(cuda)).cpu(),
                    pc.flow.log_prob(carry_c.params, pts)) <= 1e-4
    assert float(carry_c.params["conditioners.0.head.weight"].abs().max()) > 0  # it trained


def test_fab_hmc_gradient_on_phi_four_launches_k3(cuda):
    """FAB's HMC transition on phi-four (d=64): every gradient of log gamma
    runs autograd through the flow and K3's analytic score (a value launch
    and a score launch), n_inner + 1 = 6 gradients; against the CPU's plain
    version: 1e-4."""
    from mfm_tpu_torch.drivers.mfm import set_field_precision

    set_field_precision("highest")
    pg, pc = _fab_pair(cuda, PhiFour(64, device=cuda), PhiFour(64), "phi-four")
    gen = torch.Generator().manual_seed(3)
    params = {k: v + 0.02 * torch.randn(v.shape, generator=gen) for k, v in pc.params.items()}
    x = 2.0 * torch.rand(64, 64, generator=gen) - 1.0
    moves, u = torch.randn(1, 64, 64, generator=gen), torch.rand(1, 64, generator=gen)
    beta, step = torch.tensor(0.5), torch.tensor(3e-3)
    before = phi_four.phi_four_value_and_score.launches
    xg, acc_g = pg.transition({k: v.to(cuda) for k, v in params.items()}, beta.to(cuda),
                              step.to(cuda), x.to(cuda), moves.to(cuda), u.to(cuda))
    torch.cuda.synchronize()
    assert phi_four.phi_four_value_and_score.launches - before >= 2 * 6
    xc, acc_c = pc.transition(params, beta, step, x, moves, u)
    assert _rel_err(xg.cpu(), xc) <= 1e-4 and abs(float(acc_g) - float(acc_c)) <= 1e-6
    assert 0.0 < float(acc_c)
