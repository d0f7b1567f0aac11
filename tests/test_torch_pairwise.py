"""The redesigned pairwise kernels (K2a/K2b), as far as a CPU reaches them.

- The fused MMD's plain version and assembly against the Pallas kernels in
  interpret mode (rtol 1e-5: the same ~T^2 fp32 terms, the port adds its
  tiles in fp64).
- The host-side tile schedule by enumeration: every tile pair of a sum
  exactly once (of a symmetric sum, every unordered pair, those with j > i
  at weight 2).
- A torch emulation of the CUDA kernels' arithmetic, tile by tile on that
  schedule, against the float64 sums within 1e-5 relative: the differences
  form with the IMQ powers from one rsqrt (b = 1/2) or one exp2/log2 and a
  reciprocal (any b); the centred Gram form with three hi/lo-split TF32
  products (x.x, s.s, (x+s).(x+s)); the RBF term as exp2 of pre-scaled
  coordinates. fp32 inside a tile, fp64 across tiles, as the kernels.
- The Stein sum's route by the data (``gram_error_estimate``,
  ``pick_stein_route``): on two modes at +-1, +-8, +-16 and +-32 in every
  coordinate (d = 32 and 64) the route it picks, emulated, stays within
  1e-5 of float64, where the Gram route alone does not.
- check_floor, report_row and aggregate_seeds against the reference's
  (rtol 1e-4 for the statistics, the row layout exact).
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfm_tpu.targets as jt
import mfm_tpu_torch.targets as pt
from mfm_tpu.drivers import eval as j_eval
from mfm_tpu.ops.pairwise_pallas import max_mean_disc_pallas as j_mmd_pallas
from mfm_tpu.ops.pairwise_pallas import rbf_kernel_sum as j_rbf_sum
from mfm_tpu_torch.drivers import aggregate_seeds, check_floor, report_row
from mfm_tpu_torch.ops import pairwise as K2
from torch_parity import tt

torch.set_num_threads(1)

TILE = K2.TILE


def _draw(T, d, seed, scale=2.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((T, d)) + shift).astype(np.float32)


# ------------------------------------------------- the fused MMD, plain --


def test_rbf_mmd_sums_plain_matches_pallas_interpret():
    X, Y = _draw(300, 3, 0), _draw(200, 3, 1, 1.5)
    ref = [float(j_rbf_sum(jnp.asarray(a), jnp.asarray(b), interpret=True))
           for a, b in ((X, X), (Y, Y), (X, Y))]
    got = K2.rbf_mmd_sums(tt(X), tt(Y))  # CPU tensors: the plain version
    assert got.dtype == torch.float64 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_max_mean_disc_fused_matches_pallas():
    X, Y = _draw(300, 2, 2, 3.0), _draw(300, 2, 3, 3.5)
    ref = float(j_mmd_pallas(jnp.asarray(X), jnp.asarray(Y)))
    # MMD^2 is a small difference of O(1) means: 1e-5 of those, absolute
    np.testing.assert_allclose(float(K2.max_mean_disc_fused(tt(X), tt(Y))), ref,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------- the schedule --


@pytest.mark.parametrize("sums,n_blocks", [
    (((0, 16, 16, True),), 264),     # T=1024: one tile pair a block
    (((0, 200, 200, True),), 264),   # T=12800: runs of tens of tiles
    (((2, 5, 9, False),), 7),
    (((0, 3, 3, True), (1, 7, 7, True), (2, 3, 7, False)), 10),  # an MMD
    (((0, 1, 1, True),), 264),
])
def test_tile_schedule_visits_every_tile_pair_once(sums, n_blocks):
    items, ends = K2.tile_schedule(sums, n_blocks)
    total = sum(n_i * (n_i + 1) // 2 if sym else n_i * n_j for _, n_i, n_j, sym in sums)
    longest = max(1, math.ceil(total / n_blocks))
    start = 0
    for which, n_i, n_j, sym in sums:
        mine = items[start:ends[which]]
        start = ends[which]
        weight = np.zeros((n_i, n_j))
        for i, first, count, w in mine:
            assert w == which and 1 <= count <= longest
            for j in range(first, first + count):
                assert weight[i, j] == 0  # no tile twice
                weight[i, j] = 2 if sym and j > i else 1
        if sym:  # every unordered pair once: the upper triangle, doubled off the diagonal
            np.testing.assert_array_equal(weight, np.triu(np.full((n_i, n_j), 2.0)) - np.eye(n_i))
        else:
            np.testing.assert_array_equal(weight, np.ones((n_i, n_j)))
        assert weight.sum() == n_i * n_j  # the weights add up to all ordered tile pairs
    assert start == len(items) == ends[2]
    assert len(items) <= n_blocks + sum(n_i for _, n_i, _, _ in sums)


# ------------------------------------------- the kernels' arithmetic --


def _thread_sums(term):
    """A (64, 64) tile of fp32 terms as the kernels add it: each thread its
    4x4 pairs in fp32 (rows ty + 16 u, columns tx + 16 v), then fp64."""
    per_thread = term.view(4, 16, 4, 16).sum(dim=(0, 2), dtype=torch.float32)
    return per_thread.sum(dtype=torch.float64)


def _imq(r, cross, ss, b, d):
    base = 1.0 + r
    if b == 0.5:
        p = torch.rsqrt(base)  # the kernel: rsqrt.approx and one Newton step
        q = p * p
    else:
        p = torch.exp2(-b * torch.log2(base))
        q = 1.0 / base
    c1, c2 = np.float32(-4.0 * b * (b + 1.0)), np.float32(2.0 * b)
    return p * (ss + q * (c2 * (d + cross) + c1 * r * q))


def _pad_rows(V, rows):
    return torch.cat([V, torch.zeros((rows - V.shape[0], V.shape[1]))])


def _split_tf32(v):
    """hi rounded to TF32 (10 mantissa bits) and lo = v - hi cut to it, as
    the tensor core reads common.cuh's split_tf32_open."""
    def bits(w):
        return w.contiguous().view(torch.int32)
    hi = ((bits(v) + 0x1000) & -0x2000).view(torch.float32)
    return hi, (bits(v - hi) & -0x2000).view(torch.float32)


def _dot_3xtf32(A, B):
    (ah, al), (bh, bl) = _split_tf32(A), _split_tf32(B)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def emulate_stein(X, S, b, route, n_blocks=5):
    T, d = X.shape
    n = math.ceil(T / TILE)
    items, _ = K2.tile_schedule(((0, n, n, True),), n_blocks)
    if route == "gram":
        X = X - X.mean(0, dtype=torch.float32)
    Xp, Sp = _pad_rows(X, n * TILE), _pad_rows(S, n * TILE)
    sq, sxx, Up = torch.sum(Xp * Xp, -1), torch.sum(Sp * Xp, -1), Xp + Sp
    valid = torch.arange(n * TILE) < T
    total = torch.zeros((), dtype=torch.float64)
    for i, first, count, _ in items:
        si = slice(i * TILE, (i + 1) * TILE)
        acc = torch.zeros((), dtype=torch.float64)  # the block's partial
        for j in range(first, first + count):
            sj = slice(j * TILE, (j + 1) * TILE)
            if route == "diff":
                dx = Xp[si, None, :] - Xp[None, sj, :]
                ds = Sp[si, None, :] - Sp[None, sj, :]
                r, cross = torch.sum(dx * dx, -1), torch.sum(ds * dx, -1)
                ss = Sp[si] @ Sp[sj].T
            else:
                gxx, ss = _dot_3xtf32(Xp[si], Xp[sj]), _dot_3xtf32(Sp[si], Sp[sj])
                guu = _dot_3xtf32(Up[si], Up[sj])
                r = torch.clamp(sq[si, None] + sq[None, sj] - 2.0 * gxx, min=0.0)
                cross = sxx[si, None] + sxx[None, sj] - (guu - gxx - ss)
                if i == j:  # a point with itself: r and cross are 0, not rounding noise
                    r.fill_diagonal_(0.0)
                    cross.fill_diagonal_(0.0)
            term = _imq(r, cross, ss, b, float(d))
            term = torch.where(valid[si, None] & valid[None, sj], term, torch.zeros(()))
            acc = acc + (2.0 if j > i else 1.0) * _thread_sums(term)
        total = total + acc
    return total


@pytest.mark.parametrize("T,d,route,beta", [
    (130, 2, "diff", -0.5),
    (97, 64, "diff", -0.5),
    (70, 300, "diff", -0.5),
    (70, 300, "gram", -0.5),
    (130, 2, "diff", -0.3),   # the general-b form
    (70, 300, "gram", -0.3),
    (97, 64, "gram", -0.5),
    (130, 20, "gram", -0.5),  # below the route threshold the form still holds
])
def test_stein_kernel_arithmetic_matches_float64(T, d, route, beta):
    # points away from the origin (the Gram form's cancellation) and a
    # score with a part that is not a function of x - mean
    X = tt(_draw(T, d, T + d, 1.5, shift=3.0))
    S = -X / 2.0 + 0.3 * tt(_draw(T, d, T + d + 1, 1.0))
    ref = K2.stein_pairwise_sum_plain(X.double(), S.double(), beta)
    got = emulate_stein(X, S, -beta, route)
    assert got.dtype == torch.float64
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))


def _two_modes(T, d, offset, seed):
    """Two unit Gaussians at +-offset in every coordinate, and their score."""
    rng = np.random.default_rng(seed)
    centre = np.where(rng.random((T, 1)) < 0.5, -1.0, 1.0) * offset
    X = tt((centre + rng.standard_normal((T, d))).astype(np.float32))
    return X, -(X - tt(centre.astype(np.float32)))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("offset", [1, 8, 16, 32])
def test_stein_route_by_the_data_keeps_the_sum_within_1e5(d, offset):
    X, S = _two_modes(320, d, float(offset), 7 * d + offset)
    ref = float(K2.stein_pairwise_sum_plain(X.double(), S.double(), -0.5))
    route = K2.pick_stein_route(X)
    got = float(emulate_stein(X, S, 0.5, route))
    assert abs(got - ref) <= 1e-5 * abs(ref), (route, got, ref)
    # near modes keep the tensor cores, far ones leave them
    assert route == ("gram" if offset == 1 else "diff")
    Xc = X - X.mean(0)
    est = float(K2.gram_error_estimate(Xc, torch.sum(Xc * Xc, -1)))
    gram_err = abs(float(emulate_stein(X, S, 0.5, "gram")) - ref) / abs(ref)
    assert gram_err <= est, "the estimate bounds the Gram route's error here"
    if offset == 32:  # the case the bound exists for: the Gram route alone fails
        assert gram_err > 1e-5


def test_stein_route_edge_cases():
    X, _ = _two_modes(200, 16, 32.0, 1)
    assert K2.pick_stein_route(X) == "diff"  # below GRAM_MIN_D: never the Gram form
    wide = tt(_draw(200, 1600, 2, 1.0))
    assert K2.pick_stein_route(wide) == "gram"  # a unit Gaussian at pines' width
    twice = torch.cat([wide[:100], wide[:100]])  # repeated points, as an IS-resampled set has
    Xc = twice - twice.mean(0)
    est = float(K2.gram_error_estimate(Xc, torch.sum(Xc * Xc, -1)))
    assert est > K2.GRAM_ERROR_BUDGET and K2.pick_stein_route(twice) == "diff"
    near = tt(_draw(70, 64, 3, 0.5))
    assert K2.pick_stein_route(near) == "gram"
    # on the CPU the wrapper is the plain version whatever the route
    S = -near
    assert float(K2.stein_pairwise_sum(near, S)) == float(K2.stein_pairwise_sum_plain(near, S))


def emulate_rbf_sums(X, Y, sigma2, n_blocks=5):
    """The three sums of one fused launch, on its schedule."""
    sets = {0: (X, X), 1: (Y, Y), 2: (X, Y)}
    nx, ny = math.ceil(X.shape[0] / TILE), math.ceil(Y.shape[0] / TILE)
    sums = ((0, nx, nx, True), (1, ny, ny, True), (2, nx, ny, False))
    items, ends = K2.tile_schedule(sums, n_blocks)
    scale = np.float32(math.sqrt(0.5 / sigma2 * math.log2(math.e)))
    partials = []
    for i, first, count, which in items:
        A, B = sets[which]
        Ap, Bp = _pad_rows(A * scale, nx * TILE + ny * TILE), _pad_rows(B * scale, nx * TILE + ny * TILE)
        va, vb = torch.arange(Ap.shape[0]) < A.shape[0], torch.arange(Bp.shape[0]) < B.shape[0]
        si = slice(i * TILE, (i + 1) * TILE)
        acc = torch.zeros((), dtype=torch.float64)
        for j in range(first, first + count):
            sj = slice(j * TILE, (j + 1) * TILE)
            diff = Ap[si, None, :] - Bp[None, sj, :]
            term = torch.exp2(-torch.sum(diff * diff, -1))
            term = torch.where(va[si, None] & vb[None, sj], term, torch.zeros(()))
            acc = acc + (2.0 if which != 2 and j > i else 1.0) * _thread_sums(term)
        partials.append(acc)
    bounds = (0,) + ends
    return torch.stack([torch.stack(partials[bounds[k]:bounds[k + 1]]).sum() for k in range(3)])


@pytest.mark.parametrize("Tx,Ty,d,sigma2", [(130, 97, 2, 1.0), (70, 200, 5, 2.5)])
def test_rbf_kernel_arithmetic_matches_float64(Tx, Ty, d, sigma2):
    X, Y = tt(_draw(Tx, d, 5, 1.5)), tt(_draw(Ty, d, 6, 1.5, shift=0.3))
    ref = K2.rbf_mmd_sums_plain(X.double(), Y.double(), sigma2)
    got = emulate_rbf_sums(X, Y, sigma2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5)


# ------------------------------------------- the helpers of drivers/eval.py --


@pytest.mark.parametrize("fused", [None, True])
def test_check_floor_matches(fused):
    jtarget, ptarget = jt.four_mode_mixture(), pt.four_mode_mixture()
    real = _draw(256, 2, 20, 7.0)
    ref = j_eval.check_floor(jtarget, jnp.asarray(real))
    got = check_floor(ptarget, tt(real), fused_metrics=fused)
    assert list(got) == list(ref)
    for k, v in ref.items():
        # mmd_real is 0 up to the rounding of O(1) means
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("with_mmd", [True, False])
def test_report_row_matches(with_mmd):
    cfg = SimpleNamespace(mcmc_per_flow_steps=10, learning_iter=500)
    rng = np.random.default_rng(21)
    keys = ("logpdf", "logpdf_star", "stein_u", "stein_u_star", "stein_v", "stein_v_star",
            "mmd", "mmd_star")
    metrics = {k: float(rng.standard_normal()) for k in keys}
    if not with_mmd:
        metrics["mmd"] = None
    assert report_row(cfg, metrics, 12.5) == j_eval.report_row(cfg, metrics, 12.5)
    assert len(report_row(cfg, metrics, 12.5)) == (11 if with_mmd else 9)


def test_aggregate_seeds_matches():
    rows = np.random.default_rng(22).standard_normal((5, 11)).tolist()
    ref, got = j_eval.aggregate_seeds(rows), aggregate_seeds(rows)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12)
