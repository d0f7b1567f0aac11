"""K2a/K2b: the pairwise Stein and RBF sums, and their plain versions.

Replaces ``mfm_tpu/ops/pairwise_pallas.py::stein_pairwise_sum`` and
``::rbf_kernel_sum``. Each wrapper runs its plain PyTorch version for CPU
tensors and launches ``csrc/pairwise.cu`` for CUDA tensors (or raises).
The kernels work through a schedule of 64x64 tiles of pairs built here
(``tile_schedule``): a sum of a point set with itself visits only the
tiles with j >= i and counts the others twice. One launch gives a sum (or
the three sums of an MMD) as fp64, the same bits on every run; the Stein
sum at d >= ``GRAM_MIN_D`` takes the tensor cores, with a first launch
that centres X. The U/V and MMD^2 assembly stays here, as in
``pairwise_pallas.py:168-185``.
"""

import functools
import math
from typing import Optional

import torch

from mfm_tpu_torch.diagnostics.metrics import rbf_term, stein_term
from mfm_tpu_torch.ops import build

TILE = 64  # rows of a tile of pairs on each side: kTile in csrc/pairwise.cu
GRAM_COLS = 32  # the Gram route pads d to a multiple of it: kGK there
# The Stein sum takes the Gram form on the tensor cores from this d on, the
# differences form below it (the choice follows d alone). On an H100 at
# T = 12800 the two take the same time at d = 16 and the Gram form 0.6 of
# the other's at d = 32 (tools/pairwise_variants.py); its error against
# float64 grows as d falls (1e-6 at d = 32, 1e-5 at d = 8).
GRAM_MIN_D = 32
# Blocks of a launch for each SM: many short runs of tiles, so that the
# card's own block scheduler evens out the strips' unequal lengths.
BLOCKS_PER_SM = 16


def stein_pairwise_sum_plain(X, S, beta: float = -0.5, tile: int = 256):
    """sum over all (i, j), diagonal included, of the IMQ Stein term,
    row tile by row tile (terms in the inputs' type, fp64 sum)."""
    b = -beta
    sq, sxx = torch.sum(X * X, -1), torch.sum(S * X, -1)
    total = torch.zeros((), dtype=torch.float64, device=X.device)
    for i in range(0, X.shape[0], tile):
        sl = slice(i, i + tile)
        term = stein_term(X[sl], S[sl], sq[sl], sxx[sl], X, S, sq, sxx, b)
        total = total + term.sum(dtype=torch.float64)
    return total


def rbf_kernel_sum_plain(A, B, sigma2: float = 1.0, tile: int = 256):
    """sum_ij exp(-|a_i - b_j|^2 / (2 sigma2)), row tile by row tile."""
    sqb = torch.sum(B * B, -1)
    total = torch.zeros((), dtype=torch.float64, device=A.device)
    for i in range(0, A.shape[0], tile):
        ai = A[i : i + tile]
        term = rbf_term(ai, torch.sum(ai * ai, -1), B, sqb, sigma2)
        total = total + term.sum(dtype=torch.float64)
    return total


def rbf_mmd_sums_plain(X, Y, sigma2: float = 1.0):
    """The three RBF sums of an MMD, (X with X, Y with Y, X with Y), fp64 (3,)."""
    return torch.stack([
        rbf_kernel_sum_plain(X, X, sigma2),
        rbf_kernel_sum_plain(Y, Y, sigma2),
        rbf_kernel_sum_plain(X, Y, sigma2),
    ])


def tile_schedule(sums, n_blocks: int):
    """The kernels' work items, one per block, as rows
    (i-tile, first j-tile, j-tiles, sum), and the end of each sum's rows.

    ``sums`` lists (sum, i-tiles, j-tiles, symmetric) in rising order of
    ``sum`` (0, 1 or 2: the slot of the kernel's output). A symmetric sum
    pairs a point set with itself: its items hold only the tiles with
    j >= i, and the kernel counts a tile with j > i twice. Each strip of
    i-rows is cut into runs of consecutive j-tiles of nearly equal length,
    at most ceil(all tiles / n_blocks) tiles each."""
    total = sum(n_i * (n_i + 1) // 2 if sym else n_i * n_j for _, n_i, n_j, sym in sums)
    longest = max(1, math.ceil(total / n_blocks))
    items, ends = [], [0, 0, 0]
    for which, n_i, n_j, sym in sums:
        for i in range(n_i):
            first = i if sym else 0
            runs = math.ceil((n_j - first) / longest)
            base, extra = divmod(n_j - first, runs)
            for k in range(runs):
                count = base + (k < extra)
                items.append((i, first, count, which))
                first += count
        ends[which:] = [len(items)] * (3 - which)
    return items, tuple(ends)


@functools.lru_cache(maxsize=64)
def _device_schedule(sums, device):
    """``tile_schedule`` for ``BLOCKS_PER_SM`` blocks an SM of ``device``, as an
    int32 tensor there (kept: a schedule depends on the shapes alone)."""
    if build.load_library().mfm_pairwise_tile() != TILE:
        raise RuntimeError("ops/pairwise.py::TILE differs from kTile in csrc/pairwise.cu")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    items, ends = tile_schedule(sums, BLOCKS_PER_SM * n_sm)
    return torch.tensor(items, dtype=torch.int32).to(device), ends


@functools.lru_cache(maxsize=None)
def _ticket_counter(device, stream):
    """The integer the blocks of a launch draw their tickets from: zero
    between launches (the last block resets it), one per stream so that
    launches on two streams do not share it."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def _launch_state(sums, device):
    items, ends = _device_schedule(sums, device)
    stream = torch.cuda.current_stream(device).cuda_stream
    partials = torch.empty(items.shape[0], dtype=torch.float64, device=device)
    out = torch.empty(3, dtype=torch.float64, device=device)
    return items, ends, partials, _ticket_counter(device, stream), out, stream


def _check_inputs(name, *tensors):
    dev = tensors[0].device
    for v in tensors:
        if v.device != dev or v.dtype != torch.float32 or not v.is_contiguous() or v.ndim != 2:
            raise ValueError(f"{name}: inputs must be contiguous float32 (T, d) on {dev}")
        if v.requires_grad:
            raise ValueError(f"{name}: inputs require grad; the kernel is forward only")


def _tiles(n_rows: int) -> int:
    return math.ceil(n_rows / TILE)


def stein_pairwise_sum(X: torch.Tensor, S: torch.Tensor, beta: float = -0.5,
                       route: Optional[str] = None):
    """Total IMQ-Stein pairwise sum (diagonal included) as an fp64 scalar.

    ``route`` is for measurements: ``'diff'`` or ``'gram'`` instead of the
    route that d picks (``GRAM_MIN_D``)."""
    if X.device.type == "cpu":
        return stein_pairwise_sum_plain(X, S, beta)
    if X.device.type != "cuda":
        raise ValueError(f"stein_pairwise_sum: unsupported device {X.device}")
    _check_inputs("stein_pairwise_sum", X, S)
    if X.shape != S.shape:
        raise ValueError("stein_pairwise_sum: X and S differ in shape")
    T, d = X.shape
    if route is None:
        route = "gram" if d >= GRAM_MIN_D else "diff"
    if route not in ("diff", "gram"):
        raise ValueError(f"stein_pairwise_sum: unknown route {route!r}")
    lib = build.load_library()
    n = _tiles(T)
    items, _, partials, counter, out, stream = _launch_state(((0, n, n, True),), X.device)
    if route == "diff":
        err = lib.mfm_stein_sum(
            X.data_ptr(), S.data_ptr(), T, d, float(-beta), items.data_ptr(), items.shape[0],
            partials.data_ptr(), counter.data_ptr(), out.data_ptr(), stream,
        )
    else:
        Tp, dp = n * TILE, math.ceil(d / GRAM_COLS) * GRAM_COLS
        Xc, Sp = (torch.empty((Tp, dp), dtype=torch.float32, device=X.device) for _ in range(2))
        mean = torch.empty(d, dtype=torch.float32, device=X.device)
        sq, sxx = (torch.empty(Tp, dtype=torch.float32, device=X.device) for _ in range(2))
        err = lib.mfm_stein_gram_prepare(
            X.data_ptr(), S.data_ptr(), T, d, Tp, dp, mean.data_ptr(), Xc.data_ptr(),
            Sp.data_ptr(), sq.data_ptr(), sxx.data_ptr(), stream,
        ) or lib.mfm_stein_gram_sum(
            Xc.data_ptr(), Sp.data_ptr(), sq.data_ptr(), sxx.data_ptr(), T, d, dp, float(-beta),
            items.data_ptr(), items.shape[0], partials.data_ptr(), counter.data_ptr(),
            out.data_ptr(), stream,
        )
    build.check(err, "stein_pairwise_sum")
    stein_pairwise_sum.launches += 1
    return out[0]


def _rbf_launch(P0, P1, sums, sigma2):
    lib = build.load_library()
    items, ends, partials, counter, out, stream = _launch_state(sums, P0.device)
    build.check(
        lib.mfm_rbf_mmd_sums(
            P0.data_ptr(), P0.shape[0], P1.data_ptr(), P1.shape[0], P0.shape[1], 0.5 / sigma2,
            items.data_ptr(), items.shape[0], ends[0], ends[1], partials.data_ptr(),
            counter.data_ptr(), out.data_ptr(), stream,
        ),
        "rbf_kernel_sum",
    )
    rbf_kernel_sum.launches += 1
    return out


def _check_rbf(name, A, B):
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    _check_inputs(name, A, B)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"{name}: the two point sets differ in d")


def rbf_kernel_sum(A: torch.Tensor, B: torch.Tensor, sigma2: float = 1.0):
    """sum_ij exp(-|a_i - b_j|^2 / (2 sigma2)) as an fp64 scalar. When ``B``
    is ``A`` itself the kernel visits half the pairs."""
    if A.device.type == "cpu":
        return rbf_kernel_sum_plain(A, B, sigma2)
    _check_rbf("rbf_kernel_sum", A, B)
    na, nb = _tiles(A.shape[0]), _tiles(B.shape[0])
    if A.data_ptr() == B.data_ptr() and A.shape == B.shape:
        return _rbf_launch(A, A, ((0, na, na, True),), sigma2)[0]
    return _rbf_launch(A, B, ((2, na, nb, False),), sigma2)[2]


def rbf_mmd_sums(X: torch.Tensor, Y: torch.Tensor, sigma2: float = 1.0):
    """The three RBF sums of an MMD, (X with X, Y with Y, X with Y), as an
    fp64 (3,) tensor: one launch of K2b (counted on ``rbf_kernel_sum``)."""
    if X.device.type == "cpu":
        return rbf_mmd_sums_plain(X, Y, sigma2)
    _check_rbf("rbf_mmd_sums", X, Y)
    nx, ny = _tiles(X.shape[0]), _tiles(Y.shape[0])
    return _rbf_launch(X, Y, ((0, nx, nx, True), (1, ny, ny, True), (2, nx, ny, False)), sigma2)


stein_pairwise_sum.launches = 0
rbf_kernel_sum.launches = 0


def stein_disc_fused(X, score_fn, beta: float = -0.5):
    """(U, V) statistics from the pairwise sum minus the closed-form
    diagonal 2 b d + |s_i|^2."""
    T, d = X.shape
    S = score_fn(X).contiguous()
    total = stein_pairwise_sum(X.contiguous(), S, beta)
    diag = torch.sum(2.0 * (-beta) * d + torch.sum(S * S, -1), dtype=torch.float64)
    return (total - diag) / (T * (T - 1)), total / (T * T)


def max_mean_disc_fused(X, Y, sigma2: float = 1.0):
    """Unbiased MMD^2 from three RBF sums (diagonals removed from XX/YY)."""
    m = X.shape[0]
    xx, yy, xy = rbf_mmd_sums(X.contiguous(), Y.contiguous(), sigma2)
    m2 = m * m
    return (xx - m) / (m2 - m) - 2.0 * xy / m2 + (yy - Y.shape[0]) / (m2 - m)
