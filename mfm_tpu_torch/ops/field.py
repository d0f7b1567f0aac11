"""K1: the fused vector-field apply, its packing and its plain version.

Replaces ``mfm_tpu/ops/field_pallas.py::_pallas_apply`` (the Pallas kernel
body ``_forward``). ``field_apply(packed, layout, act, freqs, x, t, ex)``
returns ``(field, gate)`` of the ``VectorFieldNet`` MLP, and with ``ex`` of
shape (K, B, d) also ``dfield`` (K, B, d), the K x-tangents pushed through
the same weights. The score gate is added by the caller.

On a CPU tensor the wrapper runs ``field_apply_plain``; on a CUDA tensor it
launches ``csrc/field.cu`` or raises. The kernel is forward only: it raises
on inputs that require grad (training differentiates the ``nn.Module``).

The kernel streams the weights in tiles of ``TILE_ROWS`` rows in the order
it consumes them; ``weight_tiles`` builds that schedule and ``kernel_meta``
the struct that carries it, once per (layout, activation).
``field_flops`` and ``field_bytes`` count one call's work, which the
wrapper reports to an open roofline count (``diagnostics.roofline``).

The seed axis (the reference's ``pallas_call`` under ``jax.vmap`` of a seed
sweep): ``packed`` (S, P) and ``freqs`` (S, F) hold S nets of one layout,
and the rows are seed-major, x (S B, d), t (S B,), ex (K, S B, d), seed s
owning rows s B ... s B + B - 1. One launch covers every seed; the plain
version is ``field_apply_plain`` applied seed by seed.
"""

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from mfm_tpu_torch.diagnostics import roofline
from mfm_tpu_torch.ops import build

ACTIVATIONS = ("relu", "tanh")
MAX_WIDTH = 128  # output columns per layer a block covers (16 mma tiles of 8)
MAX_FOURIER = 128
MAX_LAYERS = 16
TILE_ROWS = 64  # weight rows per streamed tile: kKS of csrc/field.cu
MAX_TILES = 144  # primal tiles + one chunk's tiles: kMaxTiles


class FieldLayout(NamedTuple):
    """Where each layer of the packed buffer lives. Layer order: t-trunk,
    x-trunk, xt-trunk (the joint first layer is xt[0]), gate, field; each
    matrix (in, out) row-major, as ``field_pallas.split_params`` orders
    them. The joint first layer's x-half starts at its ``w_off``, its
    t-half (``ht`` rows) at ``wt_off``."""

    n_t: int
    n_x: int
    n_xt: int
    F: int
    d: int
    wt_off: int
    ht: int
    max_w: int
    max_t: int
    w_off: Tuple[int, ...]
    b_off: Tuple[int, ...]
    k_in: Tuple[int, ...]
    n_out: Tuple[int, ...]
    size: int


def _layer_names(params: dict, trunk: str):
    n = 0
    while f"{trunk}.{n}.weight" in params:
        n += 1
    return [f"{trunk}.{i}" for i in range(n)]


def _ordered_layers(params: dict):
    return (
        _layer_names(params, "t_trunk"),
        _layer_names(params, "x_trunk"),
        _layer_names(params, "xt_trunk"),
    )


def field_layout(params: dict, n_fourier: int) -> FieldLayout:
    """The packed layout of a ``VectorFieldNet`` parameter dict."""
    t_names, x_names, xt_names = _ordered_layers(params)
    if not xt_names:
        raise ValueError("the fused field needs at least one joint-trunk layer")
    names = t_names + x_names + xt_names + ["gate_head", "field_head"]
    w_off, b_off, k_in, n_out = [], [], [], []
    off = 0
    for name in names:
        out_f, in_f = params[f"{name}.weight"].shape
        w_off.append(off)
        off += in_f * out_f
        b_off.append(off)
        off += out_f
        k_in.append(in_f)
        n_out.append(out_f)
    d = n_out[-1]
    ht = n_out[len(t_names) - 1] if t_names else 2 * n_fourier
    joint = len(t_names) + len(x_names)
    hx = k_in[joint] - ht
    k_in[joint] = hx  # the x-half; the t-half is a second product
    return FieldLayout(
        n_t=len(t_names), n_x=len(x_names), n_xt=len(xt_names), F=n_fourier, d=d,
        wt_off=w_off[joint] + hx * n_out[joint], ht=ht,
        max_w=max([d] + n_out[len(t_names):joint + len(xt_names)]),
        max_t=max([2 * n_fourier] + n_out[: len(t_names)]),
        w_off=tuple(w_off), b_off=tuple(b_off), k_in=tuple(k_in),
        n_out=tuple(n_out), size=off,
    )


def pack_field_params(params: dict, layout: FieldLayout) -> torch.Tensor:
    """One contiguous fp32 buffer: per layer W^T (in, out) then the bias;
    (S, P), one row a seed, for parameters stacked on a leading seed axis."""
    t_names, x_names, xt_names = _ordered_layers(params)
    lead = params["field_head.bias"].shape[:-1]  # () or (S,)
    parts = []
    for name in t_names + x_names + xt_names + ["gate_head", "field_head"]:
        parts.append(params[f"{name}.weight"].detach().transpose(-1, -2).reshape(lead + (-1,)))
        parts.append(params[f"{name}.bias"].detach().reshape(lead + (-1,)))
    packed = torch.cat(parts, dim=-1).to(torch.float32).contiguous()
    assert packed.shape[-1] == layout.size
    return packed


_ACT_FNS = {
    "relu": (torch.relu, lambda z: (z > 0.0).to(z.dtype)),
    "tanh": (torch.tanh, lambda z: 1.0 - torch.tanh(z) ** 2),
}


def field_apply_plain(packed, layout: FieldLayout, act: str, freqs, x, t, ex=None):
    """Plain PyTorch version of the kernel, with the same split-weight
    algebra as ``field_pallas._reference_apply``; the K tangents ride a
    leading batch axis of the same products. With a seed axis (``packed``
    (S, P)), the single-seed version on each seed's rows."""
    if packed.ndim == 2:
        S = packed.shape[0]
        B = x.shape[0] // S
        outs = [
            field_apply_plain(packed[s], layout, act, freqs[s], x[s * B:(s + 1) * B],
                              t[s * B:(s + 1) * B],
                              None if ex is None else ex[:, s * B:(s + 1) * B])
            for s in range(S)
        ]
        return tuple(torch.cat(parts, dim=-2) for parts in zip(*outs))
    a, da = _ACT_FNS[act]

    def weight(l, k_in=None, off=None):
        k = layout.k_in[l] if k_in is None else k_in
        o = layout.w_off[l] if off is None else off
        return packed[o : o + k * layout.n_out[l]].view(k, layout.n_out[l])

    def bias(l):
        return packed[layout.b_off[l] : layout.b_off[l] + layout.n_out[l]]

    L = 0
    ang = (2.0 * math.pi) * t[:, None] * freqs[None, :]
    if layout.n_t:
        w0 = weight(0)
        h_t = a(torch.cos(ang) @ w0[: layout.F] + torch.sin(ang) @ w0[layout.F :] + bias(0))
        for L in range(1, layout.n_t):
            h_t = a(h_t @ weight(L) + bias(L))
        L = layout.n_t
    else:
        h_t = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    h, dh = x, ex
    for i in range(layout.n_x + layout.n_xt):
        w = weight(L)
        z = h @ w + bias(L)
        if i == layout.n_x:  # joint first layer: the t-half
            z = z + h_t @ weight(L, k_in=layout.ht, off=layout.wt_off)
        if dh is not None:
            dh = da(z) * (dh @ w)
        h = a(z)
        L += 1
    gate = h_t @ weight(L) + bias(L)
    wf = weight(L + 1)
    field = h @ wf + bias(L + 1)
    if ex is None:
        return field, gate
    return field, gate, dh @ wf


def _matrix_tiles(off: int, k: int, n: int) -> List[Tuple[int, int, int]]:
    """(offset, rows, n) of each TILE_ROWS-row slice of a (k, n) matrix."""
    return [(off + k0 * n, min(TILE_ROWS, k - k0), n) for k0 in range(0, k, TILE_ROWS)]


def weight_tiles(layout: FieldLayout):
    """The kernel's weight schedule: (primal tiles, tiles of one tangent
    chunk), in the order ``field_kernel`` multiplies the matrices -- the
    t-trunk, the gate head, the x-trunk, the joint trunk (its first layer's
    x-half, then its t-half), the field head; then, for every chunk of
    tangents, the x-trunk, the joint trunk (x-halves only) and the field
    head."""
    L = layout
    mat = lambda l, n=None: _matrix_tiles(L.w_off[l], L.k_in[l], L.n_out[l] if n is None else n)
    n_h = L.n_x + L.n_xt
    gate, head = L.n_t + n_h, L.n_t + n_h + 1
    primal = [tile for l in range(L.n_t) for tile in mat(l)] + mat(gate, L.d)
    chunk = []
    for h in range(n_h):
        l = L.n_t + h
        primal += mat(l)
        if h == L.n_x:
            primal += _matrix_tiles(L.wt_off, L.ht, L.n_out[l])
        chunk += mat(l)
    primal += mat(head, L.d)
    chunk += mat(head, L.d)
    return primal, chunk


def check_fits(layout: FieldLayout) -> None:
    """Raise if the field is wider than the kernel takes."""
    n_layers = layout.n_t + layout.n_x + layout.n_xt + 2
    if n_layers > MAX_LAYERS:
        raise ValueError(f"fused field takes at most {MAX_LAYERS} layers, got {n_layers}")
    if max(layout.n_out) > MAX_WIDTH or layout.F > MAX_FOURIER:
        raise ValueError(
            f"fused field takes widths and d <= {MAX_WIDTH} and at most "
            f"{MAX_FOURIER} Fourier features; got widths {layout.n_out}, "
            f"F={layout.F}"
        )
    n_tiles = sum(map(len, weight_tiles(layout)))
    if n_tiles > MAX_TILES:
        raise ValueError(f"fused field streams at most {MAX_TILES} weight tiles, got {n_tiles}")


def _stride(width: int, pad: int) -> int:
    """A shared-memory row stride >= width whose fragment loads hit 32
    distinct banks: a multiple of 32 plus ``pad`` (4 for activations, read
    8 rows x 4 columns; 8 for weights, read 4 rows x 8 columns)."""
    return -(-width // 32) * 32 + pad


@functools.lru_cache(maxsize=None)
def kernel_meta(layout: FieldLayout, act: str):
    """The ``FieldMeta`` struct of csrc/field.cu as a C int array, built
    once per (layout, activation)."""
    check_fits(layout)
    primal, chunk = weight_tiles(layout)
    pad = lambda v, n: list(v) + [0] * (n - len(v))
    tiles = primal + chunk + [(0, 0, 0)] * (MAX_TILES - len(primal) - len(chunk))
    ints = [layout.n_t, layout.n_x, layout.n_xt, layout.F, layout.d, ACTIVATIONS.index(act),
            layout.wt_off, layout.ht, _stride(layout.max_w, 4), _stride(layout.max_t, 4),
            _stride(max(layout.n_out), 8), len(primal), len(chunk)]
    for v in (layout.w_off, layout.b_off, layout.k_in, layout.n_out):
        ints += pad(v, MAX_LAYERS)
    for i in range(3):
        ints += [tile[i] for tile in tiles]
    return (ctypes.c_int * len(ints))(*ints)


def field_flops(layout: FieldLayout, B: int, K: int) -> int:
    """Floating-point operations of one call (2 per multiply-add of the
    products; biases, activations and Fourier features not counted): the
    primal through every layer, and each of the K tangents through the
    x-trunk, the joint trunk's x-halves and the field head."""
    n_h = layout.n_x + layout.n_xt
    joint = layout.n_t + layout.n_x
    macs = [k * n for k, n in zip(layout.k_in, layout.n_out)]
    primal = sum(macs) + layout.ht * layout.n_out[joint]
    tangent = sum(macs[layout.n_t : layout.n_t + n_h]) + macs[-1]
    return 2 * B * (primal + K * tangent)


def field_bytes(layout: FieldLayout, B: int, K: int, S: int = 1) -> int:
    """Bytes one call must move: x, t, the frequencies, the packed weights
    and ex read once; field, gate and dfield written once (fp32). ``B``
    rows a seed, ``S`` seeds (each with its own weights and frequencies)."""
    d = layout.d
    per_seed = B * d + B + layout.F + layout.size + K * B * d + 2 * B * d + K * B * d
    return 4 * S * per_seed


def field_apply(
    packed: torch.Tensor,
    layout: FieldLayout,
    act: str,
    freqs: torch.Tensor,
    x: torch.Tensor,
    t: torch.Tensor,
    ex: Optional[torch.Tensor] = None,
):
    """(field, gate[, dfield]) for x (B, d), t (B,), ex (K, B, d); with a
    seed axis, ``packed`` (S, P), ``freqs`` (S, F) and seed-major rows x
    (S B, d), t (S B,), ex (K, S B, d)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"fused field supports activations {ACTIVATIONS}, got {act!r}")
    S = packed.shape[0] if packed.ndim == 2 else 1
    if packed.ndim not in (1, 2) or freqs.shape != packed.shape[:-1] + (layout.F,) or (
        x.shape[0] % S
    ):
        raise ValueError("field_apply: packed (P,) or (S, P), freqs (F,) or (S, F), and "
                         "S B rows")
    if x.device.type == "cpu":
        return field_apply_plain(packed, layout, act, freqs, x, t, ex)
    if x.device.type != "cuda":
        raise ValueError(f"field_apply: unsupported device {x.device}")
    meta = kernel_meta(layout, act)  # raises if the kernel cannot take the field
    rows, d = x.shape
    B = rows // S
    K = 0 if ex is None else ex.shape[0]
    tensors = {"packed": packed, "freqs": freqs, "x": x, "t": t}
    if ex is not None:
        tensors["ex"] = ex
    for name, v in tensors.items():
        if v.device != x.device or v.dtype != torch.float32 or not v.is_contiguous():
            raise ValueError(f"field_apply: {name} must be contiguous float32 on {x.device}")
        if v.requires_grad:
            raise ValueError(f"field_apply: {name} requires grad; the kernel is forward only")
    if B == 0 or d != layout.d or t.shape != (rows,) or (
        ex is not None and ex.shape[1:] != (rows, d)
    ) or packed.shape[-1] != layout.size:
        raise ValueError("field_apply: shapes do not match the layout")
    field = torch.empty_like(x)
    gate = torch.empty_like(x)
    dfield = torch.empty((K, rows, d), device=x.device) if K else None
    lib = build.load_library()
    err = lib.mfm_field_apply(
        packed.data_ptr(), ctypes.addressof(meta),
        freqs.data_ptr(), x.data_ptr(), t.data_ptr(),
        ex.data_ptr() if K else None, field.data_ptr(), gate.data_ptr(),
        dfield.data_ptr() if K else None, B, K, S, layout.size,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "field_apply")
    field_apply.launches += 1
    if roofline.counter is not None:
        roofline.counter.add_kernel("field_apply", field_flops(layout, rows, K),
                                    field_bytes(layout, B, K, S))
    return (field, gate) if ex is None else (field, gate, dfield)


field_apply.launches = 0
