"""Roofline accounting: a measured time against the card's ceilings
(counterpart of ``mfm_tpu.diagnostics.roofline``).

- **Counts.** ``count(fn, *args)`` runs ``fn`` once under a
  ``TorchDispatchMode``. FLOPs are ``torch.utils.flop_counter``'s formulas
  for the aten ops it knows (matrix products, convolutions, attention);
  bytes are the logical operand and result traffic of every aten op that
  moves data (views and allocations move none). That is the convention of
  XLA's "bytes accessed": intermediates that a fused kernel would keep out
  of device memory are counted, so a bandwidth share is an upper bound.
  The port's own CUDA kernels launch through ctypes, which the mode cannot
  see: each wrapper reports its hand count (``add_kernel``) to the open
  counter, ``counter``; with none open that costs a launch one ``None``
  test. Every launch that runs is counted, a loop body as often as it
  runs (XLA's cost model counts a ``scan`` body once; the reference's
  ``loop_reps`` and ``lower_kwargs`` have no counterpart here).
- **Time** is the median of ``repeats`` calls after a warm one, each ended
  by ``torch.cuda.synchronize()`` on a CUDA device.
- **Ceilings** are data-sheet rates keyed by
  ``torch.cuda.get_device_name()`` (``CEILINGS``); the FLOP ceiling of a
  report is the dense bf16 tensor-core rate, the reference's choice of
  the matrix unit's bf16 peak, so fp32 work shows well below 100 %.
  On the CPU, and on a card not in the table, there is no ceiling to
  cite: ``device_peaks()`` is ``(None, None)``.
"""

import time
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# card -> ceilings (NVIDIA's H100 SXM data sheet, dense rates, at the
# card's 700 W limit): bf16 and TF32 on the tensor cores, fp32 outside
# them, HBM3 bytes/s
CEILINGS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4e12, "tf32": 495e12, "fp32": 67e12, "hbm": 3.35e12},
}
H100 = CEILINGS["NVIDIA H100 80GB HBM3"]


class RooflineReport(NamedTuple):
    name: str
    flops: float  # per call: aten ops by flop_counter, the kernels by their hand counts
    bytes_accessed: float  # per call, logical operand and result traffic (upper bound)
    seconds: float  # median wall-clock a call
    achieved_flops_per_sec: float
    achieved_bytes_per_sec: float
    pct_peak_flops: Optional[float]  # None without a ceiling (the CPU)
    pct_peak_bandwidth: Optional[float]
    bound: str  # 'compute' | 'memory', by the counts' arithmetic intensity

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._fields}


class KernelCount(NamedTuple):
    launches: int
    flops: float
    bytes: float


class CostCounter:
    """FLOPs and bytes of one call: the aten ops' and, by name, the
    kernels' (``kernels[name]``, a ``KernelCount``)."""

    def __init__(self):
        self.aten_flops = 0.0
        self.aten_bytes = 0.0
        self.kernels: Dict[str, KernelCount] = {}

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        n, f, b = self.kernels.get(name, KernelCount(0, 0.0, 0.0))
        self.kernels[name] = KernelCount(n + 1, f + flops, b + nbytes)

    @property
    def flops(self) -> float:
        return self.aten_flops + sum(k.flops for k in self.kernels.values())

    @property
    def bytes(self) -> float:
        return self.aten_bytes + sum(k.bytes for k in self.kernels.values())


# the open count's counter, which the kernels' wrappers report to
counter: Optional[CostCounter] = None

_METADATA = {
    torch.ops.aten.is_contiguous.default, torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default, torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default, torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default, torch.ops.prim.layout.default,
}
# allocations (a result that nothing has written yet) and a view that its
# schema does not mark as one
_NO_TRAFFIC = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.prim.device.default,
    torch.ops.aten._unsafe_view.default,
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _CountMode(TorchDispatchMode):
    def __init__(self, costs: CostCounter):
        super().__init__()
        self.costs = costs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry and func not in _NO_TRAFFIC:
            with self:  # count a composite op by its parts, as flop_counter does
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace != "aten" or func in _NO_TRAFFIC or func.is_view:
            return out  # a custom op's kernel reports itself
        if packet in flop_registry:
            self.costs.aten_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.costs.aten_bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def count(fn: Callable, *args):
    """``(fn(*args), CostCounter)`` of one call."""
    global counter
    if counter is not None:
        raise RuntimeError("roofline.count: a count is already open")
    costs = CostCounter()
    counter = costs
    try:
        with _CountMode(costs):
            out = fn(*args)
    finally:
        counter = None
    return out, costs


def _device(args) -> torch.device:
    tensors = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    return tensors[0].device if tensors else torch.device("cpu")


def device_peaks(device=None):
    """(peak FLOP/s (dense bf16 tensor cores), peak bytes/s) of ``device``
    (default: the current CUDA device where there is one), or (None, None)
    for the CPU and for a card not in ``CEILINGS``."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    c = CEILINGS.get(torch.cuda.get_device_name(device))
    return (c["bf16"], c["hbm"]) if c else (None, None)


def roofline(name: str, fn: Callable, *args, repeats: int = 3) -> RooflineReport:
    """Count ``fn(*args)`` once (``count``), time it as the median of
    ``repeats`` calls after a warm one, and set both against the ceilings
    of the device its tensors are on."""
    _, costs = count(fn, *args)
    device = _device(args)

    def call():
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    call()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    seconds = sorted(times)[len(times) // 2]
    flops, nbytes = costs.flops, costs.bytes
    peak_f, peak_b = device_peaks(device)
    ach_f, ach_b = flops / seconds, nbytes / seconds
    if peak_f and peak_b:
        bound = "compute" if flops / max(nbytes, 1.0) > peak_f / peak_b else "memory"
    else:
        bound = "memory" if nbytes > flops else "compute"
    return RooflineReport(
        name=name, flops=flops, bytes_accessed=nbytes, seconds=seconds,
        achieved_flops_per_sec=ach_f, achieved_bytes_per_sec=ach_b,
        pct_peak_flops=100.0 * ach_f / peak_f if peak_f else None,
        pct_peak_bandwidth=100.0 * ach_b / peak_b if peak_b else None,
        bound=bound,
    )
