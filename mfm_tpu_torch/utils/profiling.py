"""Profiling helpers (counterpart of ``mfm_tpu/utils/profiling.py``) and the
program's spans and counters.

**Spans and counters.** ``span(name)`` is a context manager and
``count(name, n=1)`` a counter; both record only while a ``torch.profiler``
is recording in the process (``torch.autograd.profiler``'s module flag).
Otherwise ``span`` returns one shared no-op object and ``count`` returns at
once, so a run that is not profiled pays one flag test a call. A span
records its name, its parent (the span open around it), its start and end
on ``time.time_ns()`` (the clock Kineto stamps the profiler's events with)
and, once CUDA is initialised in the process, a start/end pair of CUDA
events on the current stream. It launches no kernel and waits on nothing.
The records stay in memory: ``spans()``, ``counters()`` and ``summarize()``
read them, ``reset()`` clears them.

The program's spans (names fixed; ``PERF.md`` lists the reader of each):

- ``drivers/mfm.py`` ``step_fn``: ``step.flow`` (an iteration whose move is
  the flow kernel) or ``step.mcmc`` (every other), with the children
  ``move``, ``fm_grad`` (loss and gradient), ``adamw`` and ``temper`` (the
  check and the tempering step);
- ``flows/flow_mh.py``: ``flow.inverse`` and ``flow.forward`` (the
  transports), ``flow.target`` (value and score at the proposals) and
  ``flow.accept``;
- ``flows/cnf.py``, in each stage's field call: ``stage.field`` (the module
  field's tangent pass, or K1), ``stage.gate`` (the score gate with its
  copies) and ``stage.divergence`` (the exact divergence's diagonal gather
  and sum, or the probes' products); the RK4 combination is the
  transport's self time.

Counters: ``sync``, each host wait on a device value that ``step_fn`` or
``train_loop``'s chunk logging reaches (the tempering check, NUTS's tree
reads, the chunk means, a gloo collective's copy to the host); ``stages``,
the field evaluations of every fixed-grid ODE solve (``flows/ode.py``);
``field.tangent_pass``, the calls of the module field
(``flows/cnf.py::module_tangent_field``), one a stage where the exact basis
fits one chunk (d <= 64), none on K1.
``counters()`` adds the kernel wrappers' own ``.launches`` as read.

``trace`` profiles a block with ``torch.profiler`` (the device's activity
on a CUDA device, which the spans complement with the host's side; the
host's ops on the CPU) and writes a Chrome trace, which Perfetto or
``chrome://tracing`` opens, and ``spans.json`` (``summarize``); ``timed``
measures the steady-state wall clock of a callable, warm-up excluded, after
``torch.cuda.synchronize()``.
"""

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

OUTSIDE = "(outside spans)"  # spans.json's row for device work launched in no span
_LAUNCH_RECORD = "cu"  # the name prefix of the CUDA runtime and driver calls


class Span:
    """One recorded span: ``parent`` is the index in ``spans()`` of the span
    open around it (-1 for none), ``end_ns`` None while it is open,
    ``events`` its (start, end) CUDA events or None."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str, parent: int, start_ns: int, end_ns: Optional[int] = None,
                 events=None):
        self.name, self.parent, self.start_ns, self.end_ns = name, parent, start_ns, end_ns
        self.events = events


_SPANS: List[Span] = []
_OPEN: List[int] = []  # indices of the spans open now, innermost last
_COUNTERS: Dict[str, int] = {}


class _Off:
    """The shared span of a process that no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recording:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.record = Span(self.name, _OPEN[-1] if _OPEN else -1, time.time_ns(), None, events)
        _OPEN.append(len(_SPANS))
        _SPANS.append(self.record)
        if events is not None:
            events[0].record()
        return None

    def __exit__(self, *exc):
        rec = self.record
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.time_ns()
        if _OPEN and _SPANS[_OPEN[-1]] is rec:  # a reset() inside the span cleared it
            _OPEN.pop()
        return False


def span(name: str):
    """``with span("move"): ...`` records the block while a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def spans() -> List[Span]:
    """The spans recorded since the last ``reset()``, in the order they opened."""
    return list(_SPANS)


def _launch_counts() -> Dict[str, int]:
    from mfm_tpu_torch.ops.field import field_apply
    from mfm_tpu_torch.ops.pairwise import rbf_kernel_sum, stein_pairwise_sum
    from mfm_tpu_torch.ops.phi_four import phi_four_score_gate, phi_four_value_and_score

    return {f"launches.{f.__name__}": f.launches for f in (
        field_apply, stein_pairwise_sum, rbf_kernel_sum, phi_four_value_and_score,
        phi_four_score_gate)}


def counters() -> Dict[str, int]:
    """The counters since the last ``reset()``, and each kernel wrapper's
    ``.launches`` as it reads now (``launches.<wrapper>``)."""
    return {**_COUNTERS, **_launch_counts()}


def reset() -> None:
    """Forget every span and counter (not the wrappers' ``.launches``)."""
    _SPANS.clear()
    _OPEN.clear()
    _COUNTERS.clear()


def _paths(recs: List[Span]) -> List[str]:
    paths: List[str] = []
    for r in recs:  # a parent opens before its children
        paths.append(r.name if r.parent < 0 else f"{paths[r.parent]}/{r.name}")
    return paths


def _innermost(recs: List[Span], times: List[int]) -> List[int]:
    """For each time, the index of the innermost span whose [start, end)
    holds it, or -1."""
    marks = []
    for i, r in enumerate(recs):
        if r.end_ns is not None:
            marks += [(r.start_ns, 1, i), (r.end_ns, 0, i)]
    marks.sort()  # at one time, a span's end before a sibling's start
    out, cur, j = [-1] * len(times), -1, 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        while j < len(marks) and marks[j][0] <= times[q]:
            _, opens, i = marks[j]
            cur = i if opens else recs[i].parent
            j += 1
        out[q] = cur
    return out


def _row(device: bool) -> dict:
    row = {"count": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": None}
    if device:
        row.update(launched_ms=0.0, idle_ms=0.0, idle_gaps=0)
    return row


def summarize(prof=None, window_ns=None) -> dict:
    """The spans by path (``step.flow/move/flow.inverse/stage.field``): the
    count; host ms in all and self ms (duration less the children's); device
    ms from the spans' CUDA events (None without them); and the counters.

    Given ``prof`` (a stopped ``torch.profiler.profile`` over the spans) each
    path also gets ``launched_ms``, the device time of the operations it
    launched as the innermost span, and ``idle_ms`` / ``idle_gaps``, the
    device's idle gaps charged to it: a gap goes to the span that launched
    the operation ending it (the CUDA runtime call of the same correlation
    id), or, where the trace has no launch record, to the span the host was
    in when the gap ended; ``device`` gives the busy and idle time, the
    operations and kernels, and how many gaps each rule placed. Work
    launched in no span is the row ``OUTSIDE``. ``window_ns``, the host's
    (start, end) of the block, gives ``window_ms``."""
    recs = spans()
    paths = _paths(recs)
    child_ns = [0] * len(recs)
    for r in recs:
        if r.parent >= 0 and r.end_ns is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()  # the end events, before their elapsed times
    rows: Dict[str, dict] = {}
    for i, r in enumerate(recs):
        if r.end_ns is None:
            continue
        row = rows.setdefault(paths[i], _row(prof is not None))
        row["count"] += 1
        row["host_ms"] += (r.end_ns - r.start_ns) * 1e-6
        row["self_ms"] += (r.end_ns - r.start_ns - child_ns[i]) * 1e-6
        if r.events is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
    out = {"spans": rows, "counters": counters()}
    if window_ns is not None:
        out["window_ms"] = (window_ns[1] - window_ns[0]) * 1e-6
    if prof is not None:
        out["device"] = _device_split(prof, recs, paths, rows)
    return out


def _device_split(prof, recs, paths, rows) -> dict:
    events = list(prof.profiler.kineto_results.events())
    on_device = lambda e: str(e.device_type()).endswith("CUDA")
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(), e.name())
                 for e in events if on_device(e) and not e.is_user_annotation())
    launched_at = {e.correlation_id(): e.start_ns() for e in events
                   if not on_device(e) and e.name().startswith(_LAUNCH_RECORD)}
    owner = _innermost(recs, [launched_at.get(c, s) for s, _, c, _ in ops])
    busy, idle, cur_end, kernels = 0, 0, None, 0
    rule = {"launch": 0, "host": 0}
    for (start, end, corr, name), who in zip(ops, owner):
        row = rows.setdefault(paths[who] if who >= 0 else OUTSIDE, _row(True))
        row["launched_ms"] += (end - start) * 1e-6
        kernels += "emcpy" not in name and "emset" not in name
        if cur_end is None or start > cur_end:
            if cur_end is not None:  # an idle gap [cur_end, start)
                row["idle_ms"] += (start - cur_end) * 1e-6
                row["idle_gaps"] += 1
                idle += start - cur_end
                rule["launch" if corr in launched_at else "host"] += 1
            busy += end - start
            cur_end = end
        elif end > cur_end:
            busy += end - cur_end
            cur_end = end
    return {
        "busy_ms": busy * 1e-6,
        "idle_ms": idle * 1e-6,
        "operations": len(ops),
        "kernels": kernels,
        "gaps_placed_by": rule,
    }


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """``with trace("traces/run") as prof: step(...)`` writes
    ``log_dir/trace.json`` and ``log_dir/spans.json`` (``summarize`` of the
    block's spans, which ``trace`` resets first; its device split on a CUDA
    device only); ``prof.key_averages()`` sums the kernels (the host's ops
    on the CPU)."""
    cuda = torch.device(device).type == "cuda"
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        yield prof
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as fh:
        json.dump(summarize(prof if cuda else None, (t0, t1)), fh, indent=1)


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, repeats: int = 3, warmup: int = 1):
    """(mean seconds, last output) of ``fn(*args)`` over ``repeats`` calls
    after ``warmup`` calls."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync()
    start = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args)
    _sync()
    return (time.perf_counter() - start) / repeats, out
