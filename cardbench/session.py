"""One run of one cell: set-up, the timed window, the check, the result.

The window runs whole units of the cell's kind (``kinds/<kind>.py``: a
training cycle, an evaluation) until ``seconds`` have passed on the host
clock, and closes at the end of the unit in progress, after a
``torch.cuda.synchronize()``. A traced run records CUDA events around every
call of the window and profiles ``PROFILED`` whole units of it, from the
second on; the per-layer metrics timed by events or by the host clock leave
the profiled units out, and those read from the trace take them alone.
"""

import gc
import json
import time

import torch

from cardbench import harness

PROFILED = 2  # units under the profiler in a traced run


def _profile_warm(device):
    """Start and stop the profiler once on a small op, so that its own set-up
    (CUPTI) is paid before the window."""
    with torch.profiler.profile(activities=_activities(device)):
        torch.ones(8, device=device).sum()


def _activities(device):
    """The device's activity only: recording every host op would slow the
    host-paced parts of the profiled units several-fold."""
    cuda = torch.device(device).type == "cuda"
    return [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(kind, state, seconds, device, trace):
    """(units, seconds, spans, profile record) of the timed window."""
    spans = harness.Spans(torch, trace, torch.device(device).type == "cuda")
    prof, profiled, prof_s = None, 0, 0.0
    # set-up's objects out of the collector's reach: a collection in the
    # window then scans only what the window itself allocates
    gc.collect()
    gc.freeze()
    _sync(device)
    t0 = time.perf_counter()
    units, ends = 0, []
    while True:
        if trace and units == 1 and prof is None:
            _sync(device)
            prof = torch.profiler.profile(activities=_activities(device))
            prof.start()
            spans.profiling = True
            p0 = time.perf_counter()
        kind.unit(state, spans)
        units += 1
        ends.append(time.perf_counter())
        if prof is not None and not profiled and units == 1 + PROFILED:
            _sync(device)
            prof_s = time.perf_counter() - p0
            prof.stop()
            spans.profiling = False
            profiled = PROFILED
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    elapsed = time.perf_counter() - t0
    gc.unfreeze()
    took = sorted(b - a for a, b in zip([t0] + ends, ends))
    print(f"cardbench: unit seconds on the host clock: min {took[0]:.4f} median "
          f"{took[len(took) // 2]:.4f} max {took[-1]:.4f} of {len(took)}", flush=True)
    if prof is not None and not profiled:  # a window shorter than the profiled units
        prof_s = time.perf_counter() - p0
        prof.stop()
        spans.profiling = False
        profiled = units - 1
    return units, elapsed, spans, (prof, profiled, prof_s)


def run_cell(cell, seed, seconds, trace, device, start, overrides=None):
    """(result line, check lines) of one run; ``overrides`` replace entries
    of the configuration and the traffic (tests at small sizes)."""
    clock = harness.Clock(start)
    clock.part("import")
    state = cell.kind.setup(cell, seed, device, clock, overrides or {})
    if trace:
        _profile_warm(device)
        clock.part("profiler")
    setup_s = clock.total()
    units, elapsed, spans, (prof, profiled, prof_s) = window(cell.kind, state, seconds, device,
                                                             trace)
    summary = cell.kind.summarize(state, units, elapsed)
    print(f"cardbench: setup parts (s) {json.dumps(clock.parts)}", flush=True)
    print(f"cardbench: window {summary['window']}", flush=True)
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if torch.device(device).type == "cuda" else 0)}
    result = {"correct": False, "attempted": summary["attempted"], "failed": summary["failed"]}
    breakdown = None
    if trace:
        spans_ms = spans.totals()
        reduced = None
        if prof is not None:
            reduced = harness.reduce_trace(prof, spans.host, prof_s)
            print(f"cardbench: trace busy {reduced['busy_s']:.4f} s of {prof_s:.4f} s, "
                  f"{reduced['launches']} launches, device time starting outside the spans "
                  f"{reduced['outside_spans_s']:.4f} s", flush=True)
            dev["busy_s"], dev["window_s"] = reduced["busy_s"], reduced["window_s"]
            breakdown = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
            del prof
        record = {
            "cell": cell.name, "spans": spans_ms, "trace": reduced, "units": units - profiled,
            "profiled_units": profiled, "seconds": elapsed - prof_s, "window": summary["window"],
            "work": cell.counts.work(state.config, state.traffic),
            "peaks": harness.peaks_for(dev["kind"]),
        }
        metrics = harness.read_per_layer(cell, record)
    else:
        metrics = {m["name"]: {"value": summary["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    cell.kind.release(state)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    readings = cell.kind.check(state, cell.limits)
    correct, checks = harness.judge(readings, cell.limits)
    result["correct"] = bool(correct and summary["failed"] == 0)
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines = [f"check {name}: {value!r} (limit {limit!r})" for name, (value, limit) in
             checks.items()]
    lines.append(f"failed units: {summary['failed']} (limit 0); correct: {result['correct']}")
    return result, lines
