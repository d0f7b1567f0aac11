"""The benchmark's shared machinery: a cell's files found by name, the
set-up clock, the timed window's records, the reduction of a profiler
trace, the per-layer readers, the comparison against limits and the result
line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the configuration as run;
- ``traffic/<traffic>.json``: the mix, whose ``kind`` names the generator
  ``kinds/<kind>.py`` that reads it;
- ``limits/<cell>.json``: the limit of each number that decides ``correct``;
- ``counts/<config>.py``: the operations and bytes of its work;
- ``metrics/<metric>.py``: a per-layer metric's reader;
- ``parked/<cell>.json``: the ``BENCHMARK.json`` entries of a cell that was
  measured and left out of it, found by name where ``BENCHMARK.json`` has
  none of that name (so that its entries can be moved back unchanged).
"""

import bisect
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parent  # cardbench/
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mfm_tpu")  # whole top-level module names


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    kind: object  # kinds/<kind>.py
    counts: object  # counts/<config>.py
    limits: dict  # limits/<cell>.json: number -> limit
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def with_parked(bench: dict) -> dict:
    """``bench`` with the entries of the parked cells that it lacks."""
    out = dict(bench)
    for path in sorted((ROOT / "parked").glob("*.json")):
        for key, entries in read_json(path).items():
            have = {e["name"] for e in out.get(key, [])}
            out[key] = out.get(key, []) + [e for e in entries if e["name"] not in have]
    return out


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = with_parked(read_json(CHECKOUT / "BENCHMARK.json") if bench is None else bench)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = read_json(ROOT / "traffic" / f"{w['traffic']}.json")
    kind = load_module(ROOT / "kinds" / f"{traffic['kind']}.py", f"cardbench_kind_{traffic['kind']}")
    counts = load_module(ROOT / "counts" / f"{w['config']}.py", f"cardbench_counts_{w['config']}")
    return Cell(
        name, w["chips"], read_json(CHECKOUT / conf["file"]), traffic, kind, counts,
        read_json(ROOT / "limits" / f"{name}.json"),
        [m for m in bench["end_to_end"] if _applies(m, name)],
        [m for m in bench["per_layer"] if _applies(m, name)],
    )


class Clock:
    """The set-up's parts on the host clock, from the process's start."""

    def __init__(self, start: float):
        self.start = self.last = start
        self.parts: Dict[str, float] = {}

    def part(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.start


class _HostEvent:
    """A CPU run's stand-in for a CUDA event (tests on the CPU only)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """The calls into each layer in a traced run's window: CUDA events
    around each (per span name, the sum of elapsed times and the count),
    and, while ``profiling``, the host's wall-clock interval of each, which
    the profiler's device timeline is read against. ``enabled`` False
    records nothing."""

    def __init__(self, torch, enabled: bool, cuda: bool = True):
        self.torch, self.enabled, self.pairs, self.host = torch, enabled, [], []
        self.profiling = False
        self.event = (lambda: torch.cuda.Event(enable_timing=True)) if cuda else _HostEvent

    def run(self, name: str, fn: Callable, *args):
        if not self.enabled:
            return fn(*args)
        if self.profiling:  # the profiled units are timed by the trace alone
            t0 = time.time_ns()
            out = fn(*args)
            self.host.append((t0, time.time_ns(), name))
            return out
        start, end = self.event(), self.event()
        start.record()
        out = fn(*args)
        end.record()
        self.pairs.append((name, start, end))
        return out

    def totals(self) -> Dict[str, list]:
        """name -> [total ms, count]; call after a synchronize."""
        out: Dict[str, list] = {}
        for name, start, end in self.pairs:
            acc = out.setdefault(name, [0.0, 0])
            acc[0] += start.elapsed_time(end)
            acc[1] += 1
        return out


def reduce_trace(prof, host: List[tuple], window_s: float) -> dict:
    """Device time by kernel name, launches, busy time and the idle gaps by
    the benchmark's span the host was in (``host``: wall-clock (start ns,
    end ns, name) of each call), from a ``torch.profiler`` trace of the
    device's activity."""
    device = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation())
    host = sorted(host)
    starts = [h[0] for h in host]

    def where(t):
        i = bisect.bisect_right(starts, t) - 1
        return host[i][2] if i >= 0 and t < host[i][1] else "outside_spans"

    by_name: Dict[str, list] = {}
    busy, cur_end, gaps = 0, None, {}
    kernels, queued = 0, 0
    for start, end, name in device:
        acc = by_name.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += (end - start) * 1e-9
        if "emcpy" not in name and "emset" not in name:
            kernels += 1
        if where(start) == "outside_spans":
            queued += end - start
        if cur_end is None or start > cur_end:
            if cur_end is not None:  # an idle gap [cur_end, start)
                g = gaps.setdefault(where(cur_end), [0, 0.0])
                g[0] += 1
                g[1] += (start - cur_end) * 1e-9
            busy += end - start
            cur_end = end
        elif end > cur_end:
            busy += end - cur_end
            cur_end = end
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": {k: v for k, v in by_name.items()},
        "launches": kernels,
        "busy_s": busy * 1e-9,
        # device time of operations that start while the host is in no
        # span: work queued by an earlier call (or clocks out of step)
        "outside_spans_s": queued * 1e-9,
        "window_s": window_s,
        "device_ops": [[k[:64], v[1]] for k, v in top[:10]],
        "idle_gaps": [[f"{k} ({v[0]} gaps)", v[1]]
                      for k, v in sorted(gaps.items(), key=lambda kv: -kv[1][1])[:10]],
    }


def peaks_for(device_name: Optional[str]):
    """The published peaks of this card (``peaks.json``), or None."""
    return read_json(ROOT / "peaks.json").get(device_name or "")


def read_per_layer(cell: Cell, record: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py",
                             "cardbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number within its limit; a number that is
    not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.nan)
        checks[name] = [value, limit]
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))

