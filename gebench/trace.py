"""The traced run: host spans from the benchmark's own wrappers, one
`torch.profiler` window over one whole run, and the reduction of its trace
to what the per-layer readers take.

The wrappers sit around the program's own calls, installed only for the
traced run: `telemetry.StageTimer.__call__` opens a
`torch.profiler.record_function` named after each stage (`mate`,
`reproduce/probe`, `compute_ad`, `migration`, ...), and `Simulation`'s
`__init__` (`load`), `init_generation0` (`generation0`) and
`write_summary` (`summary`) open their own. A per-layer reader that names a
callable in `WRAP` gets its launches recorded: its `work(*args)` reckons
each launch's (bytes, operations) from the arguments' shapes.

The busy and idle arithmetic is `chip_smoke.py`'s `profile_phase`: the
device is busy where a kernel, a copy or a set runs (the union of their
intervals), over the host clock's span of the run."""

from __future__ import annotations

import contextlib
import importlib
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUN_SPAN = "gebench.run"


class Wrappers:
    """Installs and removes the traced run's wrappers; records the stage
    timer the run used and each wrapped launch's work."""

    def __init__(self, readers: dict):
        self.readers = readers
        self.timer = None
        self.launches = {name: [] for name, r in readers.items()
                         if getattr(r, "WRAP", None)}
        self._undo = []

    def _patch(self, owner, attr, new) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def __enter__(self):
        import torch
        from geneevolve_tpu_torch.core import engine
        from geneevolve_tpu_torch.utils import telemetry

        rf = torch.profiler.record_function
        stage = telemetry.StageTimer.__call__
        me = self

        @contextlib.contextmanager
        def stage_span(timer, name):
            me.timer = timer
            with rf(name), stage(timer, name):
                yield

        self._patch(telemetry.StageTimer, "__call__", stage_span)
        for attr, span in (("__init__", "load"),
                           ("init_generation0", "generation0"),
                           ("write_summary", "summary")):
            self._patch(engine.Simulation, attr,
                        _spanned(getattr(engine.Simulation, attr), span, rf))
        for name, rows in self.launches.items():
            mod, attr = self.readers[name].WRAP
            owner = importlib.import_module(mod)
            self._patch(owner, attr, _recorded(
                getattr(owner, attr), self.readers[name].work, rows))
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo = []


def _spanned(fn, name, rf):
    def wrapper(*a, **k):
        with rf(name):
            return fn(*a, **k)
    return wrapper


def _recorded(fn, work, rows):
    def wrapper(*a, **k):
        rows.append(work(*a, **k))
        return fn(*a, **k)
    return wrapper


def profile(fn, trace_path: Path):
    """Run `fn()` under `torch.profiler` with CUDA activity inside a span
    named `RUN_SPAN`; returns the trace's events."""
    import torch
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(RUN_SPAN):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    trace_path.unlink()
    return events


def reduce(events: list) -> dict:
    """What the readers take from a trace: the device events, the run's
    span, the host spans, the device's busy seconds and the idle gaps
    inside the run, each labelled with the innermost host span around
    it."""
    dev = sorted(({"name": e["name"], "ts": float(e["ts"]),
                   "dur": float(e["dur"])} for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e),
                 key=lambda e: e["ts"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and "dur" in e]
    run = [s for s in spans if s[2] == RUN_SPAN]
    if not run:
        raise RuntimeError("the trace holds no span of the traced run")
    lo, hi = run[0][0], run[0][1]
    busy, gaps, end = 0.0, [], lo
    for e in dev:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    inner = [s for s in spans if s[2] != RUN_SPAN]

    def label(a, b):
        mid = 0.5 * (a + b)
        cover = [s for s in inner if s[0] <= mid <= s[1]]
        return min(cover, key=lambda s: s[1] - s[0])[2] if cover else "run"

    gaps.sort(key=lambda g: g[0] - g[1])
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    return dict(
        device_events=dev, window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
        idle_gaps=[[label(a, b), (b - a) / 1e6] for a, b in gaps[:10]],
        device_ops=sorted(([k, v] for k, v in by_name.items()),
                          key=lambda kv: -kv[1])[:10])
