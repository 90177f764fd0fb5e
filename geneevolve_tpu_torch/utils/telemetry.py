"""Observability: memory reports, the run's spans and profiler traces
(counterpart of geneevolve_tpu/utils/telemetry.py).

`process_mem_usage` keeps the reference's VM/RSS report
(`Simulation.cpp:3440-3475`); device memory comes from `torch.cuda`.
`StageTimer` is the run's span recorder: each span adds its wall time to a
named total and, while a `torch.profiler` records, lands in the trace as a
`record_function` beside the device's events. `host_wait` is the one door
of every call inside a generation that makes the host wait for the card.
`device_fence` synchronizes the device so that a span closed after it is
device-true (`--stage_sync`). `profiler_trace` records a `torch.profiler`
trace (`--profile`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

STEP = "step"  # the span of one whole generation (`Simulation.step`)
HOST_WAIT = "host_wait"  # the total of the host's waits inside `step` spans
SYNC = "sync/"  # the door's spans: `sync/<site>`
_NO_SPAN = contextlib.nullcontext()


def process_mem_usage() -> Tuple[float, float]:
    """(vm_mb, rss_mb) of this process, from /proc/self/stat; (0, 0) when
    unavailable (non-Linux)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().split()
        vsize = float(fields[22])
        rss_pages = float(fields[23])
        page_kb = os.sysconf("SC_PAGE_SIZE") / 1024
        return vsize / 1024.0 / 1024.0, rss_pages * page_kb / 1024.0
    except (OSError, IndexError, ValueError):
        return 0.0, 0.0


def device_memory_mb(device: torch.device) -> Dict[str, float]:
    """{device: bytes allocated by torch (Mb)}; {} for the CPU."""
    if device.type != "cuda":
        return {}
    return {str(device): torch.cuda.memory_allocated(device) / 2**20}


def device_fence(device: torch.device) -> None:
    """Wait for every kernel queued on `device` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """The run's span recorder, one instance per run: `timer(stage)` is a
    span that adds its wall time to `totals[stage]` and one to
    `counts[stage]`. Spans nest; `open` names those open now, outermost
    first. While a profiler records, a span also opens
    `torch.profiler.record_function(stage)`, so that it lands on the
    profiler's clock beside the device's events; otherwise it never enters
    one.

    Built with the run's device and `sync` (`--stage_sync`): then a span
    that closes inside a generation (a `step` span) fences the device
    first, so that device work it queued is charged to it, unless it is a
    per-group span (`.../group`); the door's spans (`host_wait`) never
    fence. The fences' seconds and those of the door's calls inside a
    generation add up in `totals["host_wait"]`."""

    def __init__(self, device="cpu", sync: bool = False) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}
        self.device = torch.device(device)
        self.sync = sync
        self.open: List[str] = []

    def add(self, stage: str, dt: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def __call__(self, stage: str):
        return self._span(stage, self.sync and STEP in self.open
                          and not stage.endswith("/group"))

    @contextlib.contextmanager
    def _span(self, stage: str, fence: bool = False):
        # one C call: does a profiler record in this process?
        rec = (torch.profiler.record_function(stage)
               if torch._C._autograd._profiler_enabled() else _NO_SPAN)
        self.open.append(stage)
        t0 = time.perf_counter()
        try:
            with rec:
                yield
                if fence:
                    t1 = time.perf_counter()
                    device_fence(self.device)
                    self.add(HOST_WAIT, time.perf_counter() - t1)
        finally:
            self.open.pop()
            self.add(stage, time.perf_counter() - t0)

    def report(self, log=print) -> None:
        if not self.totals:
            return
        log("      stage timing (total s / calls):")
        for k, v in self.totals.items():
            log(f"        {k:<22s} {v:10.3f}  /{self.counts[k]}")


@contextlib.contextmanager
def host_wait(timer: Optional[StageTimer], site: str):
    """The one door of a call that makes the host wait for the card: a
    read to the host (`.cpu()`, `.tolist()`, `float()` of a device
    tensor), an op whose output size the host must learn (`nonzero`,
    `unique`), an upload from pageable memory or a collective. Opens the
    span `sync/<site>` (counted in `timer.counts`) and, inside a
    generation, adds its seconds to `timer.totals["host_wait"]`. Where a
    sync debug mode is set (`torch.cuda.set_sync_debug_mode`), lifts it for
    the call alone, so that a run under "error" fails at any sync that goes
    around the door. Changes no result. Without a timer (a caller outside a
    run) it does nothing."""
    if timer is None:
        yield
        return
    mode = 0
    if timer.device.type == "cuda":
        mode = torch.cuda.get_sync_debug_mode()
        if mode:
            torch.cuda.set_sync_debug_mode(0)
    waits = STEP in timer.open
    t0 = time.perf_counter()
    try:
        with timer._span(SYNC + site):
            yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)
        if waits:
            timer.add(HOST_WAIT, time.perf_counter() - t0)


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str], device: torch.device):
    """`torch.profiler` trace of the host ops and the run's spans and, on
    the card, its kernels and copies, written into `trace_dir` as a Chrome
    trace (`*.pt.trace.json`, viewable in Perfetto or TensorBoard); no-op
    when trace_dir is falsy."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        yield prof
