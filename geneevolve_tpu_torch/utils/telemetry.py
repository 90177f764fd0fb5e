"""Observability: memory reports, per-stage timing and profiler traces
(counterpart of geneevolve_tpu/utils/telemetry.py).

`process_mem_usage` keeps the reference's VM/RSS report
(`Simulation.cpp:3440-3475`); device memory comes from `torch.cuda`.
`device_fence` synchronizes the device so a `StageTimer` reading taken
after it is device-true (`--stage_sync`). `profiler_trace` records a
`torch.profiler` trace (`--profile`).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch


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
    """Accumulates wall time per named stage; one instance per run."""

    def __init__(self) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    def add(self, stage: str, dt: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def report(self, log=print) -> None:
        if not self.totals:
            return
        log("      stage timing (total s / calls):")
        for k, v in self.totals.items():
            log(f"        {k:<22s} {v:10.3f}  /{self.counts[k]}")


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str], device: torch.device):
    """`torch.profiler` trace of the host ops and, on the card, its kernels
    and copies, written into `trace_dir` as a Chrome trace
    (`*.pt.trace.json`, viewable in Perfetto or TensorBoard); no-op when
    trace_dir is falsy."""
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
