"""The readers of the program's own spans and door: `host_wait_ms`,
`host_busy_ms`, `syncs_per_gen`, `load_ms` and `generation0_ms`, on
synthetic contexts in the style of `test_readers`, and, on the card, a
traced tiny cell that reports them."""

from __future__ import annotations

import json
import shutil

import pytest

from gebench import run, trace
from gebench.tests.conftest import REPO

SPANS = ("host_wait_ms", "host_busy_ms", "syncs_per_gen", "load_ms",
         "generation0_ms")


def _read(name, ctx):
    return run.reader(REPO, name).read(dict(ctx, metric=name))


def test_span_readers():
    ctx = dict(stages={"step": 3.0, "host_wait": 1.0, "load": 0.4,
                       "generation0": 0.25, "mate": 0.5}, gens=10,
               trace={}, launches={"syncs_per_gen": [1, 1, 0, 1]})
    got = {m: _read(m, ctx) for m in SPANS}
    assert got == pytest.approx(dict(
        host_wait_ms=100.0, host_busy_ms=200.0, syncs_per_gen=0.3,
        load_ms=400.0, generation0_ms=250.0))
    assert got["host_wait_ms"] + got["host_busy_ms"] == pytest.approx(
        1e3 * ctx["stages"]["step"] / ctx["gens"])


@pytest.mark.parametrize("missing", ["step", "host_wait", "load",
                                     "generation0"])
def test_span_readers_none_without_a_total(missing):
    """A total the program does not record (a program without the spans)
    reads as nothing, and nothing raises."""
    stages = {"step": 3.0, "host_wait": 1.0, "load": 0.4,
              "generation0": 0.25}
    del stages[missing]
    ctx = dict(stages=stages, gens=10, trace={}, launches={})
    readers = {"step": ["host_busy_ms"],
               "host_wait": ["host_wait_ms", "host_busy_ms"],
               "load": ["load_ms"], "generation0": ["generation0_ms"]}
    for m in SPANS:
        v = _read(m, ctx)
        assert (v is None) == (m in readers[missing] + ["syncs_per_gen"]), m


def test_sync_count_keeps_calls_inside_step():
    """`syncs_per_gen` wraps the program's door and counts only the calls
    made while a `step` span is open."""
    from geneevolve_tpu_torch.utils import telemetry

    door = telemetry.host_wait
    r = run.reader(REPO, "syncs_per_gen")
    assert r.WRAP == ("geneevolve_tpu_torch.utils.telemetry", "host_wait")
    t = telemetry.StageTimer()
    with trace.Wrappers({"syncs_per_gen": r}) as w:
        with t("load"), telemetry.host_wait(t, "upload"):
            pass
        for _ in range(2):
            with t("step"), t("reproduce"), telemetry.host_wait(t, "needs"):
                pass
        with t("summary"), telemetry.host_wait(t, "capacity_guard"):
            pass
        with telemetry.host_wait(None, "ad_frequency"):
            pass
    assert telemetry.host_wait is door
    counts = [x() for x in w.launches["syncs_per_gen"]]
    assert counts == [0, 1, 1, 0, 0]
    assert r.read(dict(launches={"syncs_per_gen": counts}, gens=2,
                       metric="syncs_per_gen")) == 1.0


def test_sync_count_silent_without_the_door(monkeypatch):
    """Over a program whose telemetry has no door, the reader wraps
    nothing and reads nothing."""
    from geneevolve_tpu_torch.utils import telemetry

    monkeypatch.delattr(telemetry, "host_wait")
    r = run.reader(REPO, "syncs_per_gen")
    assert r.WRAP is None
    with trace.Wrappers({"syncs_per_gen": r}) as w:
        assert w.launches == {}
    assert r.read(dict(launches={}, gens=3, metric="syncs_per_gen")) is None


@pytest.mark.cuda
def test_traced_tiny_cell_reports_the_spans(cuda, tiny):
    """A traced run of a tiny cell on the card reports every span metric,
    and the waits and the host's own work add up to the `step` spans."""
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["per_layer"] = [dict(m, workloads=["tiny.rand"])
                      for m in b["per_layer"] if m["name"] in SPANS]
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copytree(REPO / "gebench" / "metrics", tiny / "gebench" / "metrics")
    cell = run.load_cell(tiny, "tiny.rand")
    res = run.run_cell(cell, 23, 0.01, True, device=cuda,
                       work=tiny / "work", log=lambda s: None)
    got = {m: res["metrics"][m]["value"] for m in SPANS}
    assert all(v >= 0 for v in got.values()), got
    assert got["syncs_per_gen"] >= 1 and got["host_wait_ms"] > 0
