"""The port's spans and its one sync door (`utils/telemetry.py`): the
`StageTimer` as a span recorder, `host_wait` at every call of a generation
that makes the host wait for the card, and the spans a `torch.profiler`
trace of a whole run holds. CPU tests run tiny scenarios with the plain
versions of the kernels; the card test (marked `cuda`) runs the same
scenarios' generations under `torch.cuda.set_sync_debug_mode("error")`.
This file imports no JAX, so the card test runs on a GPU machine without
it:

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py
"""

import contextlib
import io
import json
from pathlib import Path

import pytest
import torch

from geneevolve_tpu_torch import cli
from geneevolve_tpu_torch.core import engine
from geneevolve_tpu_torch.utils import telemetry
from tools.mkscenario import make_scenario
from geneevolve_tpu_torch.utils.trace_spans import summarize

# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)

GENS = 3
# the stages of a generation: once a population, then once a generation
POP_STAGES = ("mate", "reproduce", "reproduce/probe", "reproduce/real",
              "compute_ad", "phenotypes")
STAGES = POP_STAGES + ("gamma_mv_sv", "info_files")
# name: (extra flags, environment, a second population)
VARIANTS = {
    "resident": ([], {}, False),
    "per_group": ([], {"GE_PLAN_PER_GROUP": "1"}, False),
    "fresh_planes": ([], {"GE_NO_INPLACE_REPRO": "1"}, False),
    "gather": ([], {"GE_NO_RESIDENT_CV": "1"}, False),
    "two_populations": ([], {}, True),
    "device_mating": (["--device_mating"], {}, False),
    "dense": (["--backend", "dense"], {}, False),
    "stage_sync": (["--stage_sync"], {}, False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the sync debug mode exists only there")
    return "cuda"


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    """A tiny Table 3.1 file set (40 founders, 60 a generation, 3
    chromosomes of 6 CVs, 3 generations) and a migration file."""
    root = tmp_path_factory.mktemp("telemetry")
    flags = make_scenario(str(root / "pop"), n0=40, pop_size=60, gens=GENS,
                          nchr=3, ncv=6, seed=3)
    (root / "migration.txt").write_text("0.9 0.1 0.1 0.9\n" * GENS)
    argv = [x for k, v in flags.items() for x in (f"--{k}", v)]
    return root, argv


def _argv(scenario, out: Path, name: str, extra=()):
    root, pop = scenario
    flags, _env, two = VARIANTS[name]
    argv = list(pop)
    if two:
        argv += ["--next_population", *pop, "--file_migration",
                 str(root / "migration.txt"), "--gamma", "0.5"]
    out.mkdir(parents=True, exist_ok=True)
    return argv + flags + ["--seed", "11", "--prefix", str(out / "out"),
                           *extra]


def _run(scenario, out: Path, name: str, monkeypatch, extra=(),
         device="cpu"):
    """One whole run of the variant `name` through the CLI; the
    simulation it ran."""
    for k, v in VARIANTS[name][1].items():
        monkeypatch.setenv(k, v)
    seen = []
    init = engine.Simulation.__init__

    def keep(self, *a, **k):
        seen.append(self)
        init(self, *a, **k)

    monkeypatch.setattr(engine.Simulation, "__init__", keep)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(_argv(scenario, out, name, extra), device=device)
    assert rc == 0
    return seen[0]


def _doors(monkeypatch):
    """Record every call of the door: (its site, the spans open then)."""
    calls = []
    door = telemetry.host_wait

    def counted(timer, site):
        calls.append((site, list(timer.open) if timer else None))
        return door(timer, site)

    monkeypatch.setattr(telemetry, "host_wait", counted)
    return calls


# ------------------------------------------------------------------ timer
def test_spans_nest_and_fill_totals():
    """A span adds its seconds and a call under its name, nested spans
    inside their parents; the door's call inside `step` is a `sync/` span
    and adds its seconds to `host_wait`."""
    t = telemetry.StageTimer()
    with t("step"):
        assert t.open == ["step"]
        with t("mate"):
            with telemetry.host_wait(t, "x"):
                assert t.open == ["step", "mate", "sync/x"]
        with t("mate"):
            pass
    assert t.open == []
    assert t.counts == {"sync/x": 1, "host_wait": 1, "mate": 2, "step": 1}
    assert t.totals["sync/x"] <= t.totals["host_wait"] <= \
        t.totals["mate"] <= t.totals["step"]


def test_door_outside_a_generation_is_no_wait():
    """Outside `step` the door still opens and counts its span, but adds
    nothing to `host_wait`; without a timer it does nothing."""
    t = telemetry.StageTimer()
    with t("load"), telemetry.host_wait(t, "upload"):
        pass
    with telemetry.host_wait(None, "upload"):
        pass
    assert t.counts == {"sync/upload": 1, "load": 1}
    assert "host_wait" not in t.totals


def test_span_closes_on_error():
    t = telemetry.StageTimer()
    with pytest.raises(ValueError):
        with t("step"), telemetry.host_wait(t, "x"):
            raise ValueError
    assert t.open == [] and t.counts["step"] == 1
    assert t.counts["host_wait"] == 1


def test_stage_sync_fences_each_stage_of_a_generation(monkeypatch):
    """Under `sync` every span that closes inside `step` fences the device
    and adds the fence's seconds to `host_wait`, but a per-group span, the
    door's and any span outside a generation do not; without `sync` none
    fences."""
    fenced = []
    monkeypatch.setattr(telemetry, "device_fence",
                        lambda device: fenced.append(device))
    for sync in (True, False):
        fenced.clear()
        t = telemetry.StageTimer("cpu", sync)
        with t("load"):
            pass
        with t("step"):
            with t("reproduce"), t("reproduce/real"):
                with t("reproduce/real/group"):
                    pass
                with telemetry.host_wait(t, "needs"):
                    pass
            with t("compute_ad"):
                pass
        # reproduce/real, reproduce, compute_ad
        assert len(fenced) == (3 if sync else 0)
        assert t.counts["host_wait"] == (4 if sync else 1)


def test_no_record_function_without_a_profiler(scenario, tmp_path,
                                               monkeypatch):
    """With no profiler recording, a whole run (spans and door calls)
    never enters `record_function`."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sim = _run(scenario, tmp_path, "per_group", monkeypatch)
    assert sim.timer.counts["step"] == GENS


# ----------------------------------------------------------------- a run
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_run_records_its_spans_and_waits(scenario, tmp_path, monkeypatch,
                                         name):
    """A run's totals hold `load`, `generation0`, `step` (once a
    generation), `host_wait` (no more than `step`) and `summary`; the door
    is called in every generation, and every call inside a generation
    falls inside one of its stages."""
    calls = _doors(monkeypatch)
    gens = []
    step = engine.Simulation.step

    def counted(self, gen):
        gens.append(len(calls))
        step(self, gen)

    monkeypatch.setattr(engine.Simulation, "step", counted)
    sim = _run(scenario, tmp_path, name, monkeypatch)
    tot = sim.timer.totals
    for k in ("load", "generation0", "step", "host_wait", "summary"):
        assert k in tot, k
    assert sim.timer.counts["step"] == GENS
    assert 0 < tot["host_wait"] <= tot["step"]
    gens.append(len(calls))
    per_gen = [b - a for a, b in zip(gens, gens[1:])]
    assert min(per_gen) >= 1, per_gen
    inside = [opened for _site, opened in calls if "step" in opened]
    assert inside and all(len(o) >= 2 for o in inside)
    pop_stages = (("mate", "reproduce", "reproduce/plan",
                   "reproduce/meiosis", "compute_ad", "phenotypes")
                  if name == "dense" else POP_STAGES)
    for k in pop_stages:
        assert sim.timer.counts[k] == GENS * len(sim.pops), k
    for k in ("gamma_mv_sv", "info_files"):
        assert sim.timer.counts[k] == GENS, k


def test_group_spans_under_the_per_group_plan(scenario, tmp_path,
                                              monkeypatch):
    """Under the per-group plan and in place, one span a chromosome group
    in each pass: 3 chromosomes in groups of 2 make 2 a pass."""
    monkeypatch.setenv("GE_INPLACE_GROUP", "2")
    sim = _run(scenario, tmp_path, "per_group", monkeypatch)
    c = sim.timer.counts
    assert c["reproduce/probe/group"] == 2 * GENS
    in_place = sum(e["in_place"] for e in sim.capacity_log)
    assert in_place >= 1
    assert c["reproduce/real/group"] == 2 * in_place


def test_files_identical_under_profile_and_stage_sync(scenario, tmp_path,
                                                      monkeypatch):
    """`--profile` and `--stage_sync` change no byte of the `.info` and
    `.summary` files."""
    runs = {"plain": [], "profiled": ["--profile", str(tmp_path / "tr")],
            "fenced": ["--stage_sync"]}
    for k, extra in runs.items():
        _run(scenario, tmp_path / k, "resident", monkeypatch, extra)
    names = sorted(p.name for p in (tmp_path / "plain").iterdir()
                   if p.suffix in (".txt", ".summary"))
    assert len(names) == GENS + 2  # .info of generations 0-3, .summary
    for k in ("profiled", "fenced"):
        for n in names:
            assert (tmp_path / k / n).read_bytes() == \
                (tmp_path / "plain" / n).read_bytes(), (k, n)


def test_profiler_trace_holds_the_program_spans(scenario, tmp_path,
                                                monkeypatch):
    """Under a CPU `torch.profiler` the run's `step`, stage, group and
    `sync/*` spans are `user_annotation` events; each `sync/*` event lies
    inside a program span of its own thread, and each stage inside a
    `step`."""
    path = tmp_path / "trace.json"
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(scenario, tmp_path / "out", "per_group", monkeypatch)
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation" and "dur" in e]
    spans = [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"]) for e in ev]
    names = {s[0] for s in spans}
    for k in ("load", "generation0", "step", "summary",
              "reproduce/probe/group", "reproduce/real/group", *STAGES):
        assert k in names, k
    syncs = [s for s in spans if s[0].startswith("sync/")]
    assert {"sync/needs", "sync/parents", "sync/ad_to_host"} <= \
        {s[0] for s in syncs}

    def inside(s, names_):
        return any(o[0] in names_ and o[1] == s[1] and o[2] <= s[2]
                   and s[3] <= o[3] for o in spans if o is not s)

    program = names - {s[0] for s in syncs}
    assert all(inside(s, program) for s in syncs)
    assert all(inside(s, {"step"}) for s in spans if s[0] in STAGES)
    assert sum(s[0] == "step" for s in spans) == GENS


def test_trace_spans_breakdown():
    """`utils/trace_spans.py`: each span's wall time and the device's idle
    time under the innermost open span, `run` where none is."""
    def ev(name, a, b, cat="user_annotation"):
        return dict(name=name, cat=cat, ts=a * 1e6, dur=(b - a) * 1e6)

    got = summarize([ev("w", 0, 100), ev("load", 0, 10), ev("step", 10, 60),
                     ev("mate", 10, 20), ev("sync/x", 30, 40),
                     ev("k", 15, 35, "kernel"), ev("c", 95, 120,
                                                   "gpu_memcpy")], "w")
    assert got["window_s"] == 100 and got["busy_s"] == 25
    assert got["span_s"] == {"load": 10, "mate": 10, "step": 50,
                             "sync/x": 10}
    assert got["idle_by_span"] == pytest.approx(
        {"run": 35, "step": 20, "load": 10, "mate": 5, "sync/x": 5})


def test_profile_trace_breaks_down_by_span(scenario, tmp_path, monkeypatch):
    """A `--profile` trace of a whole run, broken down by span: the steps,
    the load, generation 0 and the summary cover the run but for the CLI's
    own few statements, and every idle second lies under some span."""
    trace = tmp_path / "trace"
    _run(scenario, tmp_path / "out", "resident", monkeypatch,
         ["--profile", str(trace)])
    (path,) = trace.glob("*.pt.trace.json")
    got = summarize(json.loads(path.read_text())["traceEvents"])
    s = got["span_s"]
    assert got["calls"]["step"] == GENS
    parts = s["step"] + s["load"] + s["generation0"] + s["summary"]
    assert 0.9 * got["window_s"] <= parts <= got["window_s"]
    assert sum(got["idle_by_span"].values()) == pytest.approx(
        got["window_s"] - got["busy_s"])


# ------------------------------------------------------------------ card
@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_generations_sync_only_through_the_door(cuda, scenario, tmp_path,
                                                monkeypatch, name):
    """Every generation runs under `set_sync_debug_mode("error")` and
    completes: each call that makes the host wait for the card goes
    through `telemetry.host_wait`, which lifts the mode for itself
    alone."""
    step = engine.Simulation.step

    def strict(self, gen):
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(self, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(engine.Simulation, "step", strict)
    calls = _doors(monkeypatch)
    sim = _run(scenario, tmp_path, name, monkeypatch, device=cuda)
    assert sim.timer.counts["step"] == GENS
    assert any("step" in opened for _site, opened in calls)
    assert torch.cuda.get_sync_debug_mode() == 0
