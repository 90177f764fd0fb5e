"""The harness: `BENCHMARK.json` keeps to its contract, every cell's files
and every metric's reader are found by name, a new configuration, mix and
metric load without an edit, the check for JAX compares whole top-level
names, a run never falls back to the CPU, and a run loads no JAX."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gebench import run, trace

REPO = Path(__file__).resolve().parent.parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_manifest_keeps_to_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["gebench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("gebench/")
    cells = [w["name"] for w in b["workloads"]]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m else 1
    for m in b["end_to_end"]:
        assert m["source"] == "host_clock" and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads(cell):
    c = run.load_cell(REPO, cell)
    assert c.config["pop_size"] > 0 and c.mix["generations"] > 0
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "s_per_gen"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(run.reader(REPO, m["name"]).read)


def test_new_files_load_without_edit(tiny):
    """A configuration, a mix and a metric added as files and manifest
    entries are found by name."""
    (tiny / "gebench/metrics").mkdir()
    (tiny / "gebench/metrics/new_ms.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    mix = json.loads((tiny / "gebench/mixes/rand.json").read_text())
    (tiny / "gebench/mixes/assort.json").write_text(
        json.dumps(dict(mix, mat_cor=0.4)))
    b = json.loads((tiny / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(b["workloads"][0], name="tiny.assort",
                               traffic="assort"))
    b["per_layer"].append(dict(b["per_layer"][0], name="new_ms",
                               workloads=["tiny.assort"]))
    (tiny / "BENCHMARK.json").write_text(json.dumps(b))
    c = run.load_cell(tiny, "tiny.assort")
    assert c.mix["mat_cor"] == 0.4
    assert "new_ms" in [m["name"] for m in c.per_layer]
    assert run.reader(tiny, "new_ms").read({}) == 1.5
    assert "new_ms" not in [m["name"] for m in
                            run.load_cell(tiny, "tiny.rand").per_layer]


def test_forbidden_names_are_whole(monkeypatch):
    for name in ("geneevolve_tpu_torch.core", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    monkeypatch.setitem(sys.modules, "geneevolve_tpu.core", sys)
    assert run.forbidden_modules() == ["geneevolve_tpu.core",
                                       "jaxlib.xla_client"]


def test_refuses_without_card():
    """Without a CUDA card the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "gebench/run.py", "--workload",
                        "t31_30k.rand", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_run_loads_no_jax(tiny):
    """A whole run of the harness (on the CPU, the card's look skipped)
    leaves no module of JAX or the JAX package loaded."""
    code = (
        "import sys, torch; sys.path.insert(0, %r); torch.set_num_threads(1)\n"
        "from pathlib import Path\n"
        "from gebench import run\n"
        "c = run.load_cell(Path(%r), 'tiny.admix')\n"
        "r = run.run_cell(c, 3, 0.01, False, device='cpu', work=Path(%r), "
        "log=lambda s: None)\n"
        "print(r['correct'], run.forbidden_modules())\n"
    ) % (str(REPO), str(tiny), str(tiny / "work"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.splitlines()[-1] == "True []"


def test_trace_reduction():
    """Idle gaps are labelled by the innermost host span around them; the
    device ops are summed by name."""
    ev = [
        {"cat": "user_annotation", "name": trace.RUN_SPAN, "ts": 0,
         "dur": 100},
        {"cat": "user_annotation", "name": "reproduce", "ts": 10, "dur": 50},
        {"cat": "user_annotation", "name": "mate", "ts": 60, "dur": 30},
        {"cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "a", "ts": 35, "dur": 10},
        {"cat": "gpu_memset", "name": "b", "ts": 90, "dur": 5},
        {"cat": "gpu_user_annotation", "name": "mate", "ts": 60, "dur": 30},
    ]
    red = trace.reduce(ev)
    assert red["busy_s"] == pytest.approx(35e-6)
    assert [g[0] for g in red["idle_gaps"]] == ["mate", "run", "reproduce",
                                                "run"]
    assert red["idle_gaps"][0][1] == pytest.approx(45e-6)
    assert [k for k, _ in red["device_ops"]] == ["a", "b"]
    assert [v for _, v in red["device_ops"]] == pytest.approx([30e-6, 5e-6])


def test_readers():
    ctx = dict(stages={"mate": 0.5, "reproduce/real": 2.0}, gens=10,
               trace=dict(device_events=[{"name": "x meiose_merge_kernel",
                                          "ts": 0, "dur": 1000}],
                          busy_s=1.0, window_s=4.0),
               launches={"merge_roofline": [(3.35e6, 0)]})
    got = {m: run.reader(REPO, m).read(dict(ctx, metric=m)) for m in (
        "mate_ms", "real_ms", "migration_ms", "device_idle_pct",
        "device_ops_per_gen", "merge_roofline")}
    assert got == pytest.approx(dict(mate_ms=50.0, real_ms=200.0,
                                     migration_ms=None, device_idle_pct=75.0,
                                     device_ops_per_gen=0.1,
                                     merge_roofline=0.1))
    ctx["launches"]["merge_roofline"].append((1, 1))  # one unmatched
    assert run.reader(REPO, "merge_roofline").read(
        dict(ctx, metric="merge_roofline")) is None


def _imports(path: Path):
    import ast

    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "gebench").rglob("*.py")))
def test_sources_import_no_jax(path):
    """No file of the benchmark imports JAX or the JAX package, and the
    reference imports nothing of the program either."""
    names = set(_imports(REPO / path))
    assert not names & set(run.FORBIDDEN), names
    if path.startswith("gebench/reference/"):
        assert "geneevolve_tpu_torch" not in names
