"""A growing two-population demography under the harness, at a size a test
run holds: each population's schedule grows by its own rate and the warm-up
takes the schedule's first rows; the populations have unequal founders on
the same maps and CV sites; a tiny growth cell (a resize every generation,
a few migrants each way) runs through `run.run_cell` on the CPU and is
judged correct; each fault planted in the program underneath the harness,
and the control, make it not correct; the readers of the paint kernel's
roofline and of the `.info` stage."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from gebench import control, run, scenario
from gebench.reference import inputs
from gebench.tests.conftest import REPO, TINY_GROW


def _cell(root):
    return run.load_cell(root, "tinyg.grow")


def _run(root, seed=11):
    return run.run_cell(_cell(root), seed, 0.0, False, device="cpu",
                        work=root / "work", log=lambda s: None, min_runs=1)


def _rows(path):
    return [int(r.split()[0]) for r in path.read_text().splitlines()[1:]]


def test_growth_schedule_rows(tiny_grow, tmp_path):
    """Population k's size at generation g of G is round(pop_size[k]
    e^(-r_k (G - g))); the warm-up's schedule is the first rows of it."""
    c = _cell(tiny_grow)
    inp = scenario.write_inputs(tmp_path / "s", c.config, c.mix, 3)
    G = c.mix["generations"]
    for d, n, r in zip(inp.pop_dirs, TINY_GROW["pop_size"],
                       TINY_GROW["growth_per_generation"]):
        want = [round(n * math.exp(-r * (G - g))) for g in range(1, G + 1)]
        assert _rows(d / "popinfo.txt") == want
        assert want[-1] == n and len(set(want)) == G
        assert _rows(d / "popinfo_warm.txt") == \
            want[:scenario.WARMUP_GENERATIONS]
    sc = inputs.read(inp.argv, 1)
    assert [p.pop_size for p in sc.pops] == [
        _rows(d / "popinfo.txt") for d in inp.pop_dirs]


def test_configured_schedule_is_the_epoch(tmp_path):
    """`ooa2t12` writes the growth epoch's last rows: AFR 372,157 to
    432,125 and EUR 420,724 to 501,436."""
    cfg = json.loads((REPO / "gebench/configs/ooa2t12.json").read_text())
    rows = scenario.sizes(cfg, 2, 10)
    assert rows[0][0] == 372_157 and rows[0][-1] == 432_125
    assert rows[1][0] == 420_724 and rows[1][-1] == 501_436
    assert sum(r[0] for r in rows) == 792_881
    assert sum(r[-1] for r in rows) == 933_561


def test_scalars_write_one_size():
    """A configuration without growth gives every generation its size."""
    cfg = dict(pop_size=50, founders=20)
    assert scenario.sizes(cfg, 2, 3) == [[50] * 3] * 2
    with pytest.raises(ValueError):
        scenario.per_population(dict(pop_size=[1, 2, 3]), "pop_size", 2)


def test_unequal_founders(tiny_grow, tmp_path):
    """Each population has its own founder count in its panel and CV
    haplotypes, on the first population's maps and CV sites, with its own
    effects."""
    c = _cell(tiny_grow)
    inp = scenario.write_inputs(tmp_path / "s", c.config, c.mix, 4)
    sc = inputs.read(inp.argv, 1)
    for d, n0, pop in zip(inp.pop_dirs, TINY_GROW["founders"], sc.pops):
        assert len((d / "ref.indv").read_text().splitlines()) == n0
        for ch in range(1, c.config["chromosomes"] + 1):
            width = len((d / f"ref.chr{ch}.hap").read_bytes()
                        .split(b"\n", 1)[0])
            assert width == 2 * (2 * n0)
        assert pop.n0 == n0
    a, b = (d for d in inp.pop_dirs)
    for name in ("rmap.txt", "mut.txt") + tuple(
            f"ref.chr{ch}.legend" for ch in range(1, 4)):
        assert (a / name).read_bytes() == (b / name).read_bytes()
    for ca, cb, ea, eb in zip(sc.pops[0].cv_bp, sc.pops[1].cv_bp,
                              sc.pops[0].a, sc.pops[1].a):
        assert np.array_equal(ca, cb) and not np.array_equal(ea, eb)


@pytest.mark.parametrize("seed", [11, 2**33 + 5])
def test_tiny_grow_is_correct(tiny_grow, seed):
    res = _run(tiny_grow, seed)
    assert res["correct"], res["checks"]
    assert "cv_mismatch" not in res["checks"]  # the gather A/D path
    assert 0 < res["checks"]["pheno_gap"]["value"]


def plant(monkeypatch, fault):
    """Plant `fault` in the program underneath the harness."""
    from geneevolve_tpu_torch.core import engine

    if fault == "row_dropped":  # a child row lost where fresh planes are made
        real = engine.Simulation._real_pass

        def dropped(self, *a, **k):
            planes, *used = real(self, *a, **k)
            for x in planes[:3]:
                x[:, :-1] = x[:, 1:].clone()
            return (planes, *used)
        monkeypatch.setattr(engine.Simulation, "_real_pass", dropped)
    elif fault == "migrant_stays":  # one migrant left in its source
        gather, moved = engine.Simulation._gather_state, {}

        def kept(self, parts):
            (own, keep), *rest = parts
            if own.index == 0 and rest:  # population 1 loses its first
                src, idx = rest[0]  # immigrant from population 2 ...
                moved["row"] = idx[0]
                rest[0] = (src, idx[1:])
            elif "row" in moved:  # ... which population 2 keeps
                keep = np.sort(np.append(keep, moved.pop("row")))
            return gather(self, [(own, keep), *rest])
        monkeypatch.setattr(engine.Simulation, "_gather_state", kept)
    elif fault == "cv_allele":  # one painted CV allele flipped
        paint = engine.paint

        def flipped(seg_st, seg_hap, mut, founder, pos):
            out = paint(seg_st, seg_hap, mut, founder, pos)
            if mut.shape[-1]:  # alleles, not root populations
                out[0, 0, 0, 0] ^= 1
            return out
        monkeypatch.setattr(engine, "paint", flipped)


FAULTS = {"row_dropped": "ledger_mismatch",
          "migrant_stays": "pedigree_mismatch",
          "cv_allele": "pheno_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_grow_fault_is_not_correct(tiny_grow, monkeypatch, fault):
    plant(monkeypatch, fault)
    res = _run(tiny_grow)
    assert not res["correct"]
    over = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    assert FAULTS[fault] in over, res["checks"]


def test_grow_control_fails(tiny_grow):
    """The program with its A/D in bfloat16 comes out not correct on the
    growth cell, through the phenotype gaps."""
    (res,) = control.readings(_cell(tiny_grow), [5], device="cpu",
                              work=tiny_grow / "work")
    assert not res["correct"]
    for k in ("pheno_gap", "info_gap"):
        assert res["checks"][k]["value"] > res["checks"][k]["limit"], res


def test_paint_and_info_readers():
    """`paint_roofline` reckons each launch's bound from the traced run's
    shapes and the replay's live counts, and reads nothing when the replay
    saw other launches; `info_ms` adds the writer's seconds to the stage's."""
    import torch

    from gebench import roofline

    st = torch.full((1, 2, 2, 4), 2**30, dtype=torch.int32)
    st[..., 0] = 0
    args = (st, st.short(), st.clone(),
            torch.zeros((1, 6, 3), dtype=torch.uint8),
            torch.zeros((1, 3), dtype=torch.int32))
    paint = run.reader(REPO, "paint_roofline")
    shapes = paint.work(*args)()
    assert all(isinstance(x, roofline.Shape) for x in shapes)
    counts = paint.replay(*args)
    assert counts[2:] == (4, 4)
    nbytes, ops = roofline.paint_work(*args)
    assert (nbytes, ops) == (12 + 4 * 6 + 4 * 4 + 18 + 12, 48)
    us = 1e6 * roofline.bound_s(nbytes, ops)
    ctx = dict(stages={"info_files": 0.3}, gens=10,
               clocked={"info_ms": 0.2},
               trace=dict(device_events=[
                   {"name": "void paint_kernel<short>(int const*)", "ts": 0,
                    "dur": 10 * us}]),
               launches={"paint_roofline": [shapes]},
               replays={"paint_roofline": [counts]})
    got = {m: run.reader(REPO, m).read(dict(ctx, metric=m))
           for m in ("paint_roofline", "info_ms")}
    assert got == pytest.approx(dict(paint_roofline=10.0, info_ms=50.0))
    other = (torch.Size((1, 3, 2, 4)),) + counts[1:]
    for replays in ([], [counts, counts], [other]):
        assert paint.read(dict(ctx, metric="paint_roofline",
                               replays={"paint_roofline": replays})) is None
    none = dict(stages={}, gens=10, trace=dict(device_events=[]),
                launches={"paint_roofline": []}, replays={})
    for m in ("paint_roofline", "info_ms"):
        assert run.reader(REPO, m).read(dict(none, metric=m)) is None


def test_paint_launch_is_recorded(tiny_grow):
    """The traced run's wrapper of the engine's paint sees every launch of
    the gather A/D path (alleles, and roots with two populations) and keeps
    their shapes alone; a run of the same seed under `Replays` sees the
    same launches and counts their live slots; the writer of the `.info`
    files is clocked."""
    from gebench import roofline, trace
    from geneevolve_tpu_torch import cli
    from geneevolve_tpu_torch.core import engine

    c = _cell(tiny_grow)
    inp = scenario.write_inputs(tiny_grow / "s", c.config, c.mix, 3)
    argv = inp.argv + ["--seed", "5", "--prefix", str(tiny_grow / "o")]
    entry, writer = engine.paint, engine.Simulation._save_info_sync
    readers = {m: run.reader(REPO, m) for m in ("paint_roofline", "info_ms")}
    with trace.Wrappers(readers) as w:
        assert cli.main(argv, device="cpu") == 0
    with trace.Replays(readers) as r:
        assert set(r.launches) == {"paint_roofline"}
        assert cli.main(argv, device="cpu") == 0
    assert engine.paint is entry
    assert engine.Simulation._save_info_sync is writer
    assert w.clocked["info_ms"][0] > 0
    shapes = [x() for x in w.launches["paint_roofline"]]
    counts = r.launches["paint_roofline"]
    # two launches a population and generation, generation 0 included
    assert len(shapes) == len(counts) == 2 * 2 * (inp.generations + 1)
    for s, n in zip(shapes, counts):
        assert all(isinstance(x, roofline.Shape) for x in s)
        assert (s[0].shape, s[2].shape) == n[:2] and n[2] > 0
        nbytes, ops = roofline.paint_work(*s, *n[2:])
        assert nbytes > 0 and ops > 0


def test_traced_run_takes_paint_counts_from_the_check(tiny_grow,
                                                      monkeypatch):
    """A traced run of the growth cell replays the window's last run, and
    the check's run of that seed gives a live count for each paint launch
    that the traced run recorded (the profiler left out on the CPU)."""
    import shutil

    from gebench import trace

    shutil.copytree(REPO / "gebench" / "metrics",
                    tiny_grow / "gebench" / "metrics")
    monkeypatch.setattr(trace, "profile", lambda fn: fn() or [
        {"cat": "user_annotation", "name": trace.RUN_SPAN, "ts": 0,
         "dur": 1e6}])
    seen, layer_metrics = [], run.layer_metrics
    monkeypatch.setattr(run, "layer_metrics",
                        lambda cell, readers, ctx: seen.append(ctx)
                        or layer_metrics(cell, readers, ctx))
    res = run.run_cell(_cell(tiny_grow), 29, 0.0, True, device="cpu",
                       work=tiny_grow / "work", log=lambda s: None,
                       min_runs=1)
    assert res["correct"], res["checks"]
    (ctx,) = seen
    shapes = ctx["launches"]["paint_roofline"]
    counts = ctx["replays"]["paint_roofline"]
    assert len(shapes) == len(counts) > 0
    assert [(s[0].shape, s[2].shape) for s in shapes] == \
        [tuple(n[:2]) for n in counts]
    assert res["metrics"]["info_ms"]["value"] > 0


@pytest.mark.cuda
def test_tiny_grow_on_card(cuda, tiny_grow):
    """A traced run of the tiny growth cell on the card is correct and
    reports every per-layer metric the cell lists, the paint kernel's
    roofline share among them, under 100%."""
    import shutil

    shutil.copytree(REPO / "gebench" / "metrics",
                    tiny_grow / "gebench" / "metrics")
    cell = _cell(tiny_grow)
    res = run.run_cell(cell, 27, 0.01, True, device=cuda,
                       work=tiny_grow / "work", log=lambda s: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["metrics"]["paint_roofline"]["value"] < 100


@pytest.mark.cuda
def test_grow_control_fails_on_card(cuda, tiny_grow):
    (res,) = control.readings(_cell(tiny_grow), [28], device=cuda,
                              work=tiny_grow / "work")
    assert not res["correct"], res
