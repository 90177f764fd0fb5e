"""The dense backend under the harness, at a size a test run holds: a tiny
dense cell (a few hundred rows, three chromosomes of uneven panels, CVs on
panel sites) runs through `run.run_cell` on the CPU and is judged correct;
each fault planted in the program underneath the harness, and the control,
make it not correct; every earlier cell's scenario files and arguments are
those of the tree before the growth configuration."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from gebench import check, control, run, scenario
from gebench.reference import dense, law
from gebench.tests.conftest import REPO

# the digest of `write_inputs`' files and arguments for every cell of the
# benchmark before the growth configuration's, at a small size (`SMALL`,
# and three uneven panels on the dense backend), as the tree before that
# configuration wrote them (`_digest`)
CELL_DIGESTS = {
    "t31_30k.rand":
        "81b212fded3c8f395d6ac1a5800e736cb2c6bd8efee57d47fca2fd1050df25e0",
    "t31_300k.rand":
        "81b212fded3c8f395d6ac1a5800e736cb2c6bd8efee57d47fca2fd1050df25e0",
    "t31_30k.admix":
        "3f984e815b4494e1fdd4c55e75d59cd9f1a681e4f6bbb661627cc8b27f0dda9e",
    "dense31.rand":
        "132969cb3e9a20b91fc0af340fdf3e196027baa5bbe94f425c3ccc2fd6c9a71d",
}
SMALL = dict(pop_size=50, founders=20, chromosomes=3, cvs_per_chromosome=4)


def _run(root, seed=11, min_runs=3):
    c = run.load_cell(root, "tinyd.rand")
    return run.run_cell(c, seed, 0.01, False, device="cpu",
                        work=root / "work", log=lambda s: None,
                        min_runs=min_runs)


def test_sound_dense_run_is_correct(tiny_dense):
    res = _run(tiny_dense)
    assert res["correct"], res["checks"]
    assert list(res["checks"]) == [
        "files_differ", "pedigree_mismatch", "plane_mismatch", "cv_mismatch",
        "pheno_gap", "info_gap"]
    assert 0 < res["checks"]["pheno_gap"]["value"] < check.LIMITS["pheno_gap"]


def test_dense_argv_and_panel(tiny_dense, tmp_path):
    """The dense configuration's run names `--backend dense`, its panels
    hold the stated counts, and every CV sits on a panel SNP whose alleles
    it carries."""
    c = run.load_cell(tiny_dense, "tinyd.rand")
    inp = scenario.write_inputs(tmp_path / "s", c.config, c.mix, 7)
    for argv in (inp.argv, inp.warm_argv):
        assert argv[-2:] == ["--backend", "dense"]
    d = inp.pop_dirs[0]
    for ch, m in enumerate(c.config["snps_per_chromosome"], 1):
        legend = (d / f"ref.chr{ch}.legend").read_text().splitlines()[1:]
        assert len(legend) == m
        pos = [int(r.split()[1]) for r in legend]
        panel = (d / f"ref.chr{ch}.hap").read_bytes().splitlines(True)
        cvs = [r.split() for r in (d / "cv.info").read_text().splitlines()[1:]
               if r.split()[0] == str(ch)]
        rows = (d / f"cv.chr{ch}.hap").read_bytes().splitlines(True)
        assert len(cvs) == len(rows) == c.config["cvs_per_chromosome"]
        for cv, row in zip(cvs, rows):
            assert row == panel[pos.index(int(cv[1]))]


def _digest(root, inp) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode() + b"\0")
            h.update(p.read_bytes().replace(str(root).encode(), b"ROOT")
                     + b"\0")
    for a in (inp.argv, inp.warm_argv):
        h.update("\0".join(x.replace(str(root), "ROOT") for x in a).encode()
                 + b"\1")
    return h.hexdigest()


@pytest.mark.parametrize("cell", sorted(CELL_DIGESTS))
def test_segment_inputs_unchanged(tmp_path, cell):
    """Every earlier cell's files and arguments, at a small size, are byte
    for byte those the tree before the growth configuration wrote."""
    c = run.load_cell(REPO, cell)
    cfg = dict(c.config, **SMALL)
    if "snps_per_chromosome" in cfg:
        cfg["snps_per_chromosome"] = [30, 12, 50]
    root = tmp_path / "s"
    inp = scenario.write_inputs(root, cfg, c.mix, 2**33 + 7)
    assert inp.generations == 10
    assert _digest(root, inp) == CELL_DIGESTS[cell]


def _plant(monkeypatch, fault):
    from geneevolve_tpu_torch.core import engine, phenotype
    from geneevolve_tpu_torch.dense import backend

    window, cv_child = backend.meiose_window, backend.cv_child
    if fault == "unchanged":  # a step that leaves its state as it was
        monkeypatch.setattr(engine.Simulation, "step", lambda self, gen: None)
    elif fault == "half_batch":  # half the children never made
        def half(*a, **k):
            out = window(*a, **k)
            h = out.shape[0] // 2
            out[h:2 * h] = out[:h]
            return out
        monkeypatch.setattr(backend, "meiose_window", half)
    elif fault == "plane_bit":  # one bit of a child's plane flipped
        def flipped(*a, **k):
            out = window(*a, **k)
            out[0, 0, 0] ^= 1 << 3
            return out
        monkeypatch.setattr(backend, "meiose_window", flipped)
    elif fault == "cv_allele":  # one resident CV allele flipped
        def cv_flipped(*a, **k):
            out = cv_child(*a, **k)
            out[0, 0] ^= 1
            return out
        monkeypatch.setattr(backend, "cv_child", cv_flipped)
    elif fault == "a_value":  # one A value changed where it is made
        ad = phenotype.additive_dominance_chr

        def changed(*a, **k):
            A, D = ad(*a, **k)
            A = A.clone()
            A[0] += 1.0
            return A, D
        monkeypatch.setattr(phenotype, "additive_dominance_chr", changed)


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "pedigree_mismatch"),
    ("half_batch", "plane_mismatch"),
    ("plane_bit", "plane_mismatch"),
    ("cv_allele", "cv_mismatch"),
    ("a_value", "pheno_gap"),
])
def test_dense_fault_is_not_correct(tiny_dense, monkeypatch, fault, number):
    _plant(monkeypatch, fault)
    res = _run(tiny_dense, min_runs=1)
    assert not res["correct"]
    over = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    assert number in over, res["checks"]


def test_dense_control_fails(tiny_dense):
    """The program with its A/D in bfloat16 comes out not correct on the
    dense cell, through the phenotype gaps."""
    (res,) = control.readings(run.load_cell(tiny_dense, "tinyd.rand"), [5],
                              device="cpu", work=tiny_dense / "work")
    assert not res["correct"]
    for k in ("pheno_gap", "info_gap"):
        assert res["checks"][k]["value"] > res["checks"][k]["limit"], res


def test_dense_generations_judged(tiny_dense):
    """Every generation is judged, planes at 0, 1 and the last."""
    seen, finish = [], check.Judge.finish

    def keep(self, *a):
        finish(self, *a)
        seen.append(self)
    try:
        check.Judge.finish = keep
        res = _run(tiny_dense, seed=12, min_runs=1)
    finally:
        check.Judge.finish = finish
    assert res["correct"], res["checks"]
    judge, = seen
    assert judge.packed
    assert set(judge.want) == {(g, 0) for g in range(4)}


def test_gametes_follow_the_law():
    """A child chromatid's alleles: the start chromatid's, switched at each
    crossover at or before the column, flipped where a mutation fell an odd
    number of times."""
    lay = dense.Layout(n_chr=1, m_real=[64], chr_len=64,
                       cv_cols=[torch.tensor([0, 50])],
                       xo_cdf=torch.zeros(64), mut_cdf=None, mut_rate=0.0,
                       xo_cap=3, mut_cap=3)
    a = torch.tensor([0x0000FFFF, 0x0F0F0F0F], dtype=torch.int32)
    b = torch.tensor([-1, 0], dtype=torch.int32)
    hap = torch.stack([a, b])[None]  # one parent (1, 2, 2 words)
    big = lay.m
    pl = dense.Plan(xo=[torch.tensor([[[40, 8, big]]], dtype=torch.int32)] * 2,
                    start=[torch.tensor([[1]], dtype=torch.int32)] * 2,
                    mu=torch.tensor([[[5, 5, 50], [big] * 3]],
                                    dtype=torch.int32))
    kids = dense.Children(lay, hap, torch.tensor([0]), torch.tensor([0]), pl)
    cols = torch.arange(64)
    got = kids.gametes(0, 0, 0, 1, cols)[0].numpy()
    A = dense.bits(a, cols).numpy()
    B = dense.bits(b, cols).numpy()
    want = np.where((cols.numpy() >= 8) & (cols.numpy() < 40), A, B)
    want[50] ^= 1  # column 5 was drawn twice: no flip there
    assert (got == want).all()


def test_dense_plan_draws_as_the_program():
    """The reference's plan draws the program's numbers from the seed: the
    same generator in the same order (`DenseSimulation._plan`)."""
    from geneevolve_tpu_torch.core.rng import Stage, generator
    from geneevolve_tpu_torch.dense import backend
    from geneevolve_tpu_torch.dense.packed import PackedConfig
    from geneevolve_tpu_torch.dense.step import _sample_gamete_plan

    rng = np.random.default_rng(3)
    m, nchr = 96, 3
    xo_cdf = torch.as_tensor(np.cumsum(rng.random(m)) / 20, dtype=torch.float32)
    mut_cdf = torch.as_tensor(np.cumsum(rng.random(m)) / 50,
                              dtype=torch.float32)
    lay = dense.Layout(n_chr=nchr, m_real=[30, 32, 20], chr_len=32,
                       cv_cols=[], xo_cdf=xo_cdf, mut_cdf=mut_cdf,
                       mut_rate=float(mut_cdf[-1]), xo_cap=9, mut_cap=6)
    pl = dense.plan(lay, 77, 2, 0, 40, "cpu")
    cfg = PackedConfig(n=40, m=m, n_chr=nchr, xo_cap=9,
                       mut_rate=float(mut_cdf[-1]), mut_cap=6, ncv=0)
    g = generator("cpu", 77, 2, Stage.CROSSOVER, 0)
    assert int(Stage.CROSSOVER) == law.CROSSOVER
    for side in (0, 1):
        xo, st, _ = _sample_gamete_plan(g, cfg.as_dense(), 40, xo_cdf)
        assert torch.equal(xo, pl.xo[side]) and torch.equal(st, pl.start[side])
    for side in (0, 1):
        assert torch.equal(backend._mutation_cols(g, 40, cfg, mut_cdf),
                           pl.mu[:, side])


def test_dense_readers():
    ctx = dict(stages={"reproduce/plan": 0.2, "reproduce/meiosis": 0.5},
               gens=10, trace=dict(device_events=[
                   {"name": "void meiose_packed_kernel<true, false>(Params)",
                    "ts": 0, "dur": 1000}]),
               launches={"packed_roofline": [(3.35e6, 0)]})
    got = {m: run.reader(REPO, m).read(dict(ctx, metric=m))
           for m in ("plan_ms", "meiosis_ms", "packed_roofline")}
    assert got == pytest.approx(dict(plan_ms=20.0, meiosis_ms=50.0,
                                     packed_roofline=0.1))
    none = dict(stages={}, gens=10, trace=dict(device_events=[]),
                launches={"packed_roofline": []})
    for m in ("plan_ms", "meiosis_ms", "packed_roofline"):
        assert run.reader(REPO, m).read(dict(none, metric=m)) is None


def test_packed_launch_is_recorded(tiny_dense):
    """The traced run's wrapper of kernel 4's window entry sees one launch a
    generation on the dense path, and reckons its bound from the launch's
    parents and plan."""
    from gebench import trace
    from geneevolve_tpu_torch import cli
    from geneevolve_tpu_torch.parallel import mesh

    c = run.load_cell(tiny_dense, "tinyd.rand")
    inp = scenario.write_inputs(tiny_dense / "s", c.config, c.mix, 3)
    entry = mesh.meiose_packed_window
    r = run.reader(REPO, "packed_roofline")
    with trace.Wrappers({"packed_roofline": r}) as w:
        assert cli.main(inp.argv + ["--seed", "5", "--prefix",
                                    str(tiny_dense / "o")], device="cpu") == 0
    assert mesh.meiose_packed_window is entry
    launches = w.launches["packed_roofline"]
    assert len(launches) == inp.generations
    for x in launches:
        nbytes, ops = x()
        assert nbytes > ops > 0


@pytest.mark.cuda
def test_tiny_dense_on_card(cuda, tiny_dense):
    res = run.run_cell(run.load_cell(tiny_dense, "tinyd.rand"), 24, 0.01,
                       False, device=cuda, work=tiny_dense / "work",
                       log=lambda s: None)
    assert res["correct"], res["checks"]
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_dense_control_fails_on_card(cuda, tiny_dense):
    (res,) = control.readings(run.load_cell(tiny_dense, "tinyd.rand"), [25],
                              device=cuda, work=tiny_dense / "work")
    assert not res["correct"], res


@pytest.mark.cuda
def test_traced_tiny_dense_reports_its_metrics(cuda, tiny_dense):
    """A traced run of the tiny dense cell on the card reports every
    per-layer metric the dense cell lists, kernel 4's roofline share
    among them, under 100%."""
    import shutil

    shutil.copytree(REPO / "gebench" / "metrics",
                    tiny_dense / "gebench" / "metrics")
    cell = run.load_cell(tiny_dense, "tinyd.rand")
    res = run.run_cell(cell, 26, 0.01, True, device=cuda,
                       work=tiny_dense / "work", log=lambda s: None)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["metrics"]["packed_roofline"]["value"] < 100
