"""The comparison that decides `correct`, at a size a test run holds: a sound
run of the CLI on the CPU (the kernels' plain versions) agrees with the
reference in both mixes, and the run comes out not correct under each
fault a cell can have, planted in the program underneath the harness, and
under the control (the program's A/D in bfloat16)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gebench import check, run

FAULTS = ("unchanged", "half_batch", "ledger_slot", "ad_float16",
          "ledger_slot_middle", "probe_over")
# every number of a tiny cell's check, sound and under planted faults, that
# was not 0 as the check read them when it held every chromosome of the
# parents' planes and of the reference's children on the device at once
# (the tree before the block-wise check, on the CPU, one thread)
EARLIER = [
    ("tiny.rand", 11, None, dict(
        pheno_gap=3.357707410429298e-07, info_gap=5.247607373424212e-06)),
    ("tiny.rand", 12, None, dict(
        pheno_gap=2.394487824275406e-07, info_gap=6.718735806972358e-06)),
    ("tiny.admix", 11, None, dict(
        pheno_gap=2.458902599954692e-07, info_gap=1.0522959054121945e-05)),
    ("tiny.admix", 12, None, dict(
        pheno_gap=3.4416300065860963e-07, info_gap=8.081646132945321e-06)),
    ("tinyd.rand", 11, None, dict(
        pheno_gap=3.805175764053789e-07, info_gap=5.394063452220204e-06)),
    ("tinyd.rand", 12, None, dict(
        pheno_gap=3.061665042767396e-07, info_gap=5.014295790677802e-06)),
    ("tiny.rand", 11, "half_batch", dict(
        ledger_mismatch=156, cv_mismatch=724, pheno_gap=2.8650853865754535,
        info_gap=2.8650839591496844)),
    ("tiny.rand", 11, "ledger_slot", dict(
        ledger_mismatch=4, cv_mismatch=2, pheno_gap=0.2585222452982177,
        info_gap=0.258524259806677)),
    ("tiny.rand", 11, "ledger_slot_middle", dict(
        cv_mismatch=8, pheno_gap=0.45558183103354694,
        info_gap=0.4555831160031907)),
    ("tiny.admix", 11, "ledger_slot", dict(
        ledger_mismatch=7, pheno_gap=0.7845129611282349,
        info_gap=0.7845129573022218)),
    ("tiny.admix", 11, "ledger_slot_middle", dict(
        pheno_gap=0.33458663900193125, info_gap=0.33458534620293556)),
]


def _run(root, cell, seed=11):
    c = run.load_cell(root, cell)
    return run.run_cell(c, seed, 0.01, False, device="cpu",
                        work=root / "work", log=lambda s: None)


@pytest.mark.parametrize("cell", ["tiny.rand", "tiny.admix"])
def test_sound_run_is_correct(tiny, cell):
    res = _run(tiny, cell)
    assert res["correct"], res["checks"]
    names = set(res["checks"])
    assert {"ledger_mismatch", "mutation_mismatch", "pheno_gap", "info_gap",
            "files_differ", "probe_gap", "pedigree_mismatch"} <= names
    # resident CV alleles are compared only where the program holds them
    assert ("cv_mismatch" in names) == (cell == "tiny.rand")
    assert 0 < res["checks"]["pheno_gap"]["value"] < check.LIMITS["pheno_gap"]


def _plant(monkeypatch, fault):
    from geneevolve_tpu_torch.core import engine, phenotype

    merge = engine.meiose_merge
    if fault == "unchanged":  # a step that leaves its state as it was
        monkeypatch.setattr(engine.Simulation, "step", lambda self, gen: None)
    elif fault == "half_batch":  # half the children never made
        def half(*a, **k):
            st, hap, nv = merge(*a, **k)
            h = st.shape[1] // 2
            st[:, h:], hap[:, h:] = st[:, :st.shape[1] - h], hap[:, :hap.shape[1] - h]
            return st, hap, nv
        monkeypatch.setattr(engine, "meiose_merge", half)
    elif fault == "ledger_slot":  # one answer altered where it is made
        def slot(*a, **k):
            st, hap, nv = merge(*a, **k)
            hap[0, 0, 0, 0] += 1
            return st, hap, nv
        monkeypatch.setattr(engine, "meiose_merge", slot)
    elif fault == "ad_float16":  # A/D taken in float16
        ad = phenotype.additive_dominance_chr

        def half_ad(*a, **k):
            A, D = ad(*a, **k)
            return A.half().float(), D.half().float()
        monkeypatch.setattr(phenotype, "additive_dominance_chr", half_ad)
    elif fault == "ledger_slot_middle":  # a ledger altered in generation 2
        step = engine.Simulation.step

        def altered(self, gen):
            step(self, gen)
            if gen == 2:
                # the first child's first chromatids copy the other haps
                # of their founders
                self.pops[0].state.seg_hap[:, 0, 0, :] ^= 1
        monkeypatch.setattr(engine.Simulation, "step", altered)
    elif fault == "probe_over":  # the probe reserves a mutation slot more
        needs = engine.Simulation._needs

        def over(self, counts):
            s, m = needs(self, counts)
            return s, m + 1
        monkeypatch.setattr(engine.Simulation, "_needs", over)


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(tiny, monkeypatch, fault):
    _plant(monkeypatch, fault)
    res = _run(tiny, "tiny.rand")
    assert not res["correct"]
    over = [k for k, v in res["checks"].items() if v["value"] > v["limit"]]
    want = {"unchanged": "pedigree_mismatch",
            "half_batch": "ledger_mismatch",
            "ledger_slot": "ledger_mismatch",
            "ad_float16": "pheno_gap",
            "ledger_slot_middle": "cv_mismatch",
            "probe_over": "probe_gap"}[fault]
    assert want in over, res["checks"]


@pytest.mark.parametrize("cell", ["tiny.rand", "tiny.admix"])
def test_every_generation_is_judged(tiny, cell):
    """Generations between the second and the last are judged too: their
    pedigree and phenotypes against the reference, their `.info` files,
    and the probe's counts."""
    from geneevolve_tpu_torch.core import engine

    c = run.load_cell(tiny, cell)
    seen = []
    finish = check.Judge.finish

    def keep(self, *a):
        finish(self, *a)
        seen.append(self)
    try:
        check.Judge.finish = keep
        res = run.run_cell(c, 12, 0.0, False, device="cpu",
                           work=tiny / "work", log=lambda s: None,
                           min_runs=1)
    finally:
        check.Judge.finish = finish
    assert res["correct"], res["checks"]
    judge, = seen
    gens = c.mix["generations"]
    n_pop = c.mix["populations"]
    assert set(judge.want) == {(g, k) for g in range(gens + 1)
                               for k in range(n_pop)}
    assert set(judge.held) == set(range(1, gens + 1))
    assert engine.Simulation.step.__name__ == "step"


def test_timed_files_must_match(tiny):
    """A checked run whose files differ from the timed run's is not
    correct."""
    judge = check.Judge.__new__(check.Judge)
    judge.n = {k: 0 for k in check.LIMITS}
    judge.last, judge.seen, judge.probes, judge.want = 0, set(), {}, {}
    judge.held, judge.seconds = {}, dict(files=0.0)
    judge.finish(None, tiny / "none", {"a.summary": "1"}, {"a.summary": "2"})
    assert judge.n["files_differ"] == 1


@pytest.mark.parametrize("cell", ["tiny.rand", "tiny.admix"])
def test_control_fails(tiny, cell):
    """The program with its A/D in bfloat16 comes out not correct, through
    the phenotype gaps, as held and as the `.info` files print them."""
    from gebench import control

    (res,) = control.readings(run.load_cell(tiny, cell), [5], device="cpu",
                              work=tiny / "work")
    assert not res["correct"]
    for k in ("pheno_gap", "info_gap"):
        assert res["checks"][k]["value"] > res["checks"][k]["limit"], res


def test_reference_ledgers_are_functions():
    """`canonical` keeps the last entry of equal positions and drops
    entries that repeat the haplotype before them."""
    from gebench.reference import sim

    big = sim.BIG
    st = torch.tensor([[0, 5, 5, 9, big], [0, 3, 7, big, big]],
                      dtype=torch.int32)
    hap = torch.tensor([[1, 2, 3, 3, 0], [4, 4, 5, 0, 0]])
    pos, h = sim.canonical(st, hap)
    assert pos.tolist() == [[0, 5], [0, 7]]
    assert h.tolist() == [[1, 3], [4, 5]]


@pytest.mark.parametrize("cell,seed,fault,want", EARLIER,
                         ids=[f"{c}-{s}-{f}" for c, s, f, _ in EARLIER])
def test_blockwise_check_reads_as_before(tmp_path, monkeypatch, cell, seed,
                                         fault, want):
    """The check that holds the parents' planes in host memory and makes
    and compares a chromosome of a population at a time reads every number
    as the whole-generation check read it, digit for digit."""
    from gebench.tests import conftest

    torch.set_num_threads(1)
    make = (conftest.tiny_dense_root if cell.startswith("tinyd")
            else conftest.tiny_root)
    root = make(tmp_path / "checkout")
    if fault:
        _plant(monkeypatch, fault)
    res = run.run_cell(run.load_cell(root, cell), seed, 0.0, False,
                       device="cpu", work=root / "work", log=lambda s: None,
                       min_runs=1)
    got = {k: v["value"] for k, v in res["checks"].items()}
    assert got == {k: want.get(k, 0) for k in got}


def test_info_files_read(tmp_path):
    """The check reads each `.info` file's id and value columns; a missing
    or malformed file reads as nothing, a file without rows as no rows."""
    rows = "\n".join(f"{i} 1 2 3 4 5 6 {1 + i % 2} {i / 7:g} {-i:g}"
                     for i in range(50))
    paths = []
    for k, body in enumerate([rows, rows[:-3], "", "1 2 3"]):
        paths.append(tmp_path / f"run.info.pop1.gen{k}.txt")
        paths[-1].write_text("ID a b c d e f sex A B\n" + body + "\n")
    paths.append(tmp_path / "missing.txt")
    got = [check._read_info(p) for p in paths]
    assert [x[0] is None for x in got] == [False, True, False, True, True]
    assert got[2][0].shape == (0, 8) and got[0][1].shape == (50, 2)
    assert np.array_equal(got[0][0][:, 0], np.arange(50))
    assert np.array_equal(got[0][1][:, 1], -np.arange(50.0))
