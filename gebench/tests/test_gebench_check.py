"""The comparison that decides `correct`, at a size a test run holds: a sound
run of the CLI on the CPU (the kernels' plain versions) agrees with the
reference in both mixes, and the run comes out not correct under each
fault a cell can have, planted in the program underneath the harness, and
under the control (the program's A/D in bfloat16)."""

from __future__ import annotations

import pytest
import torch

from gebench import check, run

FAULTS = ("unchanged", "half_batch", "ledger_slot", "ad_float16",
          "ledger_slot_middle", "probe_over")


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
    judge.held = {}
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
