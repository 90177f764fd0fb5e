"""The segment engine's biobank-n memory regime in the PyTorch port, on the
CPU (the kernels' plain versions): in-place grouped reproduction, the
per-group plan, row-chunked gamete work and the memory reckoning
(`core/memory.py`).

The scenario has 4 chromosomes, so groups of 1, 3 (3 + 1) and 4 differ
from the default 2, a mutation map (~1 de novo mutation a gamete and
chromosome) and a resident CV matrix, at a constant population size for 4
generations. Every run here must write the same bytes as the run on fresh
planes (`GE_NO_INPLACE_REPRO=1`), and, fed the JAX run's plans, the same
planes as the JAX engine every generation.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core import checkpoint, memory, segments
from test_torch_engine import PLANES, JaxRun, _inject, _planes
from test_torch_multipop import duo_argv, make_duo

torch.set_num_threads(1)
NCHR = 4
GENS = 4
FRESH = {"GE_NO_INPLACE_REPRO": "1"}


def make_quad(root: Path, sizes=(50,) * GENS) -> Path:
    """40 founders, 4 chromosomes x 120 SNPs, 6 CVs a chromosome, a 1
    cM/Mb map and a mutation map; one generation-info row a size."""
    rng = np.random.default_rng(11)
    n0, nsnp, ncv = 40, 120, 6
    cv_rows = []
    for c in range(1, NCHR + 1):
        hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
        np.savetxt(root / f"ref.chr{c}.hap", hap, fmt="%d")
        pos = np.sort(rng.choice(np.arange(1_000_000, 40_000_000), nsnp,
                                 replace=False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            f.writelines(f"rs{c}_{i} {q} A G\n" for i, q in enumerate(pos))
        (root / f"ref.chr{c}.indv").write_text(
            "".join(f"{i + 1}\n" for i in range(n0)))
        cols = np.sort(rng.choice(nsnp, ncv, replace=False))
        np.savetxt(root / f"cv.chr{c}.hap", hap[cols], fmt="%d")
        cv_rows += [(c, pos[i], rng.normal()) for i in cols]
    (root / "cv.info").write_text("chr pos a d\n" + "".join(
        f"{c} {q} {a} 0\n" for c, q, a in cv_rows))
    (root / "hap_address.txt").write_text("chr hap legend sample\n" + "".join(
        f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
        f"{root}/ref.chr{c}.indv\n" for c in range(1, NCHR + 1)))
    (root / "cv_address.txt").write_text("".join(
        f"{c} {root}/cv.chr{c}.hap\n" for c in range(1, NCHR + 1)))
    (root / "popinfo.txt").write_text(
        "pop_size mat_cor offspring_dist selection_func "
        "selection_func_par1 selection_func_par2\n"
        + "".join(f"{n} 0.2 p thr 1 1\n" for n in sizes))
    bins = [(c, bp) for c in range(1, NCHR + 1)
            for bp in range(0, 45_000_000, 50_000)]
    (root / "rmap.txt").write_text("chr bp cM\n" + "".join(
        f"{c} {bp} {bp / 1_000_000:.6f}\n" for c, bp in bins))
    (root / "mut.txt").write_text("chr bp rate\n" + "".join(
        f"{c} {bp} {1 / 800:.8g}\n" for c, bp in bins))
    return root


def argv(root: Path, prefix: Path, extra=()):
    return [
        "--file_gen_info", str(root / "popinfo.txt"),
        "--file_hap_name", str(root / "hap_address.txt"),
        "--file_recom_map", str(root / "rmap.txt"),
        "--file_cv_info", str(root / "cv.info"),
        "--file_cvs", str(root / "cv_address.txt"),
        "--file_mutation_map", str(root / "mut.txt"),
        "--seed", "321", "--prefix", str(prefix), *extra,
    ]


class PortRun:
    """A port run through `Simulation.run` on the CPU, with a copy of
    population 1's planes after each generation and the address of its
    `seg_st` plane (the same address from one generation to the next:
    written in place)."""

    def __init__(self, a, env=None, inject=None):
        with pytest.MonkeyPatch.context() as m:
            for k, v in (env or {}).items():
                m.setenv(k, v)
            sim = torch_engine.Simulation(parse_args(a), device="cpu",
                                          verbose=False)
            if inject is not None:
                _inject(sim, inject)
            self.states, self.ptrs = [], []
            init, step = sim.init_generation0, sim.step

            def init_kept():
                init()
                self._keep(sim)

            def step_kept(gen):
                step(gen)
                self._keep(sim)

            sim.init_generation0, sim.step = init_kept, step_kept
            sim.run()
        sim._io_pool.shutdown(wait=True)
        self.sim = sim

    def _keep(self, sim):
        st = sim.pops[0].state
        self.states.append({k: v.copy() for k, v in _planes(st).items()
                            if v is not None and v.ndim})
        self.ptrs.append(st.seg_st.data_ptr())


def same_files(a: Path, b: Path, min_files=GENS + 2) -> int:
    names = sorted(x.name for x in a.iterdir() if x.is_file())
    assert names == sorted(x.name for x in b.iterdir() if x.is_file())
    names = [x for x in names if not x.endswith(".npz")]
    assert len(names) >= min_files
    for x in names:
        assert filecmp.cmp(a / x, b / x, shallow=False), x
    return len(names)


def same_planes(got: PortRun, want):
    assert len(got.states) == len(want)
    for gen, (g, w) in enumerate(zip(got.states, want)):
        for k in PLANES:
            if k in w:
                assert g[k].dtype == w[k].dtype, (gen, k)
                np.testing.assert_array_equal(g[k], w[k],
                                              err_msg=f"{gen} {k}")


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return make_quad(tmp_path_factory.mktemp("quad"))


@pytest.fixture(scope="module")
def fresh(quad, tmp_path_factory):
    """The run on fresh planes every generation: the reference."""
    out = tmp_path_factory.mktemp("fresh")
    run = PortRun(argv(quad, out / "out"), FRESH)
    run.out = out
    return run


@pytest.mark.parametrize("group", [None, "1", "2", "3", "4"])
def test_in_place_equals_fresh(quad, fresh, tmp_path, group):
    """The default (groups of 2) and groups of 1, 2, 3 (3 + 1) and every
    chromosome write their children over the parents' planes, and their
    ledgers, mutations, CV matrices and `.info`/`.summary` bytes equal
    the fresh-plane run's every generation."""
    env = {} if group is None else {"GE_INPLACE_GROUP": group}
    run = PortRun(argv(quad, tmp_path / "out"), env)
    same_planes(run, fresh.states)
    # every generation keeps the planes of generation 0 (padded to
    # generation 1's rows), so every generation was written in place
    assert len(set(run.ptrs)) == 1
    assert all(a != b for a, b in zip(fresh.ptrs, fresh.ptrs[1:]))
    assert (run.states[-1]["mut"] < 2**30).sum() > 50
    assert same_files(tmp_path, fresh.out) == GENS + 2


@pytest.fixture(scope="module")
def jax_quad(quad, tmp_path_factory):
    return JaxRun(argv(quad, tmp_path_factory.mktemp("jax") / "out"))


@pytest.mark.parametrize("env", [{}, {"GE_INPLACE_GROUP": "1"},
                                 {"GE_INPLACE_GROUP": "3"},
                                 {"GE_PLAN_PER_GROUP": "1"}, FRESH],
                         ids=["default", "group1", "group3", "per_group",
                              "fresh"])
def test_in_place_fed_jax_plans_bit_exact(quad, jax_quad, tmp_path, env):
    """Fed the JAX run's mating and reproduce plans (a group's rows of
    them under the per-group plan), every grouping writes the JAX run's
    planes bit for bit every generation, in place or not."""
    run = PortRun(argv(quad, tmp_path / "out"), env, inject=jax_quad)
    same_planes(run, jax_quad.states)
    assert (len(set(run.ptrs)) == 1) == (env != FRESH)


def test_plan_per_group_files_identical(quad, fresh, tmp_path, monkeypatch):
    """`GE_PLAN_PER_GROUP=1`, and a `GE_PLAN_BYTES_MAX` below the plan's
    bytes, draw the plan a group at a time, in the probe and again in the
    real pass; `GE_PLAN_PER_GROUP=0` keeps the whole plan even past the
    bytes. The files are byte-identical to the whole-plan run's (the
    mirror of `tests/test_engine.py`'s per-group test)."""
    ranges = []
    plan = torch_engine.Simulation._plan

    def plan_rec(self, p, gen, n_pad, c0=0, c1=None):
        ranges.append((gen, c0, c1))
        return plan(self, p, gen, n_pad, c0, c1)

    monkeypatch.setattr(torch_engine.Simulation, "_plan", plan_rec)
    for name, env in (("on", {"GE_PLAN_PER_GROUP": "1"}),
                      ("bytes", {"GE_PLAN_BYTES_MAX": "1000"}),
                      ("off", {"GE_PLAN_PER_GROUP": "0",
                               "GE_PLAN_BYTES_MAX": "1000"})):
        ranges.clear()
        (tmp_path / name).mkdir()
        run = PortRun(argv(quad, tmp_path / name / "out"), env)
        same_planes(run, fresh.states)
        same_files(tmp_path / name, fresh.out)
        if name == "off":
            assert ranges == [(g, 0, None) for g in range(1, GENS + 1)]
        else:  # each group drawn twice: the probe's, the real pass's
            want = [(g, c0, c0 + 2) for g in range(1, GENS + 1)
                    for _ in range(2) for c0 in (0, 2)]
            assert ranges == want


def test_resize_generation_takes_fresh_planes(tmp_path):
    """A schedule whose size changes: the resize generation (50 -> 400)
    writes fresh planes between in-place ones, and every file and plane
    equals the fresh-plane run's."""
    root = make_quad(tmp_path, sizes=(50, 50, 400, 400))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = PortRun(argv(root, tmp_path / "a" / "out"), FRESH)
    run = PortRun(argv(root, tmp_path / "b" / "out"))
    same_planes(run, want.states)
    same_files(tmp_path / "b", tmp_path / "a")
    p = run.ptrs
    assert p[0] == p[1] == p[2] != p[3] == p[4]


@pytest.mark.parametrize("variant", ["out_interval", "gather_path",
                                     "two_populations", "resumed"])
def test_in_place_paths_identical(quad, tmp_path, variant,
                                  tmp_path_factory):
    """`--out_interval` (merge_ibd=False), the gather path
    (`GE_NO_RESIDENT_CV=1`), two populations with migration and a
    checkpoint resumed in place: every file byte-identical to the run on
    fresh planes."""
    extra, env = [], {}
    if variant == "out_interval":
        extra = ["--out_interval"]
    if variant == "gather_path":
        env = {"GE_NO_RESIDENT_CV": "1"}
    if variant == "two_populations":
        duo = make_duo(tmp_path_factory.mktemp("duo"))
    if variant == "resumed":
        # a straight run on fresh planes checkpoints generation 2 (its
        # later saves skipped); both runs resume from it
        ck = tmp_path / "ck"
        ck.mkdir()
        save = checkpoint.save
        with pytest.MonkeyPatch.context() as m:
            m.setattr(checkpoint, "save", lambda sim, gen, path: save(
                sim, gen, path) if gen <= 2 else None)
            PortRun(argv(quad, ck / "out", ["--checkpoint_every", "2"]),
                    FRESH)
        extra = ["--resume", str(ck / "out.ckpt.npz")]
    files = {}
    for name, e in (("inplace", env), ("fresh", {**env, **FRESH})):
        out = tmp_path / name
        out.mkdir()
        if variant == "two_populations":
            a = duo_argv(duo, out / "out", ["--out_interval"])
        else:
            a = argv(quad, out / "out", extra)
        run = PortRun(a, e)
        files[name] = out
        if variant == "resumed":
            assert run.sim.resident_cv and len(run.states) == 2
            assert (run.ptrs[0] == run.ptrs[1]) == (name == "inplace")
        if variant == "gather_path":
            assert not run.sim.resident_cv
    n = same_files(files["inplace"], files["fresh"], min_files=3)
    if variant in ("out_interval", "two_populations"):
        assert any(x.name.endswith(".int") for x in
                   files["fresh"].iterdir())
    assert n >= (3 if variant == "resumed" else GENS + 2)


def test_row_chunks_equal_one_pass():
    """`segments.in_row_chunks` at a chunk of 7 rows equals one pass of
    `inherit_mutations` and of `gamete_cv` over 50 rows."""
    g = torch.Generator().manual_seed(5)
    n, K, M, mn, C = 50, 6, 5, 3, 9
    BIG = segments.BIG
    xo = torch.randint(0, 1000, (n, K), generator=g, dtype=torch.int32)
    xo[torch.rand((n, K), generator=g) < 0.5] = BIG
    start = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    q = torch.sort(torch.randint(0, 1000, (C,), generator=g,
                                 dtype=torch.int32)).values
    pm = torch.sort(torch.where(torch.rand((n, 2, M), generator=g) < 0.5,
                                q[torch.randint(0, C, (n, 2, M),
                                                generator=g)], BIG)).values
    new = torch.where(torch.rand((n, mn), generator=g) < 0.5,
                      q[torch.randint(0, C, (n, mn), generator=g)], BIG)
    rows = torch.randint(0, 2, (n, 2, C), generator=g, dtype=torch.uint8)
    one = segments.inherit_mutations(pm, xo, start, new, 8)
    got = segments.in_row_chunks(segments.inherit_mutations, 7,
                                 (pm, xo, start, new), 8)
    assert all(torch.equal(a, b) for a, b in zip(one, got))
    assert int((one[0] < BIG).sum()) > 20
    for m in (pm, None):
        one = segments.gamete_cv(rows, xo, start, m, new, q)
        got = segments.in_row_chunks(segments.gamete_cv, 7,
                                     (rows, xo, start, m, new), q)
        assert torch.equal(one, got)


def test_engine_row_chunks_files_identical(quad, fresh, tmp_path,
                                           monkeypatch):
    """Past `memory.CHUNKED_PAST` children (2^19; 16 here) each
    chromosome's mutation inheritance and CV alleles run over chunks of
    `GE_REPRO_CHUNK` rows (7 here): the same planes and files."""
    monkeypatch.setattr(memory, "CHUNKED_PAST", 16)
    calls = []
    chunks = segments.in_row_chunks

    def rec(fn, chunk, rows, *fixed):
        calls.append(chunk)
        return chunks(fn, chunk, rows, *fixed)

    monkeypatch.setattr(segments, "in_row_chunks", rec)
    run = PortRun(argv(quad, tmp_path / "out"), {"GE_REPRO_CHUNK": "7"})
    same_planes(run, fresh.states)
    same_files(tmp_path, fresh.out)
    assert calls and set(calls) == {7}


# --------------------------------------------------------- the reckoning
TABLE31 = dict(nchr=22, founder_haps=20_000, n_pop=1, c_all=100,
               ncv_pad=100, s_cap=49, m_cap=27, xo_cap=23, mn_cap=11,
               hap_bytes=2)
GIB = 1 << 30


def _rows(n):
    return n + 4 * int(np.sqrt(n)) + 16


def _sizes(n, **kw):
    return memory.Sizes(pop_rows=(_rows(n),), **{**TABLE31, **kw})


def _parent_choice(sz: memory.Sizes, free: int):
    """The seed tree's `_check_fits` arithmetic (one 'ind' rank, one
    population): (resident, gather_chunk)."""
    nchr, rows = sz.nchr, max(sz.pop_rows)
    row_state = nchr * 2 * (sz.s_cap * (4 + sz.hap_bytes) + sz.m_cap * 4)
    state, cv = rows * row_state, nchr * rows * 2 * sz.c_all
    plan = 2 * nchr * rows * (sz.xo_cap + sz.mn_cap + 2) * 4
    transient = 8 * rows * (sz.xo_cap + 2 * sz.m_cap + sz.mn_cap) * sz.c_all
    need = 2 * (state + cv) + plan + transient
    painted = nchr * (rows * 2 + sz.founder_haps) * sz.c_all
    need_gather = 2 * state + plan + painted \
        + 8 * rows * (2 * sz.m_cap + sz.mn_cap) * 8
    resident = need <= free
    used = need if resident else need_gather
    gathered = rows * 2 * ((sz.c_all if resident else 0) + 4 * sz.m_cap)
    return resident, int(min(nchr, max(1, (free - used) // gathered)))


def test_reckoning_keeps_table31_choices():
    """At `table31`'s sizes with 79 GiB free: the resident path with every
    chromosome in one gather, as the seed tree chose; in place and, at
    30,000 (0.2 GB of plan), the whole plan."""
    sz = _sizes(30_000)
    for sw in (memory.Switches(), memory.Switches(in_place=False)):
        got = memory.reckon(sz, 79 * GIB, sw)
        assert (got.resident_cv, got.gather_chunk) == \
            _parent_choice(sz, 79 * GIB) == (True, 22)
        assert not got.per_group
    assert memory.reckon(sz, 79 * GIB).in_place
    assert memory.reckon(sz, 79 * GIB).need < memory.reckon(
        sz, 79 * GIB, memory.Switches(in_place=False)).need


@pytest.mark.parametrize("in_place", [True, False])
def test_reckoning_never_moves_toward_gather(in_place):
    """Over populations from 1,000 to 3,000,000 and 1 to 80 GiB free, no
    population the seed tree ran resident goes to the gather path, and
    on a path both take, the gathers are at least as wide."""
    sw = memory.Switches(in_place=in_place)
    moved = 0
    for n in (1_000, 30_000, 300_000, 1_000_000, 3_000_000):
        for free in (1, 2, 5, 10, 20, 40, 79, 80):
            sz = _sizes(n)
            old = _parent_choice(sz, free * GIB)
            new = memory.reckon(sz, free * GIB, sw)
            assert new.resident_cv >= old[0], (n, free)
            if new.resident_cv == old[0]:
                assert new.gather_chunk >= old[1], (n, free)
            moved += new.resident_cv and not old[0]
    assert moved > 0  # the corrected transient admits more


def test_reckoning_biobank_and_short_memory():
    """At 1e6 with 79 GiB free the run stays resident and in place (the
    seed tree sent it to the gather path), with the per-group plan (past
    1.5e9 bytes of plan; 300,000 too). With less free memory the resident
    path's gathers narrow, then the run takes the gather path, with
    gathers of one chromosome."""
    sz = _sizes(1_000_000)
    big = memory.reckon(sz, 79 * GIB)
    assert big.resident_cv and big.in_place and big.per_group
    assert big.gather_chunk == 22 and _parent_choice(sz, 79 * GIB)[0] is False
    assert big.need <= 79 * GIB
    assert memory.reckon(_sizes(300_000), 79 * GIB).per_group
    assert not memory.reckon(_sizes(30_000), 79 * GIB).per_group
    rows = _rows(1_000_000)
    res, gat = big.need_resident, big.need_gather
    per_res, per_gat = rows * 2 * (100 + 4 * 27), rows * 2 * 4 * 27
    for k in (22, 5, 1):
        got = memory.reckon(sz, res + k * per_res)
        assert got.resident_cv and got.gather_chunk == k
        assert got.need == res + min(2, k) * per_res
    # the gather path needs a little less (its painted CV columns take
    # the resident matrix's bytes)
    assert gat + per_gat < res
    assert not memory.reckon(sz, res - 1).resident_cv
    for k in (1, 0):
        got = memory.reckon(sz, gat + k * per_gat)
        assert not got.resident_cv and got.gather_chunk == 1
        assert got.need == gat + per_gat
    # a resize in the schedule reckons fresh planes: twice the state; a
    # second 'ind' rank holds half the rows, in place
    got = memory.reckon(_sizes(1_000_000, constant=False), 79 * GIB)
    assert not got.in_place and got.need_resident > res
    got = memory.reckon(_sizes(1_000_000, ind=2), 79 * GIB)
    assert got.in_place and got.need_resident < res
    assert not memory.reckon(sz, 79 * GIB,
                             memory.Switches(in_place=False)).in_place


# `multipop31`'s sizes: two populations of 30,000 on the gather path, int32
# haps (40,000 founder haps), the capacities of 3 generations
MULTIPOP31 = dict(TABLE31, founder_haps=40_000, n_pop=2, s_cap=37, m_cap=22,
                  hap_bytes=4)


def test_reckoning_several_populations():
    """With several populations a generation after a migration runs in
    place only when its children fit the rows the migration left, so the
    reckoning takes the larger of the in-place and the fresh-plane needs,
    and gathers as wide as a fresh generation's. At `multipop31`'s sizes
    with 79 GiB free it reckons at least the 2,214.9 MiB the card measured
    at those sizes (H100, the smoke's `multipop_ref`, the migration
    writing each new state into planes allocated once; `multipop31`
    2,182.9)."""
    sz = memory.Sizes(pop_rows=(_rows(30_000),) * 2, **MULTIPOP31)
    got = memory.reckon(sz, 79 * GIB, resident=False)
    fresh = memory.reckon(sz, 79 * GIB, memory.Switches(in_place=False),
                          resident=False)
    assert got.in_place and not fresh.in_place and not got.resident_cv
    assert got.gather_chunk == fresh.gather_chunk == 22
    assert got.need_gather >= fresh.need_gather
    assert got.need >= fresh.need
    assert got.need >= 2214.9 * 2**20
    # one population keeps the in-place width (a group's gathers)
    one = memory.Sizes(pop_rows=(_rows(30_000),),
                       **dict(MULTIPOP31, n_pop=1, founder_haps=20_000))
    assert memory.reckon(one, 79 * GIB, resident=False).need < \
        memory.reckon(one, 79 * GIB, memory.Switches(in_place=False),
                      resident=False).need


def test_check_fits_keeps_the_plan(quad, tmp_path, monkeypatch):
    """On the card `_check_fits` asks `memory.reckon` with the run's sizes
    and keeps its plan (`mem_plan`); off the card there is none."""
    sim = torch_engine.Simulation(parse_args(argv(quad, tmp_path / "o")),
                                  device="cpu", verbose=False)
    assert sim.mem_plan is None and sim.gather_chunk == NCHR
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (79 * GIB, 80 * GIB))
    sim.device = torch.device("cuda")
    sim._check_fits()
    plan = sim.mem_plan
    assert plan.resident_cv and plan.in_place and not plan.per_group
    assert plan == memory.reckon(sim._sizes(), 79 * GIB)
    assert sim._sizes().pop_rows == (_rows(50),)
    monkeypatch.setenv("GE_NO_INPLACE_REPRO", "1")
    sim._check_fits()
    assert not sim.mem_plan.in_place
