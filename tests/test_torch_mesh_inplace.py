"""The segment engine's in-place reproduce regime on a mesh of several
'ind' ranks (gloo CPU ranks, the kernels' plain versions): each rank
writes a constant-size generation's children over its own block of the
planes, a group of `GE_INPLACE_GROUP` chromosomes at a time, fetching only
that group's parent rows, as the JAX engine runs its in-place branch under
any mesh (`geneevolve_tpu/core/engine.py:1785-1821`).

Every output file (`.info`, `.summary`, `.int`, `.hap`) of a mesh run must
be byte-identical (tolerance 0) to the one-rank run's: at 2 ranks with
groups of 1, 2 and 3 chromosomes, the plan drawn per group or whole, on
fresh planes (`GE_NO_INPLACE_REPRO=1`), without `--out_interval`, on the
gather path, with two populations and migration, with a ledger capacity
cut after loading (a generation grows it) and with a resize generation; at
3 ranks (uneven blocks, edge-padded rows) and at 4. The capacity log says
in place on every rank for every constant-size generation and the planes
keep their address. The owner-side probe counts equal the counts of the
parents' rows fetched to the children's ranks, number for number. The
memory reckoning (`core/memory.reckon`) admits at least 1.5x one card's
largest population on 2 ranks and 2.8x on 4. The migration moves rows in
chunks with the same bytes.

Every launch of ranks runs under a deadline (the runs share BUDGET_S), so
a hang fails these tests and not the run.
"""

import dataclasses
import filecmp
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core import memory
from test_torch_inplace import argv, make_quad
from test_torch_multipop import duo_argv, make_duo

torch.set_num_threads(1)
BUDGET_S = 300  # every run of the `runs` fixture, one-rank runs included
GENS = 4
MAIN = ["--out_interval", "--out_hap"]
FRESH = {"GE_NO_INPLACE_REPRO": "1"}
# name -> (scenario, extra argv, env, ledger capacity cut after loading):
# the runs of the 2-rank launch
VARIANTS = {
    "main": ("quad", MAIN, {}, None),
    "group1_per_group": ("quad", MAIN, {"GE_INPLACE_GROUP": "1",
                                        "GE_PLAN_PER_GROUP": "1"}, None),
    "group1_whole_plan": ("quad", MAIN, {"GE_INPLACE_GROUP": "1",
                                         "GE_PLAN_PER_GROUP": "0"}, None),
    "group2_per_group": ("quad", MAIN, {"GE_INPLACE_GROUP": "2",
                                        "GE_PLAN_PER_GROUP": "1"}, None),
    "group3_per_group": ("quad", MAIN, {"GE_INPLACE_GROUP": "3",
                                        "GE_PLAN_PER_GROUP": "1"}, None),
    "group3_whole_plan": ("quad", MAIN, {"GE_INPLACE_GROUP": "3",
                                         "GE_PLAN_PER_GROUP": "0"}, None),
    "fresh": ("quad", MAIN, FRESH, None),
    "merged": ("quad", ["--out_hap"], {}, None),
    "gather": ("quad", MAIN, {"GE_NO_RESIDENT_CV": "1"}, None),
    "duo": ("duo", ["--out_interval"], {}, None),
    "grow": ("quad", MAIN, {}, 3),
    "resize": ("resize", MAIN, {}, None),
}
# the one-rank run each variant's files must equal (the capacity cut and
# the regime change no byte)
REFERENCE = {"fresh": "main", "grow": "main", "merged": "merged",
             "gather": "gather", "duo": "duo", "resize": "resize"}
# (ranks, variant) of the 3- and 4-rank launches
MORE = [(3, "main"), (3, "group3_per_group"), (4, "main"),
        (4, "group1_per_group")]


def _argv(roots, name, prefix):
    scenario, extra, _env, _cap = VARIANTS[name]
    if scenario == "duo":
        return duo_argv(roots["duo"], prefix, extra)
    return argv(roots[scenario], prefix, extra)


def _single(a, env) -> list:
    """The one-rank run (CPU) with `env` set around it: its capacity
    log."""
    with pytest.MonkeyPatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        sim = torch_engine.Simulation(parse_args(a), device="cpu",
                                      verbose=False)
        sim.run()
    return sim.capacity_log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return torch_dist.once(tmp_path_factory, "mesh_inplace_runs",
                           lambda: _runs(tmp_path_factory))


def _runs(tmp_path_factory):
    """The one-rank references in this process, then one launch each of
    2, 3 and 4 ranks, all within BUDGET_S."""
    deadline = time.monotonic() + BUDGET_S
    out = tmp_path_factory.mktemp("mesh_inplace")
    roots = {"quad": make_quad(tmp_path_factory.mktemp("quad")),
             "resize": make_quad(tmp_path_factory.mktemp("resize"),
                                 sizes=(50, 50, 400, 400)),
             "duo": make_duo(tmp_path_factory.mktemp("duo"), gens=GENS)}
    dirs, res = {}, {}
    for name in ("main", "merged", "gather", "duo", "resize"):
        d = dirs["single", name] = out / f"single_{name}"
        d.mkdir()
        res["single", name] = _single(_argv(roots, name, d / "out"),
                                      VARIANTS[name][2])
    launches = [(2, list(VARIANTS))] + [
        (k, [v for kk, v in MORE if kk == k]) for k in (3, 4)]
    for ranks, names in launches:
        todo = []
        for name in names:
            d = dirs[ranks, name] = out / f"mesh{ranks}_{name}"
            d.mkdir()
            _s, _extra, env, cap = VARIANTS[name]
            todo.append(dict(argv=_argv(roots, name, d / "out"), env=env,
                             s_cap=cap))
        got = torch_dist.launch_by(deadline, torch_dist.engine_runs, ranks,
                                   ((ranks, 1), todo))
        for i, name in enumerate(names):
            res[ranks, name] = [r[i] for r in got]
    return dict(dirs=dirs, res=res, roots=roots)


def _same_dirs(a: Path, b: Path) -> int:
    names = sorted(x.name for x in a.iterdir())
    assert names == sorted(x.name for x in b.iterdir())
    for x in names:
        assert filecmp.cmp(a / x, b / x, shallow=False), (a, b, x)
    return len(names)


def _kinds(d: Path) -> set:
    return {x.name.split(".")[-1] for x in d.iterdir()}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_two_ranks_files_identical(runs, name):
    """Each 2-rank run writes every file of its one-rank run, byte for
    byte (`.info` every generation, `.summary`, and `.int`/`.hap` where
    asked)."""
    d = runs["dirs"]
    ref = d["single", REFERENCE.get(name, "main")]
    n = _same_dirs(ref, d[2, name])
    assert n >= GENS + 2
    if VARIANTS[name][1] == MAIN:
        assert {"int", "hap", "summary", "txt"} <= _kinds(ref)


@pytest.mark.parametrize("ranks, name", MORE)
def test_more_ranks_files_identical(runs, ranks, name):
    """3 ranks (blocks of 32 of 94 rows: the last edge-padded) and 4
    ranks write the one-rank run's files."""
    d = runs["dirs"]
    _same_dirs(d["single", "main"], d[ranks, name])
    rows = runs["res"][ranks, name][0]["rows"]
    assert rows == -(-94 // ranks) and rows * ranks > 94


@pytest.mark.parametrize("ranks, name", [(2, k) for k in VARIANTS
                                         if k not in ("fresh", "resize")]
                         + MORE)
def test_in_place_on_every_rank(runs, ranks, name):
    """Every rank's capacity log agrees with the one-rank run's on which
    generations ran in place: every one of a constant-size population
    (with two populations, those whose children fit the rows the
    migration left). The probe's counts were the slots used, and (one
    population, no capacity grow) population 1's planes kept their
    address: the children went over each rank's own block."""
    logs = [r["log"] for r in runs["res"][ranks, name]]
    assert all(log == logs[0] for log in logs)
    ref = runs["res"]["single", REFERENCE.get(name, "main")]
    assert [c["in_place"] for c in logs[0]] == [c["in_place"] for c in ref]
    assert all(c["seg_need"] == c["seg_used"] for c in logs[0])
    per_group = VARIANTS[name][2].get("GE_PLAN_PER_GROUP") == "1"
    assert all(c["per_group"] == per_group for c in logs[0])
    if name == "duo":
        assert len(logs[0]) == 2 * GENS and logs[0][0]["in_place"]
    else:
        assert len(logs[0]) == GENS and all(c["in_place"] for c in logs[0])
    if name == "grow":  # a generation outgrew the cut capacity
        assert logs[0][-1]["s_cap"] > 3
        assert any(c["seg_need"] > 3 for c in logs[0])
    elif name != "duo":
        for r in runs["res"][ranks, name]:
            assert len(set(r["ptrs"])) == 1
    exchanged = runs["res"][ranks, name][0]["traffic"]
    assert exchanged["calls"] > 0 and exchanged["bytes"] > 0


def test_fresh_planes_where_the_rows_change(runs):
    """Under GE_NO_INPLACE_REPRO=1 every generation, and in a resize
    schedule (50 -> 400) the resize generation alone, take fresh planes
    on every rank: the planes move at those generations only."""
    for r in runs["res"][2, "fresh"]:
        assert not any(c["in_place"] for c in r["log"])
        assert all(a != b for a, b in zip(r["ptrs"], r["ptrs"][1:]))
    for r in runs["res"][2, "resize"]:
        assert [c["in_place"] for c in r["log"]] == [True, True, False, True]
        p = r["ptrs"]
        assert p[0] == p[1] != p[2] == p[3]


def test_groups_exchange_the_generation_fetch_bytes(runs):
    """A group at a time moves the rows of the whole generation's fetch,
    a group's slabs in each exchange: per rank the in-place runs exchange
    exactly the fresh-plane run's bytes (its probe fetches nothing, its
    real pass every chromosome at once) in more calls."""
    for rank in range(2):
        fresh = runs["res"][2, "fresh"][rank]["traffic"]
        for name in ("main", "group1_per_group", "group3_whole_plan"):
            got = runs["res"][2, name][rank]["traffic"]
            assert got["calls"] > fresh["calls"]
            assert got["bytes"] == fresh["bytes"]


# ------------------------------------------------ the owner-side probe
def _blocks(x: torch.Tensor, ind: int, r: int) -> torch.Tensor:
    """Rank r's block of the rows (axis 1) of a full plane or plan,
    edge-padded as `Simulation._own` holds it."""
    rows = x.shape[1]
    b = -(-rows // ind)
    idx = torch.arange(r * b, (r + 1) * b).clamp_(max=rows - 1)
    return x.index_select(1, idx)


@pytest.fixture(scope="module")
def evolved(tmp_path_factory):
    """A one-rank `Simulation` after 4 generations of the quad scenario
    (ledgers with crossovers, mutations carried)."""
    root = make_quad(tmp_path_factory.mktemp("quad_probe"))
    sim = torch_engine.Simulation(
        parse_args(argv(root, tmp_path_factory.mktemp("o") / "out")),
        device="cpu", verbose=False)
    sim.run()
    return sim


@pytest.mark.parametrize("ind", [2, 3, 4])
@pytest.mark.parametrize("per_group", [False, True])
def test_owner_side_probe_equals_fetched_count(evolved, ind, per_group):
    """On the same parents, plan and planes, the probe counted on the
    parents' ranks (`_owned_gametes`: each gamete on its parent's rank)
    gives, number for number, the largest counts over the ranks of the
    seed tree's probe, which counted on the children's ranks from the
    parents' rows fetched to them, and both equal the one-rank count. One
    case makes a rank hold no parent at all."""
    sim = evolved
    p = sim.pops[0]
    st = p.state
    rows, n = sim._rows(st), st.n
    rng = np.random.default_rng(ind)
    cases = [rng.integers(0, n, size=(2, rows))]
    cases.append(np.minimum(cases[0], rows // ind - 1))  # rank 0's rows
    groups = [(0, 2), (2, 4)] if per_group else [(0, 4)]
    for par in cases:
        parents = torch.as_tensor(par, dtype=torch.int32)
        whole = [sim._probe_counts(st.seg_st[c0:c1], st.mut[c0:c1], parents,
                                   sim._plan(p, 1, rows, c0, c1))
                 for c0, c1 in groups]
        owner, fetched = [], []
        sim._ind = ind
        try:
            for r in range(ind):
                sim._me = r
                owned = sim._owned_gametes(parents, rows)
                wants, local = sim._wants(parents, rows)
                for c0, c1 in groups:
                    plan = sim._plan(p, 1, rows, c0, c1)
                    owner.append(sim._probe_counts(
                        _blocks(st.seg_st[c0:c1], ind, r),
                        _blocks(st.mut[c0:c1], ind, r), parents, plan,
                        owned))
                    fetched.append(sim._probe_counts(
                        st.seg_st[c0:c1][:, wants[r].long()],
                        st.mut[c0:c1][:, wants[r].long()], local,
                        tuple(_blocks(x, ind, r) for x in plan)))
                if par is cases[1] and r:
                    assert owned == ()
        finally:
            sim._ind, sim._me = 1, 0

        def top(counts):
            return [int(max(c[k] for c in counts)) for k in (0, 1)]

        assert top(owner) == top(fetched) == top(whole)
        assert top(whole)[0] > 2 and top(whole)[1] > 0


# ------------------------------------------------------- the reckoning
# the smoke's Table 3.1 capacities (3 generations), 78.6 GiB free
TABLE31 = dict(nchr=22, founder_haps=20_000, n_pop=1, c_all=100,
               ncv_pad=100, s_cap=37, m_cap=22, xo_cap=23, mn_cap=11,
               hap_bytes=2)
FREE = int(78.6 * (1 << 30))


def _rows(n):
    return n + 4 * int(np.sqrt(n)) + 16


def _largest_n(ind: int) -> int:
    base = memory.Sizes(pop_rows=(1,), ind=ind, **TABLE31)

    def admits(n):
        plan = memory.reckon(dataclasses.replace(base, pop_rows=(_rows(n),)),
                             FREE)
        return plan.resident_cv and plan.need <= FREE

    lo, hi = 1, 1 << 30
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if admits(mid) else (lo, mid)
    return lo


def test_reckoning_mesh_admits_more():
    """In place on the mesh a rank holds its block once: the largest
    population the resident path admits is at least 1.5x one card's on 2
    ranks and 2.8x on 4 (fresh planes admitted 1,937,255 and 3,377,172
    against 3,949,472)."""
    one = _largest_n(1)
    assert one == 3_949_472
    assert _largest_n(2) >= 1.5 * one
    assert _largest_n(4) >= 2.8 * one


def test_reckoning_mesh_in_place_per_rank():
    """At 300,000 and 1e6 two ranks reckon in place, each below one card's
    need; the need covers a group's exchange (above half of one card's)."""
    for n in (300_000, 1_000_000):
        one = memory.reckon(memory.Sizes(pop_rows=(_rows(n),), **TABLE31),
                            FREE)
        two = memory.reckon(memory.Sizes(pop_rows=(_rows(n),), ind=2,
                                         **TABLE31), FREE)
        assert two.in_place and two.resident_cv and two.per_group
        assert one.need / 2 < two.need < one.need


def _fresh_seed_tree(sz: memory.Sizes):
    """The seed tree's fresh-plane reckoning (one population): (resident,
    gather) bytes."""
    nchr, rows_all = sz.nchr, max(sz.pop_rows)
    row_state = nchr * 2 * (sz.s_cap * (4 + sz.hap_bytes) + sz.m_cap * 4)
    loc = [-(-r // sz.ind) for r in sz.pop_rows]
    rows = max(loc)
    state = [r * row_state for r in loc]
    both = [a + nchr * r * 2 * sz.c_all for a, r in zip(state, loc)]
    plan = memory.plan_bytes(nchr, rows_all, sz.xo_cap, sz.mn_cap)
    rt = min(rows, memory.Switches().chunk_rows(rows))
    cv_t = 48 * rt * sz.c_all + 2 * rows * (4 * sz.m_cap + sz.c_all)
    mut_t = 8 * rt * (2 * sz.m_cap + sz.mn_cap) * 8
    painted = nchr * (rows * 2 + sz.founder_haps) * sz.c_all
    fetched = 0 if sz.ind == 1 else max(min(2 * a, b)
                                        for a, b in zip(loc, sz.pop_rows))
    return (sum(both) + max(both) + plan + cv_t
            + fetched * (row_state + nchr * 2 * sz.c_all),
            sum(state) + max(state) + plan + painted + fetched * row_state
            + mut_t)


@pytest.mark.parametrize("ind", [1, 2, 4])
def test_reckoning_fresh_unchanged_for_resize(ind):
    """A schedule that resizes reckons fresh planes, with the parents'
    fetch under a mesh, exactly as the seed tree did."""
    for n in (30_000, 300_000, 1_000_000):
        sz = memory.Sizes(pop_rows=(_rows(n),), ind=ind, constant=False,
                          **TABLE31)
        got = memory.reckon(sz, FREE)
        assert not got.in_place
        assert (got.need_resident, got.need_gather) == _fresh_seed_tree(sz)


# ----------------------------------------------------------- migration
def test_migration_chunks_files_identical(runs, tmp_path, monkeypatch):
    """The migration moves rows into planes allocated once, in chunks of
    `memory.MIGRATION_CHUNK` rows: at 7 rows a chunk (a part of ~45
    stayers in 7 chunks) the two-population run writes the same bytes as
    at the default (one chunk a part)."""
    monkeypatch.setattr(memory, "MIGRATION_CHUNK", 7)
    _single(duo_argv(runs["roots"]["duo"], tmp_path / "out",
                     ["--out_interval"]), {})
    _same_dirs(runs["dirs"]["single", "duo"], tmp_path)
