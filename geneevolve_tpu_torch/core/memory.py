"""The segment engine's device memory: what a generation needs, and the
choices that follow from it (`Simulation._check_fits`, `_reproduce`).

A pure function of the run's sizes, the free bytes and the switches, so
that tests and the smoke can ask it at any size. The switches are the JAX
package's, with its defaults and meanings:

- `GE_NO_INPLACE_REPRO=1`: every generation writes its children into fresh
  planes (by default a generation that keeps the parents' row count
  writes each group of chromosomes' children over that group's parents);
- `GE_INPLACE_GROUP` (2): chromosomes a group;
- `GE_PLAN_PER_GROUP` (1 on, 0 off) and `GE_PLAN_BYTES_MAX` (1.5e9): past
  that many bytes of stacked plan the probe keeps only its counts and the
  real pass draws each group's plan again just before it uses it;
- `GE_REPRO_CHUNK` (2^18): past 2^19 children a chromosome's mutation and
  CV work runs over row chunks of this many children.

`GE_NO_INPLACE_REPRO` and `GE_PLAN_PER_GROUP` choose the regime;
`GE_INPLACE_GROUP`, `GE_PLAN_BYTES_MAX` and `GE_REPRO_CHUNK` only size it,
and are honoured for parity with the JAX package (tests set them to
drive small groups, plans and chunks).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

PLAN_BYTES_MAX = 1_500_000_000
INPLACE_GROUP = 2
REPRO_CHUNK = 1 << 18
CHUNKED_PAST = 1 << 19  # children a chromosome takes in one pass
MIGRATION_CHUNK = 1 << 13  # rows a migration moves with one row gather


@dataclass(frozen=True)
class Switches:
    in_place: bool = True
    group: int = INPLACE_GROUP
    plan_per_group: Optional[bool] = None  # None: by the plan's bytes
    plan_bytes_max: int = PLAN_BYTES_MAX
    repro_chunk: int = REPRO_CHUNK

    @staticmethod
    def from_env(env=None) -> "Switches":
        env = os.environ if env is None else env
        per = env.get("GE_PLAN_PER_GROUP")
        return Switches(
            in_place=env.get("GE_NO_INPLACE_REPRO") != "1",
            group=int(env.get("GE_INPLACE_GROUP", str(INPLACE_GROUP))),
            plan_per_group={"1": True, "0": False}.get(per),
            plan_bytes_max=int(env.get("GE_PLAN_BYTES_MAX",
                                       str(PLAN_BYTES_MAX))),
            repro_chunk=int(env.get("GE_REPRO_CHUNK", str(REPRO_CHUNK))),
        )

    def group_size(self, nchr: int) -> int:
        return max(1, min(nchr, self.group))

    def per_group(self, nchr: int, rows: int, xo_cap: int,
                  mn_cap: int) -> bool:
        """Whether a generation of `rows` plane rows draws its plan a group
        at a time (the JAX `_reproduce`'s test)."""
        if self.plan_per_group is not None:
            return self.plan_per_group
        return plan_bytes(nchr, rows, xo_cap, mn_cap) > self.plan_bytes_max

    def chunk_rows(self, nc: int) -> int:
        """Rows one pass of a chromosome's gamete work takes: all of them
        up to 2^19, else `repro_chunk`."""
        return nc if nc <= CHUNKED_PAST else max(1, self.repro_chunk)


def plan_bytes(nchr: int, rows: int, xo_cap: int, mn_cap: int) -> int:
    """Bytes of the stacked plan of `nchr` chromosomes (the JAX
    reckoning): both parents' crossovers, de novo mutations and start
    chromatids."""
    return 2 * nchr * rows * (xo_cap + mn_cap + 2) * 4


@dataclass(frozen=True)
class Sizes:
    nchr: int
    pop_rows: Tuple[int, ...]  # each population's largest plane rows
    founder_haps: int  # H, every population's together
    n_pop: int
    c_all: int  # CV columns of every phenotype (n_pheno * ncv_pad)
    ncv_pad: int
    s_cap: int
    m_cap: int
    xo_cap: int
    mn_cap: int
    hap_bytes: int
    ind: int = 1  # 'ind' ranks (a rank holds a block of every plane's rows)
    constant: bool = True  # no generation changes a population's rows


@dataclass(frozen=True)
class MemoryPlan:
    resident_cv: bool
    gather_chunk: int  # chromosomes one stacked row gather covers
    in_place: bool  # constant-size generations write over their parents
    per_group: bool  # the largest generation draws its plan a group at a time
    need: int  # bytes reckoned at the run's peak on the chosen path
    need_resident: int  # the resident path's, without the row gathers
    need_gather: int  # the gather path's, without the row gathers


def reckon(sz: Sizes, free: int, sw: Switches = Switches(),
           resident: bool = True) -> MemoryPlan:
    """The path a run takes and the bytes a rank needs at its peak.

    Fresh planes (a population's rows change, or `GE_NO_INPLACE_REPRO=1`):
    every population's state, one population's children beside it, the
    stacked plan and the CV phase's transient (plus, under a mesh, the
    parents' rows a rank fetches). In place: the states once, one group's
    children, the plan kept (a rank's rows of the whole of it, or of a
    group's under the per-group plan) and the same transient; or, while a
    plan is drawn (over every row, on every rank), the plan and one kind
    of draw's probes and bins. Under several 'ind' ranks in place, a
    group's exchange besides: its fetched parent rows (at most twice a
    rank's rows) and, while they move, the rows a rank sends (at most its
    rows once to every rank) or the received bytes beside the tables split
    from them; and while the probe counts, the columns of the gametes a
    rank holds (at most the drawn plan again). The CV phase's transient is
    the (rows, C) tensors the plain `segments.gamete_cv` holds at one time
    (its sorted searches: ~48 bytes a row and CV) over the rows of one
    chunk, and a gamete's mutation and CV rows (twice when chunked); the
    card's `ops/gamete_inherit` kernel holds none, so there it over-reckons.
    The resident CV matrix stays when its path's need fits `free` (and
    `resident` asks for it); the gather path adds the painted CV columns
    and panels, and with several populations the migration's new states
    beside the old and the founders' panels. With several populations a
    constant schedule reckons the larger of both regimes: a generation
    after a migration runs in place only when its children fit the rows
    the migration left.
    The stacked row gathers then take as many chromosomes as fit in what
    is left, down to one; in place (one population) at most a group's."""
    nchr, rows_all = sz.nchr, max(sz.pop_rows)
    ledger = 2 * (sz.s_cap * (4 + sz.hap_bytes) + sz.m_cap * 4)
    row_state = nchr * ledger
    loc = [-(-r // sz.ind) for r in sz.pop_rows]  # a rank's rows
    rows = max(loc)
    state = [r * row_state for r in loc]
    cv = [nchr * r * 2 * sz.c_all for r in loc]
    both = [a + b for a, b in zip(state, cv)]
    in_place = sw.in_place and sz.constant
    g = sw.group_size(nchr)
    per_group = sw.per_group(nchr, rows_all, sz.xo_cap, sz.mn_cap)
    plan = plan_bytes(nchr, rows_all, sz.xo_cap, sz.mn_cap)
    rt = min(rows, sw.chunk_rows(rows))
    # a chunk's (rows, C) search tensors, and a gamete's mutation and CV
    # rows with their concatenation from the chunks
    cv_t = 48 * rt * sz.c_all + 2 * rows * (4 * sz.m_cap + sz.c_all)
    mut_t = 8 * rt * (2 * sz.m_cap + sz.mn_cap) * 8
    painted = nchr * (rows * 2 + sz.founder_haps) * sz.c_all
    if sz.n_pop > 1:
        painted += nchr * (rows * 2 + sz.founder_haps) * sz.ncv_pad \
            + 16 * rows * sz.ncv_pad
    # the migration's new states beside the old, the rows it moves at once
    # (a chunk; under a mesh a part's exchange: the rows a rank sends, at
    # most its rows to every rank, and those it receives), and the
    # founders' CV and root panels
    moved = (min(rows, MIGRATION_CHUNK) if sz.ind == 1
             else (sz.ind + 1) * rows)
    migration = (2 * sum(state) + moved * row_state
                 + nchr * sz.founder_haps * (sz.c_all + sz.ncv_pad)
                 if sz.n_pop > 1 else 0)

    def fresh():
        fetched = 0 if sz.ind == 1 else max(
            min(2 * a, b) for a, b in zip(loc, sz.pop_rows))
        return (sum(both) + max(both) + plan + cv_t
                + fetched * (row_state + nchr * 2 * sz.c_all),
                max(sum(state) + max(state) + plan + painted
                    + fetched * row_state + mut_t, migration))

    def exchange(cv_bytes):
        """(held, peak): a group's fetched parent rows, and the most its
        exchange holds at once (0, 0 on one 'ind' rank)."""
        if sz.ind == 1:
            return 0, 0
        w = g * (ledger + 2 * cv_bytes)  # a row of a group's slabs
        big = g * 2 * max(4 * sz.s_cap, sz.hap_bytes * sz.s_cap,
                          4 * sz.m_cap, cv_bytes)  # its widest table
        got, sent = min(2 * rows, rows_all), sz.ind * rows
        return got * w, max(sent * (w + big), (sent + got) * w,
                            got * (2 * w + big))

    def over_parents():
        cs = g if per_group else nchr
        drawn = plan_bytes(cs, rows_all, sz.xo_cap, sz.mn_cap)
        kept = plan_bytes(cs, rows, sz.xo_cap, sz.mn_cap)
        drawing = 3 * cs * rows_all * max(sz.xo_cap, sz.mn_cap) * 4 + (
            drawn if sz.ind > 1 else 0)
        kids = g * rows * ledger
        kids_cv = g * rows * 2 * sz.c_all
        held_r, moving_r = exchange(sz.c_all)
        held_g, moving_g = exchange(0)
        return (max(sum(both) + kept + max(
                        held_r + kids + kids_cv + cv_t, moving_r),
                    sum(both) + drawn + drawing),
                max(sum(state) + kept + max(
                        held_g + kids + painted + mut_t, moving_g),
                    sum(state) + drawn + drawing, migration))

    # with several populations a generation after a migration runs in
    # place only when its children fit the rows the migration left, else
    # on fresh planes: the larger of both
    fresh_too = not in_place or sz.n_pop > 1
    needs = ([over_parents()] if in_place else []) + (
        [fresh()] if fresh_too else [])
    need_res, need_gat = (max(x) for x in zip(*needs))
    resident = resident and need_res <= free
    used = need_res if resident else need_gat
    # a chromosome's parent rows: CV rows (resident) and mutation rows
    gathered = rows * 2 * ((sz.c_all if resident else 0) + 4 * sz.m_cap)
    chunk = int(min(nchr, max(1, (free - used) // gathered)))
    return MemoryPlan(
        resident_cv=resident, gather_chunk=chunk, in_place=in_place,
        per_group=per_group,
        need=used + (chunk if fresh_too else min(g, chunk)) * gathered,
        need_resident=need_res, need_gather=need_gat)
