"""The paint kernel's launch plan (`ops/paint.launch_plan`), a pure function
of the shapes, on the CPU: at the port's two real shapes and at edge
shapes its blocks and warps cover every (chromosome, chromatid row, locus)
exactly once by the kernel's own index arithmetic, its shared memory holds
what the kernel stages, and what the card cannot run is refused."""

import numpy as np
import pytest
import torch

from geneevolve_tpu_torch.ops import paint as tpaint

# name -> (C, rows, S, M, Q): one full-width chromosome and the gather
# path's 22 x 100 CVs (the segment slice's ledgers), and edge shapes
SHAPES = {
    "full_width": (1, 29_978, 49, 27, 14_588),
    "all_22": (22, 29_978, 49, 27, 14_588),
    "gather_path": (22, 30_708, 49, 27, 100),
    "fewer_rows_than_warps": (2, 3, 49, 27, 300),
    "one_row": (1, 1, 1, 0, 1),
    "span_exact": (1, 100, 9, 5, tpaint.SPAN),
    "span_plus_one": (3, 61, 9, 5, tpaint.SPAN + 1),
    "two_rows_a_warp": (1, 9_000, 49, 27, 100),
    "s800": (1, 9, 800, 10, 600),
    "wide_ledger": (1, 50, 7_000, 30, 5_000),  # fewer warps a block
}


def _cover(plan, C, rows, Q):
    """How often each chromatid row and each locus is painted: block x
    paints rows [x * rows_per_block, (x + 1) * rows_per_block) below the
    row count, its warp w rows w, w + warps, ... of them; block y paints
    loci [y * span, (y + 1) * span) cut at Q. The grid is their
    product over chromosomes, so a (chromosome, row, locus) is painted as
    often as its row times its locus."""
    rows2 = 2 * rows
    per_row = np.zeros(rows2, dtype=np.int64)
    for x in range(plan.blocks):
        g0 = x * plan.rows_per_block
        g1 = min(g0 + plan.rows_per_block, rows2)
        for w in range(plan.warps):
            per_row[g0 + w:g1:plan.warps] += 1
    per_locus = np.zeros(Q, dtype=np.int64)
    for y in range(plan.spans):
        per_locus[y * plan.span:min(Q, (y + 1) * plan.span)] += 1
    return per_row, per_locus


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_covers_every_row_and_locus_once(name):
    C, rows, S, M, Q = SHAPES[name]
    plan = tpaint.launch_plan(C, rows, S, M, Q)
    per_row, per_locus = _cover(plan, C, rows, Q)
    assert (per_row == 1).all() and (per_locus == 1).all()
    assert plan.spans <= tpaint.GRID_LIMIT and C <= tpaint.GRID_LIMIT
    # the last row group is not empty: no block launches for nothing
    assert (plan.blocks - 1) * plan.rows_per_block < 2 * rows


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_shared_memory_holds_the_staging(name):
    """The span's positions and, for each warp, one staged row (run
    boundaries and haps, S + 2 each; mutation ranges, M + 2 each; int32),
    each region 16-byte aligned."""
    C, rows, S, M, Q = SHAPES[name]
    plan = tpaint.launch_plan(C, rows, S, M, Q)
    words = 2 * S + 2 * M + 8
    assert plan.warp_words >= words and plan.warp_words % 4 == 0
    need = 4 * (-(-min(plan.span, Q) // 4) * 4 + plan.warps * plan.warp_words)
    assert plan.smem == need <= tpaint.SMEM_LIMIT
    assert plan.warps in (1, 2, 4, 8)
    if plan.warps < tpaint.WARPS:  # the next wider block would not fit
        assert need + plan.warps * 4 * plan.warp_words > tpaint.SMEM_LIMIT


def test_plan_real_shapes():
    """At the real shapes: 8-warp blocks; at full width one span's blocks
    outnumber the blocks the card holds at once (so the blocks in flight
    read one span's slab of the panel), and a warp loops over several
    rows; the S 800 ledger needs more than 48 KB."""
    for name in ("full_width", "all_22", "gather_path"):
        plan = tpaint.launch_plan(*SHAPES[name])
        assert plan.warps == 8
        assert plan.blocks >= tpaint.BLOCKS_IN_FLIGHT
        assert plan.rows_per_block // plan.warps > 1
    assert tpaint.launch_plan(*SHAPES["s800"]).smem > 48 * 1024
    assert tpaint.launch_plan(*SHAPES["wide_ledger"]).warps < 8


@pytest.mark.parametrize("shape, what", [
    ((1, 10, 1 << 20, 5, 100), "S"),
    ((1, 10, 9, 1 << 20, 100), "M"),
    ((65_536, 10, 9, 5, 100), "grid"),
    ((1, 10, 9, 5, tpaint.SPAN * 65_535 + 1), "grid"),
    ((1, 10, 30_000, 5, 100), "shared memory"),  # 240 KB for one warp
    ((1, 10, 9, 5, 0), "empty"),
    ((1, 0, 9, 5, 10), "empty"),
])
def test_plan_refuses_what_the_card_cannot_run(shape, what):
    with pytest.raises(ValueError, match=what):
        tpaint.launch_plan(*shape)


def test_span_paths():
    """How the kernel paints each span: runs where it is longer than
    `LOCUS_SPAN` and its positions do not descend inside it (the edges
    between spans do not count); else a lane 4 loci."""
    pos = torch.arange(6200, dtype=torch.int32).repeat(3, 1)
    pos[0, 2048:4096] = pos[0, 2048:4096].flip(0)  # span 1 descends
    pos[1, 2047] = 10**6  # a step down at the span edge only
    pos[1, 4100] = pos[1, 4101]  # a repeat: still ascending
    name = lambda t: [[tpaint.PATHS[i] for i in r] for r in t.tolist()]
    got = name(tpaint.span_paths(pos, 2048))  # the last span: 56 loci
    assert got == [["runs", "loci", "runs", "loci"],
                   ["runs", "runs", "runs", "loci"],
                   ["runs", "runs", "runs", "loci"]]
    longer = torch.arange(2048 * 3 + tpaint.LOCUS_SPAN + 1,
                          dtype=torch.int32)[None]
    assert name(tpaint.span_paths(longer, 2048)) == [["runs"] * 4]
    assert name(tpaint.span_paths(pos[:, :100], 2048)) == [["loci"]] * 3


def test_card_cases_reach_both_paths():
    """The card test's paint cases (`tests/test_torch_cuda.py`) paint spans
    by runs and a lane 4 loci, both within one span and across several:
    their positions, made as the card test makes them, reach both
    paths."""
    import numpy as np
    from torch_cases import PAINT_CASES, paint_case

    seen = set()
    for case in PAINT_CASES:
        pos = torch.as_tensor(paint_case(*case)[-1])
        paths = tpaint.span_paths(pos, tpaint.SPAN)
        seen |= {(tpaint.PATHS[i], pos.shape[1] > tpaint.SPAN)
                 for i in np.unique(paths.numpy())}
    assert seen == {(p, wide) for p in tpaint.PATHS for wide in (0, 1)}
