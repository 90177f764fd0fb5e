"""Genotype painting over C stacked chromosomes in one launch: the founder
allele under each (row, chromatid, locus), flipped where the chromatid
carries a mutation at that locus.

CUDA kernel: `csrc/paint.cu` (replaces the XLA functions geneevolve_tpu/
core/output.py `_paint_chunk` and core/engine.py `_ad_all`, both built on
core/segments.py `hap_at` and `mutation_flip_mask`). The port paints
genotype output with it (`core/output.py`, one launch a chunk of rows and
loci) and the CV columns of the gather A/D path (`core/engine.py`, one
launch over every chromosome a phenotype). Integer math only: the kernel
equals the plain version bit for bit. `launch_plan` sizes a launch from
the shapes alone; the wrapper keeps the last one as `paint.plan`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build

# bytes the plain version's (rows, 2, Q, S) compare may take at once
PLAIN_CHUNK_BYTES = 1 << 28

SPAN = 4096  # loci a block paints of each row (output chunks its multiples)
LOCUS_SPAN = 256  # spans this short: a lane 4 loci (GE_PAINT_LOCUS_SPAN)
WARPS = 8  # warps a block, at most
MAX_ROWS_PER_WARP = 16
# blocks of 8 warps the H100's 132 SMs hold at once (2,048 threads an SM)
BLOCKS_IN_FLIGHT = 132 * 8
SMEM_LIMIT = 227 * 1024 - 64  # a block's shared memory, less the static
GRID_LIMIT = 65_535  # grid y (spans) and z (chromosomes)
SLOT_LIMIT = 1 << 20  # S and M below this
PATHS = ("loci", "runs")  # `span_paths`' codes


@dataclass(frozen=True)
class PaintPlan:
    """One launch: a grid of (`blocks` row groups, `spans`, C) blocks of
    `warps` warps. Block (x, y, z) paints rows [x * rows_per_block, (x + 1)
    * rows_per_block) of chromosome z over loci [y * span, (y + 1) * span)
    (cut at Q); its warp w takes the rows w, w + warps, ... of the group.
    `warp_words`: int32 words of shared memory a warp (a staged row: run
    boundaries or starts, haps, mutation ranges); `smem`: bytes in all,
    the span's positions first, each region 16-byte aligned."""

    span: int
    spans: int
    warps: int
    rows_per_block: int
    blocks: int
    warp_words: int
    smem: int


def _up4(x: int) -> int:
    return -(-x // 4) * 4


def launch_plan(C: int, rows: int, S: int, M: int, Q: int) -> PaintPlan:
    """The launch for (C, rows, 2, S) ledgers, (C, rows, 2, M) mutations
    and Q positions. Rows a warp: enough row groups that a span's blocks
    fill the card (the blocks in flight then read one span's slab of the
    panel), at most `MAX_ROWS_PER_WARP`. Warps a block: the most of 8, 4,
    2, 1 whose shared memory fits. Raises ValueError for what the card
    cannot run: S or M of 2^20 or more, more than 65,535 spans or
    chromosomes, past 227 KB of shared memory."""
    if S >= SLOT_LIMIT or M >= SLOT_LIMIT:
        raise ValueError(f"paint: S {S} or M {M} not below 2^20")
    if min(C, rows, Q) < 1 or min(S, M) < 0:
        raise ValueError("paint: empty launch")
    span = SPAN
    spans = -(-Q // span)
    if C > GRID_LIMIT or spans > GRID_LIMIT:
        raise ValueError(f"paint: {C} chromosomes x {spans} spans exceed "
                         f"the grid limit {GRID_LIMIT}")
    words = _up4(2 * S + 2 * M + 8)  # a staged row
    staged = 4 * _up4(min(span, Q))
    warps = WARPS
    while warps > 1 and staged + warps * 4 * words > SMEM_LIMIT:
        warps //= 2
    smem = staged + warps * 4 * words
    if smem > SMEM_LIMIT:
        raise ValueError(f"paint: {smem} bytes of shared memory a block, "
                         f"{SMEM_LIMIT} at most")
    rows2 = 2 * rows
    rows_per_warp = max(1, min(MAX_ROWS_PER_WARP,
                               rows2 // (warps * BLOCKS_IN_FLIGHT)))
    rpb = warps * rows_per_warp
    return PaintPlan(span=span, spans=spans, warps=warps, rows_per_block=rpb,
                     blocks=-(-rows2 // rpb), warp_words=words, smem=smem)


def span_paths(pos: torch.Tensor, span: int) -> torch.Tensor:
    """(C, spans) int8: how the kernel paints each span of `span` loci, by
    its own test, as an index into `PATHS`: "runs" where the positions
    ascend (no step down inside the span) and the span is longer than
    `LOCUS_SPAN`, else "loci" (a lane 4 loci)."""
    C, Q = pos.shape
    spans = -(-Q // span)
    down = torch.zeros((C, spans * span), dtype=torch.bool,
                       device=pos.device)
    down[:, :Q - 1] = pos[:, 1:] < pos[:, :-1]
    down[:, span - 1::span] = False  # a span's last locus has no next
    asc = ~down.view(C, spans, span).any(-1)
    n = (Q - torch.arange(spans, device=pos.device) * span).clamp(max=span)
    return (asc & (n > LOCUS_SPAN)).to(torch.int8)


def paint_plain(seg_st, seg_hap, mut, founder, pos) -> torch.Tensor:
    """The kernel's function in plain torch: `segments.hap_at` and
    `segments.mutation_flip_mask` per chromosome, over chunks of rows so
    that the (rows, 2, Q, max(S, M)) compares stay near
    `PLAIN_CHUNK_BYTES`. Hap indices are clamped into the panel, as the
    JAX gather clamps them."""
    C, rows, _, S = seg_st.shape
    H, Q = founder.shape[1:]
    out = torch.empty((C, rows, 2, Q), dtype=torch.uint8,
                      device=seg_st.device)
    step = max(1, PLAIN_CHUNK_BYTES // max(1, 2 * Q * max(S, mut.shape[-1])))
    cols = torch.arange(Q, device=seg_st.device)
    for c in range(C):
        for r0 in range(0, rows, step):
            sl = slice(r0, r0 + step)
            hap = segments.hap_at(seg_st[c, sl], seg_hap[c, sl], pos[c])
            f = founder[c][hap.long().clamp(0, H - 1), cols]
            flip = segments.mutation_flip_mask(mut[c, sl], pos[c])
            out[c, sl] = torch.where(flip, 1 - f, f)
    return out


def _check(seg_st, seg_hap, mut, founder, pos) -> None:
    ts = (seg_st, seg_hap, mut, founder, pos)
    dev = seg_st.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("paint: all tensors must lie on one CUDA device")
    if (seg_st.dtype != torch.int32 or mut.dtype != torch.int32
            or pos.dtype != torch.int32 or founder.dtype != torch.uint8
            or seg_hap.dtype not in (torch.int16, torch.int32)):
        raise TypeError("paint takes int32 starts, mutations and positions, "
                        "int16 or int32 haps and a uint8 panel")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paint takes contiguous tensors")
    if seg_st.dim() != 4 or mut.dim() != 4 or founder.dim() != 3 \
            or pos.dim() != 2:
        raise ValueError("paint: shape mismatch")
    C, rows, two, _ = seg_st.shape
    if (two != 2 or seg_hap.shape != seg_st.shape
            or mut.shape[:3] != seg_st.shape[:3] or founder.shape[0] != C
            or pos.shape != (C, founder.shape[2])):
        raise ValueError("paint: shape mismatch")


def paint(
    seg_st: torch.Tensor,  # (C, rows, 2, S) int32, ascending, BIG padded
    seg_hap: torch.Tensor,  # (C, rows, 2, S) int16 / int32
    mut: torch.Tensor,  # (C, rows, 2, M) int32, ascending, BIG padded
    founder: torch.Tensor,  # (C, H, Q) uint8 founder panel
    pos: torch.Tensor,  # (C, Q) int32 positions painted
) -> torch.Tensor:
    """(C, rows, 2, Q) uint8 painted alleles: `where(flip, 1 - f, f)` with
    `f = founder[c, hap_at(...), j]` and `flip = mutation_flip_mask(...)`,
    the JAX `_paint_chunk` with a leading chromosome axis."""
    if seg_st.device.type == "cpu":
        return paint_plain(seg_st, seg_hap, mut, founder, pos)
    _check(seg_st, seg_hap, mut, founder, pos)
    C, rows, _, S = seg_st.shape
    H, Q = founder.shape[1:]
    out = torch.empty((C, rows, 2, Q), dtype=torch.uint8,
                      device=seg_st.device)
    if out.numel() == 0:
        return out
    M = mut.shape[-1]
    plan = launch_plan(C, rows, S, M, Q)
    code = _build.lib().ge_paint(
        seg_st.data_ptr(), seg_hap.data_ptr(), seg_hap.element_size(),
        mut.data_ptr(), founder.data_ptr(), pos.data_ptr(), out.data_ptr(),
        C, rows, S, M, H, Q, segments.BIG, plan.span, plan.warps,
        plan.rows_per_block, plan.blocks, plan.warp_words, plan.smem,
        torch.cuda.current_stream(seg_st.device).cuda_stream,
    )
    _build.check(code, "paint")
    paint.launches += 1
    paint.plan = plan
    return out


paint.launches = 0  # kernel launches since the last reset
paint.plan = None  # the last launch's PaintPlan
