"""Genotype painting over C stacked chromosomes in one launch: the founder
allele under each (row, chromatid, locus), flipped where the chromatid
carries a mutation at that locus.

CUDA kernel: `csrc/paint.cu` (replaces the XLA functions geneevolve_tpu/
core/output.py `_paint_chunk` and core/engine.py `_ad_all`, both built on
core/segments.py `hap_at` and `mutation_flip_mask`). The port paints
genotype output with it (`core/output.py`, one launch a chunk of rows and
loci) and the CV columns of the gather A/D path (`core/engine.py`, one
launch over every chromosome a phenotype). Integer math only: the kernel
equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build

# bytes the plain version's (rows, 2, Q, S) compare may take at once
PLAIN_CHUNK_BYTES = 1 << 28


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
    code = _build.lib().ge_paint(
        seg_st.data_ptr(), seg_hap.data_ptr(), seg_hap.element_size(),
        mut.data_ptr(), founder.data_ptr(), pos.data_ptr(), out.data_ptr(),
        C, rows, S, mut.shape[-1], H, Q, segments.BIG,
        torch.cuda.current_stream(seg_st.device).cuda_stream,
    )
    _build.check(code, "paint")
    paint.launches += 1
    return out


paint.launches = 0  # kernel launches since the last reset
