"""The capacity probe's merge-valid count: every chromosome's gametes of
both parents in one launch, parent rows read by index.

CUDA kernel: `csrc/merge_count.cu` (replaces geneevolve_tpu/ops/
merge_count_pallas.py `count_merge_valid_pallas`), one warp per gamete; it
counts copied slots with the same device code as the merge
(`csrc/common.cuh`). Integer math only: the kernel equals the plain version
bit for bit.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build

MAX_XO = 64  # crossover slots a row may have: two per lane of a warp


def parent_rows(plane: torch.Tensor, parents: torch.Tensor, g: int):
    """(nchr * nc, 2, S): parent g's rows of every chromosome's plane."""
    return plane[:, parents[g].long()].flatten(0, 1)


def merge_count_plain(seg_st, parents, xo_f, xo_m, sh) -> torch.Tensor:
    nchr, nc = xo_f.shape[:2]
    return torch.stack([
        segments.count_merge_valid(parent_rows(seg_st, parents, g),
                                   xo.flatten(0, 1), sh[:, :, g].reshape(-1))
        for g, xo in enumerate((xo_f, xo_m))
    ], -1).view(nchr, nc, 2)


def check_inputs(name, seg_st, parents, xo_f, xo_m, sh, *planes) -> None:
    """Raise unless the stacked operands are what the kernels take: one
    CUDA device, int32 positions, indices and starts, contiguous, (nchr,
    rows, 2, S) ledgers (`planes` alike), (2, nc) parents, (nchr, nc, K)
    crossovers with K <= MAX_XO and (nchr, nc, 2) starts."""
    ts = (seg_st, parents, xo_f, xo_m, sh, *planes)
    dev = seg_st.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    if any(t.dtype != torch.int32 for t in ts[:5]):
        raise TypeError(f"{name} takes int32 positions, indices and starts")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if seg_st.dim() != 4 or parents.dim() != 2 or xo_f.dim() != 3:
        raise ValueError(f"{name}: shape mismatch")
    nchr, _, two, _ = seg_st.shape
    nc, K = parents.shape[1], xo_f.shape[2]
    if (two != 2 or parents.shape[0] != 2 or xo_f.shape != (nchr, nc, K)
            or xo_m.shape != xo_f.shape or sh.shape != (nchr, nc, 2)
            or any(p.shape != seg_st.shape for p in planes)):
        raise ValueError(f"{name}: shape mismatch")
    if K > MAX_XO:
        raise ValueError(f"{name}: {K} crossover slots > {MAX_XO}")


def merge_count(
    seg_st: torch.Tensor,  # (nchr, rows, 2, S) int32 parent ledger starts
    parents: torch.Tensor,  # (2, nc) int32 father's and mother's rows
    xo_f: torch.Tensor,  # (nchr, nc, K) int32 crossovers of the father's
    xo_m: torch.Tensor,  # gametes and the mother's (BIG padded, any order)
    sh: torch.Tensor,  # (nchr, nc, 2) int32 start chromatids
) -> torch.Tensor:
    """(nchr, nc, 2) int32: ledger slots `meiose` will fill for each
    chromosome's gamete of each parent."""
    if seg_st.device.type == "cpu":
        return merge_count_plain(seg_st, parents, xo_f, xo_m, sh)
    check_inputs("merge_count", seg_st, parents, xo_f, xo_m, sh)
    nchr, rows, _, S = seg_st.shape
    nc, K = parents.shape[1], xo_f.shape[2]
    out = torch.empty((nchr, nc, 2), dtype=torch.int32, device=seg_st.device)
    code = _build.lib().ge_merge_count(
        seg_st.data_ptr(), parents.data_ptr(), xo_f.data_ptr(),
        xo_m.data_ptr(), sh.data_ptr(), out.data_ptr(), nchr, rows, nc, S, K,
        segments.BIG, torch.cuda.current_stream(seg_st.device).cuda_stream,
    )
    _build.check(code, "merge_count")
    merge_count.launches += 1
    return out


merge_count.launches = 0  # kernel launches since the last reset
