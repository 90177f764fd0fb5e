"""The capacity probe's merge-valid count, reading parent rows by index.

CUDA kernel: `csrc/merge_count.cu` (replaces geneevolve_tpu/ops/
merge_count_pallas.py `count_merge_valid_pallas`). Integer math only: the
kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build


def merge_count_plain(par_st, idx, xo, start) -> torch.Tensor:
    return segments.count_merge_valid(par_st[idx.long()], xo, start)


def merge_count(
    par_st: torch.Tensor,  # (n, 2, S) int32 parent ledger starts
    idx: torch.Tensor,  # (nc,) int32 parent row per gamete
    xo: torch.Tensor,  # (nc, K) int32 crossovers (BIG padded, any order)
    start: torch.Tensor,  # (nc,) int32 start chromatid
) -> torch.Tensor:
    """(nc,) int32: ledger slots `meiose` will fill for each gamete."""
    if par_st.device.type == "cpu":
        return merge_count_plain(par_st, idx, xo, start)
    dev = par_st.device
    if dev.type != "cuda" or any(t.device != dev for t in (idx, xo, start)):
        raise ValueError("merge_count: all tensors must lie on one CUDA device")
    for t in (par_st, idx, xo, start):
        if t.dtype != torch.int32:
            raise TypeError("merge_count takes int32 tensors")
    n, two, S = par_st.shape
    nc, K = xo.shape
    if two != 2 or idx.shape != (nc,) or start.shape != (nc,):
        raise ValueError("merge_count: shape mismatch")
    par_st, idx, xo, start = (
        t.contiguous() for t in (par_st, idx, xo, start)
    )
    out = torch.empty((nc,), dtype=torch.int32, device=dev)
    code = _build.lib().ge_merge_count(
        par_st.data_ptr(), idx.data_ptr(), xo.data_ptr(), start.data_ptr(),
        out.data_ptr(), nc, S, K, segments.BIG,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "merge_count")
    merge_count.launches += 1
    return out


merge_count.launches = 0  # kernel launches since the last reset
