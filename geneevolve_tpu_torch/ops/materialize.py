"""Row gather `table[idx]` over raw row bytes, for one table or for B
stacked ones (`table[:, idx]`) in one launch.

CUDA kernel: `csrc/gather_rows.cu` (replaces geneevolve_tpu/ops/
materialize.py `gather_rows` / `materialize_rows`). On the segment path it
gathers the parents' mutation rows and resident-CV rows of every
chromosome (`gather_rows_stacked`, 4 launches a generation); on the dense
path the parents' CV rows (`gather_rows`, the one-table case).
"""

from __future__ import annotations

import math

import torch

from geneevolve_tpu_torch.ops import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_rows_stacked_plain(table: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    return table[:, idx.long()]


def _launch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of the (B, n, *R) `table`, as a fresh (B, nc, *R)."""
    dev = table.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError("gather_rows: table and idx must lie on one CUDA "
                         "device")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("gather_rows takes a 1-D int32 index")
    table, idx = table.contiguous(), idx.contiguous()
    B, nc = table.shape[0], idx.shape[0]
    out = torch.empty((B, nc) + tuple(table.shape[2:]), dtype=table.dtype,
                      device=dev)
    es = table.element_size()
    code = _build.lib().ge_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), B, nc,
        math.prod(table.shape[2:]) * es, table.stride(0) * es,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), *table.shape[1:]) rows of `table`, bit-identical to
    `table[idx]`: the stacked kernel's one-table case."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    return _launch(table[None], idx)[0]


def gather_rows_stacked(table: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """(B, len(idx), *table.shape[2:]): rows `idx` of each of the B stacked
    tables (B, n, *R), bit-identical to `table[:, idx]`."""
    if table.device.type == "cpu":
        return gather_rows_stacked_plain(table, idx)
    return _launch(table, idx)


gather_rows.launches = 0  # kernel launches since the last reset
