"""Row gather `table[idx]` over raw row bytes.

CUDA kernel: `csrc/gather_rows.cu` (replaces geneevolve_tpu/ops/
materialize.py `gather_rows` / `materialize_rows`). On the main path it
gathers the parents' mutation rows and resident-CV rows for every gamete.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.ops import _build


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), *table.shape[1:]) rows of `table`, bit-identical to
    `table[idx]`."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    dev = table.device
    if dev.type != "cuda" or idx.device != dev:
        raise ValueError("gather_rows: table and idx must lie on one CUDA device")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("gather_rows takes a 1-D int32 index")
    table = table.contiguous()
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0],) + tuple(table.shape[1:]),
                      dtype=table.dtype, device=dev)
    row_bytes = table[0].numel() * table.element_size() if table.shape[0] else 0
    code = _build.lib().ge_gather_rows(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0  # kernel launches since the last reset
