"""Inverse-CDF bins of the samplers: `min(searchsorted(cum, u, right), K-1)`
for C stacked CDFs (one per chromosome) in one launch; one CDF is C = 1.

CUDA kernel: `csrc/cdf_bins.cu` (replaces geneevolve_tpu/ops/
cdf_bins_pallas.py `searchsorted_right`). The kernel only maps `u` to
bins; `u` itself comes from the same torch expression on both paths
(`core/segments.py:_probes`), so the two paths agree bit for
bit on the bins.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.ops import _build

MAX_K = 227 * 1024 // 4  # CDF entries a block's shared memory holds


def cdf_bins_plain(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    rows = u.reshape(cum.shape[0], -1).contiguous()
    bins = torch.searchsorted(cum, rows, right=True).reshape(u.shape)
    return bins.clamp_max(cum.shape[1] - 1).to(torch.int32)


def cdf_bins(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """(shape of u) int32 bins of C stacked f32 CDFs `cum` (C, K), row c
    serving `u[c]` (u of shape (C, ...))."""
    if u.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("cdf_bins takes float32 u and cum")
    if cum.dim() != 2 or cum.shape[1] < 1:
        raise ValueError("cum must be a (C, K) tensor with K >= 1")
    if u.dim() < 1 or u.shape[0] != cum.shape[0]:
        raise ValueError("stacked cum (C, K) needs u of shape (C, ...)")
    if u.device.type == "cpu":
        return cdf_bins_plain(u, cum)
    if u.device.type != "cuda" or cum.device != u.device:
        raise ValueError("cdf_bins: u and cum must lie on one CUDA device")
    C, K = cum.shape
    if K > MAX_K or C > 65535:
        raise ValueError(f"cdf_bins: {C} CDFs of {K} entries exceed the "
                         f"kernel's {MAX_K} entries / 65535 rows")
    u = u.contiguous()
    cum = cum.contiguous()
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    code = _build.lib().ge_cdf_bins(
        u.data_ptr(), cum.data_ptr(), out.data_ptr(), C, u.numel() // C, K,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(code, "cdf_bins")
    cdf_bins.launches += 1
    return out


cdf_bins.launches = 0  # kernel launches since the last reset
