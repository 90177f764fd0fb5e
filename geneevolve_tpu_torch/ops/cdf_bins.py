"""Inverse-CDF bins of the samplers: `min(searchsorted(cum, u, right), K-1)`.

CUDA kernel: `csrc/cdf_bins.cu` (replaces geneevolve_tpu/ops/
cdf_bins_pallas.py `searchsorted_right`). The kernel only maps `u` to
bins; `u` itself comes from the same torch expression on both paths
(`core/segments.py:sample_point_process`), so the two paths agree bit for
bit on the bins.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.ops import _build


def cdf_bins_plain(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    K = cum.shape[0]
    bins = torch.searchsorted(cum, u.contiguous(), right=True)
    return bins.clamp_max(K - 1).to(torch.int32)


def cdf_bins(u: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """(shape of u) int32 bins over one chromosome's f32 CDF `cum` (K,)."""
    if u.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError("cdf_bins takes float32 u and cum")
    if cum.dim() != 1 or cum.shape[0] < 1:
        raise ValueError("cum must be a non-empty 1-D tensor")
    if u.device.type == "cpu":
        return cdf_bins_plain(u, cum)
    if u.device.type != "cuda" or cum.device != u.device:
        raise ValueError("cdf_bins: u and cum must lie on one CUDA device")
    u = u.contiguous()
    cum = cum.contiguous()
    out = torch.empty(u.shape, dtype=torch.int32, device=u.device)
    code = _build.lib().ge_cdf_bins(
        u.data_ptr(), cum.data_ptr(), out.data_ptr(), u.numel(),
        cum.shape[0], torch.cuda.current_stream(u.device).cuda_stream,
    )
    _build.check(code, "cdf_bins")
    cdf_bins.launches += 1
    return out


cdf_bins.launches = 0  # kernel launches since the last reset
