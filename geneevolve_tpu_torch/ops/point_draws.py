"""The segment sampler's points from its random draws: C stacked
chromosomes' Poisson counts, uniforms and within-bin uniforms to their
BIG-padded int32 positions in one launch.

CUDA kernel: `csrc/point_draws.cu`, a thread a row (a warp a row past 32
slots). It ports no TPU
kernel: it fuses the plain chain that followed the draws in
`core/segments.py` (the JAX package's `sample_point_process`, XLA there):
`-log1p`, `torch.cumsum`, the gather of the denominator, the divide and
scale, `cdf_bins`'s inverse-CDF search and `_place`, ~26 launches a
chromosome and kind of draw, `torch.cumsum`'s the slowest of them (past
~2^10 rows a row it launches 512 threads on each row of 24 floats). What
bounds the kernel is bytes: a row's count, the uniforms its points read,
its positions. Its scan adds in torch.cumsum's order (`torch_scan_threads`),
and every other step is the chain's float32 arithmetic in the chain's
order, so the positions equal the plain chain's bit for bit: the
benchmark's check draws the plan again with that chain and compares every
child's ledger exactly.

The plain version, `point_draws_plain`, is that chain as the sampler ran
it, a chromosome at a time, its bins one stacked `segments.cdf_bins` call.
"""

from __future__ import annotations

import numpy as np
import torch

from geneevolve_tpu_torch.ops import _build

MAX_CHR = 64  # chromosomes a launch (`PD_CHR`); more take several launches
THREADS = 256  # a block (`PD_THREADS`): a row a thread, or a row a warp
SMEM_MAX = 227 * 1024  # shared memory one block may opt in to


def torch_scan_threads(num_rows: int, row_size: int) -> int:
    """The threads torch's CUDA `cumsum` puts on a row of a (num_rows,
    row_size) tensor; it scans a row in chunks of twice as many slots, each
    a Sklansky tree. `get_log_num_threads_x_inner_scan<uint32_t>` in
    `ATen/native/cuda/ScanUtils.cuh`, whose difference of logs is unsigned:
    past ~2^10 rows a slot of row it wraps, and the clamp gives 512."""
    log_x = int(row_size - 1).bit_length()
    log_y = int(num_rows - 1).bit_length()
    log_x = ((9 + log_x - log_y) % (1 << 32)) // 2
    return 1 << min(max(4, log_x), 9)


def point_draws_plain(counts, unif, v, cum, bp, width, live, inclusive,
                      bp0=None, bp_step=None):
    """`point_draws` as plain torch ops, the chain the kernel fuses."""
    from geneevolve_tpu_torch.core import segments

    C, n, cap = v.shape
    out = torch.empty((C, n, cap), dtype=torch.int32, device=v.device)
    u = torch.zeros((C, n, cap), dtype=torch.float32, device=v.device)
    k = [None] * C
    for c in range(C):
        if live[c]:
            k[c] = counts[c].clamp_max(cap).long()
            s = torch.cumsum(-torch.log1p(-unif[c]), dim=1)
            denom = s.gather(1, k[c][:, None])
            u[c] = s[:, :cap] / torch.clamp(denom, min=1e-30) * cum[c][-1]
    bins = segments.cdf_bins(u, cum) if any(live) else None
    for c in range(C):
        if live[c]:
            out[c] = segments._place(
                v[c], k[c], bins[c], bp[c], float(width[c]), inclusive,
                None if bp0 is None else int(bp0[c]),
                None if bp_step is None else int(bp_step[c]))
        else:
            out[c] = segments.BIG
    return out


def point_draws(counts: torch.Tensor, unif: torch.Tensor, v: torch.Tensor,
                cum: torch.Tensor, bp: torch.Tensor, width, live,
                inclusive: bool, bp0=None, bp_step=None) -> torch.Tensor:
    """(C, n, cap) int32 positions, BIG-padded, of C chromosomes' draws:
    `counts` (C, n) as `torch.poisson` returns them, `unif` (C, n, cap + 1)
    and `v` (C, n, cap) uniforms, over the f32 CDFs `cum` (C, K) and the
    anchors `bp` (C, K) or, when given, `bp0[c] + k * bp_step[c]`;
    `width[c]` the crossover offset's span, `inclusive` the mutation
    convention, `live[c]` False for a chromosome of rate 0 (no draws, all
    BIG)."""
    C, n, cap = v.shape
    f32 = torch.float32
    if any(t.dtype != f32 for t in (counts, unif, v, cum)):
        raise TypeError("point_draws takes float32 draws and CDFs")
    if (counts.shape != (C, n) or unif.shape != (C, n, cap + 1)
            or cum.dim() != 2 or cum.shape[0] != C or cum.shape[1] < 1
            or len(width) != C or len(live) != C):
        raise ValueError("point_draws: shape mismatch")
    if bp0 is None and (bp.shape != cum.shape or bp.dtype != torch.int32):
        raise ValueError("point_draws: bp must be int32 of cum's shape")
    if v.device.type == "cpu":
        return point_draws_plain(counts, unif, v, cum, bp, width, live,
                                 inclusive, bp0, bp_step)
    out = torch.empty((C, n, cap), dtype=torch.int32, device=v.device)
    used = [counts, unif, v, cum, out] + ([bp] if bp0 is None else [])
    if v.device.type != "cuda" or any(t.device != v.device for t in used):
        raise ValueError("point_draws: all tensors must lie on one CUDA "
                         "device")
    if n == 1:
        raise ValueError("point_draws: torch scans a single row with cub, "
                         "whose order the kernel does not follow")
    K = cum.shape[1]
    R = cap + 1
    # the CDF, then the block's staged positions (or its warps' rows)
    rows = THREADS * cap if R <= 32 else THREADS // 32 * R
    if 4 * (-(-K // 4) * 4 + rows) > SMEM_MAX:
        raise ValueError(f"point_draws: CDFs of {K} entries and rows of {R} "
                         "slots exceed a block's shared memory")
    from geneevolve_tpu_torch.core.segments import BIG

    if not all(t.is_contiguous() for t in used):
        raise ValueError("point_draws: operands must be contiguous")
    affine = bp0 is not None
    host = dict(
        bp0=np.ascontiguousarray(bp0 if affine else np.zeros(C), np.int32),
        step=np.ascontiguousarray(bp_step if affine else np.zeros(C),
                                  np.int32),
        width=np.ascontiguousarray(width, np.float32),
        live=np.ascontiguousarray(live, np.int32))
    code = _build.lib().ge_point_draws(
        counts.data_ptr(), unif.data_ptr(), v.data_ptr(), cum.data_ptr(),
        None if affine else bp.data_ptr(), out.data_ptr(),
        *(a.ctypes.data for a in host.values()), C, n, cap, K,
        2 * torch_scan_threads(n, R), int(affine), int(inclusive), BIG,
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    _build.check(code, "point_draws")
    point_draws.launches += -(-C // MAX_CHR)
    return out


point_draws.launches = 0  # kernel launches since the last reset
