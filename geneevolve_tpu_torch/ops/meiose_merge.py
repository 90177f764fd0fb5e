"""The meiosis ledger merge, one gamete per thread, reading parent rows by
index.

CUDA kernel: `csrc/meiose_merge.cu` (replaces geneevolve_tpu/core/
segments.py `meiose` -> `merge3_T`, which XLA ran as fused compare-reduces;
the JAX package's hottest op). The plain version is `segments.meiose` on
the gathered parent rows; the kernel equals it bit for bit in both
`merge_ibd` modes.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build

MAX_XO = 64  # crossover slots per row the kernel holds in registers


def meiose_merge_plain(par_st, par_hap, idx, xo, start, cap, merge_ibd):
    i = idx.long()
    return segments.meiose(par_st[i], par_hap[i], xo, start, cap, merge_ibd)


def meiose_merge(
    par_st: torch.Tensor,  # (n, 2, S) int32
    par_hap: torch.Tensor,  # (n, 2, S) int16 or int32
    idx: torch.Tensor,  # (nc,) int32 parent row per gamete
    xo: torch.Tensor,  # (nc, K) int32 crossovers (BIG padded, any order)
    start: torch.Tensor,  # (nc,) int32 start chromatid
    cap: int,
    merge_ibd: bool = True,
):
    """(child_st (nc, cap) int32, child_hap (nc, cap) hap dtype, n_valid
    (nc,) int32)."""
    if par_st.device.type == "cpu":
        return meiose_merge_plain(par_st, par_hap, idx, xo, start, cap,
                                  merge_ibd)
    dev = par_st.device
    if dev.type != "cuda" or any(
        t.device != dev for t in (par_hap, idx, xo, start)
    ):
        raise ValueError("meiose_merge: all tensors must lie on one CUDA device")
    for t in (par_st, idx, xo, start):
        if t.dtype != torch.int32:
            raise TypeError("meiose_merge takes int32 positions and indices")
    if par_hap.dtype not in (torch.int16, torch.int32):
        raise TypeError("meiose_merge takes int16 or int32 haps")
    n, two, S = par_st.shape
    nc, K = xo.shape
    if par_hap.shape != par_st.shape or two != 2 or idx.shape != (nc,) \
            or start.shape != (nc,):
        raise ValueError("meiose_merge: shape mismatch")
    if K > MAX_XO:
        raise ValueError(f"meiose_merge: {K} crossover slots > {MAX_XO}")
    par_st, par_hap, idx, xo, start = (
        t.contiguous() for t in (par_st, par_hap, idx, xo, start)
    )
    out_st = torch.empty((nc, cap), dtype=torch.int32, device=dev)
    out_hap = torch.empty((nc, cap), dtype=par_hap.dtype, device=dev)
    n_valid = torch.empty((nc,), dtype=torch.int32, device=dev)
    code = _build.lib().ge_meiose_merge(
        par_st.data_ptr(), par_hap.data_ptr(), par_hap.element_size(),
        idx.data_ptr(), xo.data_ptr(), start.data_ptr(), out_st.data_ptr(),
        out_hap.data_ptr(), n_valid.data_ptr(), nc, S, K, cap,
        int(merge_ibd), segments.BIG,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_merge")
    meiose_merge.launches += 1
    return out_st, out_hap, n_valid


meiose_merge.launches = 0  # kernel launches since the last reset
