"""The meiosis ledger merge: every chromosome's gametes of both parents in
one launch, parent rows read by index, written straight into the child
planes.

CUDA kernel: `csrc/meiose_merge.cu` (replaces geneevolve_tpu/core/
segments.py `meiose` -> `merge3_T`, which XLA ran as fused compare-reduces;
the JAX package's hottest op), one warp per gamete, each candidate placed
at its rank. The plain version is `segments.meiose` on the gathered parent
rows; the kernel equals it bit for bit in both `merge_ibd` modes.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.ops import _build
from geneevolve_tpu_torch.ops.merge_count import check_inputs, parent_rows

SMEM_MAX = 232_448  # shared memory one block may opt in to (227 KB)


def gamete_bytes(S: int, K: int, cap: int, hap_bytes: int) -> int:
    """Shared memory the kernel gives one gamete (its layout in
    `csrc/meiose_merge.cu`: positions, crossovers, copied masks and counts,
    output row, then the haps), rounded to 16 bytes."""
    W = (S + 31) // 32
    b = 4 * (2 * S + K + 4 * W + cap) + hap_bytes * (2 * S + cap)
    return (b + 15) // 16 * 16


def meiose_merge_plain(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap,
                       merge_ibd):
    nchr, nc = xo_f.shape[:2]
    outs = [
        segments.meiose(parent_rows(seg_st, parents, g),
                        parent_rows(seg_hap, parents, g), xo.flatten(0, 1),
                        sh[:, :, g].reshape(-1), cap, merge_ibd)
        for g, xo in enumerate((xo_f, xo_m))
    ]
    c_st, c_hap, n_valid = (torch.stack(o, 1) for o in zip(*outs))
    return (c_st.view(nchr, nc, 2, cap), c_hap.view(nchr, nc, 2, cap),
            n_valid.view(nchr, nc, 2))


def meiose_merge(
    seg_st: torch.Tensor,  # (nchr, rows, 2, S) int32 parent ledgers
    seg_hap: torch.Tensor,  # (nchr, rows, 2, S) int16 or int32
    parents: torch.Tensor,  # (2, nc) int32 father's and mother's rows
    xo_f: torch.Tensor,  # (nchr, nc, K) int32 crossovers of the father's
    xo_m: torch.Tensor,  # gametes and the mother's (BIG padded, any order)
    sh: torch.Tensor,  # (nchr, nc, 2) int32 start chromatids
    cap: int,
    merge_ibd: bool = True,
):
    """The child planes: (c_st (nchr, nc, 2, cap) int32, c_hap (nchr, nc,
    2, cap) hap dtype, n_valid (nchr, nc, 2) int32), gamete g of child i
    at [:, i, g]."""
    if seg_st.device.type == "cpu":
        return meiose_merge_plain(seg_st, seg_hap, parents, xo_f, xo_m, sh,
                                  cap, merge_ibd)
    check_inputs("meiose_merge", seg_st, parents, xo_f, xo_m, sh, seg_hap)
    if seg_hap.dtype not in (torch.int16, torch.int32):
        raise TypeError("meiose_merge takes int16 or int32 haps")
    nchr, rows, _, S = seg_st.shape
    nc, K = parents.shape[1], xo_f.shape[2]
    hb = seg_hap.element_size()
    need = gamete_bytes(S, K, cap, hb)
    if need > SMEM_MAX:
        raise ValueError(
            f"meiose_merge: one gamete's rows (S {S}, K {K}, cap {cap}) "
            f"need {need} bytes of shared memory, more than a block's "
            f"{SMEM_MAX}")
    dev = seg_st.device
    c_st = torch.empty((nchr, nc, 2, cap), dtype=torch.int32, device=dev)
    c_hap = torch.empty((nchr, nc, 2, cap), dtype=seg_hap.dtype, device=dev)
    n_valid = torch.empty((nchr, nc, 2), dtype=torch.int32, device=dev)
    code = _build.lib().ge_meiose_merge(
        seg_st.data_ptr(), seg_hap.data_ptr(), hb, parents.data_ptr(),
        xo_f.data_ptr(), xo_m.data_ptr(), sh.data_ptr(), c_st.data_ptr(),
        c_hap.data_ptr(), n_valid.data_ptr(), nchr, rows, nc, S, K, cap,
        int(merge_ibd), segments.BIG,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_merge")
    meiose_merge.launches += 1
    return c_st, c_hap, n_valid


meiose_merge.launches = 0  # kernel launches since the last reset
