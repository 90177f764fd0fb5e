"""A gamete's mutation inheritance and CV alleles after the ledger merge: a
group of chromosomes of one parent's gametes in one launch, written
straight into the child planes through their strides.

CUDA kernel: `csrc/gamete_inherit.cu`, one warp per gamete. It ports no
TPU kernel: it replaces the plain-torch chains of the real pass (the JAX
package's `segments.inherit_mutations` and `_make_per_chr`'s `gamete_cv`,
XLA there), which sort each gamete's rows from scratch. The plain version
is those two functions over the engine's row chunks
(`segments.in_row_chunks`); the kernel equals it bit for bit and holds no
transient, so it needs no chunks.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.core import memory, segments
from geneevolve_tpu_torch.ops import _build
from geneevolve_tpu_torch.ops.meiose_merge import SMEM_MAX
from geneevolve_tpu_torch.ops.merge_count import MAX_XO


def gamete_bytes(K: int, mn: int, Mp: int) -> int:
    """Shared memory the kernel gives one gamete (its layout in
    `csrc/gamete_inherit.cu`: sorted crossovers and de novo slots, the
    parent rows, the kept and fresh counts), rounded to 16 bytes; `mn` and
    `Mp` 0 without mutation rows."""
    return (4 * (K + 2 * mn + 1 + 4 * Mp + 2) + 15) // 16 * 16


def gamete_inherit_plain(pm, cv_rows, xo, start, new, q, out_mut, out_cv):
    nk, nc = xo.shape[:2]
    rows = memory.Switches.from_env().chunk_rows(nc)
    counts = []
    for j in range(nk):
        pmj = None if pm is None else pm[j]
        if out_mut is not None:
            m_g, nm = segments.in_row_chunks(
                segments.inherit_mutations, rows,
                (pmj, xo[j], start[j], new[j]), out_mut.shape[-1])
            out_mut[j] = m_g
            counts.append(nm)
        if out_cv is not None:
            out_cv[j] = segments.in_row_chunks(
                segments.gamete_cv, rows, (cv_rows[j], xo[j], start[j], pmj,
                                           new[j]), q[j])
    return torch.stack(counts) if counts else None


def _check(pm, cv_rows, xo, start, new, q, out_mut, out_cv) -> None:
    """Raise unless the operands are what the kernel takes."""
    name = "gamete_inherit"
    if (pm is None) != (out_mut is None) or (cv_rows is None) != (
            out_cv is None):
        raise ValueError(f"{name}: mutation rows and their output, CV rows "
                         "and theirs, come together")
    if pm is None and cv_rows is None:
        raise ValueError(f"{name}: neither mutation nor CV rows")
    used = [t for t in (pm, cv_rows, xo, start, out_mut, out_cv)
            if t is not None]
    if pm is not None:
        used.append(new)
    if cv_rows is not None:
        used.append(q)
    dev = xo.device
    if dev.type != "cuda" or any(t.device != dev for t in used):
        raise ValueError(f"{name}: all tensors must lie on one CUDA device")
    pos = [t for t in (pm, xo, start, out_mut) if t is not None]
    pos += [new] if pm is not None else []
    pos += [q] if cv_rows is not None else []
    if any(t.dtype != torch.int32 for t in pos) or any(
            t.dtype != torch.uint8 for t in (cv_rows, out_cv)
            if t is not None):
        raise TypeError(f"{name} takes int32 positions and starts, uint8 "
                        "CV alleles")
    if xo.dim() != 3 or start.dim() != 2:
        raise ValueError(f"{name}: shape mismatch")
    nk, nc, K = xo.shape
    bad = start.shape != (nk, nc)
    if pm is not None:
        bad |= (pm.dim() != 4 or pm.shape[:3] != (nk, nc, 2)
                or new.dim() != 3 or new.shape[:2] != (nk, nc)
                or out_mut.dim() != 3 or out_mut.shape[:2] != (nk, nc))
    if cv_rows is not None:
        C = cv_rows.shape[-1] if cv_rows.dim() == 4 else -1
        bad |= (cv_rows.dim() != 4 or cv_rows.shape[:3] != (nk, nc, 2)
                or q.shape != (nk, C) or out_cv.shape != (nk, nc, C))
    if bad:
        raise ValueError(f"{name}: shape mismatch")
    dense = [xo] + ([pm, new] if pm is not None else []) + (
        [cv_rows, q] if cv_rows is not None else [])
    if not all(t.is_contiguous() for t in dense) or any(
            t.stride(-1) != 1 for t in (out_mut, out_cv) if t is not None):
        raise ValueError(f"{name} takes contiguous rows and outputs whose "
                         "slots are adjacent")
    mn = new.shape[-1] if pm is not None else 0
    if K > MAX_XO or mn > MAX_XO:
        raise ValueError(f"{name}: {K} crossover or {mn} de novo slots > "
                         f"{MAX_XO}")
    need = gamete_bytes(K, mn, pm.shape[-1] if pm is not None else 0)
    if need > SMEM_MAX:
        raise ValueError(
            f"{name}: one gamete's rows (K {K}, mn {mn}, M "
            f"{pm.shape[-1]}) need {need} bytes of shared memory, more "
            f"than a block's {SMEM_MAX}")


def gamete_inherit(
    pm,  # (nk, nc, 2, Mp) int32 parent mutation rows (ascending), or None
    cv_rows,  # (nk, nc, 2, C) uint8 parent CV rows, or None
    xo: torch.Tensor,  # (nk, nc, K) int32 crossovers (BIG padded, any order)
    start: torch.Tensor,  # (nk, nc) int32 start chromatids (any strides)
    new: torch.Tensor,  # (nk, nc, mn) int32 de novo slots (any order)
    q: torch.Tensor,  # (nk, C) int32 CV positions of the nk chromosomes
    out_mut,  # (nk, nc, Mo) int32, slots adjacent, or None
    out_cv,  # (nk, nc, C) uint8, entries adjacent, or None
):
    """Write the gametes' mutation rows into `out_mut` (ascending, BIG
    padded, cut to Mo slots) and their CV alleles into `out_cv`; returns
    the (nk, nc) int32 uncapped mutation counts, or None without mutation
    rows."""
    if xo.device.type == "cpu":
        return gamete_inherit_plain(pm, cv_rows, xo, start, new, q, out_mut,
                                    out_cv)
    _check(pm, cv_rows, xo, start, new, q, out_mut, out_cv)
    nk, nc, K = xo.shape
    dev = xo.device
    has_mut = pm is not None
    counts = (torch.empty((nk, nc), dtype=torch.int32, device=dev)
              if has_mut else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    om = out_mut.stride()[:2] if has_mut else (0, 0)
    oc = out_cv.stride()[:2] if out_cv is not None else (0, 0)
    code = _build.lib().ge_gamete_inherit(
        ptr(pm), ptr(cv_rows), xo.data_ptr(), start.data_ptr(),
        ptr(new) if has_mut else None,
        ptr(q) if cv_rows is not None else None, ptr(out_mut), ptr(out_cv),
        ptr(counts), nk, nc, start.stride(0), start.stride(1), *om, *oc, K,
        new.shape[-1] if has_mut else 0, pm.shape[-1] if has_mut else 0,
        out_mut.shape[-1] if has_mut else 0,
        cv_rows.shape[-1] if cv_rows is not None else 0, segments.BIG,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "gamete_inherit")
    gamete_inherit.launches += 1
    return counts


gamete_inherit.launches = 0  # kernel launches since the last reset
