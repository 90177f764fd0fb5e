"""Byte-plane meiosis: both gametes of every child, one uint8 per locus.

CUDA kernel: `csrc/meiose_planes.cu` (replaces geneevolve_tpu/ops/
meiosis_pallas.py `meiose_planes_pallas`). The plain version is
`dense/step.py`'s `_meiose_xla`; the kernel equals it bit for bit, a
crossover counting in the chromosome its locus lies in whatever slot row
holds it. A CPU tensor goes to the plain version; a CUDA tensor to the
kernel.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.dense import step as dense_step
from geneevolve_tpu_torch.ops import _build

MAX_SMEM = 48 * 1024  # bytes of staged plan per block (no opt-in needed)


def meiose_planes_plain(hapA, hapB, fathers, mothers, xo_p, st_p, xo_m, st_m,
                        *, n_chr):
    m = hapA.shape[1]
    cfg = dense_step.DenseConfig(n=fathers.shape[0], m=m, n_chr=n_chr)
    return (dense_step._meiose_xla(hapA, hapB, fathers, xo_p, st_p, cfg),
            dense_step._meiose_xla(hapA, hapB, mothers, xo_m, st_m, cfg))


def meiose_planes(
    hapA: torch.Tensor,  # (N, m) uint8 parents' paternal chromatids
    hapB: torch.Tensor,  # (N, m) uint8 maternal chromatids
    fathers: torch.Tensor,  # (n,) int32
    mothers: torch.Tensor,  # (n,) int32
    xo_p: torch.Tensor,  # (n, n_chr, K) int32 crossover loci, pad = m
    st_p: torch.Tensor,  # (n, n_chr) int32 start chromatid
    xo_m: torch.Tensor,
    st_m: torch.Tensor,
    *,
    n_chr: int,
):
    """(childA, childB), each (n, m) uint8: the gamete of the father and of
    the mother."""
    if hapA.device.type == "cpu":
        return meiose_planes_plain(hapA, hapB, fathers, mothers, xo_p, st_p,
                                   xo_m, st_m, n_chr=n_chr)
    dev = hapA.device
    ts = (hapB, fathers, mothers, xo_p, st_p, xo_m, st_m)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("meiose_planes: all tensors must lie on one CUDA "
                         "device")
    if hapA.dtype != torch.uint8 or hapB.dtype != torch.uint8 or any(
            t.dtype != torch.int32 for t in ts[1:]):
        raise TypeError("meiose_planes takes uint8 planes and int32 plans")
    N, m = hapA.shape
    n = fathers.shape[0]
    K = xo_p.shape[2]
    if (hapB.shape != (N, m) or m % n_chr or mothers.shape != (n,)
            or xo_p.shape != (n, n_chr, K) or xo_m.shape != xo_p.shape
            or st_p.shape != (n, n_chr) or st_m.shape != st_p.shape):
        raise ValueError("meiose_planes: shape mismatch")
    if 4 * (2 * n_chr * K + 6 * n_chr) > MAX_SMEM:
        raise ValueError("meiose_planes: plan too large for shared memory")
    if n * ((m + 16383) // 16384) >= 2**31:
        raise ValueError("meiose_planes: too many blocks")
    hapA, hapB, fathers, mothers, xo_p, st_p, xo_m, st_m = (
        t.contiguous()
        for t in (hapA, hapB, fathers, mothers, xo_p, st_p, xo_m, st_m)
    )
    outA = torch.empty((n, m), dtype=torch.uint8, device=dev)
    outB = torch.empty_like(outA)
    code = _build.lib().ge_meiose_planes(
        hapA.data_ptr(), hapB.data_ptr(), outA.data_ptr(), outB.data_ptr(),
        fathers.data_ptr(), mothers.data_ptr(), xo_p.data_ptr(),
        st_p.data_ptr(), xo_m.data_ptr(), st_m.data_ptr(), n, m, n_chr, K,
        m // n_chr, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_planes")
    meiose_planes.launches += 1
    return outA, outB


meiose_planes.launches = 0  # kernel launches since the last reset
