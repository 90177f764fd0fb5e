"""Byte-plane meiosis: both gametes of every child, one uint8 per locus.

CUDA kernel: `csrc/meiose_planes.cu` (replaces geneevolve_tpu/ops/
meiosis_pallas.py `meiose_planes_pallas`). The plain version is
`dense/step.py`'s `_meiose_xla`; the kernel equals it bit for bit, a
crossover counting in the chromosome its locus lies in whatever slot row
holds it. A CPU tensor goes to the plain version; a CUDA tensor to the
kernel.

The kernel cuts each child row at its own 16-byte boundaries into a head,
a body of 16-byte pieces and a tail, whatever the window's offset, the
row strides or m % 16; `launch_plan` picks the path and the blocks from
the shapes, strides and pointer offsets alone, so the CPU tests hold it to
covering every child locus exactly once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from geneevolve_tpu_torch.dense import step as dense_step
from geneevolve_tpu_torch.ops import _build

MAX_SMEM = 48 * 1024  # bytes of staged plan per block (no opt-in needed)
THREADS = 256  # threads a block
PIECES = 1024  # 16-byte pieces of a child row a block moves (16,384 loci)


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch cuts (n children x 2 gametes x m loci): each child
    row at its own 16-byte boundaries into a head of at most 15 bytes, a
    body of 16-byte pieces and a tail of at most 15 bytes; block (child,
    c) moves body pieces [c PIECES, (c + 1) PIECES), thread x of it pieces
    x, x + THREADS, ...; block c = 0 also writes the heads, the last block
    of a child the tails, a thread a byte."""

    shifted: bool  # some parent row at another 16-byte phase than its
    #                child row: two 16-byte loads a piece, funnel-shifted
    edges: bool  # some child row starts or ends off a 16-byte boundary
    chunks: int  # blocks a child
    blocks: int
    smem: int  # bytes of staged plan a block


def byte_offsets(*ptrs: int) -> tuple:
    """Each pointer's byte within its 16 bytes (0..15)."""
    return tuple(p % 16 for p in ptrs)


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, m: int, n_chr: int, K: int, par_stride: int,
                out_stride: int, offsets: tuple = (0, 0, 0, 0)) -> LaunchPlan:
    """The blocks of one launch over m loci of n children, from the
    planes' row strides (bytes) and `offsets`, the byte within 16 of the
    hapA, hapB, outA and outB pointers at the window's first locus
    (`byte_offsets`). Every layout keeps 16-byte accesses; raises on a
    shape the kernel cannot take."""
    a, b, oa, ob = (x % 16 for x in offsets)
    # a parent row's shift against its child row is its offset less the
    # child's plus the rows' strides times their indices: zero everywhere
    # only where all four share their phase and both strides are whole
    # vectors
    shifted = bool(par_stride % 16 or out_stride % 16
                   or len({a, b, oa, ob}) > 1)
    edges = bool(m % 16 or out_stride % 16 or oa or ob)
    chunks = max(1, -(-(m // 16) // PIECES)) if m else 0
    smem = 4 * (2 * n_chr * K + 6 * n_chr)
    if smem > MAX_SMEM:
        raise ValueError("meiose_planes: plan too large for shared memory")
    if n * chunks >= 2**31:
        raise ValueError("meiose_planes: too many blocks")
    return LaunchPlan(shifted=shifted, edges=edges, chunks=chunks,
                      blocks=n * chunks, smem=smem)


def meiose_planes_plain(hapA, hapB, fathers, mothers, xo_p, st_p, xo_m, st_m,
                        *, n_chr):
    m = hapA.shape[1]
    cfg = dense_step.DenseConfig(n=fathers.shape[0], m=m, n_chr=n_chr)
    return (dense_step._meiose_xla(hapA, hapB, fathers, xo_p, st_p, cfg),
            dense_step._meiose_xla(hapA, hapB, mothers, xo_m, st_m, cfg))


def meiose_planes_window_plain(hapA, hapB, outA, outB, l0, fathers, mothers,
                               xo_p, st_p, xo_m, st_m, *, n_chr, chr_len):
    w = slice(l0, l0 + n_chr * chr_len)
    outA[:, w], outB[:, w] = meiose_planes_plain(
        hapA[:, w], hapB[:, w], fathers, mothers, xo_p, st_p, xo_m, st_m,
        n_chr=n_chr)
    return outA, outB


def _launch(hapA, hapB, outA, outB, l0, fathers, mothers, xo_p, st_p, xo_m,
            st_m, n_chr, chr_len):
    """One launch over loci [l0, l0 + n_chr * chr_len) of the (N, M)
    parent and (n, M') child planes, rows as far apart as they lie."""
    dev = hapA.device
    ts = (hapB, outA, outB, fathers, mothers, xo_p, st_p, xo_m, st_m)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("meiose_planes: all tensors must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.uint8 for t in (hapA, hapB, outA, outB)) or any(
            t.dtype != torch.int32 for t in ts[3:]):
        raise TypeError("meiose_planes takes uint8 planes and int32 plans")
    m = n_chr * chr_len
    n = fathers.shape[0]
    K = xo_p.shape[2]
    if (hapA.dim() != 2 or hapB.shape != hapA.shape or outA.dim() != 2
            or outB.shape != outA.shape or outA.shape[0] != n
            or mothers.shape != (n,) or xo_p.shape != (n, n_chr, K)
            or xo_m.shape != xo_p.shape or st_p.shape != (n, n_chr)
            or st_m.shape != st_p.shape):
        raise ValueError("meiose_planes: shape mismatch")
    if l0 < 0 or l0 + m > min(hapA.shape[1], outA.shape[1]):
        raise ValueError(f"meiose_planes: loci [{l0}, {l0 + m}) lie outside "
                         "the planes")
    if any(t.stride(1) != 1 for t in (hapA, hapB, outA, outB)):
        raise ValueError("meiose_planes: plane rows must be contiguous")
    if outA.stride(0) != outB.stride(0) or hapA.stride(0) != hapB.stride(0):
        raise ValueError("meiose_planes: both planes need one row stride")
    # the window's first locus of each plane (rows hold uint8 loci), reckoned
    # rather than sliced
    ptrs = [t.data_ptr() + l0 for t in (hapA, hapB, outA, outB)]
    plan = launch_plan(n, m, n_chr, K, hapA.stride(0), outA.stride(0),
                       byte_offsets(*ptrs))
    fathers, mothers, xo_p, st_p, xo_m, st_m = (
        t.contiguous() for t in (fathers, mothers, xo_p, st_p, xo_m, st_m))
    code = _build.lib().ge_meiose_planes(
        *ptrs[:2], hapA.stride(0), *ptrs[2:], outA.stride(0),
        fathers.data_ptr(), mothers.data_ptr(), xo_p.data_ptr(),
        st_p.data_ptr(), xo_m.data_ptr(), st_m.data_ptr(), n, m, n_chr, K,
        chr_len, int(plan.shifted), plan.chunks, plan.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_planes")
    return plan


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
    N, m = hapA.shape
    if m % n_chr:
        raise ValueError("meiose_planes: shape mismatch")
    hapA, hapB = hapA.contiguous(), hapB.contiguous()
    outA = torch.empty((fathers.shape[0], m), dtype=torch.uint8,
                       device=hapA.device)
    outB = torch.empty_like(outA)
    meiose_planes.plan = _launch(hapA, hapB, outA, outB, 0, fathers, mothers,
                                 xo_p, st_p, xo_m, st_m, n_chr, m // n_chr)
    meiose_planes.launches += 1
    return outA, outB


def meiose_planes_window(
    hapA: torch.Tensor,  # (N, M) uint8 parent planes
    hapB: torch.Tensor,
    outA: torch.Tensor,  # (n, M) uint8 child planes, written in place
    outB: torch.Tensor,
    l0: int,  # the window's first locus, in both
    fathers: torch.Tensor,
    mothers: torch.Tensor,
    xo_p: torch.Tensor,  # (n, n_chr, K) loci local to the window, pad = m
    st_p: torch.Tensor,
    xo_m: torch.Tensor,
    st_m: torch.Tensor,
    *,
    n_chr: int,
    chr_len: int,
):
    """(outA, outB) with loci [l0, l0 + n_chr * chr_len) of every child row
    written: `meiose_planes` of that window of the parents' loci, its n_chr
    chromosomes of chr_len loci each, read and written in place (the
    planes' row strides passed to the kernel, nothing copied), with
    16-byte accesses at any offset."""
    if hapA.device.type == "cpu":
        return meiose_planes_window_plain(
            hapA, hapB, outA, outB, l0, fathers, mothers, xo_p, st_p, xo_m,
            st_m, n_chr=n_chr, chr_len=chr_len)
    meiose_planes_window.plan = _launch(hapA, hapB, outA, outB, l0, fathers,
                                        mothers, xo_p, st_p, xo_m, st_m,
                                        n_chr, chr_len)
    meiose_planes.launches += 1  # the kernel's count, through any entry
    meiose_planes_window.launches += 1
    return outA, outB


# kernel launches since the last reset: `meiose_planes`'s through it and
# the window entry, `meiose_planes_window`'s through the window entry
meiose_planes.launches = 0
meiose_planes_window.launches = 0
# the last LaunchPlan of each entry
meiose_planes.plan = meiose_planes_window.plan = None
