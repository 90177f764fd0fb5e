"""Packed meiosis: both gametes of every child, 32 loci per int32 word, with
de novo mutations fused.

CUDA kernel: `csrc/meiose_packed.cu` (replaces geneevolve_tpu/ops/
meiosis_packed_pallas.py `meiose_packed_pallas`, and its layout
experiments tools/kexp.py `meiose_v3` (combined planes, no mutations:
`meiose_packed` with `mu=None`) and `meiose_v2` (split planes:
`meiose_packed_split`)). The plain version is `dense/packed.py`'s
`meiose_packed_xla` + `apply_mutations_packed`; the kernel equals it bit for
bit. A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
`meiose_packed_window` launches the same kernel on a window of words of
the parent and child planes (a pointer offset beside the planes' row
stride, nothing copied): the sharded steps' and the dense mesh's pieces
of a chromosome.

The kernel cuts the work into tiles aligned to chromosomes, (child, gamete,
chromosome, span of words), and each child row into a head, a body of
16-byte accesses and a tail at its own 16-byte boundaries; `launch_plan`
sizes the tiles from the shapes, strides and pointer offsets alone, so the
CPU tests hold it to covering every child word exactly once.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from geneevolve_tpu_torch.dense import packed
from geneevolve_tpu_torch.ops import _build

MAX_SMEM = 227 * 1024  # shared memory a block may use (opted in above 48 KB)
THREADS = 256  # threads a block
PER_THREAD = 4  # body accesses of a tile a thread moves, at most
MIN_GROUP = 4  # threads a tile, at least: at most 8 tiles a warp, and a
#                tile's at most 6 head and tail words take one a thread
ROWS = 8  # tiles a warp holds, at most (groups of 4 threads)
# shifted, a warp's parent vectors of a plane: its accesses end to end,
# each run of a tile (or of a tile's 32 lanes at one access of a thread)
# followed by one vector
REGION = PER_THREAD * 32 + 8


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch cuts (n children x 2 gametes x n_chr chromosomes of
    cw words) into tiles. Each child row of a chromosome is cut where its
    addresses cross 16 bytes: a head of at most 3 words, a body of 16-byte
    accesses, a tail of at most 3 words. A group of `group` threads owns a
    tile of group x per_thread body accesses (the last tile of a row cut
    short; the first also takes the row's head, the last its tail); thread
    t moves body accesses t, t + group, ... (at most `per_thread`)."""

    shifted: bool  # some parent plane at another 16-byte phase than its
    #                child row: an access of it takes the vector after its
    #                own too, staged by the next access where it can
    edges: bool  # some child row starts or ends off a 16-byte boundary
    group: int  # threads a tile, a power of two in [MIN_GROUP, THREADS]
    per_thread: int
    splits: int  # tiles a (child, gamete, chromosome) row
    tiles: int
    blocks: int
    smem: int  # bytes of shared memory a block


def word_offsets(*ptrs: int) -> tuple:
    """Each pointer's 4-byte word within its 16 bytes (0..3)."""
    return tuple(p // 4 % 4 for p in ptrs)


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, mw: int, n_chr: int, chr_len: int, K: int, km: int,
                par_stride: int, out_stride: int,
                offsets: tuple = (0, 0, 0, 0)) -> LaunchPlan:
    """The tiling of one launch, from the shapes, the planes' row strides
    (words) and `offsets`, the word within 16 bytes of the A, B, child-0
    and child-1 plane base pointers (`word_offsets`). Every layout keeps
    16-byte copies; raises on a shape the kernel cannot take."""
    _cfg(mw, n_chr, chr_len)
    if 32 * mw >= 2**31:
        raise ValueError("meiose_packed: loci (and the pad m) must fit int32")
    cw = chr_len // 32
    a, b, o0, o1 = (x % 4 for x in offsets)
    # a plane's shift against its child row is a - o (mod 4) plus the
    # rows' strides times their indices: zero everywhere only where all
    # four bases share their phase and both strides are whole vectors
    shifted = bool(par_stride % 4 or out_stride % 4 or len({a, b, o0, o1}) > 1)
    edges = bool(cw % 4 or out_stride % 4 or o0 or o1)
    acc = cw // 4  # body accesses of a row, at most
    need = -(-acc // PER_THREAD)
    group = min(THREADS, max(MIN_GROUP, 1 << max(need - 1, 0).bit_length()))
    per_thread = max(1, min(PER_THREAD, -(-acc // group)))
    # rows of fewer than 4 words are all head and tail: one tile each
    splits = -(-acc // (group * per_thread)) if acc else min(cw, 1)
    tiles = n * 2 * n_chr * splits
    # each warp keeps the plan of up to 8 tiles (starts, 32-slot masks of
    # the crossovers before and inside each tile and of the mutations
    # inside it, the slots) and its lanes' parent vectors of both planes
    # (shifted, with one more vector after each run)
    nx, nm = ROWS * K, ROWS * km
    plan = ROWS + 2 * -(-nx // 32) + -(-nm // 32) + nx + nm
    vecs = REGION if shifted else PER_THREAD * 32
    smem = 4 * THREADS // 32 * (-(-plan // 4) * 4 + 2 * vecs * 4)
    if smem > MAX_SMEM:
        raise ValueError("meiose_packed: plan too large for shared memory")
    if tiles + THREADS >= 2**31:
        raise ValueError("meiose_packed: too many tiles")
    return LaunchPlan(shifted=shifted, edges=edges, group=group,
                      per_thread=per_thread, splits=splits, tiles=tiles,
                      blocks=-(-tiles // (THREADS // group)), smem=smem)


def _cfg(mw: int, n_chr: int, chr_len: int) -> packed.PackedConfig:
    if n_chr * chr_len != 32 * mw or chr_len % 32:
        raise ValueError(
            f"meiose_packed: {n_chr} x {chr_len} loci do not fill {mw} words"
        )
    return packed.PackedConfig(n=0, m=32 * mw, n_chr=n_chr)


def meiose_packed_split_plain(hapA, hapB, fathers, mothers, xo_p, st_p,
                              xo_m, st_m, *, n_chr, chr_len):
    cfg = _cfg(hapA.shape[1], n_chr, chr_len)
    return (packed.meiose_words_xla(hapA, hapB, fathers, xo_p, st_p, cfg),
            packed.meiose_words_xla(hapA, hapB, mothers, xo_m, st_m, cfg))


def meiose_packed_plain(hap, fathers, mothers, xo_p, st_p, xo_m, st_m,
                        mu=None, *, n_chr, chr_len):
    ab = meiose_packed_split_plain(hap[:, 0], hap[:, 1], fathers, mothers,
                                   xo_p, st_p, xo_m, st_m, n_chr=n_chr,
                                   chr_len=chr_len)
    if mu is not None:
        ab = [packed.apply_mutations_packed(x, mu[:, g])
              for g, x in enumerate(ab)]
    return torch.stack(ab, 1)


def _launch(planes, ptrs, par_stride, out_stride, fathers, mothers, xo_p,
            st_p, xo_m, st_m, mu, n_chr, chr_len, mw):
    """One launch; `ptrs`: the A, B, child-0 and child-1 plane bases in
    `planes` (the tensors holding them), reckoned from their data
    pointers rather than sliced, to keep the host's share of a call
    small."""
    dev = planes[0].device
    ts = [*planes, fathers, mothers, xo_p, st_p, xo_m, st_m]
    if mu is not None:
        ts.append(mu)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("meiose_packed: all tensors must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError("meiose_packed takes int32 words, rows and loci")
    n = fathers.shape[0]
    K = xo_p.shape[2]
    km = 0 if mu is None else mu.shape[2]
    if (mothers.shape != (n,) or xo_p.shape != (n, n_chr, K)
            or xo_m.shape != xo_p.shape or st_p.shape != (n, n_chr)
            or st_m.shape != st_p.shape
            or (mu is not None and mu.shape != (n, 2, km))):
        raise ValueError("meiose_packed: shape mismatch")
    plan = launch_plan(n, mw, n_chr, chr_len, K, km, par_stride, out_stride,
                       word_offsets(*ptrs))
    fathers, mothers, xo_p, st_p, xo_m, st_m = (
        t.contiguous() for t in (fathers, mothers, xo_p, st_p, xo_m, st_m)
    )
    mu = None if mu is None or km == 0 else mu.contiguous()
    code = _build.lib().ge_meiose_packed(
        *ptrs[:2], par_stride, *ptrs[2:], out_stride,
        fathers.data_ptr(), mothers.data_ptr(), xo_p.data_ptr(),
        st_p.data_ptr(), xo_m.data_ptr(), st_m.data_ptr(),
        None if mu is None else mu.data_ptr(), km, n, n_chr, K,
        chr_len // 32, int(plan.edges), int(plan.shifted),
        plan.group.bit_length() - 1,
        plan.per_thread, plan.splits, plan.blocks, plan.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_packed")
    return plan


def meiose_packed(
    hap: torch.Tensor,  # (N, 2, mw) int32 parent planes
    fathers: torch.Tensor,  # (n,) int32
    mothers: torch.Tensor,  # (n,) int32
    xo_p: torch.Tensor,  # (n, n_chr, K) int32 crossover loci, pad = m
    st_p: torch.Tensor,  # (n, n_chr) int32 start chromatid
    xo_m: torch.Tensor,
    st_m: torch.Tensor,
    mu=None,  # (n, 2, Km) int32 de novo mutation loci, pad = m
    *,
    n_chr: int,
    chr_len: int,
) -> torch.Tensor:
    """(n, 2, mw) int32 child planes, the gamete from the father in plane
    0: meiosis of both parents with the mutations XORed in."""
    if hap.device.type == "cpu":
        return meiose_packed_plain(hap, fathers, mothers, xo_p, st_p, xo_m,
                                   st_m, mu, n_chr=n_chr, chr_len=chr_len)
    if hap.dim() != 3 or hap.shape[1] != 2:
        raise ValueError("meiose_packed takes (N, 2, mw) planes")
    hap = hap.contiguous()
    mw = hap.shape[2]
    out = torch.empty((fathers.shape[0], 2, mw), dtype=torch.int32,
                      device=hap.device)
    a, o = hap.data_ptr(), out.data_ptr()
    meiose_packed.plan = _launch(
        (hap, out), (a, a + 4 * mw, o, o + 4 * mw), 2 * mw, 2 * mw, fathers,
        mothers, xo_p, st_p, xo_m, st_m, mu, n_chr, chr_len, mw)
    meiose_packed.launches += 1
    return out


def meiose_packed_window_plain(hap, out, w0, fathers, mothers, xo_p, st_p,
                               xo_m, st_m, mu=None, *, n_chr, chr_len):
    w = n_chr * chr_len // 32
    out[:, :, w0:w0 + w] = meiose_packed_plain(
        hap[:, :, w0:w0 + w], fathers, mothers, xo_p, st_p, xo_m, st_m, mu,
        n_chr=n_chr, chr_len=chr_len)
    return out


def meiose_packed_window(
    hap: torch.Tensor,  # (N, 2, mw) int32 parent planes
    out: torch.Tensor,  # (n, 2, mw) int32 child planes, written in place
    w0: int,  # the window's first word, in both
    fathers: torch.Tensor,
    mothers: torch.Tensor,
    xo_p: torch.Tensor,  # (n, n_chr, K) loci local to the window, pad = m
    st_p: torch.Tensor,
    xo_m: torch.Tensor,
    st_m: torch.Tensor,
    mu=None,  # (n, 2, Km) loci local to the window, pad = m
    *,
    n_chr: int,
    chr_len: int,
) -> torch.Tensor:
    """`out` with words [w0, w0 + n_chr * chr_len / 32) of every child
    row written: `meiose_packed` of that window of the parents' words, its
    n_chr chromosomes of chr_len loci each. The kernel reads and writes
    the planes in place, one launch, with 16-byte copies at any word
    offset."""
    if hap.device.type == "cpu":
        return meiose_packed_window_plain(
            hap, out, w0, fathers, mothers, xo_p, st_p, xo_m, st_m, mu,
            n_chr=n_chr, chr_len=chr_len)
    w = n_chr * chr_len // 32
    if (hap.dim() != 3 or out.dim() != 3 or hap.shape[1] != 2
            or out.shape[1] != 2 or out.shape[0] != fathers.shape[0]):
        raise ValueError("meiose_packed_window takes (N, 2, mw) parent and "
                         "(n, 2, mw) child planes")
    if not (hap.is_contiguous() and out.is_contiguous()):
        raise ValueError("meiose_packed_window: planes must be contiguous")
    if w0 < 0 or w0 + w > min(hap.shape[2], out.shape[2]):
        raise ValueError(f"meiose_packed_window: words [{w0}, {w0 + w}) "
                         "lie outside the planes")
    a = hap.data_ptr() + 4 * w0
    o = out.data_ptr() + 4 * w0
    meiose_packed_window.plan = _launch(
        (hap, out), (a, a + 4 * hap.shape[2], o, o + 4 * out.shape[2]),
        hap.stride(0), out.stride(0), fathers, mothers, xo_p, st_p, xo_m,
        st_m, mu, n_chr, chr_len, w)
    meiose_packed.launches += 1  # the kernel's count, through any entry
    meiose_packed_window.launches += 1
    return out


def meiose_packed_split(hapA, hapB, fathers, mothers, xo_p, st_p, xo_m,
                        st_m, *, n_chr, chr_len):
    """(childA, childB), each (n, mw) int32, from split parent planes hapA,
    hapB (N, mw), without mutations: the same kernel, addressed with the
    split layout's strides."""
    if hapA.device.type == "cpu":
        return meiose_packed_split_plain(hapA, hapB, fathers, mothers, xo_p,
                                         st_p, xo_m, st_m, n_chr=n_chr,
                                         chr_len=chr_len)
    if hapA.dim() != 2 or hapB.shape != hapA.shape:
        raise ValueError("meiose_packed_split takes two (N, mw) planes")
    hapA, hapB = hapA.contiguous(), hapB.contiguous()
    n, mw = fathers.shape[0], hapA.shape[1]
    outA = torch.empty((n, mw), dtype=torch.int32, device=hapA.device)
    outB = torch.empty_like(outA)
    meiose_packed_split.plan = _launch(
        (hapA, hapB, outA, outB),
        tuple(t.data_ptr() for t in (hapA, hapB, outA, outB)), mw, mw,
        fathers, mothers, xo_p, st_p, xo_m, st_m, None, n_chr, chr_len, mw)
    meiose_packed_split.launches += 1
    return outA, outB


# kernel launches since the last reset: `meiose_packed`'s through it and
# the window entry, `meiose_packed_window`'s through the window entry
meiose_packed.launches = 0
meiose_packed_window.launches = 0
meiose_packed_split.launches = 0
# the last LaunchPlan of each entry
meiose_packed.plan = meiose_packed_window.plan = None
meiose_packed_split.plan = None
