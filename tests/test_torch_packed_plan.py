"""The packed meiosis kernel's launch plan (`ops/meiose_packed.launch_plan`),
a pure function of the shapes, strides and pointer offsets, on the CPU: at
the flagship's, the dense slice's, their odd-word twins' and edge shapes,
in the combined, split and window layouts, the tiles cover every (child,
gamete, word) exactly once by the kernel's own index arithmetic (each
child row cut at its 16-byte boundaries into head, body and tail), the
body's stores are 16-byte aligned, a plan without `shifted` reads every
parent plane at its child row's phase, the staged plan fits its shared
memory, and the shapes the tiling cannot take are refused."""

import numpy as np
import pytest

from geneevolve_tpu_torch.ops import meiose_packed as tmp

# name -> (n_chr, chr_len, K, km, layout): the flagship (`bench.py`), the
# dense slice (22 chromosomes of 2,048 panel sites) and their odd-word
# twins, and edge shapes; a layout is "combined" (N, 2, mw), "split" (N,
# mw) x 2, or ("window", w0, M): words [w0, w0 + mw) of (N, 2, M) planes
SHAPES = {
    "flagship": (8, 131072, 8, 8, "combined"),
    "flagship_odd": (8, 131040, 8, 8, "combined"),  # 4,095 words
    "dense_slice": (22, 2048, 23, 8, "combined"),
    "dense_odd": (22, 2016, 23, 8, "combined"),  # 63 words, mw % 4 == 2
    "word_chromosomes": (3, 96, 4, 3, "combined"),  # 3-word rows, mw 9
    "two_chromosomes": (2, 4096, 5, 4, "combined"),
    "split_rows": (2, 32 * 8192, 5, 4, "combined"),  # two tiles a row
    "split_rows_odd": (2, 32 * 8191, 5, 4, "combined"),  # mw % 4 == 2
    "ragged_row": (2, 32 * 1000, 6, 6, "combined"),  # last access cut short
    "k40": (2, 4096, 40, 40, "combined"),  # two slots a lane
    "mw_mod1": (5, 32 * 13, 6, 4, "combined"),  # mw 65
    "mw_mod2": (2, 32 * 5, 5, 3, "combined"),  # mw 10
    "mw_mod3": (3, 32 * 601, 6, 4, "combined"),  # mw 1,803
    "one_word_rows": (4, 32, 3, 2, "combined"),  # all head and tail
    "split_entry_mw_odd": (3, 160, 6, 0, "split"),  # mw 15
    "split_entry": (8, 131072, 8, 0, "split"),
    "window_w0_1": (2, 32 * 130, 5, 4, ("window", 1, 300)),
    "window_w0_2": (2, 32 * 130, 5, 4, ("window", 2, 301)),  # B at +M odd
    "window_w0_3": (1, 32 * 1023, 8, 8, ("window", 3, 2050)),
    "window_odd_word": (1, 131040, 8, 8, ("window", 8193, 32768)),
}


def _layout(name):
    """(mw, parent stride, child stride, word offsets of the A, B, child-0
    and child-1 bases) of a shape's launch."""
    n_chr, chr_len, _, _, layout = SHAPES[name]
    mw = n_chr * chr_len // 32
    if layout == "split":
        return mw, mw, mw, (0, 0, 0, 0)
    w0, M = (0, mw) if layout == "combined" else layout[1:]
    off = tmp.word_offsets(4 * w0, 4 * (w0 + M), 4 * w0, 4 * (w0 + M))
    return mw, 2 * M, 2 * M, off


def _plan(n, name, offsets=None):
    n_chr, chr_len, K, km, _ = SHAPES[name]
    mw, ps, os, off = _layout(name)
    return tmp.launch_plan(n, mw, n_chr, chr_len, K, km, ps, os,
                           off if offsets is None else offsets)


def _words(plan, n_chr, cw, out_stride, out_off):
    """(child, gamete, word, thread's access kind) of every word the launch
    writes, one row a word, and the child word address of every body
    access's first word: block b's thread x takes tile b * (THREADS /
    group) + x // group as its thread t = x % group; a tile is (span s,
    chromosome, gamete, child), fastest first. The tile's child row
    (gamete g's base `out_off[g]` words past 16 bytes, rows `out_stride`
    apart) has a head of hd = min((4 - addr % 4) % 4, cw) words, nbody =
    (cw - hd) // 4 body accesses, then a tail; the thread moves body
    accesses t, t + group, ... of the tile's span (words hd + 4 j ...),
    and edge words t and t + group of the tile's head (first tile) and
    tail (last tile)."""
    tpb = tmp.THREADS // plan.group
    x = np.arange(tmp.THREADS)
    tile = np.arange(plan.blocks)[:, None] * tpb + x // plan.group
    t = np.broadcast_to(x % plan.group, tile.shape)
    tile, t = tile[tile < plan.tiles], t[tile < plan.tiles]
    s, u = tile % plan.splits, tile // plan.splits
    ch, gc = u % n_chr, u // n_chr
    child, g = gc >> 1, gc & 1
    addr = np.asarray(out_off)[g] + child * out_stride + ch * cw
    hd = np.minimum((4 - addr % 4) % 4, cw)
    nbody = (cw - hd) // 4
    span = plan.group * plan.per_thread
    j = (s * span + t)[:, None] + plan.group * np.arange(plan.per_thread)
    live = j < np.minimum(nbody, (s + 1) * span)[:, None]
    word = (hd[:, None, None] + 4 * j[..., None] + np.arange(4))
    live = np.broadcast_to(live[..., None], word.shape)
    body = [np.broadcast_to(a[:, None, None], word.shape)[live]
            for a in (child, g, ch * cw)]
    body_addr = (addr[:, None] + hd[:, None] + 4 * j)[live[..., 0]]
    n_head = np.where(s == 0, hd, 0)
    n_tail = np.where(s == plan.splits - 1, cw - hd - 4 * nbody, 0)
    e = t[:, None] + plan.group * np.arange(2)
    live_e = e < (n_head + n_tail)[:, None]
    ew = np.where(e < n_head[:, None], e,
                  (cw - n_tail)[:, None] + e - n_head[:, None])
    edge = [np.broadcast_to(a[:, None], e.shape)[live_e]
            for a in (child, g, ch * cw)]
    got = np.concatenate([
        np.stack([*body[:2], body[2] + word[live]], 1),
        np.stack([*edge[:2], edge[2] + ew[live_e]], 1)])
    # more edge words than two a thread would go unwritten
    assert ((n_head + n_tail) <= 2 * plan.group).all()
    return got, body_addr


def _covers(plan, name, n):
    n_chr, chr_len, *_ = SHAPES[name]
    cw = chr_len // 32
    mw, _, os, off = _layout(name)
    got, body_addr = _words(plan, n_chr, cw, os, off[2:])
    key = (got[:, 0] * 2 + got[:, 1]) * n_chr * cw + got[:, 2]
    assert got.shape[0] == n * 2 * n_chr * cw
    assert np.array_equal(np.sort(key), np.arange(n * 2 * n_chr * cw))
    assert (body_addr % 4 == 0).all()  # 16-byte stores


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", [1, 5])
def test_plan_covers_every_word_once(name, n):
    _covers(_plan(n, name), name, n)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_shifts_only_where_a_plane_needs_it(name):
    """Without `shifted`, every parent plane's body words start on 16
    bytes wherever its child row's body does: parent row p's chromosome c
    at word offset a + p par_stride + c cw, the child's at o + k
    out_stride + c cw, so a - o + p par_stride - k out_stride must be 0
    (mod 4) for every pair."""
    n_chr, chr_len, *_ = SHAPES[name]
    mw, ps, os, off = _layout(name)
    plan = _plan(3, name)
    rows = np.arange(9)
    shift = {((src - dst + p * ps - k * os) % 4)
             for src in off[:2] for dst in off[2:] for p in rows
             for k in rows}
    assert plan.shifted == (shift != {0})
    assert plan.edges == bool(
        (chr_len // 32) % 4 or os % 4 or off[2] or off[3])


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_stays_within_shared_memory(name):
    """Each of a block's 8 warps keeps the plan of up to 8 tiles (starts,
    32-slot masks of the crossovers before and inside each tile and of the
    mutations inside it, the K crossover and km mutation slots) and its
    lanes' parent vectors (4 accesses of each plane a lane, and, shifted,
    one vector after each of at most 8 runs); a block fits the card."""
    n_chr, chr_len, K, km, _ = SHAPES[name]
    plan = _plan(3, name)
    words = 8 + 2 * -(-8 * K // 32) + -(-8 * km // 32) + 8 * (K + km)
    vecs = 4 * 32 + (8 if plan.shifted else 0)  # a vector after each run
    assert plan.smem == 4 * 8 * (-(-words // 4) * 4 + 2 * vecs * 4)
    assert plan.smem <= tmp.MAX_SMEM
    assert plan.blocks * (tmp.THREADS // plan.group) >= plan.tiles


@pytest.mark.parametrize("name, n, want", [
    # a chromosome of 4,096 words a block: 256 threads x 4 16-byte loads
    ("flagship", 16_384, dict(shifted=False, edges=False, group=256,
                              per_thread=4, splits=1, tiles=262_144,
                              blocks=262_144)),
    # 4,095 words: the flagship's tiles, a head or tail on each row, the
    # planes at their rows' phase (mw % 4 == 0)
    ("flagship_odd", 16_384, dict(shifted=False, edges=True, group=256,
                                  per_thread=4, splits=1, tiles=262_144,
                                  blocks=262_144)),
    # a chromosome of 64 words a group of 4: 64 tiles a block
    ("dense_slice", 30_563, dict(shifted=False, edges=False, group=4,
                                 per_thread=4, splits=1, tiles=30_563 * 44,
                                 blocks=21_013)),
    # 63 words: the 64-word plan's tiles; B at +1,386 words (2 mod 4)
    ("dense_odd", 30_563, dict(shifted=True, edges=True, group=4,
                               per_thread=4, splits=1, tiles=30_563 * 44,
                               blocks=21_013)),
    ("split_entry_mw_odd", 7, dict(shifted=True, group=4, per_thread=1)),
    ("split_rows", 2, dict(group=256, per_thread=4, splits=2, tiles=16)),
    ("split_rows_odd", 2, dict(shifted=True, group=256, per_thread=4,
                               splits=2, tiles=16)),
    ("window_odd_word", 16_384, dict(shifted=False, edges=True, group=256,
                                     per_thread=4, splits=1)),
])
def test_plan_at_main_path_shapes(name, n, want):
    plan = _plan(n, name)
    assert {k: getattr(plan, k) for k in want} == want


def test_plan_word_loads_where_unaligned():
    """A plane pointer off 16 bytes, or a row stride off four words, keeps
    the aligned plan's tiles and 16-byte accesses: pointers at one phase
    cut heads and tails, at different phases (or an odd stride) shift the
    parent words; the tiles still cover every word once."""
    aligned = _plan(5, "two_chromosomes")
    for off, shifted in (((1, 1, 1, 1), False), ((0, 0, 0, 2), True),
                         ((3, 0, 3, 0), True)):
        plan = _plan(5, "two_chromosomes", off)
        assert (plan.shifted, plan.edges) == (shifted, True)
        assert (plan.group, plan.per_thread, plan.splits) == (
            aligned.group, aligned.per_thread, aligned.splits)
        got, body_addr = _words(plan, 2, 128, 512, off[2:])
        assert np.unique((got[:, 0] * 2 + got[:, 1]) * 256
                         + got[:, 2]).size == 5 * 2 * 256 == got.shape[0]
        assert (body_addr % 4 == 0).all()
    plan = tmp.launch_plan(5, 256, 2, 4096, 5, 4, 258, 512)
    assert plan.shifted and not plan.edges


def test_plan_of_no_children_launches_nothing():
    assert _plan(0, "dense_slice").blocks == 0


@pytest.mark.parametrize("args, match", [
    ((4, 100, 3, 1000, 5, 4, 200, 200), "do not fill"),  # chr_len % 32
    ((4, 2**26, 1, 2**31, 5, 4, 2**27, 2**27), "int32"),  # m = 2**31
    ((4, 1408, 22, 2048, 1000, 8, 2816, 2816), "shared memory"),  # K 1000
    ((2**26, 1408, 22, 2048, 23, 8, 2816, 2816), "too many tiles"),
])
def test_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        tmp.launch_plan(*args)
