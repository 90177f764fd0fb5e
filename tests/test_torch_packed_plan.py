"""The packed meiosis kernel's launch plan (`ops/meiose_packed.launch_plan`),
a pure function of the shapes, on the CPU: at the flagship's, the dense
slice's and the edge shapes the tiles cover every (child, gamete, word)
exactly once by the kernel's own index arithmetic, the staged plan fits
its shared memory, and the shapes the tiling cannot take are refused."""

import numpy as np
import pytest

from geneevolve_tpu_torch.ops import meiose_packed as tmp

# name -> (n_chr, chr_len, K, km, entry): the flagship (`bench.py`), the
# dense slice (22 chromosomes of 2,048 panel sites), and edge shapes
SHAPES = {
    "flagship": (8, 131072, 8, 8, "combined"),
    "dense_slice": (22, 2048, 23, 8, "combined"),
    "word_chromosomes": (3, 96, 4, 3, "combined"),  # 3-word rows
    "two_chromosomes": (2, 4096, 5, 4, "combined"),
    "split_rows": (2, 32 * 8192, 5, 4, "combined"),  # two tiles a row
    "ragged_row": (2, 32 * 1000, 6, 6, "combined"),  # last access cut short
    "k40": (2, 4096, 40, 40, "combined"),  # two slots a lane
    "split_entry_mw_odd": (3, 160, 6, 0, "split"),  # mw 15: word loads
    "split_entry": (8, 131072, 8, 0, "split"),
}


def _plan(n, name, aligned=True):
    n_chr, chr_len, K, km, entry = SHAPES[name]
    mw = n_chr * chr_len // 32
    stride = mw if entry == "split" else 2 * mw
    return tmp.launch_plan(n, mw, n_chr, chr_len, K, km, stride, stride,
                           aligned)


def _words(plan, n_chr, cw):
    """(child, gamete, word) of every word the launch writes, one row a
    word: block b's thread x takes tile b * (THREADS / group) + x // group
    as its thread t = x % group; a tile is (span s, chromosome, gamete,
    child), fastest first; the thread moves accesses t, t + group, ... of
    the tile's span, each of `vw` words."""
    tpb = tmp.THREADS // plan.group
    x = np.arange(tmp.THREADS)
    tile = np.arange(plan.blocks)[:, None] * tpb + x // plan.group
    t = np.broadcast_to(x % plan.group, tile.shape)
    tile, t = tile[tile < plan.tiles], t[tile < plan.tiles]
    s, u = tile % plan.splits, tile // plan.splits
    ch, gc = u % n_chr, u // n_chr
    span = plan.group * plan.per_thread
    j = (s * span + t)[:, None] + plan.group * np.arange(plan.per_thread)
    live = j < np.minimum(cw // plan.vw, (s + 1) * span)[:, None]
    word = ((ch * cw)[:, None, None] + plan.vw * j[..., None]
            + np.arange(plan.vw))
    live = np.broadcast_to(live[..., None], word.shape)
    child, g = (np.broadcast_to(a[:, None, None], word.shape)[live]
                for a in (gc >> 1, gc & 1))
    word = word[live]
    return np.stack([child, g, word], 1)


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("n", [1, 5])
def test_plan_covers_every_word_once(name, n):
    n_chr, chr_len, *_ = SHAPES[name]
    cw = chr_len // 32
    plan = _plan(n, name)
    got = _words(plan, n_chr, cw)
    key = (got[:, 0] * 2 + got[:, 1]) * n_chr * cw + got[:, 2]
    assert got.shape[0] == n * 2 * n_chr * cw
    assert np.array_equal(np.sort(key), np.arange(n * 2 * n_chr * cw))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_stays_within_shared_memory(name):
    """Each of a block's 8 warps keeps the plan of up to 8 tiles (starts,
    32-slot masks of the crossovers before and inside each tile and of the
    mutations inside it, the K crossover and km mutation slots) and its
    lanes' parent words (4 accesses of each plane a lane); a block fits the
    card."""
    n_chr, chr_len, K, km, _ = SHAPES[name]
    plan = _plan(3, name)
    words = 8 + 2 * -(-8 * K // 32) + -(-8 * km // 32) + 8 * (K + km)
    assert plan.smem == 4 * 8 * (-(-words // 4) * 4 + 2 * 4 * 32 * plan.vw)
    assert plan.smem <= tmp.MAX_SMEM
    assert plan.blocks * (tmp.THREADS // plan.group) >= plan.tiles


@pytest.mark.parametrize("name, n, want", [
    # a chromosome of 4,096 words a block: 256 threads x 4 16-byte loads
    ("flagship", 16_384, dict(vw=4, group=256, per_thread=4, splits=1,
                              tiles=262_144, blocks=262_144)),
    # a chromosome of 64 words a group of 4: 64 tiles a block
    ("dense_slice", 30_563, dict(vw=4, group=4, per_thread=4, splits=1,
                                 tiles=30_563 * 44, blocks=21_013)),
    ("split_entry_mw_odd", 7, dict(vw=1, group=4, per_thread=2)),
    ("split_rows", 2, dict(group=256, per_thread=4, splits=2, tiles=16)),
])
def test_plan_at_main_path_shapes(name, n, want):
    plan = _plan(n, name)
    assert {k: getattr(plan, k) for k in want} == want


def test_plan_word_loads_where_unaligned():
    """A plane pointer off 16 bytes, or a row stride off four words, takes
    word accesses; the tiles still cover every word once."""
    assert _plan(5, "two_chromosomes", aligned=False).vw == 1
    plan = tmp.launch_plan(5, 256, 2, 4096, 5, 4, 258, 512)
    assert plan.vw == 1
    got = _words(plan, 2, 128)
    assert np.unique((got[:, 0] * 2 + got[:, 1]) * 256 + got[:, 2]).size \
        == 5 * 2 * 256 == got.shape[0]


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
