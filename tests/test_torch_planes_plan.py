"""The byte meiosis kernel's launch plan (`ops/meiose_planes.launch_plan`),
a pure function of the shapes, strides and pointer offsets, on the CPU: at
every byte offset 0-15 of a window, at m % 16 != 0 and at the smoke's
shapes (the byte engine's 1 Mi loci, its odd twin of 8 x 131,071 loci, a
chromosome window at an odd offset), the blocks cover every (child,
gamete, locus) exactly once by the kernel's own index arithmetic (each
child row cut at its 16-byte boundaries into head, body and tail), the
body's stores are 16-byte aligned, a plan without `shifted` reads every
parent row at its child row's phase, and the shapes the kernel cannot
take are refused."""

import numpy as np
import pytest

from geneevolve_tpu_torch.ops import meiose_planes as tpl


def _loci(plan, n, m, out_stride, out_off):
    """(child, gamete, locus) of every byte the launch writes, one row a
    byte, and the child address of every body piece: block b is (child b
    // chunks, chunk c = b % chunks); for gamete g the child row (base
    `out_off[g]` bytes past 16, rows `out_stride` apart) has a head of hd
    = min((16 - addr % 16) % 16, m) bytes, nbody = (m - hd) // 16 pieces,
    then a tail; thread x moves pieces c PIECES + x, + THREADS, ... below
    min(nbody, (c + 1) PIECES) (loci hd + 16 k ...), and edge bytes x, x +
    THREADS, ... of the head (chunk 0) and tail (last chunk)."""
    blk = np.arange(plan.blocks)
    child, c = blk // plan.chunks, blk % plan.chunks
    x = np.arange(tpl.THREADS)
    per = -(-tpl.PIECES // tpl.THREADS)
    out, body_addr = [], []
    for g in range(2):
        addr = out_off[g] + child * out_stride
        hd = np.minimum((16 - addr % 16) % 16, m)
        nbody = (m - hd) // 16
        k = (c * tpl.PIECES)[:, None, None] + x[:, None] + tpl.THREADS \
            * np.arange(per)
        live = k < np.minimum(nbody, (c + 1) * tpl.PIECES)[:, None, None]
        col = hd[:, None, None, None] + 16 * k[..., None] + np.arange(16)
        rows = np.broadcast_to(child[:, None, None, None], col.shape)
        lv = np.broadcast_to(live[..., None], col.shape)
        out.append(np.stack([rows[lv], np.full(lv.sum(), g), col[lv]], 1))
        body_addr.append((addr[:, None, None] + hd[:, None, None]
                          + 16 * k)[live])
        n_head = np.where(c == 0, hd, 0)
        n_tail = np.where(c == plan.chunks - 1, m - hd - 16 * nbody, 0)
        e = x[None, :]
        le = e < (n_head + n_tail)[:, None]
        ecol = np.where(e < n_head[:, None], e,
                        (m - n_tail)[:, None] + e - n_head[:, None])
        erow = np.broadcast_to(child[:, None], le.shape)
        out.append(np.stack([erow[le], np.full(le.sum(), g), ecol[le]], 1))
        # more edge bytes than a thread each would go unwritten
        assert ((n_head + n_tail) <= tpl.THREADS).all()
    return np.concatenate(out), np.concatenate(body_addr)


def _check(n, m, n_chr, par_stride, out_stride, offsets):
    plan = tpl.launch_plan(n, m, n_chr, 4, par_stride, out_stride, offsets)
    got, body_addr = _loci(plan, n, m, out_stride, offsets[2:])
    key = (got[:, 0] * 2 + got[:, 1]) * m + got[:, 2]
    assert got.shape[0] == n * 2 * m
    assert np.array_equal(np.sort(key), np.arange(n * 2 * m))
    assert (body_addr % 16 == 0).all()
    return plan


@pytest.mark.parametrize("offset", range(16))
@pytest.mark.parametrize("m, M", [(3003, 3200), (32773, 40000), (48, 64)])
def test_window_at_every_byte_offset_covers_every_locus_once(offset, m, M):
    """A window of m loci at byte `offset` of (N, M) planes, as the sharded
    byte step launches it; m % 16 = 11, 5 (two blocks a row) and 0."""
    plan = _check(3, m, 1, M, M, tpl.byte_offsets(*[offset] * 4))
    assert plan.edges == bool(offset or m % 16 or M % 16)
    assert plan.shifted == bool(M % 16)


@pytest.mark.parametrize("m", [1, 15, 16, 17, 99, 16 * 1024, 16 * 1024 + 1,
                               8 * 131071])
def test_whole_planes_cover_every_locus_once(m):
    """Whole (N, m) planes (rows m bytes apart): m % 16 != 0 shifts odd
    rows against each other; rows shorter than 16 bytes are all head."""
    plan = _check(2, m, 1, m, m, (0, 0, 0, 0))
    assert plan.shifted == plan.edges == bool(m % 16)


@pytest.mark.parametrize("name, n, m, stride, offset, want", [
    # the byte engine: 4,096 x 1 Mi loci, 64 blocks a child
    ("whole_planes", 4096, 1 << 20, 1 << 20, 0,
     dict(shifted=False, edges=False, chunks=64, blocks=4096 * 64)),
    # its odd twin, 8 x 131,071 loci: rows 8 bytes off 16 every other row
    ("m_odd", 4096, 8 * 131071, 8 * 131071, 0,
     dict(shifted=True, edges=True, chunks=64, blocks=4096 * 64)),
    # a chromosome less its first 5 loci at the flagship's planes
    ("window_odd_offset", 4096, 131067, 1 << 20, 2 * 131072 + 5,
     dict(shifted=False, edges=True, chunks=8, blocks=4096 * 8)),
])
def test_plan_at_smoke_shapes(name, n, m, stride, offset, want):
    plan = tpl.launch_plan(n, m, 8 if name == "m_odd" else 1, 8, stride,
                           stride, tpl.byte_offsets(*[offset] * 4))
    assert {k: getattr(plan, k) for k in want} == want
    _check(2, m, 1, stride, stride, tpl.byte_offsets(*[offset] * 4))


@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (3, 3, 3, 3),
                                     (0, 5, 0, 5), (7, 7, 2, 2),
                                     (1, 2, 3, 4)])
@pytest.mark.parametrize("strides", [(640, 640), (648, 640), (640, 656)])
def test_plan_shifts_only_where_a_row_needs_it(offsets, strides):
    """Without `shifted`, every parent row's body starts on 16 bytes
    wherever its child row's body does: a - o + p par_stride - k
    out_stride = 0 (mod 16) for every plane pair and rows p, k."""
    ps, os = strides
    plan = _check(3, 600, 2, ps, os, offsets)
    rows = np.arange(17)
    shift = {((src - dst + p * ps - k * os) % 16)
             for src in offsets[:2] for dst in offsets[2:] for p in rows
             for k in rows}
    assert plan.shifted == (shift != {0})


def test_plan_of_nothing_launches_nothing():
    assert tpl.launch_plan(0, 640, 1, 4, 640, 640).blocks == 0
    assert tpl.launch_plan(5, 0, 1, 4, 640, 640).blocks == 0


@pytest.mark.parametrize("args, match", [
    ((4, 1 << 20, 22, 1000, 1 << 20, 1 << 20), "shared memory"),  # K 1000
    ((2**26, 1 << 20, 8, 8, 1 << 20, 1 << 20), "too many blocks"),
])
def test_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        tpl.launch_plan(*args)
