"""The port's CUDA kernels against their plain PyTorch versions, on the
card, bit-exact (integer outputs). Every case is marked `cuda` and skips
where no CUDA device is present. This file imports no JAX, so it runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from geneevolve_tpu_torch.core import memory as tmemory
from geneevolve_tpu_torch.ops import cdf_bins as tbins
from geneevolve_tpu_torch.ops import gamete_inherit as tinherit
from geneevolve_tpu_torch.ops import materialize as tmat
from geneevolve_tpu_torch.ops import meiose_merge as tmerge
from geneevolve_tpu_torch.ops import meiose_packed as tpacked
from geneevolve_tpu_torch.ops import meiose_planes as tplanes
from geneevolve_tpu_torch.ops import merge_count as tcount
from geneevolve_tpu_torch.ops import paint as tpaint
from torch_cases import (BIG, CASES, INHERIT_CASES, INHERIT_PARTS,
                         PAINT_CASES, STACKED_CASES, cdf, dense_plan,
                         foreign_slots, inherit_case, inherit_planes,
                         mutation_loci, paint_case, paint_ledger,
                         paint_positions, probes, stacked)

T = torch.as_tensor


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [7, 1000, 5120, 20000])
def test_cuda_bins_kernel(cuda, K):
    rng = np.random.default_rng(K)
    cum = T(cdf(rng, K)[None], device=cuda)
    u = T(probes(rng, cum[0].cpu().numpy())[None], device=cuda)
    got = tbins.cdf_bins(u, cum)
    torch.cuda.synchronize()
    assert torch.equal(got, tbins.cdf_bins_plain(u, cum))


def _stacked_probes(rng, cum, size=3600):
    """-1, -inf, +inf, NaN, 0, every chunk's last entry and its float
    neighbours, a sample of exact entries, then uniforms past both ends."""
    last = cum[np.minimum(np.arange(31, len(cum) + 31, 32), len(cum) - 1)]
    u = np.concatenate([
        [-1.0, -np.inf, np.inf, np.nan, 0.0], last,
        np.nextafter(last, np.float32(np.inf)),
        np.nextafter(last, np.float32(-np.inf)),
        rng.choice(cum, size=min(len(cum), 500))]).astype(np.float32)
    fill = rng.uniform(-0.1, float(cum[-1]) * 1.1, size=size - len(u))
    return np.concatenate([u, fill.astype(np.float32)])


@pytest.mark.cuda
@pytest.mark.parametrize("C, K", [(1, 7), (3, 31), (3, 32), (4, 65),
                                  (5, 1), (22, 4981)])
def test_cuda_bins_stacked_kernel(cuda, C, K):
    """Stacked CDFs, padded as `StackedMaps` pads them, K around the
    32-entry chunk: the kernel equals the plain version (itself
    `torch.searchsorted`), one row or all at once."""
    rng = np.random.default_rng(C * 100 + K)
    cum = np.stack([cdf(rng, K) for _ in range(C)])
    cum[0, K // 2:] = cum[0, K // 2]
    u = T(np.stack([_stacked_probes(rng, c) for c in cum]).reshape(C, 60, 60),
          device=cuda)
    cum = T(cum, device=cuda)
    got = tbins.cdf_bins(u, cum)
    torch.cuda.synchronize()
    assert torch.equal(got, tbins.cdf_bins_plain(u, cum))
    assert torch.equal(tbins.cdf_bins(u[C - 1:], cum[C - 1:]), got[C - 1:])


@pytest.mark.cuda
@pytest.mark.parametrize("B, R, dtype", [
    (22, (2, 100), torch.uint8),  # the slice's CV rows: 8-byte units
    (22, (2, 27), torch.int32),  # mutation rows
    (3, (2, 13), torch.int16),  # 2-byte units
    (2, (4400,), torch.uint8),  # the dense slice's rows: 16-byte units
    (4, (3,), torch.uint8),  # byte units
    (2, (20000,), torch.uint8),  # rows wider than a block's tile
])
def test_cuda_gather_stacked_kernel(cuda, B, R, dtype):
    table = torch.randint(0, 100, (B, 90) + R, dtype=dtype, device=cuda)
    # 501 rows: the last block's tile of rows is cut short at every width
    # but the widest (one row a tile)
    idx = torch.randint(0, 90, (501,), dtype=torch.int32, device=cuda)
    want = tmat.gather_rows_stacked_plain(table, idx)
    assert torch.equal(tmat.gather_rows_stacked(table, idx), want)
    # a slice of the stacked tables, as the real pass takes a chunk
    assert torch.equal(tmat.gather_rows_stacked(table[1:], idx), want[1:])
    assert torch.equal(tmat.gather_rows(table[B - 1], idx), want[B - 1])


def _count_and_merge(cuda, st, hap, parents, xo_f, xo_m, sh, caps):
    """Both kernels against their plain versions, the merge in both modes
    at each cap; returns the operands on the card."""
    a = [T(x, device=cuda) for x in (st, hap, parents, xo_f, xo_m, sh)]
    count = (a[0], *a[2:])
    got = tcount.merge_count(*count)
    torch.cuda.synchronize()
    assert torch.equal(got, tcount.merge_count_plain(*count))
    for merge_ibd in (True, False):
        for cap in caps:
            got = tmerge.meiose_merge(*a, cap, merge_ibd)
            want = tmerge.meiose_merge_plain(*a, cap, merge_ibd)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    return a


@pytest.mark.cuda
@pytest.mark.parametrize("n, S, K, live", CASES)
def test_cuda_count_and_merge_kernels(cuda, n, S, K, live):
    rng = np.random.default_rng(n)
    _count_and_merge(cuda, *stacked(rng, 1, n, S, K, live), (S + K, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("hap_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("nchr, n, S, K, live", STACKED_CASES + [
    (1, 24, 3000, 40, 2900),  # one gamete's rows past 48 KB (opt-in)
])
def test_cuda_stacked_count_and_merge_kernels(cuda, nchr, n, S, K, live,
                                              hap_dtype):
    """Several chromosomes and both parents a launch, K past 32, S past 64,
    caps below the counts; a slice of the stacked chromosomes gives that
    slice of the result."""
    rng = np.random.default_rng(nchr * n + S)
    a = _count_and_merge(cuda, *stacked(rng, nchr, n, S, K, live, hap_dtype),
                         (S + K, S // 3))
    part = [x[1:] if x.dim() > 2 else x for x in a]
    if nchr > 1:
        assert torch.equal(tcount.merge_count(part[0], *part[2:]),
                           tcount.merge_count(a[0], *a[2:])[1:])
        for g, w in zip(tmerge.meiose_merge(*part, S), tmerge.meiose_merge(
                *a, S)):
            assert torch.equal(g, w[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("c0, g", [(2, 2), (3, 2), (4, 1)])
def test_cuda_group_view_and_copy_back(cuda, c0, g):
    """The in-place real pass's launches (`Simulation._real_pass_in_place`)
    on a group view of the stacked planes at an offset c0 > 0: the merge,
    the count and the stacked row gathers equal those chromosomes of the
    whole-stack launch, and copying the group's children into its slab
    leaves every other chromosome's planes untouched."""
    rng = np.random.default_rng(40 + c0)
    nchr, n, S, K = 5, 90, 49, 23
    a = [T(x, device=cuda) for x in stacked(rng, nchr, n, S, K, 14)]
    st, hap, parents, xo_f, xo_m, sh = a
    cv = T(rng.integers(0, 2, size=(nchr, n, 2, 200)).astype(np.uint8),
           device=cuda)
    mut = T(rng.integers(0, 1 << 20, size=(nchr, n, 2, 27)).astype(
        np.int32), device=cuda)
    cs = slice(c0, c0 + g)
    grp = [st[cs], hap[cs], parents, xo_f[cs], xo_m[cs], sh[cs]]
    whole = tmerge.meiose_merge(*a, S)
    kids = tmerge.meiose_merge(*grp, S)
    for k, w in zip(kids, whole):
        assert torch.equal(k, w[cs])
    assert torch.equal(tcount.merge_count(st[cs], *grp[2:]),
                       tcount.merge_count(st, *a[2:])[cs])
    for table in (cv, mut):
        for idx in parents:
            assert torch.equal(tmat.gather_rows_stacked(table[cs], idx),
                               tmat.gather_rows_stacked(table, idx)[cs])
    before = [x.clone() for x in (st, hap)]
    for dst, src in zip((st, hap), kids[:2]):
        dst[cs].copy_(src)
    torch.cuda.synchronize()
    for x, b, k in zip((st, hap), before, kids[:2]):
        assert torch.equal(x[cs], k)
        keep = [i for i in range(nchr) if not c0 <= i < c0 + g]
        assert torch.equal(x[keep], b[keep])


@pytest.mark.cuda
def test_cuda_merge_refuses_rows_past_shared_memory(cuda):
    """One gamete's rows above a block's 227 KB: the wrapper raises."""
    rng = np.random.default_rng(5)
    a = [T(x, device=cuda)
         for x in stacked(rng, 1, 4, 10_000, 8, 20, np.int32)]
    with pytest.raises(ValueError):
        tmerge.meiose_merge(*a, 10_000)


@pytest.mark.cuda
def test_cuda_count_and_merge_at_slice_shape(cuda):
    """The segment slice's stacked shape: 22 chromosomes x 30,708 plane
    rows, S 49, K 23, ledgers of ~16 live boundaries, crossovers at parent
    boundaries and duplicated."""
    g = torch.Generator(device=cuda).manual_seed(31)
    nchr, n, S, K = 22, 30_708, 49, 23
    lens = torch.randint(1, 32, (nchr, n, 2, 1), generator=g, device=cuda)
    pos = torch.randint(1, 249_000_000, (nchr, n, 2, S), generator=g,
                        device=cuda, dtype=torch.int32)
    slot = torch.arange(S, device=cuda)
    st = torch.where(slot < lens, pos, BIG).sort(-1).values
    st[..., 0] = 0
    hap = torch.randint(0, 20_000, st.shape, generator=g, device=cuda,
                        dtype=torch.int16)
    hap[st >= BIG] = 0
    parents = torch.randint(0, n, (2, n), generator=g, device=cuda,
                            dtype=torch.int32)
    xo = []
    for p in parents.long():
        cnt = torch.randint(0, K + 1, (nchr, n, 1), generator=g, device=cuda)
        x = torch.randint(1, 249_000_000, (nchr, n, K), generator=g,
                          device=cuda, dtype=torch.int32)
        x[..., 0] = st[:, p, 0, 1].clamp(max=248_999_999)  # a boundary
        x[..., 1] = x[..., 0]  # duplicated
        xo.append(torch.where(torch.arange(K, device=cuda) < cnt, x, BIG))
    sh = torch.randint(0, 2, (nchr, n, 2), generator=g, device=cuda,
                       dtype=torch.int32)
    a = (st.contiguous(), hap, parents, *xo, sh)
    assert torch.equal(tcount.merge_count(a[0], *a[2:]),
                       tcount.merge_count_plain(a[0], *a[2:]))
    for merge_ibd in (True, False):
        got = tmerge.meiose_merge(*a, S, merge_ibd)
        want = tmerge.meiose_merge_plain(*a, S, merge_ibd)
        torch.cuda.synchronize()
        assert all(torch.equal(x, w) for x, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((90, 2, 13), torch.int16), ((90, 2, 8), torch.int32),
    ((90, 2, 100), torch.uint8), ((90, 3), torch.uint8),
])
def test_cuda_gather_kernel(cuda, shape, dtype):
    table = torch.randint(0, 100, shape, dtype=dtype, device=cuda)
    idx = torch.randint(0, shape[0], (500,), dtype=torch.int32, device=cuda)
    assert torch.equal(tmat.gather_rows(table, idx),
                       tmat.gather_rows_plain(table, idx))


def _gametes(rng, cuda, N, n, n_chr, chr_len, K):
    f = rng.integers(0, N, size=n).astype(np.int32)
    mo = rng.integers(0, N, size=n).astype(np.int32)
    xo_p, st_p = dense_plan(rng, n, n_chr, chr_len, K)
    xo_m, st_m = dense_plan(rng, n, n_chr, chr_len, K)
    return [T(x, device=cuda) for x in (f, mo, xo_p, st_p, xo_m, st_m)]


def _check_packed_entries(hap, args, mu, kw):
    """All three entries (combined with and without mutations, split)
    against their plain versions."""
    for m in (mu, None):
        got = tpacked.meiose_packed(hap, *args, m, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, tpacked.meiose_packed_plain(hap, *args, m,
                                                            **kw))
    a, b = hap[:, 0].contiguous(), hap[:, 1].contiguous()
    got = tpacked.meiose_packed_split(a, b, *args, **kw)
    want = tpacked.meiose_packed_split_plain(a, b, *args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n_chr, chr_len, K, Km", [
    (2, 4096, 5, 4),  # 16-byte loads (mw % 4 == 0)
    (3, 96, 4, 3),  # 3-word chromosomes: word loads, chromosome edges
    (8, 131072, 8, 8),  # the flagship's chromosome shape
    (22, 2048, 23, 8),  # the dense slice's: 22 chromosomes of 64 words
    (2, 4096, 40, 40),  # K and Km past a warp's lanes: two slots a lane
    (3, 160, 6, 4),  # mw 15: word loads in every entry, the split's too
])
def test_cuda_meiose_packed_kernel(cuda, n_chr, chr_len, K, Km):
    """All three entries against their plain versions; unsorted slots,
    words with several crossovers, duplicated mutation loci."""
    rng = np.random.default_rng(chr_len)
    N, n = 50, 33
    mw = n_chr * chr_len // 32
    hap = torch.randint(-2**31, 2**31 - 1, (N, 2, mw), dtype=torch.int32,
                        device=cuda)
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, K)
    mu = T(mutation_loci(rng, n, n_chr * chr_len, Km), device=cuda)
    _check_packed_entries(hap, args, mu, dict(n_chr=n_chr, chr_len=chr_len))


@pytest.mark.cuda
@pytest.mark.parametrize("n_chr, chr_len, K", [
    (2, 32 * 8192, 8),  # two tiles of 4,096 words a chromosome
    (22, 2048, 23),  # the dense slice: a tile of 64 words a chromosome
])
def test_cuda_meiose_packed_tile_edges(cuda, n_chr, chr_len, K):
    """Crossovers on the first and last words of every tile and of a
    thread's accesses, two in one word, slots unsorted and not a prefix;
    mutations in the first and the last word of a tile: each entry equals
    its plain version."""
    rng = np.random.default_rng(n_chr)
    N, n, cw, m = 20, 9, chr_len // 32, n_chr * chr_len
    plan = tpacked.launch_plan(n, m // 32, n_chr, chr_len, K, 4, m // 16,
                               m // 16)
    tile = 4 * plan.group * plan.per_thread  # words (16-byte accesses)
    step = 4 * plan.group  # words between a thread's accesses
    edges = np.array(sorted({w for s in range(0, cw, tile) for w in (
        s, s + 3, s + 4, s + step - 1, s + step,
        min(s + tile, cw) - 1) if w < cw}))
    xo = np.full((2, n, n_chr, K), m, dtype=np.int32)
    for g, i, c in np.ndindex(2, n, n_chr):
        k = rng.integers(2, K + 1)
        loci = c * chr_len + 32 * rng.choice(edges, k) + rng.integers(0, 32, k)
        loci[1] = (loci[0] & ~31) + rng.integers(0, 32)  # two in one word
        xo[g, i, c, rng.choice(K, k, replace=False)] = loci
    word = (rng.choice(np.arange(0, cw, tile), (n, 2, 4))
            + rng.choice([0, tile - 1], (n, 2, 4)))
    mu = (rng.integers(0, n_chr, (n, 2, 4)) * chr_len + 32 * word
          + rng.integers(0, 32, (n, 2, 4))).astype(np.int32)
    hap = torch.randint(-2**31, 2**31 - 1, (N, 2, m // 32), dtype=torch.int32,
                        device=cuda)
    st = rng.integers(0, 2, (2, n, n_chr)).astype(np.int32)
    args = [T(x, device=cuda) for x in (
        rng.integers(0, N, n).astype(np.int32),
        rng.integers(0, N, n).astype(np.int32), xo[0], st[0], xo[1], st[1])]
    _check_packed_entries(hap, args, T(mu, device=cuda),
                          dict(n_chr=n_chr, chr_len=chr_len))


@pytest.mark.cuda
@pytest.mark.parametrize("n_chr, chr_len, K", [
    (2, 8192, 5),  # 16-byte loads
    (3, 104, 4),  # 16 loci straddle chromosome edges
    (2, 99, 3),  # m % 16 != 0: byte loads
])
def test_cuda_meiose_planes_kernel(cuda, n_chr, chr_len, K):
    rng = np.random.default_rng(chr_len)
    N, n, m = 40, 29, n_chr * chr_len
    hapA = torch.randint(0, 2, (N, m), dtype=torch.uint8, device=cuda)
    hapB = torch.randint(0, 2, (N, m), dtype=torch.uint8, device=cuda)
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, K)
    got = tplanes.meiose_planes(hapA, hapB, *args, n_chr=n_chr)
    want = tplanes.meiose_planes_plain(hapA, hapB, *args, n_chr=n_chr)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("mw, w0, n_chr, chr_len, shifted, edges", [
    (24, 8, 2, 128, False, False),  # 32 bytes in: the aligned plan
    (24, 2, 2, 128, False, True),  # 8 bytes in: heads and tails
    (24, 13, 1, 96, False, True),  # a partial chromosome of 3 words at an
    #                                odd offset
    (4096, 1024, 3, 32768, False, False),  # whole chromosomes of 1,024
    (27, 5, 2, 256, True, True),  # B, and child B, at +27 words
])
def test_cuda_meiose_packed_window(cuda, mw, w0, n_chr, chr_len, shifted,
                                   edges):
    """The window entry writes its words of every child row, equal to its
    plain version (the whole-plane plain function on the slices), with
    and without mutations; the rest of the child planes is untouched and
    the launch counts as the kernel's. Every offset keeps 16-byte
    accesses: the plan cuts heads and tails, or shifts a plane."""
    rng = np.random.default_rng(w0 + mw)
    N, n = 40, 21
    hap = torch.randint(-2**31, 2**31 - 1, (N, 2, mw), dtype=torch.int32,
                        device=cuda)
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, 5)
    mu = T(mutation_loci(rng, n, n_chr * chr_len, 4), device=cuda)
    kw = dict(n_chr=n_chr, chr_len=chr_len)
    for m in (mu, None):
        out = torch.full((n, 2, mw), 7, dtype=torch.int32, device=cuda)
        want = out.clone()
        before = tpacked.meiose_packed.launches
        got = tpacked.meiose_packed_window(hap, out, w0, *args, m, **kw)
        tpacked.meiose_packed_window_plain(hap, want, w0, *args, m, **kw)
        torch.cuda.synchronize()
        assert got is out and torch.equal(out, want)
        plan = tpacked.meiose_packed_window.plan
        assert (plan.shifted, plan.edges) == (shifted, edges)
        assert tpacked.meiose_packed.launches == before + 1


def _edge_gametes(rng, cuda, N, n, n_chr, cw, K, Km):
    """`_gametes` with crossovers and mutations on each chromosome's first
    and last three words (a child row's head and tail at any alignment)
    beside random ones."""
    chr_len = 32 * cw
    m = n_chr * chr_len
    f, mo, xo_p, st_p, xo_m, st_m = (
        x.cpu().numpy() for x in _gametes(rng, cuda, N, n, n_chr, chr_len, K))
    edge = np.r_[0:min(3, cw), max(cw - 3, 0):cw]
    for xo in (xo_p, xo_m):
        k = rng.integers(1, 3, size=(n, n_chr))
        for i, c in np.ndindex(n, n_chr):
            w = rng.choice(edge, k[i, c])
            xo[i, c, K - k[i, c]:] = (c * chr_len + 32 * w
                                      + rng.integers(0, 32, k[i, c]))
    mu = mutation_loci(rng, n, m, Km)
    c = rng.integers(0, n_chr, size=(n, 2, 2))
    mu[:, :, :2] = (c * chr_len + 32 * rng.choice(edge, (n, 2, 2))
                    + rng.integers(0, 32, (n, 2, 2)))
    return [T(x, device=cuda) for x in (f, mo, xo_p, st_p, xo_m, st_m)], \
        T(mu, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("cw", [64, 65, 66, 67, 5])  # chr_len / 32 % 4
@pytest.mark.parametrize("w0", [0, 1, 2, 3])  # the window's word offset
@pytest.mark.parametrize("pad", [0, 1, 2, 3])  # words past the window: M % 4
def test_cuda_meiose_packed_any_alignment(cuda, cw, w0, pad):
    """Kernel 4 at every word alignment: windows of 3 chromosomes of cw
    words at word w0 of (N, 2, M) planes (B, and child B, at +M words),
    crossovers and mutations in every head and tail word; with w0 == 0
    and no pad the whole-plane entries too (mw = M), also on planes whose
    base pointer lies one word past 16 bytes. Each equals its plain
    version bit for bit."""
    rng = np.random.default_rng(1000 * cw + 10 * w0 + pad)
    N, n, n_chr, K, Km = 30, 19, 3, 6, 5
    mw = n_chr * cw
    M = w0 + mw + pad
    hap = torch.randint(-2**31, 2**31 - 1, (N, 2, M), dtype=torch.int32,
                        device=cuda)
    args, mu = _edge_gametes(rng, cuda, N, n, n_chr, cw, K, Km)
    kw = dict(n_chr=n_chr, chr_len=32 * cw)
    for m in (mu, None):
        out = torch.full((n, 2, M), 7, dtype=torch.int32, device=cuda)
        want = out.clone()
        tpacked.meiose_packed_window(hap, out, w0, *args, m, **kw)
        tpacked.meiose_packed_window_plain(hap, want, w0, *args, m, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    if w0 == 0 and pad == 0:
        _check_packed_entries(hap, args, mu, kw)
        flat = torch.randint(-2**31, 2**31 - 1, (2 * N * mw + 1,),
                             dtype=torch.int32, device=cuda)
        off = flat[1:].view(N, 2, mw)  # one word past 16 bytes
        assert off.is_contiguous() and off.data_ptr() % 16 == 4
        _check_packed_entries(off, args, mu, kw)
        assert tpacked.meiose_packed.plan.shifted


@pytest.mark.cuda
@pytest.mark.parametrize("m_all, l0, n_chr, chr_len, shifted", [
    (640, 64, 2, 128, False),  # 16-byte aligned
    (640, 37, 2, 128, False),  # an odd offset: heads and tails
    (600, 150, 1, 50, True),  # a partial chromosome of 50 loci; rows 600
    #                           bytes apart, 8 off 16
])
def test_cuda_meiose_planes_window(cuda, m_all, l0, n_chr, chr_len,
                                   shifted):
    """The byte kernel's window entry on wider planes equals its plain
    version; loci outside the window stay as they were; every offset
    keeps 16-byte accesses."""
    rng = np.random.default_rng(l0)
    N, n = 30, 17
    hapA = torch.randint(0, 2, (N, m_all), dtype=torch.uint8, device=cuda)
    hapB = torch.randint(0, 2, (N, m_all), dtype=torch.uint8, device=cuda)
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, 4)
    outs = [torch.full((n, m_all), 9, dtype=torch.uint8, device=cuda)
            for _ in range(2)]
    want = [o.clone() for o in outs]
    kw = dict(n_chr=n_chr, chr_len=chr_len)
    got = tplanes.meiose_planes_window(hapA, hapB, *outs, l0, *args, **kw)
    tplanes.meiose_planes_window_plain(hapA, hapB, *want, l0, *args, **kw)
    torch.cuda.synchronize()
    assert all(g is o for g, o in zip(got, outs))
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    plan = tplanes.meiose_planes_window.plan
    assert (plan.shifted, plan.edges) == (shifted, l0 % 16 != 0 or shifted)


def _edge_loci(rng, xo, chr_len, span=20):
    """`xo` with a crossover of every row's chromosomes in its first and
    last `span` loci (a child row's head and tail at any offset)."""
    xo = xo.copy()
    n, n_chr, K = xo.shape
    for c in range(n_chr):
        xo[:, c, 0] = c * chr_len + rng.integers(0, span, n)
        xo[:, c, 1] = (c + 1) * chr_len - 1 - rng.integers(0, span, n)
    return xo


@pytest.mark.cuda
@pytest.mark.parametrize("l0", range(1, 16))  # the window's byte offset
@pytest.mark.parametrize("n_chr, chr_len, pad", [
    (2, 99, 0),  # m % 16 = 6
    (2, 8197, 3),  # m % 16 = 10, two blocks a row
])
def test_cuda_meiose_planes_any_offset(cuda, l0, n_chr, chr_len, pad):
    """Kernel 5 at byte offsets 1-15 of (N, M) planes, m % 16 != 0,
    crossovers in every row's head and tail: the window entry, and the
    whole-plane entry on planes whose base lies l0 bytes past 16 (rows m
    bytes apart), each equal to its plain version bit for bit."""
    rng = np.random.default_rng(100 * l0 + chr_len)
    N, n, K = 24, 13, 4
    m = n_chr * chr_len
    M = l0 + m + pad
    hapA = torch.randint(0, 256, (N, M), dtype=torch.uint8, device=cuda)
    hapB = torch.randint(0, 256, (N, M), dtype=torch.uint8, device=cuda)
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, K)
    for i in (2, 4):
        args[i] = T(_edge_loci(rng, args[i].cpu().numpy(), chr_len),
                    device=cuda)
    outs = [torch.full((n, M), 9, dtype=torch.uint8, device=cuda)
            for _ in range(2)]
    want = [o.clone() for o in outs]
    kw = dict(n_chr=n_chr, chr_len=chr_len)
    tplanes.meiose_planes_window(hapA, hapB, *outs, l0, *args, **kw)
    tplanes.meiose_planes_window_plain(hapA, hapB, *want, l0, *args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    flat = torch.randint(0, 256, (2, N * m + l0), dtype=torch.uint8,
                         device=cuda)
    a, b = (x[l0:].view(N, m) for x in flat)
    assert a.data_ptr() % 16 == l0
    got = tplanes.meiose_planes(a, b, *args, n_chr=n_chr)
    want = tplanes.meiose_planes_plain(a, b, *args, n_chr=n_chr)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tplanes.meiose_planes.plan.shifted


@pytest.mark.cuda
@pytest.mark.parametrize("n_chr, chr_len, K", [(3, 8192, 5), (3, 104, 4)])
def test_cuda_meiose_kernels_foreign_slot(cuda, n_chr, chr_len, K):
    """A slot of chromosome c at chromosome c-1's last column: the byte
    kernel counts it in chromosome c-1 and the packed kernel flips all of
    chromosome c, each as its plain version does."""
    rng = np.random.default_rng(chr_len + 1)
    N, n, m = 40, 29, n_chr * chr_len
    args = _gametes(rng, cuda, N, n, n_chr, chr_len, K)
    for i in (2, 4):
        args[i] = T(foreign_slots(args[i].cpu().numpy(), chr_len),
                    device=cuda)
    hapA = torch.randint(0, 2, (N, m), dtype=torch.uint8, device=cuda)
    hapB = torch.randint(0, 2, (N, m), dtype=torch.uint8, device=cuda)
    got = tplanes.meiose_planes(hapA, hapB, *args, n_chr=n_chr)
    want = tplanes.meiose_planes_plain(hapA, hapB, *args, n_chr=n_chr)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if chr_len % 32 == 0:
        hap = torch.randint(-2**31, 2**31 - 1, (N, 2, m // 32),
                            dtype=torch.int32, device=cuda)
        kw = dict(n_chr=n_chr, chr_len=chr_len)
        got = tpacked.meiose_packed(hap, *args, None, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, tpacked.meiose_packed_plain(hap, *args, None,
                                                            **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("C, n, S, live, M, Q, hap_dtype, order",
                         PAINT_CASES)
def test_cuda_paint_kernel(cuda, C, n, S, live, M, Q, hap_dtype, order):
    """The paint kernel against its plain version: ragged rows (not a
    multiple of a block's rows) and loci (4,096-locus spans, 16-byte
    chunks at every row alignment), runs shorter than a chunk and longer
    than a span, queries before the first start and at BIG, full ledgers,
    duplicate starts and mutations, repeated positions with mutations on
    them, haps outside the panel (clamped), int16 and int32 haps,
    positions in any order and a shuffled span beside a sorted one; both
    of the kernel's paths (`tests/test_torch_paint_plan.py` checks that
    these cases reach them)."""
    args = [T(x, device=cuda) for x in paint_case(C, n, S, live, M, Q,
                                                   hap_dtype, order)]
    before = tpaint.paint.launches
    got = tpaint.paint(*args)
    torch.cuda.synchronize()
    assert tpaint.paint.launches == before + 1
    assert tpaint.paint.plan == tpaint.launch_plan(C, n, S, M, Q)
    assert torch.equal(got, tpaint.paint_plain(*args))


@pytest.mark.cuda
def test_cuda_paint_refuses_bad_inputs(cuda):
    """Non-contiguous or mistyped operands raise; nothing falls back."""
    st = torch.zeros((1, 4, 2, 3), dtype=torch.int32, device=cuda)
    hap = torch.zeros_like(st, dtype=torch.int16)
    mut = torch.full((1, 4, 2, 2), BIG, dtype=torch.int32, device=cuda)
    founder = torch.zeros((1, 4, 10), dtype=torch.uint8, device=cuda)
    pos = torch.arange(10, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(TypeError):
        tpaint.paint(st, hap.long(), mut, founder, pos)
    with pytest.raises(ValueError):
        tpaint.paint(st, hap, mut, founder, pos[:, ::2].contiguous())
    with pytest.raises(ValueError):
        tpaint.paint(st, hap, mut, founder.transpose(1, 2), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("C, n, S, Q, n_pop, order", [
    (3, 500, 49, 100, 2, "sorted"),  # the gather path's shape, 2 pops
    (2, 300, 49, 100, 255, "shuffled"),  # every root value a byte holds
    (1, 200, 65, 5_000, 7, "sorted"),  # spans painted as runs
])
def test_cuda_paint_root_panel_no_mutations(cuda, C, n, S, Q, n_pop, order):
    """The multi-population A/D's second launch: the ledger painted over a
    root panel (the population of each founder hap, values up to n_pop -
    1) with an empty (M = 0) mutation plane, bit-exact against the plain
    version; roots equal the population of the hap the ledger holds."""
    rng = np.random.default_rng(C * n + n_pop)
    per = rng.integers(1, 4, size=n_pop)
    starts = np.concatenate([[0], np.cumsum(2 * per)[:-1]])
    H = int(2 * per.sum())
    led = [paint_ledger(rng, n, S, 20, np.int16, H=H) for _ in range(C)]
    pos = np.stack([paint_positions(rng, Q, big_queries=False)
                    for _ in range(C)])
    if order == "shuffled":
        pos = np.stack([rng.permutation(p) for p in pos])
    roots = np.repeat(np.arange(n_pop, dtype=np.uint8), 2 * per)
    st, hap = (T(np.stack([x[i] for x in led]), device=cuda) for i in (0, 1))
    panel = T(roots, device=cuda)[None, :, None].expand(C, H, Q).contiguous()
    pos = T(pos, device=cuda)
    empty = torch.empty((C, n, 2, 0), dtype=torch.int32, device=cuda)
    before = tpaint.paint.launches
    got = tpaint.paint(st, hap, empty, panel, pos)
    torch.cuda.synchronize()
    assert tpaint.paint.launches == before + 1
    assert tpaint.paint.plan == tpaint.launch_plan(C, n, S, 0, Q)
    assert torch.equal(got, tpaint.paint_plain(st, hap, empty, panel, pos))
    h = torch.stack([tpaint.segments.hap_at(st[c], hap[c], pos[c])
                     for c in range(C)]).long().cpu().numpy()
    want = np.searchsorted(starts, np.clip(h, 0, H - 1), side="right") - 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert int(got.max()) == n_pop - 1


@pytest.mark.cuda
def test_cuda_int32_haps_past_32000(cuda):
    """Several populations' founders past 32,000 haps: int32 haps through
    the count, the merge (both modes) and paint (alleles over a 40,000-hap
    panel, and roots with M = 0), each bit-exact against its plain
    version."""
    rng = np.random.default_rng(40_000)
    nchr, n, S, K, H = 3, 2_000, 49, 23, 40_000
    st, hap, parents, xo_f, xo_m, sh = stacked(rng, nchr, n, S, K, 14,
                                               np.int32)
    hap = np.where(st < BIG, rng.integers(0, H, size=st.shape), 0)
    hap[:, ::3, 0, 0] = H - 1
    a = [T(x, device=cuda) for x in (st, hap.astype(np.int32), parents,
                                     xo_f, xo_m, sh)]
    assert a[1].dtype == torch.int32 and int(a[1].max()) > 32_000
    assert torch.equal(tcount.merge_count(a[0], *a[2:]),
                       tcount.merge_count_plain(a[0], *a[2:]))
    for merge_ibd in (True, False):
        got = tmerge.meiose_merge(*a, S, merge_ibd)
        want = tmerge.meiose_merge_plain(*a, S, merge_ibd)
        torch.cuda.synchronize()
        assert all(torch.equal(x, w) for x, w in zip(got, want))
    c_st, c_hap, _ = tmerge.meiose_merge(*a, S, True)
    pos = T(np.sort(rng.integers(0, 30_000, size=(nchr, 100)), 1)
            .astype(np.int32), device=cuda)
    mut = torch.full((nchr, n, 2, 4), BIG, dtype=torch.int32, device=cuda)
    mut[:, ::5, 0, 0] = pos[:, 7, None]
    founder = torch.randint(0, 2, (nchr, H, 100), dtype=torch.uint8,
                            device=cuda)
    roots = (torch.arange(H, device=cuda) >= 20_000).to(torch.uint8)
    roots = roots[None, :, None].expand(nchr, H, 100).contiguous()
    for panel, m in ((founder, mut), (roots, mut[..., :0].contiguous())):
        got = tpaint.paint(c_st, c_hap, m, panel, pos)
        torch.cuda.synchronize()
        assert torch.equal(got, tpaint.paint_plain(c_st, c_hap, m, panel,
                                                   pos))


@pytest.mark.cuda
@pytest.mark.parametrize("law, mm", [("p", 0.0), ("f", 0.0), ("p", 0.2)])
def test_cuda_device_mating_equals_cpu(cuda, law, mm):
    """`assort_mate_device`'s pairing on the card equals the CPU's under
    the same draws (drawn on the CPU and moved): the plan is identical."""
    from geneevolve_tpu_torch.parallel import mating_device as md

    rng = np.random.default_rng(21)
    n, pop_size = 3000, 3100
    mv = T(rng.normal(size=n).astype(np.float32))
    svf = T(rng.uniform(0.3, 1.0, size=n).astype(np.float32))
    sex = T(rng.integers(1, 3, size=n))
    ped = {k: T(rng.integers(0, n // 3, size=n))
           for k in ("father", "ff", "fm", "mf", "mm")}
    draws = md.draw_assort(torch.Generator().manual_seed(5), n, mm, law,
                           pop_size)
    args = (0.3, True, pop_size, mm, law, pop_size)
    want = md.pair(draws, mv, svf, sex, ped, *args)
    got = md.pair(md.MateDraws(*(None if d is None else d.to(cuda)
                                 for d in draws)),
                  mv.to(cuda), svf.to(cuda), sex.to(cuda),
                  {k: v.to(cuda) for k, v in ped.items()}, *args)
    torch.cuda.synchronize()
    for k in md.DevicePlan._fields:
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    assert want.inbred.any()


@pytest.mark.cuda
def test_cuda_parent_draw_deterministic(cuda):
    """The selection parent draw at the slice's 30,000 rows is a function
    of the generator alone on the card: drawn twice from equal seeds, with
    the allocator's blocks reused in between, the parents are equal."""
    from geneevolve_tpu_torch.dense import step as tstep

    logits = torch.randn(30_000, generator=torch.Generator().manual_seed(1))
    logits = logits.to(cuda)
    draws = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(2)
        draws.append(tstep.draw_parents(gen, 30_000, 30_000, logits))
        torch.randint(0, 2**31, (1 << 26,), device=cuda)  # churn memory
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*draws))


def _check_inherit(args, Mo, part):
    """The kernel against its plain version on the card, for each parent:
    the written rows, the counts, and the other parent's slots untouched.
    Returns the counts of parent 0's gametes."""
    out = []
    for g in range(2):
        got = inherit_planes(tinherit.gamete_inherit, args, Mo, part, g)
        torch.cuda.synchronize()
        want = inherit_planes(tinherit.gamete_inherit_plain, args, Mo, part,
                              g)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
        out.append(got[2])
    return out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("part", INHERIT_PARTS)
@pytest.mark.parametrize("nk, n, K, Mp, mn, C, Mo, span", INHERIT_CASES)
def test_cuda_gamete_inherit_kernel(cuda, nk, n, K, Mp, mn, C, Mo, span,
                                    part):
    """Crowded rows (de novo slots equal to each other, to parent mutations
    and to CVs; crossovers equal to each other and on CVs and mutations),
    counts past Mo, K and mn past 32, with and without mutation or CV rows,
    written through [:, :, g] views: the kernel equals the plain version
    bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(n + K + Mo)
    args = inherit_case(g, nk, n, K, Mp, mn, C, span, device=cuda)
    counts = _check_inherit(args, Mo, part)
    if part == "both" and Mo < Mp:
        assert (counts > Mo).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30_708, 302_208])
def test_cuda_gamete_inherit_at_group_shapes(cuda, n):
    """The in-place real pass's group at 30,000 and 300,000 (2 chromosomes
    of their plane rows, K 23, Mp 37, mn 11, 100 CVs), positions over a
    chromosome's length."""
    g = torch.Generator(device=cuda).manual_seed(n)
    args = inherit_case(g, 2, n, 23, 37, 11, 100, 249_000_000, device=cuda)
    _check_inherit(args, 37, "both")


@pytest.mark.cuda
def test_cuda_gamete_inherit_past_chunk_rows(cuda):
    """More than 2^19 gametes of one chromosome in one launch: the kernel
    equals the plain version over its row chunks."""
    n = tmemory.CHUNKED_PAST + 4099
    g = torch.Generator(device=cuda).manual_seed(19)
    args = inherit_case(g, 1, n, 23, 37, 11, 100, 5_000, device=cuda)
    assert tmemory.Switches.from_env().chunk_rows(n) < n
    _check_inherit(args, 30, "both")


@pytest.mark.cuda
def test_cuda_gamete_inherit_refuses_rows_past_shared_memory(cuda):
    """One gamete's rows above a block's 227 KB: the wrapper raises."""
    g = torch.Generator(device=cuda).manual_seed(2)
    args = inherit_case(g, 1, 4, 8, 15_000, 4, 10, 1 << 20, device=cuda)
    with pytest.raises(ValueError):
        inherit_planes(tinherit.gamete_inherit, args, 15_000, "both", 0)
