"""Shared inputs for the port's kernel tests (no JAX here: the CUDA tests
run on machines without it)."""

import numpy as np
import torch

from geneevolve_tpu_torch.ops.paint import SPAN

BIG = 2**30


def cdf(rng, K, flat=0.3):
    mass = rng.exponential(size=K).astype(np.float32)
    mass[rng.random(K) < flat] = 0.0  # flat runs of equal cum values
    return np.cumsum(mass, dtype=np.float32)


def probes(rng, cum):
    u = rng.uniform(0, float(cum[-1]), size=4096).astype(np.float32)
    extra = [0.0, -1.0, float(cum[-1]), float(cum[-1]) * 1.5]
    return np.concatenate([u, cum[:64], np.float32(extra)]).astype(np.float32)


def ledger(rng, n, S, live, span=30000, hap_dtype=np.int32):
    """(n, 2, S) sorted-prefix ledgers with duplicate positions, BIG
    padded, first boundary at 0, plus random founder haps."""
    st = np.full((n, 2, S), BIG, dtype=np.int32)
    lens = rng.integers(1, live + 1, size=(n, 2))
    for i in range(n):
        for c in range(2):
            k = lens[i, c]
            st[i, c, :k] = np.sort(rng.integers(0, span, size=k))
    st[..., 0] = 0
    hap = rng.integers(0, 20000, size=(n, 2, S)).astype(hap_dtype)
    hap[st >= BIG] = 0
    return st, hap


def crossovers(rng, n, K, st, span=30000):
    """(n, K) crossover rows, BIG padded, NOT sorted: same-bin points out
    of order, some exactly at parent boundaries, some duplicated."""
    xo = np.full((n, K), BIG, dtype=np.int32)
    cnt = rng.integers(0, K + 1, size=n)
    for i in range(n):
        pts = rng.integers(1, span, size=cnt[i])
        if cnt[i] >= 2:
            pts[0] = st[i, 0, min(1, st.shape[2] - 1)] % BIG or 5
            pts[1] = pts[0]  # duplicate position
        if cnt[i] >= 3:
            pts[2] = st[i, 1, min(2, st.shape[2] - 1)] % BIG or 7
        xo[i, : cnt[i]] = rng.permutation(pts)
    return xo


def stacked(rng, nchr, n, S, K, live, hap_dtype=np.int16):
    """The segment path's stacked merge operands: (nchr, n, 2, S) ledgers
    and haps, (2, n) father's and mother's rows, (nchr, n, K) crossovers of
    each parent's gametes (some at that parent's boundaries) and (nchr, n,
    2) start chromatids."""
    st = np.empty((nchr, n, 2, S), np.int32)
    hap = np.empty((nchr, n, 2, S), hap_dtype)
    for c in range(nchr):
        st[c], hap[c] = ledger(rng, n, S, live, hap_dtype=hap_dtype)
    parents = rng.integers(0, n, size=(2, n)).astype(np.int32)
    xo_f, xo_m = (np.stack([crossovers(rng, n, K, st[c][parents[g]])
                            for c in range(nchr)]) for g in range(2))
    sh = rng.integers(0, 2, size=(nchr, n, 2)).astype(np.int32)
    return st, hap, parents, xo_f, xo_m, sh


def dense_plan(rng, n, n_chr, chr_len, K):
    """(n, n_chr, K) crossover loci with the sampler's layout — real slots
    first, unsorted, pad = m — where every third row carries two
    crossovers in one 32-locus word and a duplicated locus; plus starts."""
    m = n_chr * chr_len
    xo = np.full((n, n_chr, K), m, dtype=np.int32)
    cnt = rng.integers(0, K + 1, size=(n, n_chr))
    for i in range(n):
        for c in range(n_chr):
            pts = rng.integers(c * chr_len, (c + 1) * chr_len, size=cnt[i, c])
            if cnt[i, c] >= 3 and i % 3 == 0:
                pts[1] = np.clip((pts[0] & ~31) + rng.integers(0, 32),
                                 c * chr_len, (c + 1) * chr_len - 1)
                pts[2] = pts[0]
            xo[i, c, : cnt[i, c]] = pts
    start = rng.integers(0, 2, size=(n, n_chr)).astype(np.int32)
    return xo, start


def foreign_slots(xo, chr_len):
    """`xo` with the last slot of every odd row's chromosomes c >= 1 at
    chromosome c-1's last column: the crossover the `cdf` sampler draws
    when `lo + u * lam` rounds to `lo`."""
    xo = xo.copy()
    for c in range(1, xo.shape[1]):
        xo[1::2, c, -1] = c * chr_len - 1
    return xo


def mutation_loci(rng, n, m, Km):
    """(n, 2, Km) loci, pad = m, with duplicates (which cancel) and pairs
    in one word."""
    mu = np.full((n, 2, Km), m, dtype=np.int32)
    cnt = rng.integers(0, Km + 1, size=(n, 2))
    for i in range(n):
        for g in range(2):
            pts = rng.integers(0, m, size=cnt[i, g])
            if cnt[i, g] >= 3:
                pts[1] = pts[0]
                pts[2] = min((pts[0] & ~31) + rng.integers(0, 32), m - 1)
            mu[i, g, : cnt[i, g]] = pts
    return mu


def paint_ledger(rng, n, S, live, hap_dtype, span=30_000, first=500, H=64):
    """(n, 2, S) ascending ledgers for painting, BIG padded, first start at
    `first` (so queries below it find no slot), with duplicate starts;
    `live` >= S fills every slot. Haps in [0, H)."""
    st = np.full((n, 2, S), BIG, dtype=np.int32)
    lens = rng.integers(1, min(live, S) + 1, size=(n, 2))
    if live >= S:
        lens[:] = S
    for i in range(n):
        for c in range(2):
            k = lens[i, c]
            pts = np.sort(rng.integers(first, span, size=k))
            if k >= 3:
                pts[2] = pts[1]  # a duplicate start
            pts[0] = first
            st[i, c, :k] = pts
    hap = rng.integers(0, H, size=(n, 2, S)).astype(hap_dtype)
    hap[st >= BIG] = 0
    return st, hap


def paint_mutations(rng, n, M, pos):
    """(n, 2, M) ascending rows, BIG padded: empty rows, rows at painted
    positions (some twice), rows at positions no query hits."""
    mut = np.full((n, 2, M), BIG, dtype=np.int32)
    for i in range(n):
        for c in range(2):
            k = rng.integers(0, M + 1) if i % 4 else 0  # every 4th row empty
            pts = np.concatenate([rng.choice(pos[pos < BIG], size=k),
                                  rng.integers(0, 30_000, size=k)])[:k]
            if k >= 2:
                pts[1] = pts[0]  # duplicate: membership, not parity
            mut[i, c, :k] = np.sort(pts)
    return mut


def paint_positions(rng, Q, big_queries=True):
    """Q ascending positions: some before every first start, some at
    starts' values, and BIG / past-BIG queries at the end."""
    q = np.sort(rng.integers(0, 32_000, size=Q)).astype(np.int32)
    q[:3] = [0, 100, 499]  # before the first start (500)
    q[3] = 500
    if big_queries:
        q[-2:] = [BIG, BIG + 7]
    return q


CASES = [(500, 49, 23, 14), (257, 8, 3, 5), (1024, 16, 9, 16), (300, 12, 5, 8)]
# (nchr, n, S, K, live) for the stacked merge and count: the slice's S and
# K, then K past one warp's lanes (two crossovers a lane) and S past two
# and four 32-slot words with most slots live
STACKED_CASES = [(3, 120, 49, 23, 14), (3, 60, 65, 33, 60),
                 (3, 40, 130, 64, 120), (3, 40, 130, 33, 128)]


# the paint kernel's card cases (tests/test_torch_cuda.py): (C, rows, S,
# live slots, M, Q, hap dtype, order of the positions)
PAINT_CASES = [
    (3, 61, 9, 5, 5, 77, np.int16, "sorted"),  # ragged rows, Q odd
    (2, 40, 49, 16, 27, 1030, np.int32, "sorted"),  # Q % 16 = 6
    (1, 33, 130, 200, 64, 4096, np.int16, "sorted"),  # full ledgers, 16 B
    (22, 20, 49, 16, 27, 100, np.int16, "sorted"),  # the gather path's C, Q
    (2, 17, 12, 12, 3, 1544, np.int32, "shuffled"),  # unsorted positions
    (1, 9, 800, 300, 10, 600, np.int32, "sorted"),  # > 48 KB shared memory
    (1, 9, 600, 600, 10, 4100, np.int16, "sorted"),  # runs shorter than 16
    (2, 9, 3, 2, 2, 9000, np.int32, "sorted"),  # runs longer than a span
    (2, 21, 49, 16, 27, 1500, np.int32, "duplicates"),  # repeated positions
    (2, 13, 49, 30, 27, 4108, np.int16, "sorted"),  # Q % 16 = 12, 2 spans
    (22, 40, 49, 16, 27, 100, np.int16, "sorted"),  # the gather shape again
    (2, 19, 20, 12, 9, 8492, np.int32, "half"),  # shuffled span, sorted span
    (2, 3, 49, 16, 27, 300, np.int16, "sorted"),  # 6 rows: fewer than warps
    (1, 9000, 49, 16, 27, 100, np.int16, "sorted"),  # 2 rows a warp
    (2, 40, 49, 16, 27, 100, np.int16, "shuffled"),  # short rows, unsorted
]


def paint_case(C, n, S, live, M, Q, hap_dtype, order):
    """The inputs of a paint case, as numpy arrays: (starts, haps,
    mutations, panel, positions)."""
    rng = np.random.default_rng(C * n + S + Q)
    H = 64
    led = [paint_ledger(rng, n, S, live, hap_dtype, H=H) for _ in range(C)]
    pos = np.stack([paint_positions(rng, Q) for _ in range(C)])
    if order == "shuffled":
        pos = np.stack([rng.permutation(p) for p in pos])
    elif order == "half":  # the first span shuffled, the others sorted
        pos[:, :SPAN] = np.stack([rng.permutation(p) for p in pos[:, :SPAN]])
    elif order == "duplicates":  # each position three times
        pos = np.sort(np.repeat(pos[:, : -(-Q // 3)], 3, axis=1)[:, :Q], 1)
    mut = np.stack([paint_mutations(rng, n, M, pos[c]) for c in range(C)])
    founder = rng.integers(0, 2, size=(C, H, Q)).astype(np.uint8)
    founder[:, 5, :7] = 2  # a value 1 - f wraps
    st, hap = (np.stack([x[i] for x in led]) for i in (0, 1))
    hap[:, ::5, 0, 1] = H + 3  # haps outside the panel read its last row
    hap[:, 1::7, 1, 0] = -2  # and its first
    return st, hap, mut, founder, pos


# `ops/gamete_inherit`'s cases: (chromosomes, gametes, K crossover slots, Mp
# parent mutation slots, mn de novo slots, C CVs, Mo output slots, span of
# the positions). The benchmark's group shape at few rows; crowded rows
# whose de novo, parent mutations, crossovers and CV positions coincide
# often; K and mn past one warp's lanes with counts past Mo; rows as wide
# as their output; one crossover and one de novo slot.
INHERIT_CASES = [(2, 300, 23, 37, 11, 100, 37, 400),
                 (3, 200, 7, 6, 4, 9, 8, 30),
                 (2, 150, 40, 40, 20, 70, 12, 60),
                 (1, 257, 33, 70, 64, 33, 70, 200),
                 (2, 64, 1, 3, 1, 5, 3, 8)]
INHERIT_PARTS = ["both", "mutations", "cv"]


def inherit_case(gen, nk, n, K, Mp, mn, C, span, device="cpu"):
    """The operands of `ops/gamete_inherit` drawn from `gen`: (parent
    mutation rows (nk, n, 2, Mp), strictly ascending and BIG padded as the
    engine keeps them; parent CV rows (nk, n, 2, C) uint8; crossovers (nk,
    n, K), BIG padded, unsorted; start chromatids (nk, n, 2); de novo slots
    (nk, n, mn), unsorted, BIG where absent; CV positions (nk, C), unsorted
    and repeated). Half of every drawn position is one of its chromosome's
    CV positions, so crossovers, parent and de novo mutations and CVs fall
    on each other; the others lie anywhere in [0, span)."""
    def ri(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    def rb(*shape):
        return torch.rand(shape, generator=gen, device=device)

    def pos(*shape):
        w = int(np.prod(shape[2:]))
        at = torch.gather(q[:, None, :].expand(nk, n, C), 2,
                          ri(C, nk, n, w).long()).view(shape)
        return torch.where(rb(*shape) < 0.5, at, ri(span, *shape))

    q = ri(span, nk, C)
    q[:, -1] = q[:, 0]  # a repeated position, as the padding columns repeat
    xo = torch.where(rb(nk, n, K) < 0.6, pos(nk, n, K), BIG)
    pm = torch.where(rb(nk, n, 2, Mp) < 0.7, pos(nk, n, 2, Mp), BIG)
    pm = torch.sort(pm, -1).values
    dup = torch.zeros_like(pm, dtype=torch.bool)
    dup[..., 1:] = pm[..., 1:] == pm[..., :-1]
    pm = torch.sort(torch.where(dup, BIG, pm), -1).values
    cv = ri(2, nk, n, 2, C).to(torch.uint8)
    sh = ri(2, nk, n, 2)
    new = torch.where(rb(nk, n, mn) < 0.5, pos(nk, n, mn), BIG)
    return pm, cv, xo, sh, new, q


def inherit_planes(fn, args, Mo, part, g):
    """`fn` (the op or its plain version) writing parent g's gametes into
    (nk, n, 2, ...) child planes through their [:, :, g] views; the planes
    start filled with values no output holds. Returns (mutation plane, CV
    plane, counts)."""
    pm, cv, xo, sh, new, q = args
    nk, n = xo.shape[:2]
    dev = xo.device
    out_m = torch.full((nk, n, 2, Mo), -7, dtype=torch.int32, device=dev)
    out_c = torch.full((nk, n, 2, cv.shape[-1]), 9, dtype=torch.uint8,
                       device=dev)
    counts = fn(None if part == "cv" else pm,
                None if part == "mutations" else cv, xo, sh[:, :, g], new,
                q, None if part == "cv" else out_m[:, :, g],
                None if part == "mutations" else out_c[:, :, g])
    return out_m, out_c, counts
