"""Segment-ledger genome representation and meiosis, in PyTorch.

Counterpart of geneevolve_tpu/core/segments.py. A chromatid is a sorted,
fixed-capacity boundary array: `seg_st[k]` is the bp where segment k starts
and `seg_hap[k]` the founder haplotype it copies; padding slots hold `BIG`.
The hap covering bp q is `seg_hap[#{seg_st <= q} - 1]`.

Positions are int32 with `BIG = 2**30` (the JAX package's x64-off path).
Layout follows the JAX public functions: (n, 2, S) ledgers, (n, K)
crossover rows. The functions here are the plain versions: they run on any
device, serve CPU tensors and the tests, and are the oracles of the CUDA
kernels in `ops/` (merge, count, paint). The sampler draws with torch's
generators and hands the draws to `ops/point_draws`, whose CUDA kernel
replaces no TPU kernel: it fuses the plain chain from the draws to the
positions (`point_draws_plain`: `torch.cumsum`, `cdf_bins`'s search,
`_place`) into one launch a kind of draw, bound by the bytes of the draws
and positions, and scans in torch.cumsum's order, since the benchmark's
check draws the plan again with that chain and compares it exactly.
Where the JAX package ranked candidates with O(L^2) compare-reduces to
suit XLA, the torch versions sort stably — the same (value, candidate
index) order, so the same result. Counterparts:
`_active_at_T` -> `active_at`, `_seg_lookup_T` -> `hap_at`,
`rank_compact_T` -> `rank_compact`, and `merge3_T` -> `rank_compact` over
the concatenated candidates [X; A; B] inside `meiose`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# `cdf_bins` is looked up here by `point_draws_plain` (tests substitute it)
from geneevolve_tpu_torch.ops.cdf_bins import cdf_bins  # noqa: F401
from geneevolve_tpu_torch.ops.point_draws import point_draws

BIG = 2**30
POS = torch.int32


@dataclass(frozen=True)
class ChromMaps:
    """Static per-chromosome map data (host numpy)."""

    chrom: int
    chr_start: int
    bin_width: int
    bp: np.ndarray  # (K,) bin anchors
    xo_cum: np.ndarray  # (K,) cumulative crossover bin mass, f32
    xo_lambda: float  # total crossover mass (Morgans)
    mut_bp: np.ndarray  # (Km,) mutation-map anchors (zeros when absent)
    mut_cum: np.ndarray  # (Km,) cumulative mutation mass, f32
    mut_lambda: float
    # affine anchors: bp[k] == bp[0] + k*step exactly
    bp_affine: bool = False
    mut_bp_affine: bool = False

    @staticmethod
    def build(chrom, rmap, mmap=None) -> "ChromMaps":
        p = rmap.prob
        if mmap is not None:
            mrate = mmap.rate.copy()
            mrate[0] = 0.0  # loop starts at bin 1 (`Simulation.cpp:2509`)
            mut_bp = np.asarray(mmap.bp, dtype=np.int32)
            mut_cum = np.cumsum(mrate).astype(np.float32)
            mut_lambda = float(mrate.sum())
        else:
            mut_bp = np.zeros((2,), dtype=np.int32)
            mut_cum = np.zeros((2,), dtype=np.float32)
            mut_lambda = 0.0
        bp = np.asarray(rmap.bp, dtype=np.int32)

        def affine(a, w):
            return bool(
                len(a) > 1
                and np.array_equal(a, a[0] + np.arange(len(a)) * w)
            )

        return ChromMaps(
            chrom=int(chrom),
            chr_start=int(rmap.bp[0]),
            bin_width=int(rmap.bin_width),
            bp=bp,
            xo_cum=np.cumsum(p).astype(np.float32),
            xo_lambda=float(p.sum()),
            mut_bp=mut_bp,
            mut_cum=mut_cum,
            mut_lambda=mut_lambda,
            bp_affine=affine(bp, int(rmap.bin_width)),
            mut_bp_affine=(
                affine(mut_bp, mut_bp[1] - mut_bp[0])
                if mmap is not None and len(mut_bp) > 1
                else False
            ),
        )


@dataclass(frozen=True)
class StackedMaps:
    """All chromosomes' maps padded to common lengths and stacked on a
    leading chr axis, on the device. Padding bins repeat the last anchor
    and the last cumulative value (zero added mass), so they are never
    sampled. The lambdas and bin widths stay host floats: they size the
    draws."""

    bp: torch.Tensor  # (nchr, K) int32
    xo_cum: torch.Tensor  # (nchr, K) f32
    xo_lambda: np.ndarray  # (nchr,) float32
    bin_width: np.ndarray  # (nchr,) float32
    mut_bp: torch.Tensor  # (nchr, Km) int32
    mut_cum: torch.Tensor  # (nchr, Km) f32
    mut_lambda: np.ndarray  # (nchr,) float32
    # affine anchors (None unless every chromosome's map is affine)
    bp0: Optional[np.ndarray] = None
    mut_bp0: Optional[np.ndarray] = None
    bp_step: Optional[np.ndarray] = None
    mut_bp_step: Optional[np.ndarray] = None

    @staticmethod
    def build(maps, device) -> "StackedMaps":
        def stack(arrs, dtype):
            K = max(a.shape[0] for a in arrs)
            out = np.stack(
                [
                    np.concatenate([a, np.full(K - a.shape[0], a[-1])])
                    for a in arrs
                ]
            )
            return torch.as_tensor(out.astype(dtype), device=device)

        f32 = np.float32
        return StackedMaps(
            bp=stack([m.bp for m in maps], np.int32),
            xo_cum=stack([m.xo_cum for m in maps], f32),
            xo_lambda=np.array([m.xo_lambda for m in maps], f32),
            bin_width=np.array([m.bin_width for m in maps], f32),
            mut_bp=stack([m.mut_bp for m in maps], np.int32),
            mut_cum=stack([m.mut_cum for m in maps], f32),
            mut_lambda=np.array([m.mut_lambda for m in maps], f32),
            bp0=(
                np.array([m.bp[0] for m in maps], np.int32)
                if all(m.bp_affine for m in maps) else None
            ),
            mut_bp0=(
                np.array([m.mut_bp[0] for m in maps], np.int32)
                if all(m.mut_bp_affine for m in maps) else None
            ),
            bp_step=np.array([m.bin_width for m in maps], np.int32),
            mut_bp_step=np.array(
                [
                    int(m.mut_bp[1] - m.mut_bp[0]) if len(m.mut_bp) > 1 else 1
                    for m in maps
                ],
                np.int32,
            ),
        )


def init_gen0_ledger_stacked(
    n: int, chr_starts, hap_offset: int, capacity: int,
    hap_dtype=torch.int32, rows: int = 0, device="cuda", ids=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nchr, rows, 2, S) founder ledgers: founder i's chromatids point
    wholly at founder haps 2i / 2i+1 (+ offset), as in
    `ras_initial_human_gen0` (`Simulation.cpp:3024-3035`). Rows past n are
    copies of founder n-1 (valid hap indices, masked from statistics).
    `ids`: only those rows (a mesh rank's block), in that order."""
    nchr = len(chr_starts)
    if ids is None:
        ids = torch.arange(max(rows, n), device=device)
    st = torch.full((nchr, len(ids), 2, capacity), BIG, dtype=POS,
                    device=device)
    st[:, :, :, 0] = torch.as_tensor(
        np.asarray(chr_starts), dtype=POS, device=device
    )[:, None, None]
    hap = torch.zeros((nchr, len(ids), 2, capacity), dtype=hap_dtype,
                      device=device)
    base = hap_offset + 2 * torch.clamp(ids, max=n - 1)
    hap[:, :, 0, 0] = base.to(hap_dtype)[None, :]
    hap[:, :, 1, 0] = (base + 1).to(hap_dtype)[None, :]
    return st, hap


def empty_mutations_stacked(nchr: int, n: int, capacity: int,
                            device="cuda") -> torch.Tensor:
    return torch.full((nchr, n, 2, capacity), BIG, dtype=POS, device=device)


def sample_point_process(
    gen: torch.Generator,
    n: int,
    cap: int,
    cum: torch.Tensor,  # (K,) f32 cumulative bin mass
    lam: float,
    bp: torch.Tensor,  # (K,) int32 anchors
    width: float,
    inclusive_bins: bool,
    bp0: Optional[int] = None,  # affine anchors: bp[k] == bp0 + k*bp_step
    bp_step: Optional[int] = None,
) -> torch.Tensor:
    """(n, cap) int32 positions padded with BIG, non-decreasing in bin.

    The law of geneevolve_tpu's `sample_point_process`: a Poisson(lam)
    count clipped to `cap`; the row's points are the order statistics of
    `count` uniforms on [0, total mass), built as normalized cumulative
    Exp(1) gaps `u = S_j / S_{count+1} * cum[-1]`; bins from the inverse CDF
    (clamped to K-1); and a FRESH within-bin uniform for the offset, so two
    same-bin points may be out of order within a row.
    `inclusive_bins=False` is the crossover convention (`bp[j] +
    U[0, width)`), True the mutation one (uniform over [bp[j-1], bp[j]]).
    The stacked sampler's one-chromosome case."""
    return sample_point_process_stacked(
        [gen], n, cap, cum[None], [lam], bp[None], [width], inclusive_bins,
        None if bp0 is None else [bp0], None if bp_step is None else [bp_step],
    )[0]


def sample_point_process_stacked(
    gens, n: int, cap: int, cum: torch.Tensor, lam, bp: torch.Tensor, width,
    inclusive_bins: bool, bp0=None, bp_step=None,
) -> torch.Tensor:
    """(C, n, cap): `sample_point_process` for C chromosomes at once, row c
    drawn from `gens[c]` over `cum[c]`, `lam[c]`, `bp[c]`, `width[c]` (and
    `bp0[c]`, `bp_step[c]` when given). Each live chromosome's generator
    draws, in order, the (n,) Poisson counts, the (n, cap + 1) uniforms of
    the Exp(1) gaps and the (n, cap) within-bin uniforms, straight into
    the stacked buffers; a chromosome of rate 0 draws nothing. One
    `point_draws` call then turns every chromosome's draws into positions."""
    C = len(gens)
    device = cum.device
    live = [float(lam[c]) > 0.0 for c in range(C)]
    counts = torch.empty((C, n), dtype=torch.float32, device=device)
    unif = torch.empty((C, n, cap + 1), dtype=torch.float32, device=device)
    v = torch.empty((C, n, cap), dtype=torch.float32, device=device)
    for c in range(C):
        if live[c]:
            rate = torch.full((n,), float(lam[c]), dtype=torch.float32,
                              device=device)
            counts[c] = torch.poisson(rate, generator=gens[c])
            torch.rand((n, cap + 1), generator=gens[c], out=unif[c])
            torch.rand((n, cap), generator=gens[c], out=v[c])
    return point_draws(counts, unif, v, cum, bp, width, live, inclusive_bins,
                       bp0, bp_step)


def _place(v, counts, bins, bp, width, inclusive_bins, bp0, bp_step):
    """Positions in the drawn bins, from the within-bin uniforms `v`."""
    n, cap = bins.shape
    device = bins.device
    v = torch.clamp(v, max=1.0 - 1e-7)
    if bp0 is not None:
        bp_bin = bp0 + bins * bp_step
        bp_prev = bp_bin - bp_step
    else:
        bp_bin = bp[bins.long()]
        bp_prev = bp[torch.clamp(bins - 1, min=0).long()]
    if inclusive_bins:
        span = (bp_bin - bp_prev + 1).to(torch.float32)
        pos = bp_prev + torch.floor(v * span).to(POS)
    else:
        pos = bp_bin + torch.floor(v * float(width)).to(POS)
    live = torch.arange(cap, device=device)[None, :] < counts[:, None]
    return torch.where(live, pos.to(POS), BIG)


def active_at(xo: torch.Tensor, start_hap: torch.Tensor,
              q: torch.Tensor) -> torch.Tensor:
    """(nc, Q) parent chromatid copied at each query: (start + #{xo <= q})
    % 2. Order-independent in the crossovers; BIG padding never counts
    against a valid q. The count is a sorted search of each crossover row
    (the (nc, Q, K) compare's sum would be cast to an int64 copy first)."""
    xs = torch.sort(xo, dim=1).values
    cnt = torch.searchsorted(xs, q.contiguous(), right=True)
    return (start_hap[:, None].long() + cnt) % 2


def member(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(nc, Q) bool: is q[i, j] one of rows[i] (nc, M)? A sorted search of
    each row, without the (nc, M, Q) compare."""
    xs = torch.sort(rows, dim=1).values
    i = torch.searchsorted(xs, q, right=False)
    got = xs.gather(1, i.clamp(max=xs.shape[1] - 1))
    return (i < xs.shape[1]) & (got == q)


def rank_compact(cand, valid, cap, *vals):
    """Stable compaction of (nc, L) rows: the valid entries ordered by
    (value, candidate index) into `cap` slots; slots past the row's valid
    count read BIG (positions) / 0 (the rest). Returns (out_st, *out_vals,
    n_valid) with n_valid uncapped — `rank_compact_T` of the JAX package."""
    nc, L = cand.shape
    if L < cap:  # room for every slot: pad with invalid candidates
        extra = cap - L
        cand = torch.cat([cand, cand.new_full((nc, extra), BIG)], 1)
        valid = torch.cat([valid, valid.new_zeros((nc, extra))], 1)
        vals = [torch.cat([v, v.new_zeros((nc, extra))], 1) for v in vals]
    key = torch.where(valid, cand, BIG)
    order = torch.sort(key, dim=1, stable=True).indices[:, :cap]
    n_valid = valid.sum(1).to(torch.int32)
    pad = torch.arange(cap, device=cand.device)[None, :] >= n_valid[:, None]
    outs = [torch.where(pad, BIG, key.gather(1, order)).to(cand.dtype)]
    for v in vals:
        g = v.gather(1, order)
        outs.append(torch.where(pad, torch.zeros_like(g), g))
    return (*outs, n_valid)


def meiose(
    par_st: torch.Tensor,  # (nc, 2, S) parent chromatid boundary starts
    par_hap: torch.Tensor,  # (nc, 2, S)
    xo: torch.Tensor,  # (nc, K) crossover positions (BIG padded, unsorted)
    start_hap: torch.Tensor,  # (nc,) 0/1
    capacity: int,
    merge_ibd: bool = True,
):
    """One gamete per row: (child_st (nc, capacity), child_hap, n_valid).

    The child ledger is the stable merge, candidate order X < A < B, of
    X = [chr_start; xo], the parent's chromatid-0 slots s > 0 the gamete
    copies (A) and its chromatid-1 slots it copies (B). A crossover carries
    the newly active chromatid's covering hap. `merge_ibd=False` then
    drops earlier entries of equal positions (keep-last), the reference's
    exact part splitting. Same result as the JAX `meiose` / `merge3_T`."""
    nc, _, S = par_st.shape
    A, B = par_st[:, 0], par_st[:, 1]
    hA, hB = par_hap[:, 0].long(), par_hap[:, 1].long()
    X = torch.cat([A[:, :1], xo], 1)
    actX = active_at(xo, start_hap, X)
    actA = active_at(xo, start_hap, A)
    actB = active_at(xo, start_hap, B)
    not_first = torch.arange(S, device=par_st.device)[None, :] > 0
    vX = torch.cat(
        [torch.ones((nc, 1), dtype=torch.bool, device=xo.device), xo < BIG], 1
    )
    vA = (A < BIG) & (actA == 0) & not_first
    vB = (B < BIG) & (actB == 1) & not_first
    hX = torch.where(actX == 0, hap_at(A, hA, X), hap_at(B, hB, X))
    st, hap, n_valid = rank_compact(
        torch.cat([X, A, B], 1), torch.cat([vX, vA, vB], 1), capacity,
        torch.cat([hX, hA, hB], 1),
    )
    if not merge_ibd:
        last = torch.cat(
            [
                (st[:, 1:] != st[:, :-1]) | (st[:, 1:] >= BIG),
                torch.ones((nc, 1), dtype=torch.bool, device=st.device),
            ],
            1,
        )
        keep = last & (st < BIG)
        st, hap, n_valid = rank_compact(st, keep, capacity, hap)
    return st, hap.to(par_hap.dtype), n_valid


def count_merge_valid(par_st, xo, start_hap) -> torch.Tensor:
    """(nc,) int32 valid-slot count of `meiose`'s merge, without building
    it — the capacity probe's count."""
    S = par_st.shape[-1]
    A, B = par_st[:, 0], par_st[:, 1]
    not_first = torch.arange(S, device=par_st.device)[None, :] > 0
    vA = (A < BIG) & (active_at(xo, start_hap, A) == 0) & not_first
    vB = (B < BIG) & (active_at(xo, start_hap, B) == 1) & not_first
    return (1 + (xo < BIG).sum(1) + vA.sum(1) + vB.sum(1)).to(torch.int32)


def inherit_mutations(par_mut, xo, start_hap, new_mut, capacity):
    """Keep a parent mutation iff the gamete copied its region
    (`Simulation.cpp:2961-2970`), add the de novo ones, and keep each
    position once (the reference flips on membership, not count). Returns
    ((nc, capacity) ascending BIG-padded positions, n_valid uncapped)."""
    m0, m1 = par_mut[:, 0], par_mut[:, 1]
    k0 = torch.where((m0 < BIG) & (active_at(xo, start_hap, m0) == 0),
                     m0, BIG)
    k1 = torch.where((m1 < BIG) & (active_at(xo, start_hap, m1) == 1),
                     m1, BIG)
    s = torch.sort(torch.cat([k0, k1, new_mut.to(POS)], 1), dim=1).values
    dup = torch.cat(
        [torch.zeros_like(s[:, :1], dtype=torch.bool), s[:, 1:] == s[:, :-1]],
        1,
    )
    s = torch.sort(torch.where(dup, BIG, s), dim=1).values
    n_valid = (s < BIG).sum(1).to(torch.int32)
    if s.shape[1] < capacity:
        s = torch.cat([s, s.new_full((s.shape[0], capacity - s.shape[1]),
                                     BIG)], 1)
    return s[:, :capacity].contiguous(), n_valid


def gamete_cv(rows, xo, start, pm, new_g, q):
    """The gamete's CV alleles from its parent's CV rows (nc, 2, C): the
    parent allele of the chromatid it copies at each CV position q (C,),
    flipped by a de novo mutation at that position unless the copied
    chromatid already carries one there (membership, not parity —
    `Simulation.cpp:2961-2970`). `pm` None: no mutation map. Sorted
    searches of each row: its transients are (nc, C) tensors."""
    qx = q.expand(xo.shape[0], -1).contiguous()
    phase = active_at(xo, start, qx)
    g = torch.where(phase == 0, rows[:, 0], rows[:, 1])
    if pm is not None:
        carried = torch.where(phase == 0, member(pm[:, 0], qx),
                              member(pm[:, 1], qx))
        flip = member(new_g, qx) & ~carried
        g = torch.where(flip, 1 - g, g)
    return g


def in_row_chunks(fn, chunk: int, rows: tuple, *fixed):
    """`fn(*rows, *fixed)` over chunks of `chunk` rows (axis 0 of each
    tensor of `rows`; None passes through), the outputs (a tensor or a
    tuple of them) concatenated on axis 0. Equal to one call for any `fn`
    whose output row i reads only row i of `rows`, as
    `inherit_mutations` and `gamete_cv` do; it bounds
    their transients at biobank row counts (the JAX `_make_per_chr`'s
    chunks)."""
    n = next(x.shape[0] for x in rows if x is not None)
    if n <= chunk:
        return fn(*rows, *fixed)
    parts = [fn(*(None if x is None else x[lo:lo + chunk] for x in rows),
                *fixed) for lo in range(0, n, chunk)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def hap_at(seg_st: torch.Tensor, seg_hap: torch.Tensor,
           q: torch.Tensor) -> torch.Tensor:
    """Founder hap covering position(s) q: `hap[#{st <= q} - 1]`, and 0
    where no start is <= q (the JAX one-hot select matches no slot there;
    it does not clamp to slot 0). seg_* are (..., S); q is (..., Q) with
    the same leading dims, or 1-D. Returns (..., Q) in seg_hap's dtype."""
    lead = seg_st.shape[:-1]
    if q.dim() == 1:
        q = q.expand(lead + q.shape)
    idx = (seg_st[..., None, :] <= q[..., :, None]).sum(-1) - 1
    got = seg_hap.gather(-1, idx.clamp(min=0))
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def mutation_flip_mask(mut: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., Q) bool: is a carried mutation exactly at q? Membership, not
    parity, and only where q < BIG (`Simulation.cpp:2770-2775`,
    `:1218-1222`). mut is (..., M); q (..., Q) or 1-D."""
    q = q.expand(mut.shape[:-1] + q.shape[-1:])
    hit = (mut[..., None, :] == q[..., :, None]).any(-1)
    return hit & (q < BIG)
