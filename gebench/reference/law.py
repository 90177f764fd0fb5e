"""The random law of a generation, as the reference draws it.

GeneEvolve's simulation is random, so the reference draws the same numbers
the simulation's law prescribes, from the run's seed: host stages seed
NumPy from a fixed 63-bit schedule of (seed, generation, stage,
population); device stages draw from a `torch.Generator` seeded a
chromosome at a time. The point processes (crossovers, de novo mutations)
follow GeneEvolve's law: a Poisson count a gamete, clipped to a capacity,
the points the order statistics of that many uniforms over the map's mass
(normalized cumulative Exp(1) gaps), each mapped to its bin by the inverse
CDF and placed in the bin by a fresh uniform. The capacities follow from
the maps as the law sets them (a 6-sigma margin over the map's mass)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

BIG = 2**30
MASK = 0x7FFFFFFFFFFFFFFF

# stages of the seed schedule
INIT_SEX, INIT_COMMON, MATE, CROSSOVER = 0, 1, 2, 3
SEX, COMMON, E_NOISE, F_GEN0, MIGRATION = 6, 7, 8, 9, 10


def np_seed(seed: int, gen: int, stage: int, pop: int = 0) -> int:
    x = (seed * 1000003 + gen) & MASK
    x = (x * 1000033 + stage) & MASK
    return (x * 1000211 + pop) & MASK


def rng(seed: int, gen: int, stage: int, pop: int = 0):
    return np.random.default_rng(np_seed(seed, gen, stage, pop))


def generator(device, seed: int, gen: int, stage: int, pop: int,
              chrom: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((np_seed(seed, gen, stage, pop) * 1000249 + chrom) & MASK)
    return g


@dataclass
class Maps:
    """Every chromosome's sampling tables, padded to one length (padding
    repeats the last anchor and mass, so it is never drawn)."""

    xo_cum: torch.Tensor  # (nchr, K) f32
    xo_lam: np.ndarray  # (nchr,) f32
    bp: torch.Tensor  # (nchr, K) int32
    width: np.ndarray  # (nchr,) f32 bin widths
    mut_cum: torch.Tensor
    mut_lam: np.ndarray
    mut_bp: torch.Tensor
    bp_affine: bool
    mut_affine: bool
    bp_step: np.ndarray  # (nchr,) int32
    mut_step: np.ndarray
    xo_cap: int
    mn_cap: int
    has_mut: bool
    chr_start: np.ndarray  # (nchr,) int64


def _pad(arrs, dtype, device):
    K = max(len(a) for a in arrs)
    out = np.stack([np.concatenate([a, np.full(K - len(a), a[-1])])
                    for a in arrs]).astype(dtype)
    return torch.as_tensor(out, device=device)


def _affine(a, w) -> bool:
    return bool(len(a) > 1 and np.array_equal(a, a[0] + np.arange(len(a)) * w))


def maps(sc, device) -> Maps:
    """The sampling tables of scenario `sc` on `device`: crossover mass a
    bin = its cM step / 100 (none in the first bin); mutation mass a bin =
    the map's rate, rates outside [0, 1] and the first bin's read as 0."""
    xo_cum, xo_lam, bps, widths = [], [], [], []
    m_cum, m_lam, m_bp = [], [], []
    for i, (bp, cm) in enumerate(sc.rmap):
        p = np.diff(cm, prepend=cm[0]) * 0.01
        p[0] = 0.0
        xo_cum.append(np.cumsum(p).astype(np.float32))
        xo_lam.append(float(p.sum()))
        bps.append(bp.astype(np.int32))
        widths.append(int(bp[1] - bp[0]))
        if sc.mmap is not None:
            mbp, rate = sc.mmap[i]
            r = rate.copy()
            r[(r < 0) | (r > 1)] = 0.0
            r[0] = 0.0
            m_cum.append(np.cumsum(r).astype(np.float32))
            m_lam.append(float(r.sum()))
            m_bp.append(mbp.astype(np.int32))
        else:
            m_cum.append(np.zeros(2, np.float32))
            m_lam.append(0.0)
            m_bp.append(np.zeros(2, np.int32))
    L = max(xo_lam)
    lam_m = max(m_lam)
    has_mut = lam_m > 0
    return Maps(
        xo_cum=_pad(xo_cum, np.float32, device),
        xo_lam=np.array(xo_lam, np.float32),
        bp=_pad(bps, np.int32, device),
        width=np.array(widths, np.float32),
        mut_cum=_pad(m_cum, np.float32, device),
        mut_lam=np.array(m_lam, np.float32),
        mut_bp=_pad(m_bp, np.int32, device),
        bp_affine=all(_affine(b, w) for b, w in zip(bps, widths)),
        mut_affine=has_mut and all(
            len(b) > 1 and _affine(b, b[1] - b[0]) for b in m_bp),
        bp_step=np.array(widths, np.int32),
        mut_step=np.array([int(b[1] - b[0]) if len(b) > 1 else 1
                           for b in m_bp], np.int32),
        xo_cap=int(8 + np.ceil(L + 6 * np.sqrt(max(L, 1.0)))),
        mn_cap=(int(4 + np.ceil(lam_m + 6 * np.sqrt(max(lam_m, 0.25))))
                if has_mut else 2),
        has_mut=has_mut,
        chr_start=np.array([int(b[0]) for b, _ in sc.rmap], np.int64),
    )


def points(g, n: int, cap: int, cum: torch.Tensor, lam, bp: torch.Tensor,
           step: int, affine: bool, width: float,
           inclusive: bool) -> torch.Tensor:
    """(n, cap) int32 positions, BIG-padded: one chromosome's point process
    for `n` gametes from generator `g`."""
    dev = cum.device
    if float(lam) <= 0.0:
        return torch.full((n, cap), BIG, dtype=torch.int32, device=dev)
    rate = torch.full((n,), float(lam), dtype=torch.float32, device=dev)
    counts = torch.poisson(rate, generator=g).clamp_max(cap).long()
    unif = torch.rand((n, cap + 1), generator=g, device=dev)
    s = torch.cumsum(-torch.log1p(-unif), dim=1)
    denom = s.gather(1, counts[:, None])
    u = s[:, :cap] / torch.clamp(denom, min=1e-30) * cum[-1]
    bins = torch.searchsorted(cum, u.contiguous(), right=True)
    bins = bins.clamp_max(cum.shape[0] - 1).to(torch.int32)
    v = torch.clamp(torch.rand((n, cap), generator=g, device=dev),
                    max=1.0 - 1e-7)
    if affine:
        hi = int(bp[0]) + bins * int(step)
        lo = hi - int(step)
    else:
        hi = bp[bins.long()]
        lo = bp[torch.clamp(bins - 1, min=0).long()]
    if inclusive:  # uniform over [bp[j-1], bp[j]]
        pos = lo + torch.floor(v * (hi - lo + 1).to(torch.float32)).to(
            torch.int32)
    else:  # uniform over [bp[j], bp[j] + width)
        pos = hi + torch.floor(v * float(width)).to(torch.int32)
    live = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    return torch.where(live, pos.to(torch.int32), BIG)


@dataclass
class Draws:
    """One chromosome's draws for `n` children: crossovers of the father's
    and the mother's gamete (n, xo_cap), start chromatids (n, 2), de novo
    mutations of each gamete (n, mn_cap)."""

    xo: List[torch.Tensor]
    start: torch.Tensor
    new: List[torch.Tensor]


def draws(m: Maps, seed: int, gen: int, pop: int, ci: int, n: int,
          device) -> Draws:
    """Chromosome `ci`'s draws in the law's order: the father's crossovers,
    the mother's, the start chromatids, the mutations, then the chromatid
    each mutation lands on."""
    g = generator(device, seed, gen, CROSSOVER, pop, ci)
    xo = [points(g, n, m.xo_cap, m.xo_cum[ci], m.xo_lam[ci], m.bp[ci],
                 m.bp_step[ci], m.bp_affine, float(m.width[ci]), False)
          for _ in range(2)]
    start = torch.randint(0, 2, (n, 2), generator=g, device=device,
                          dtype=torch.int32)
    if not m.has_mut:
        none = torch.full((n, 1), BIG, dtype=torch.int32, device=device)
        return Draws(xo, start, [none, none])
    new = points(g, n, m.mn_cap, m.mut_cum[ci], m.mut_lam[ci], m.mut_bp[ci],
                 m.mut_step[ci], m.mut_affine, 0.0, True)
    which = torch.randint(0, 2, (n, m.mn_cap), generator=g, device=device)
    return Draws(xo, start, [torch.where(which == w, new, BIG)
                             for w in (0, 1)])
