"""One generation on GeneEvolve's SNP panel, in plain NumPy and PyTorch: the
reference of a run under `--backend dense`.

There the genome is each chromatid's alleles at every SNP of the founder
panel (GeneEvolve's `.hap` rows, one a SNP, and their `.legend`
positions). A child chromatid copies, at each SNP, the allele of one of its
parent's two chromatids: its start chromatid, switched at every crossover
at or before that SNP (`sim.copied`, the law the segment reference uses),
and it is flipped where a de novo mutation fell on the SNP an odd number of
times (`ras_add_mutation` at panel sites, `Simulation.cpp:2497-2552`).

The plan's law (`ras_sim_loc_rec` resolved to panel columns):

- columns: each chromosome's SNPs in legend order, every chromosome padded
  to the longest one rounded up to 32 (`chr_len`), chromosome after
  chromosome; padding columns carry no allele and are never compared;
- crossovers: a cumulative map over the columns, in Morgans (the map's cM
  interpolated at each SNP, its increments over 100, chromosome after
  chromosome, padding repeating the chromosome's last value). A gamete
  takes on each chromosome a Poisson count of crossovers of the
  chromosome's mass, clipped to `xo_cap`, each at the first column whose
  map value reaches a uniform draw over the chromosome's stretch of the
  map; then a start chromatid a chromosome;
- de novo mutations: a cumulative map over the columns of the per-bp rate
  of the mutation map's bin at each SNP. A gamete takes a Poisson count of
  the genome's mass, clipped to `mut_cap`, each at the first column whose
  map value passes a uniform draw over the whole map;
- the draws come from one generator a (seed, generation, population): the
  father's crossovers and starts, the mother's, the father's mutations,
  the mother's.

The program's planes pack 32 columns into an int32 word, little-endian
(column l is bit l & 31 of word l >> 5 of its chromosome's words); the
reference reads them (`bits`) only to judge them.

A genome, as this reference holds it, is each chromosome's (n, 2, C) CV
alleles; `Children` can give any columns of the children it made.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from gebench.reference import inputs, law, sim

UNIT = 32  # columns a word
# elements of one block of (gametes x columns) that the reference makes at
# once: a few hundred MB of transients at the panel's widths
BLOCK = 1 << 26


def legend_positions(path: str) -> np.ndarray:
    """The base-pair positions of a `.legend` file (`id position a0 a1`,
    one header line)."""
    rows = Path(path).read_text().split("\n")[1:]
    return np.array([int(float(r.split()[1])) for r in rows if r.strip()],
                    dtype=np.int64)


def _padded(x: np.ndarray, length: int, value) -> np.ndarray:
    return np.concatenate([x, np.full(length - len(x), value)])


@dataclass
class Layout:
    """The columns of a panel and the plan's maps over them."""

    n_chr: int
    m_real: List[int]  # SNPs a chromosome
    chr_len: int  # columns a chromosome, padding included
    cv_cols: List[torch.Tensor]  # a chromosome: (C,) local column of each CV
    xo_cdf: torch.Tensor  # (m,) f32
    mut_cdf: Optional[torch.Tensor]  # (m,) f32, or None without mutations
    mut_rate: float
    xo_cap: int
    mut_cap: int

    @property
    def m(self) -> int:
        return self.n_chr * self.chr_len

    @property
    def words(self) -> int:
        """Words a chromosome."""
        return self.chr_len // UNIT


def layout(sc, maps: law.Maps, device) -> Layout:
    """The layout of the first population's panel, and the maps of the
    plan: the recombination map's cM and the mutation map's rates (out of
    [0, 1], and the first bin's, read as 0) at each SNP, in float64,
    held as float32."""
    pos = [legend_positions(leg) for _, leg in sc.pops[0].panels]
    m_real = [len(x) for x in pos]
    chr_len = -(-max(m_real) // UNIT) * UNIT
    xo, mut, total, mtotal = [], [], 0.0, 0.0
    for ic, x in enumerate(pos):
        bp, cm_map = sc.rmap[ic]
        cm = np.interp(x, bp, cm_map)
        cdf = total + np.cumsum(np.diff(cm, prepend=cm[0]) / 100.0)
        total = cdf[-1]
        xo.append(_padded(cdf, chr_len, total))
        if sc.mmap is None:
            mut.append(np.full(chr_len, mtotal))
            continue
        mbp, rate = sc.mmap[ic]
        r = rate.copy()
        r[(r < 0) | (r > 1)] = 0.0
        r[0] = 0.0
        if not r.sum() > 0:
            mut.append(np.full(chr_len, mtotal))
            continue
        per_bin = np.diff(np.cumsum(r).astype(np.float32).astype(np.float64),
                          prepend=0.0)
        b = np.clip(np.searchsorted(mbp.astype(np.int32), x, "right") - 1, 0,
                    len(per_bin) - 1)
        width = max(float(int(bp[1] - bp[0])), 1.0)
        mc = mtotal + np.cumsum(per_bin[b] / width)
        mtotal = mc[-1]
        mut.append(_padded(mc, chr_len, mtotal))
    f32 = dict(dtype=torch.float32, device=device)
    cv_cols = [torch.as_tensor(np.minimum(np.searchsorted(x, q), len(x) - 1),
                               device=device)
               for x, q in zip(pos, sc.pops[0].cv_bp)]
    lam_m = float(mtotal)
    return Layout(
        n_chr=len(pos), m_real=m_real, chr_len=chr_len, cv_cols=cv_cols,
        xo_cdf=torch.as_tensor(np.concatenate(xo), **f32),
        mut_cdf=(torch.as_tensor(np.concatenate(mut), **f32)
                 if mtotal > 0 else None),
        mut_rate=lam_m, xo_cap=maps.xo_cap,
        mut_cap=int(4 + np.ceil(lam_m + 6 * np.sqrt(max(lam_m, 0.25)))))


def _crossovers(g, lay: Layout, n: int):
    """(n, n_chr, xo_cap) int32 crossover columns (global, padding m) and
    (n, n_chr) int32 start chromatids of n gametes."""
    dev, K, nc, L = lay.xo_cdf.device, lay.xo_cap, lay.n_chr, lay.chr_len
    cdf = lay.xo_cdf
    hi = cdf[(torch.arange(nc, device=dev) + 1) * L - 1]
    lo = torch.cat([hi.new_zeros(1), hi[:-1]])
    lam = hi - lo
    count = torch.poisson(lam[None, :].expand(n, nc).contiguous(), generator=g)
    u = torch.rand((n, nc, K), generator=g, device=dev, dtype=cdf.dtype)
    u = lo[None, :, None] + u * lam[None, :, None]
    col = torch.searchsorted(cdf, u.reshape(n, -1)).reshape(n, nc, K)
    live = torch.arange(K, device=dev)[None, None, :] < count.clamp(
        max=K)[..., None]
    xo = torch.where(live, col.to(torch.int32), lay.m).to(torch.int32)
    start = torch.randint(0, 2, (n, nc), generator=g, device=dev,
                          dtype=torch.int32)
    return xo, start


def _mutations(g, lay: Layout, n: int) -> torch.Tensor:
    """(n, mut_cap) int32 de novo mutation columns (global, padding m) of
    n gametes."""
    dev, cap, cdf = lay.mut_cdf.device, lay.mut_cap, lay.mut_cdf
    count = torch.poisson(torch.full((n,), float(lay.mut_rate), device=dev),
                          generator=g)
    u = torch.rand((n, cap), generator=g, device=dev,
                   dtype=torch.float32) * cdf[-1]
    col = torch.searchsorted(cdf, u, right=True).clamp(max=lay.m - 1)
    live = torch.arange(cap, device=dev)[None, :] < count.clamp(
        max=cap)[:, None]
    return torch.where(live, col, lay.m).to(torch.int32)


@dataclass
class Plan:
    """A generation's draws for `n` children: each gamete's crossovers and
    starts (father's, mother's) and each gamete's mutations (n, 2, cap), or
    None."""

    xo: List[torch.Tensor]
    start: List[torch.Tensor]
    mu: Optional[torch.Tensor]


def plan(lay: Layout, seed: int, gen: int, pop: int, n: int, device) -> Plan:
    """Generation `gen`'s draws for `n` children, in the law's order."""
    g = law.generator(device, seed, gen, law.CROSSOVER, pop, 0)
    (xf, sf), (xm, sm) = (_crossovers(g, lay, n) for _ in range(2))
    mu = None
    if lay.mut_cdf is not None:
        mu = torch.stack([_mutations(g, lay, n) for _ in range(2)], 1)
    return Plan([xf, xm], [sf, sm], mu)


def bits(words: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(..., Q) uint8 alleles at local columns `cols` (Q,) of a chromosome's
    packed words (..., words)."""
    cols = cols.long()
    w = words[..., cols >> 5]
    return ((w >> (cols & 31).to(w.dtype)) & 1).to(torch.uint8)


def chrom_words(hap: torch.Tensor, lay: Layout, ic: int) -> torch.Tensor:
    """The words of chromosome `ic` of (rows, 2, words) planes (a view)."""
    return hap[..., ic * lay.words:(ic + 1) * lay.words]


def block_rows(lay: Layout, q: int) -> int:
    """Gametes of one block when `q` columns are made a gamete."""
    return max(1, BLOCK // max(q, 1))


class Children:
    """The children the reference made from the parents' planes: child i of
    parent rows (cf[i], cm[i]) under `plan`; any block of their alleles."""

    def __init__(self, lay: Layout, par_hap: torch.Tensor, cf, cm, pl: Plan):
        self.lay, self.par_hap, self.rows, self.plan = lay, par_hap, [cf, cm], pl
        self.n = cf.shape[0]
        self.cv = [self.alleles(ic, lay.cv_cols[ic])
                   for ic in range(lay.n_chr)]

    def gametes(self, g: int, ic: int, lo: int, hi: int,
                cols: torch.Tensor) -> torch.Tensor:
        """(hi - lo, Q) alleles at local columns `cols` of chromosome ic of
        the gametes from parent side g (0 father, 1 mother) of children
        [lo, hi)."""
        lay, pl = self.lay, self.plan
        q = (cols + ic * lay.chr_len).to(torch.int32)[None, :].expand(
            hi - lo, -1)
        par = bits(chrom_words(self.par_hap, lay, ic)[self.rows[g][lo:hi]
                                                      .long()], cols)
        which = sim.copied(pl.xo[g][lo:hi, ic], pl.start[g][lo:hi, ic], q)
        child = torch.where(which == 0, par[:, 0], par[:, 1])
        if pl.mu is not None:
            mu = torch.sort(pl.mu[lo:hi, g], 1).values
            times = (torch.searchsorted(mu, q.contiguous(), right=True)
                     - torch.searchsorted(mu, q.contiguous()))
            child ^= (times & 1).to(torch.uint8)
        return child

    def alleles(self, ic: int, cols: torch.Tensor) -> torch.Tensor:
        """(n, 2, Q) alleles of every child at local columns `cols` of
        chromosome ic, made in blocks."""
        step = block_rows(self.lay, cols.shape[0])
        out = torch.empty((self.n, 2, cols.shape[0]), dtype=torch.uint8,
                          device=cols.device)
        for lo in range(0, self.n, step):
            hi = min(lo + step, self.n)
            for g in (0, 1):
                out[lo:hi, g] = self.gametes(g, ic, lo, hi, cols)
        return out


class Reference(sim.Reference):
    """The reference of a one-population run on the dense backend: the
    segment reference's mating, pedigree, phenotypes and selection, with
    the genome held as panel alleles."""

    def __init__(self, sc, device, dtype=torch.float64):
        super().__init__(sc, device, dtype)
        if self.n_pop != 1:
            raise ValueError("the dense backend's reference takes one "
                             "population")
        self.lay = layout(sc, self.m, device)

    def founders(self, pop: int):
        """Generation 0's CV alleles: founder i's chromatids are the
        founder haplotypes 2i and 2i + 1 of the CV files."""
        return [f.view(-1, 2, f.shape[-1]) for f in self.founder]

    def alleles(self, block, c: int):
        return block

    def ad(self, genome, n: int):
        return super().ad(genome.cv if isinstance(genome, Children)
                          else genome, n)

    def generation(self, gen: int, parents: list, children=None):
        """Generation `gen` of the one population, whole: (genomes, states,
        None). Without `children` the genome is the reference's `Children`
        of the parents' planes, drawn for the rows the program's planes
        hold; with `children` (the program's CV alleles after the
        generation, [(n, 2, C)] a chromosome) their A/D is worked out, or
        NaN where they hold another number of rows."""
        plans, sizes, moves = self.prepare(gen, parents)
        (mated,), (par,), (n,) = plans, parents, sizes
        if children is None:
            pl = plan(self.lay, self.sc.seed, gen, 0,
                      self.n_pad(gen, 0, par, mated), self.device)
            g = Children(self.lay, par["hap"],
                         *(torch.as_tensor(mated[s][mated[2]],
                                           device=self.device)
                           for s in (0, 1)), pl)
        else:
            g = children[0] if children[0][0].shape[0] == n else None
        ad = (np.full(n, np.nan),) * 2 if g is None else self.ad(g, n)
        return [g], self.finish(gen, parents, plans, moves, [ad]), None

    def program_alleles(self, hap: torch.Tensor, n: int) -> list:
        """Each chromosome's (n, 2, C) alleles of the program's planes at
        the CV columns."""
        return [bits(chrom_words(hap[:n], self.lay, ic), cols)
                for ic, cols in enumerate(self.lay.cv_cols)]

    def panel_differs(self, hap: torch.Tensor, n: int) -> int:
        """Chromatids (founder, chromatid, chromosome) of the program's
        generation 0 planes whose alleles at the SNPs differ from the
        founder panel's (founder i's chromatids its haplotypes 2i, 2i +
        1)."""
        bad = 0
        for ic, (path, _) in enumerate(self.sc.pops[0].panels):
            want = torch.as_tensor(inputs._hap(path), device=self.device)
            if want.shape != (2 * n, self.lay.m_real[ic]):
                return 2 * n * self.lay.n_chr
            cols = torch.arange(self.lay.m_real[ic], device=self.device)
            got = bits(chrom_words(hap[:n], self.lay, ic), cols)
            bad += int((got != want.view(n, 2, -1)).any(-1).sum())
        return bad

    def children_differ(self, kids: Children, hap: torch.Tensor) -> int:
        """Chromatids (child, chromatid, chromosome) of the program's
        children planes whose alleles at the SNPs differ from the
        reference's children's, made and compared a block at a time."""
        lay, bad = self.lay, 0
        for ic in range(lay.n_chr):
            cols = torch.arange(lay.m_real[ic], device=self.device)
            step = block_rows(lay, lay.m_real[ic])
            words = chrom_words(hap, lay, ic)
            for lo in range(0, kids.n, step):
                hi = min(lo + step, kids.n)
                for g in (0, 1):
                    got = bits(words[lo:hi, g], cols)
                    want = kids.gametes(g, ic, lo, hi, cols)
                    bad += int((got != want).any(-1).sum())
        return bad
