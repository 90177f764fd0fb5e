"""The dense genome backend (`--backend dense`) in PyTorch (counterpart of
geneevolve_tpu/dense/backend.py).

`DenseSimulation` runs the segment engine's scenario semantics — mating,
A/D with per-generation allele frequencies, E/F/C/P assembly, MV/SV and
selection, info/summary files (the base `Simulation`) — but keeps the
genome materialized as bit-packed chromatid planes (`dense/packed.py`), so
each generation is one fused meiosis pass (the `meiose_packed` kernel on
the card) and genotype output needs no painting. The resident CV matrices
advance through the same meiosis law (`cv_child`).

Crossover positions are sampled in map space and resolved to panel
columns (exact for CVs at panel sites); de novo mutations flip panel
columns with the map's per-bp intensity at each column's position
(`ras_add_mutation` at panel sites, `Simulation.cpp:2497-2552`).

Chromosomes are padded to a multiple of 32 loci on every device, the JAX
package's CPU unit, so a CUDA run, a CPU run and a JAX CPU run share one
layout. Every device draw of a generation comes from `_plan`, so tests can
inject the JAX run's draws. Founder panels are `.hap` files or
`--file_ref_vcf` VCFs. Several populations need identical panel loci per
chromosome, so their packed planes share one layout and migration is a
row move of the planes and the resident CV matrices; a population's A/D
uses its own effects (the JAX dense backend's law, unlike the segment
engine's root-population effects).

Under a mesh (`--mesh`, `DenseSimulation(mesh=...)`) each rank holds the
block of rows its 'ind' coordinate names (edge-padded, as the segment
engine's) of every plane, and of the packed planes only its window of
words on 'loci'; the CV matrices stay whole on 'loci' (`plane_block`, the
JAX `_put_plane` rule). Every rank draws the unsharded run's whole plan
and keeps its children's block; the parents' rows come in one exchange
(`parallel.mesh.exchange_rows`) and kernel 4 runs on the window once a
piece (`parallel.mesh.meiose_window`); A/D is row-local beside integer
allele counts all-reduced over 'ind'. So every file is byte-identical to
the one-card run: rank 0 writes `.info`, `.summary`, checkpoints (the
planes gathered whole) and whole genotype files (gathered a chromosome at
a time).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from geneevolve_tpu_torch.core import mating, phenotype
from geneevolve_tpu_torch.core.output import (
    _legend_al0,
    _legend_al1,
    _legend_ids,
)
from geneevolve_tpu_torch.core.engine import (
    PopRuntime,
    Simulation,
    SimulationError,
)
from geneevolve_tpu_torch.core.rng import Stage, generator
from geneevolve_tpu_torch.dense.packed import (
    PackedConfig,
    cv_child,
    pack_bits,
    unpack_bits,
)
from geneevolve_tpu_torch.dense.step import _sample_gamete_plan
from geneevolve_tpu_torch.io import hap as hap_io
from geneevolve_tpu_torch.io import plink as plink_io
from geneevolve_tpu_torch.io import vcf as vcf_io
from geneevolve_tpu_torch.parallel import comm
from geneevolve_tpu_torch.parallel.mesh import (
    gather_dim,
    loci_pieces,
    meiose_window,
    refuse_split,
)
from geneevolve_tpu_torch.utils import telemetry

UNIT = 32  # loci per chromosome are padded to a multiple of this


@dataclass
class DensePopState:
    """The dense backend's PopState: the same host fields, the genome as
    packed planes plus per-phenotype resident CV matrices."""

    n: int
    hap: torch.Tensor  # (rows, 2, mw) int32
    cv: List[torch.Tensor]  # per phenotype: (rows, 2, ncv_j) uint8
    sex: np.ndarray = None
    ids: np.ndarray = None
    ped: Dict[str, np.ndarray] = None
    comp: Dict[str, np.ndarray] = None
    mv: np.ndarray = None
    sv: np.ndarray = None
    svf: np.ndarray = None
    rows: int = 0  # the planes' rows in the unsharded run (0: their own)


def plane_block(shape, dtype, dims: dict, coords: dict):
    """The part of a dense per-individual array of `shape` (rows first)
    that the rank at `coords` of a mesh of `dims` holds, as (its global
    rows, the slice of the last axis): a block of ceil(rows / ind) rows,
    the last one edge-padded with copies of the last row; of (rows, 2, mw)
    packed planes (int32 or uint32 words) a block of mw / loci words, of
    anything else the whole axis (the (rows, 2, ncv) uint8 CV matrices
    stay whole on 'loci'). A word count that does not split over 'loci'
    is refused, as the JAX package refuses it."""
    ind, loci = dims.get("ind", 1), dims.get("loci", 1)
    i, j = coords.get("ind", 0), coords.get("loci", 0)
    b = -(-shape[0] // ind)
    rows = np.minimum(np.arange(i * b, (i + 1) * b), shape[0] - 1)
    last = slice(None)
    name = (str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).name)
    if len(shape) == 3 and name in ("int32", "uint32"):
        refuse_split("the array of packed planes", shape, 2, loci)
        w = shape[2] // loci
        last = slice(j * w, (j + 1) * w)
    return rows, last


def take_block(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's part (`plane_block`) of a whole per-individual array, on
    the array's device."""
    rows, last = plane_block(tuple(x.shape), x.dtype, mesh.dims(),
                             dict(zip(mesh.axis_names, mesh.coords)))
    return x.index_select(0, torch.as_tensor(rows, device=x.device))[
        ..., last].contiguous()


def gather_block(x: torch.Tensor, rows: int, mesh) -> torch.Tensor:
    """The whole array of `rows` rows from every rank's part of it (the
    inverse of `take_block`; collectives every rank joins)."""
    if x.dim() == 3 and x.dtype == torch.int32 and mesh.size("loci") > 1:
        x = gather_dim(x, 2, mesh.group("loci"), mesh.traffic)
    if mesh.size("ind") > 1:
        x = gather_dim(x, 0, mesh.group("ind"), mesh.traffic)
    return x[:rows]


@dataclass
class DensePanel:
    """The packed founder panel and its per-column map tables."""

    legends: List  # per chromosome: hap_io.Legend or vcf_io.VcfData
    m_real: List[int]  # panel loci per chromosome (before padding)
    chr_len: int  # padded loci per chromosome
    xo_cdf: torch.Tensor  # (m,) f32 per-column crossover CDF (Morgans)
    mut_cdf: Optional[torch.Tensor]  # (m,) f32 per-column mutation CDF
    founder_hap: torch.Tensor  # (n0, 2, mw) int32
    cv_cols: List[torch.Tensor]  # per phenotype: (ncv_j,) int32 columns
    cfg: PackedConfig  # n = 0: set per generation


def _pad_cols(x: np.ndarray, length: int) -> np.ndarray:
    pad = np.zeros((x.shape[0], length - x.shape[1]), dtype=x.dtype)
    return np.concatenate([x, pad], axis=1)


def _pad_tail(x: np.ndarray, length: int, value: float) -> np.ndarray:
    return np.concatenate([x, np.full(length - len(x), value)])


def _mutation_cols(gen: torch.Generator, n: int, cfg: PackedConfig,
                   cdf: torch.Tensor) -> torch.Tensor:
    """(n, mut_cap) int32 de novo mutation columns by inverse CDF over the
    per-column intensities (`searchsorted`, side right), pad = m."""
    dev = gen.device
    raw = torch.poisson(torch.full((n,), float(cfg.mut_rate), device=dev),
                        generator=gen)
    u = torch.rand((n, cfg.mut_cap), generator=gen, device=dev,
                   dtype=torch.float32) * cdf[-1]
    pos = torch.searchsorted(cdf, u, right=True).clamp(max=cfg.m - 1)
    slot = torch.arange(cfg.mut_cap, device=dev)
    valid = slot[None, :] < raw.clamp(max=cfg.mut_cap)[:, None]
    return torch.where(valid, pos, cfg.m).to(torch.int32)


class DenseSimulation(Simulation):
    """`--backend dense` on one device (`cuda`, or `cpu` for the plain
    versions in tests), or on this rank's part of a mesh."""

    _row_axis = 0  # planes are (rows, 2, words) and (rows, 2, ncv)

    # ------------------------------------------------------------------ mesh
    def _block_rows(self, st: DensePopState) -> int:
        return st.hap.shape[0]

    def _take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole per-individual array."""
        return x if self.mesh is None else take_block(x, self.mesh)

    def _whole(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """The whole array of `rows` rows from every rank's part."""
        return x[:rows] if self.mesh is None else gather_block(x, rows,
                                                                self.mesh)

    def _row_tables(self, st: DensePopState) -> list:
        return [st.hap, *st.cv]

    _migrant_tables = _row_tables

    def _from_tables(self, tabs: list, **fields) -> DensePopState:
        return DensePopState(hap=tabs[0], cv=list(tabs[1:]), **fields)

    # ------------------------------------------------------------ panel load
    def _load(self) -> None:
        super()._load()
        # one packed panel a population (`_load_all_panels` in the JAX
        # backend): identical loci per chromosome, hence one padded
        # chromosome length and one plane layout
        self.dps: List[DensePanel] = []
        for p in self.pops:
            dp = self._load_panel(p)
            for ic, leg in enumerate(dp.legends):
                if self.dps and not np.array_equal(
                        leg.pos, self.dps[0].legends[ic].pos):
                    raise SimulationError(
                        "--backend dense with multiple populations needs "
                        "identical panel loci per chromosome; chr "
                        f"{self.chrs[ic]} differs between populations 1 "
                        f"and {p.index + 1}"
                    )
            self.dps.append(dp)
        # [pop][pheno] (a, d) effects over the CV columns (all chromosomes)
        self.dense_eff = [
            [tuple(torch.as_tensor(np.concatenate(v).astype(np.float32),
                                   device=self.device) for v in (ph.a, ph.d))
             for ph in p.phenos]
            for p in self.pops
        ]
        # this rank's window of the packed words, and its pieces
        cfg = self.dps[0].cfg
        loci = 1 if self.mesh is None else self.mesh.size("loci")
        refuse_split("the array of packed planes",
                     (self.pops[0].n_founders, 2, cfg.mw), 2, loci)
        self._lw = cfg.mw // loci
        self._w0 = (0 if self.mesh is None else self.mesh.coord("loci")) \
            * self._lw
        self._pieces = loci_pieces(cfg.n_chr, self.dps[0].chr_len,
                                   32 * self._w0, 32 * self._lw)

    def _load_panel(self, p: PopRuntime) -> DensePanel:
        """Pack the founder panel, build the per-column crossover and
        mutation CDFs, and find each CV's column."""
        panels, legends = [], []
        for ic in range(len(self.chrs)):
            if p.vcf_addresses:
                path = p.vcf_addresses[ic][1]
                v = vcf_io.read_vcf(path)
                legends.append(v)
                panels.append(v.hap)  # (2n0, m_chr)
            else:
                _, path, legend_path, _ = p.hap_addresses[ic]
                legends.append(hap_io.read_legend(legend_path))
                panels.append(hap_io.read_hap(path))  # (2n0, m_chr)
            if panels[-1].shape[0] != 2 * p.n_founders:
                raise SimulationError(
                    f"founder panel [{path}] holds "
                    f"{panels[-1].shape[0] // 2} founders, the CV files "
                    f"{p.n_founders}"
                )
        m_real = [x.shape[1] for x in panels]
        chr_len = -(-max(m_real) // UNIT) * UNIT
        xo_cdf, mut_cdf, total, mtotal = [], [], 0.0, 0.0
        for ic, leg in enumerate(legends):
            pos = leg.pos
            r = p.rmaps[self.chrs[ic]]
            cm = np.interp(pos, r.bp, r.cM)
            cdf = total + np.cumsum(np.diff(cm, prepend=cm[0]) / 100.0)
            total = cdf[-1]
            xo_cdf.append(_pad_tail(cdf, chr_len, total))
            m = p.maps[ic]
            if m.mut_lambda > 0:
                # per-bp intensity of the column's map bin
                rate = np.diff(np.asarray(m.mut_cum, np.float64), prepend=0.0)
                bins = np.clip(
                    np.searchsorted(np.asarray(m.mut_bp), pos, "right") - 1,
                    0, len(rate) - 1,
                )
                mc = mtotal + np.cumsum(rate[bins] / max(float(r.bin_width),
                                                         1.0))
                mtotal = mc[-1]
                mut_cdf.append(_pad_tail(mc, chr_len, mtotal))
            else:
                mut_cdf.append(np.full(chr_len, mtotal))
        planes = [
            np.concatenate([_pad_cols(x[h::2], chr_len) for x in panels], 1)
            for h in (0, 1)
        ]
        founder_hap = torch.stack(
            [pack_bits(torch.from_numpy(x)) for x in planes], 1
        ).to(self.device)
        cv_cols = []
        for ph in p.phenos:
            # the column a CV's bp maps to (exact when the CV is a panel
            # site; the insertion point otherwise)
            cols = [
                np.minimum(np.searchsorted(leg.pos, ph.cv_bp[ic]),
                           len(leg.pos) - 1) + ic * chr_len
                for ic, leg in enumerate(legends)
            ]
            cv_cols.append(torch.as_tensor(
                np.concatenate(cols).astype(np.int32), device=self.device))
        lam_m = float(mtotal)
        f32 = dict(dtype=torch.float32, device=self.device)
        return DensePanel(
            legends=legends,
            m_real=m_real,
            chr_len=chr_len,
            xo_cdf=torch.as_tensor(np.concatenate(xo_cdf), **f32),
            mut_cdf=(torch.as_tensor(np.concatenate(mut_cdf), **f32)
                     if mtotal > 0 else None),
            founder_hap=founder_hap,
            cv_cols=cv_cols,
            cfg=PackedConfig(
                n=0,
                m=chr_len * len(self.chrs),
                n_chr=len(self.chrs),
                xo_cap=self.xo_cap,
                mut_rate=lam_m,
                mut_cap=int(4 + np.ceil(lam_m
                                        + 6 * np.sqrt(max(lam_m, 0.25)))),
                ncv=0,
            ),
        )

    def _check_fits(self) -> None:
        """Refuse a run whose planes do not fit the card: every
        population's planes and CV matrices stay resident, and the one
        reproducing has parents and children at once (rows x 2 x mw x 4 B
        each, plus its CV matrices), beside one generation's plan and
        `cv_child`'s (rows, ncv) transients; a migration builds every
        population's state anew beside the old. Under a mesh the bytes are
        a rank's: its block of rows of its window of words (and of the
        whole CV matrices), the parents' rows it fetches and the whole
        plan it draws, against the least free memory of any rank."""
        if self.device.type != "cuda":
            return
        cfg = self.dps[0].cfg
        ncv = [int(c.shape[0]) for c in self.dps[0].cv_cols]
        pop_rows = []
        for p in self.pops:
            r = max(int(s) for s in p.schedule.pop_size)
            pop_rows.append(max(r + 4 * int(np.sqrt(r)) + 16, p.n_founders))
        rows = max(pop_rows)
        row_b = 2 * (self._lw * 4 + sum(ncv))
        state = [self._block(r) * row_b for r in pop_rows]
        fetched = 0 if self._ind == 1 else max(
            min(2 * self._block(r), r) for r in pop_rows) * row_b
        plan = rows * 2 * (cfg.n_chr * (cfg.xo_cap + 1) + cfg.mut_cap) * 4
        transient = self._block(rows) * max(ncv, default=0) * 16
        need = max(sum(state) + max(state) + fetched + plan + transient,
                   2 * sum(state) if self.n_pop > 1 else 0)
        free, _total = torch.cuda.mem_get_info(self.device)
        if self.mesh is not None:
            free = int(comm.all_reduce(
                torch.tensor([free], dtype=torch.int64, device=self.device),
                "min", None, self.mesh.traffic)[0])
        if need > free:
            raise SimulationError(
                f"dense planes need ~{need / 2**30:.1f} GiB, "
                f"{free / 2**30:.1f} GiB free on {self.device}"
            )

    # ------------------------------------------------------------------ gen0
    def _init_gen0_state(self, p: PopRuntime) -> DensePopState:
        cv = [
            torch.as_tensor(np.stack([
                np.concatenate([fc[h::2] for fc in ph.founder_cv], axis=1)
                for h in (0, 1)
            ], axis=1), device=self.device)
            for ph in p.phenos
        ]  # (n0, 2, ncv_j)
        return DensePopState(hap=self._take(self.dps[p.index].founder_hap),
                             cv=[self._take(c) for c in cv],
                             rows=p.n_founders,
                             **self._gen0_host_fields(p, p.n_founders))

    # ------------------------------------------------------------- reproduce
    def _plan(self, p: PopRuntime, gen: int, n_pad: int):
        """Every device draw of the coming generation, from one generator:
        (xo_p, st_p, xo_m, st_m, mu) — each gamete's (n, n_chr, K)
        crossover columns and (n, n_chr) start chromatids, and the (n, 2,
        Km) de novo mutation columns (None without a mutation map)."""
        dp = self.dps[p.index]
        cfg = dataclasses.replace(dp.cfg, n=n_pad)
        g = generator(self.device, self.cfg.seed, gen, Stage.CROSSOVER,
                      p.index)
        xo_p, st_p, _ = _sample_gamete_plan(g, cfg.as_dense(), n_pad,
                                            dp.xo_cdf)
        xo_m, st_m, _ = _sample_gamete_plan(g, cfg.as_dense(), n_pad,
                                            dp.xo_cdf)
        mu = None
        if dp.mut_cdf is not None:
            mu = torch.stack([_mutation_cols(g, n_pad, cfg, dp.mut_cdf)
                              for _ in range(2)], 1)
        return xo_p, st_p, xo_m, st_m, mu

    def _reproduce(self, p: PopRuntime, gen: int,
                   plan: mating.MatingPlan) -> DensePopState:
        st, dp = p.state, self.dps[p.index]
        n_child = len(plan.child_father)
        n_pad = self._child_rows(p, gen, n_child, self._rows(st))
        # (2, n_pad) father's and mother's rows; padding children are
        # meioses of row 0
        parents = np.pad(np.stack([plan.child_father, plan.child_mother]),
                         ((0, 0), (0, n_pad - n_child)))
        with telemetry.host_wait(self.timer, "parents"):
            parents = torch.as_tensor(parents, dtype=torch.int32,
                                      device=self.device)
        with self.timer("reproduce/plan"):
            draws = self._plan(p, gen, n_pad)
        with self.timer("reproduce/meiosis"):
            st, parents, draws = self._fetch_parents(st, parents, draws,
                                                     n_pad)
            fathers, mothers = parents
            xo_p, st_p, xo_m, st_m, mu = draws
            # kernel 4 once a piece of this rank's words (one piece, all of
            # them, on one card)
            hap = meiose_window(st.hap, fathers, mothers,
                                (xo_p, st_p, xo_m, st_m), mu, self._pieces,
                                dp.chr_len, 32 * self._w0, 32 * self._lw)
            cv = [
                torch.stack([
                    cv_child(st.cv[j], par, xo, s, None if mu is None
                             else mu[:, g], dp.cv_cols[j], dp.chr_len)
                    for g, (par, xo, s) in enumerate(
                        ((fathers, xo_p, st_p), (mothers, xo_m, st_m)))
                ], 1)
                for j in range(self.n_pheno)
            ]
        return DensePopState(n=n_child, hap=hap, cv=cv, rows=n_pad,
                             **self._child_host_fields(p, gen, plan))

    # ------------------------------------------------------------------- A/D
    def _compute_ad(self, p: PopRuntime, gen: int = -1):
        """Over several 'ind' ranks each rank computes its rows against the
        population's allele counts (exact integer sums, all-reduced over
        'ind'), and A and D are all-gathered: row sums are row-local, so
        the values are the one-card run's bit for bit."""
        st = p.state
        A = np.zeros((self.n_pheno, st.n))
        D = np.zeros((self.n_pheno, st.n))
        for j, ph in enumerate(p.phenos):
            if sum(self.ncv_real[j]) == 0:
                continue
            a, d = self.dense_eff[p.index][j]
            c = st.cv[j]
            tsum = None
            k = st.n
            if self._ind > 1:
                k = self._real_rows(st)
                tsum = self._reduce_ind(
                    (c[:k, 0].int() + c[:k, 1].int()).sum(0))
            A_j, D_j = phenotype.additive_dominance_chr(
                c[:, 0], c[:, 1], a, a, d, d, ph.vd != 0, k, tsum, st.n,
                timer=self.timer)
            with telemetry.host_wait(self.timer, "ad_to_host"):
                A[j] = self._gather_ind(A_j, st.n).double().cpu().numpy()
                D[j] = self._gather_ind(D_j, st.n).double().cpu().numpy()
        return A, D

    # ------------------------------------------------------------ checkpoint
    def _ckpt_genome_arrays(self, st: DensePopState) -> dict:
        """The packed planes as the JAX package's uint32 words and each
        phenotype's CV matrix, padding rows kept (see the segment hook);
        under a mesh gathered whole (words over 'loci', rows over 'ind':
        collectives every rank joins), so the file does not depend on the
        layout."""
        rows = self._rows(st)
        d = {"hap": self._whole(st.hap, rows).cpu().numpy().view(np.uint32)}
        for j in range(self.n_pheno):
            d[f"dcv{j}"] = self._whole(st.cv[j], rows).cpu().numpy()
        return d

    def _ckpt_make_state(self, z, pre: str, host: dict) -> DensePopState:
        hap = z[f"{pre}.hap"]
        return DensePopState(
            hap=self._take(torch.as_tensor(hap.view(np.int32),
                                           device=self.device)),
            cv=[self._take(torch.as_tensor(z[f"{pre}.dcv{j}"],
                                           device=self.device))
                for j in range(self.n_pheno)],
            rows=hap.shape[0], **host,
        )

    # --------------------------------------------------------------- outputs
    def save_genotypes(self, gen: int) -> None:
        """`.hap`/`.indv`, `.vcf` and `.ped`/`.map` per population and
        chromosome, as the JAX dense backend writes them; under a mesh
        rank 0 writes whole files (no `.hostK` files, as in the JAX
        package), every rank joining each chromosome's gather."""
        for p in self.pops:
            self._save_genotypes_pop(p, gen)

    def _chrom_words(self, st: DensePopState, ic: int, cw: int):
        """(n, 2, cw) words of chromosome `ic` of every individual: under a
        mesh each rank's part of them (zero outside its window) summed
        over 'loci', then the rows gathered over 'ind'."""
        if self.mesh is None:
            return st.hap[: st.n, :, ic * cw:(ic + 1) * cw]
        lo, hi = max(ic * cw, self._w0), min((ic + 1) * cw,
                                              self._w0 + self._lw)
        part = st.hap.new_zeros(st.hap.shape[:2] + (cw,))
        if lo < hi:
            part[:, :, lo - ic * cw:hi - ic * cw] = \
                st.hap[:, :, lo - self._w0:hi - self._w0]
        if self.mesh.size("loci") > 1:
            part = comm.all_reduce(part, "sum", self.mesh.group("loci"),
                                   self.mesh.traffic)
        return self._gather_ind(part, st.n)

    def _save_genotypes_pop(self, p: PopRuntime, gen: int) -> None:
        cfg, dp = self.cfg, self.dps[p.index]
        st = p.state
        cw = dp.chr_len // 32
        for ic, chrom in enumerate(self.chrs):
            words = self._chrom_words(st, ic, cw)
            if not self.is_root:
                continue
            base = f"{cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
            leg, mr = dp.legends[ic], dp.m_real[ic]
            a, b = (
                unpack_bits(words[:, h], dp.chr_len)[:, :mr].cpu().numpy()
                for h in (0, 1)
            )
            pos = leg.pos
            if cfg.out_hap:
                mat = np.empty((2 * st.n, mr), dtype=np.uint8)
                mat[0::2] = a
                mat[1::2] = b
                hap_io.write_hap(base + ".hap", mat)
                hap_io.write_indv(base + ".indv", st.ids + 1)
            if cfg.out_vcf:
                m = len(pos)
                v = vcf_io.VcfData(
                    samples=[f"g{gen}_{i + 1}" for i in st.ids],
                    chrom=np.full(m, str(chrom), dtype=object),
                    pos=pos,
                    ids=_legend_ids(leg),
                    ref=_legend_al0(leg),
                    alt=_legend_al1(leg),
                    qual=np.full(m, ".", dtype=object),
                    filt=np.full(m, ".", dtype=object),
                    info=np.full(m, ".", dtype=object),
                    fmt=np.full(m, "GT", dtype=object),
                    hap=np.empty((0, 0), dtype=np.uint8),
                    meta_lines=vcf_io.default_meta_lines(),
                )
                if isinstance(leg, vcf_io.VcfData):
                    v.chrom, v.qual, v.filt = leg.chrom, leg.qual, leg.filt
                with vcf_io.VcfStreamWriter(base + ".vcf", v) as w:
                    w.write_block(0, a, b)
            if cfg.out_plink or cfg.out_plink01:
                ids = plink_io.PedIds(
                    fid=st.ped["father"] + 1,
                    iid=st.ids + 1,
                    pid=st.ped["father"] + 1,
                    mid=st.ped["mother"] + 1,
                    sex=st.sex,
                )
                plink_io.write_ped_map(
                    base, np.stack([a, b], axis=2), ids, chrom,
                    _legend_ids(leg), pos, _legend_al0(leg), _legend_al1(leg),
                    letters=cfg.out_plink,
                )
