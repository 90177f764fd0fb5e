"""The simulation loop of the segment engine, in PyTorch (counterpart of
geneevolve_tpu/core/engine.py, the `--backend segment` main path).

Per generation, as `sim_next_generation` (`Simulation.cpp:1890-2082`):
mate (host) -> reproduce (device) -> A/D (device) -> phenotypes, gamma,
MV/SV (host, float64) -> info files. Reproduce has two passes:

- the probe draws the whole generation plan once (crossovers, start
  chromatids, de novo mutations; `ops/cdf_bins`, one launch over every
  chromosome per kind of draw) and counts the ledger
  slots it will need (`ops/merge_count`), so capacity grows before any
  child is written; past GE_PLAN_BYTES_MAX bytes of plan it draws and
  counts a group of chromosomes at a time and keeps only the counts;
- the real pass builds the children: the ledger merge
  (`ops/meiose_merge`), then mutation inheritance and the resident CV
  alleles moved forward from the parents' (`ops/materialize` row gathers,
  `ops/gamete_inherit`). A generation that keeps its parents' row count
  writes them over the parents, a group of GE_INPLACE_GROUP chromosomes
  at a time (peak memory ~1x state, the JAX `_reproduce_group_inplace`),
  on one card or a mesh;
  a resize generation (or GE_NO_INPLACE_REPRO=1) writes every
  chromosome's into fresh planes, one launch of each kind. Its own slot
  counts are checked against the probe's one generation later (the
  capacity tripwire). `core/memory.py` reckons what either needs.

A/D reads the resident CV matrix when it fits the card; otherwise (or
under `GE_NO_RESIDENT_CV=1`) the gather path paints each phenotype's CV
columns from the ledger (`ops/paint`, the JAX `_ad_all`). Genotype output
paints the ledger over the founder panel (`core/output.py`).

Several populations (`--next_population`) reproduce one after another
and then exchange migrants (`_migrate`, a row move of the ledgers); the
A/D effect of a chromatid is then its root population's, painted from the
ledger beside its alleles, so such runs take the gather path. Runs save
and resume checkpoints (`core/checkpoint.py`). Under `--device_mating`
the assortative pairing runs on the device (`parallel/mating_device.py`).

Under a mesh (`--mesh`, `Simulation(mesh=...)`) every rank runs this loop
with the same host state, and each 'ind' rank holds a contiguous block of
rows of every genome plane (ranks that differ on 'loci' alone hold
replicas). The plan is drawn in full on every rank (a group's rows of it
under the per-group plan) and each keeps its own children; the probe
counts each gamete on the rank that holds its parent; the parents' rows
come in one exchange of exactly the rows asked, a group's slabs at a
time in place (the whole generation's at once on fresh planes); the
allele counts behind A/D are an integer all-reduce and A and D are
all-gathered, so every output is byte-identical to the unsharded run.
Rank 0 writes `.info`, `.summary` and checkpoints; each node's first rank
paints and writes the genotype files of its ranks' rows.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from geneevolve_tpu_torch.config import ScenarioConfig
from geneevolve_tpu_torch.core import (
    checkpoint,
    mating,
    memory,
    output,
    phenotype,
    segments,
)
from geneevolve_tpu_torch.core.rng import Stage, generator, np_seed
from geneevolve_tpu_torch.core.segments import BIG, ChromMaps
from geneevolve_tpu_torch.io import hap as hap_io
from geneevolve_tpu_torch.io import tables
from geneevolve_tpu_torch.io import vcf as vcf_io
from geneevolve_tpu_torch.ops.gamete_inherit import gamete_inherit
from geneevolve_tpu_torch.ops.materialize import gather_rows_stacked
from geneevolve_tpu_torch.ops.meiose_merge import meiose_merge
from geneevolve_tpu_torch.ops.merge_count import merge_count
from geneevolve_tpu_torch.ops.paint import paint
from geneevolve_tpu_torch.parallel import comm, multihost
from geneevolve_tpu_torch.parallel.mesh import exchange_rows, gather_dim
from geneevolve_tpu_torch.utils import telemetry


# root populations are painted as bytes (`Simulation._root_panel`)
MAX_POPULATIONS = 255
# the host fields of a state that its `.info` file is written from
INFO_FIELDS = ("n", "sex", "ids", "ped", "comp", "mv", "sv", "svf")


class SimulationError(RuntimeError):
    pass


@dataclass
class PhenoScheme:
    """Static per-phenotype data for one population."""

    cv_bp: List[np.ndarray]  # per chr
    a: List[np.ndarray]
    d: List[np.ndarray]
    founder_cv: List[np.ndarray]  # per chr (2n0, ncv) uint8
    va: float
    vd: float
    vc: float
    ve: float
    vf: float
    omega: float
    beta: float
    lambda_: float


@dataclass
class PopState:
    """One population's current generation: genome planes on the device,
    stacked over chromosomes (axis 0); host fields in numpy."""

    n: int
    seg_st: torch.Tensor  # (nchr, rows, 2, S) int32
    seg_hap: torch.Tensor  # (nchr, rows, 2, S) int16 / int32
    mut: torch.Tensor  # (nchr, rows, 2, M) int32
    # (nchr, rows, 2, npheno*ncv_pad) uint8 resident CVs; None on the
    # gather path
    cv: Optional[torch.Tensor]
    sex: np.ndarray = None  # (n,) 1/2
    ids: np.ndarray = None  # (n,) 0-based birth id
    ped: Dict[str, np.ndarray] = None  # father, mother, ff, fm, mf, mm
    comp: Dict[str, np.ndarray] = None  # A D G C E F P -> (npheno, n)
    mv: np.ndarray = None
    sv: np.ndarray = None  # standardized selection value
    svf: np.ndarray = None  # selection probability
    rows: int = 0  # the planes' rows in the unsharded run (0: their own)


@dataclass
class PopRuntime:
    index: int
    schedule: tables.GenerationSchedule
    chrs: List[int]
    maps: List[ChromMaps]
    phenos: List[PhenoScheme]
    n_founders: int
    hap_offset: int
    mm_percent: float
    rm: bool
    rmaps: Optional[Dict[int, tables.RecombinationMap]] = None
    hap_addresses: List = field(default_factory=list)  # (chr, hap, legend, indv)
    vcf_addresses: List = field(default_factory=list)  # (chr, vcf)
    indv_ids: List[str] = field(default_factory=list)  # founder sample ids
    smaps: Optional[segments.StackedMaps] = None
    state: Optional[PopState] = None
    prev_phen: Optional[np.ndarray] = None
    prev_F: Optional[np.ndarray] = None
    var_a_gen0: Optional[np.ndarray] = None
    var_d_gen0: Optional[np.ndarray] = None
    sv_mean_gen0: float = 0.0
    sv_var_gen0: float = 0.0
    traj: Dict[str, np.ndarray] = field(default_factory=dict)


def _ad_resident(cv, a_tab, d_tab, dominance_on: bool, n_real: int,
                 tsum=None, n_freq=None, roots=None, timer=None):
    """A/D of one phenotype from its CV alleles (nchr, rows, 2, ncv), the
    resident ones or the gather path's painted ones: `ras_compute_AD` as
    elementwise math and row sums, accumulated over chromosomes in order in
    f32, as the JAX `_ad_resident` / `_ad_all`. `a_tab`, `d_tab`: (nchr,
    n_pop, ncv) effects; without `roots` the first population's row serves
    every chromatid, with `roots` (nchr, rows, 2, ncv) uint8 each
    chromatid's CV reads its root population's effect. `tsum` (nchr, ncv)
    and `n_freq`: the whole population's allele counts and size, when `cv`
    holds a chunk of its rows. `timer`: the run's, for the door of each
    chromosome's frequency upload."""
    A = D = None
    for ci in range(cv.shape[0]):
        if roots is None:
            a0 = a1 = a_tab[ci, 0]
            d0 = d1 = d_tab[ci, 0]
        else:
            icv = torch.arange(cv.shape[-1], device=cv.device)[None, :]
            r0, r1 = roots[ci, :, 0].long(), roots[ci, :, 1].long()
            a0, a1 = a_tab[ci][r0, icv], a_tab[ci][r1, icv]
            d0, d1 = d_tab[ci][r0, icv], d_tab[ci][r1, icv]
        A_c, D_c = phenotype.additive_dominance_chr(
            cv[ci, :, 0], cv[ci, :, 1], a0, a1, d0, d1, dominance_on,
            n_real, None if tsum is None else tsum[ci], n_freq, timer=timer,
        )
        A = A_c if A is None else A + A_c
        D = D_c if D is None else D + D_c
    return A, D


def _allele_sums(c: torch.Tensor, k: int) -> torch.Tensor:
    """(nchr, ncv) int32 sums of both chromatids' CV alleles (nchr, rows,
    2, ncv) over the first `k` rows, a chromosome at a time: the int32
    copies the sums take are one chromosome's rows, not every
    chromosome's."""
    return torch.stack([(x[:k, 0].int() + x[:k, 1].int()).sum(0)
                        for x in c])


def _pad_last(x: torch.Tensor, cap: int, value: int) -> torch.Tensor:
    cur = x.shape[-1]
    if cur >= cap:
        return x[..., :cap]
    pad = x.new_full(x.shape[:-1] + (cap - cur,), value)
    return torch.cat([x, pad], -1)


class Simulation:
    """End-to-end scenario runner on one device (`cuda`, or `cpu` for the
    plain versions in tests), or on this rank's part of a mesh."""

    def __init__(self, cfg: ScenarioConfig, device="cuda",
                 verbose: bool = True, mesh=None):
        """`mesh`: a `parallel.mesh.Mesh` with an 'ind' axis (its device
        replaces `device`): results are byte-identical to the unsharded
        run."""
        self.mesh = mesh
        if mesh is not None and "ind" not in mesh.axis_names:
            raise SimulationError("mesh must have an 'ind' axis")
        self.device = torch.device(device) if mesh is None else mesh.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise SimulationError("CUDA device requested but not available")
        rank = 0 if mesh is None else multihost.process_info()[0]
        self.is_root = rank == 0  # writes .info, .summary, checkpoints
        # paints and writes the genotype files of its node's rows
        self.writes_genotypes = mesh is None or multihost.is_node_writer()
        self._ind = 1 if mesh is None else mesh.size("ind")
        self._me = 0 if mesh is None else mesh.coord("ind")
        self.cfg = cfg
        self.verbose = verbose and self.is_root
        self.n_pheno = cfg.n_pheno
        self.vt_type = cfg.vt_type
        self.pops: List[PopRuntime] = []
        # the run's spans (`--stage_sync` fences each stage of a generation)
        self.timer = telemetry.StageTimer(self.device, cfg.stage_sync)
        # .int output needs the crossover-split ledger (the reference's part
        # structure, `Simulation.cpp:1582-1639`); otherwise merge
        # IBD-adjacent boundaries for a smaller ledger
        self.merge_ibd = not cfg.out_interval
        # A/D from the resident CV matrix, unless it does not fit the card
        # or GE_NO_RESIDENT_CV=1 (`_check_fits`): then the gather path
        self.resident_cv = True
        self._cv_panels = None  # [pheno] (nchr, H, ncv_pad): gather path
        self._roots = None  # (nchr, H, ncv_pad) root panel: gather path
        # (seg_used, mut_used, seg_need, mut_need, s_cap, m_cap, gen, pop,
        # in_place, per_group) awaiting the deferred tripwire check;
        # checked entries move to capacity_log
        self._pending_used: list = []
        self.capacity_log: List[dict] = []
        self._io_pool = ThreadPoolExecutor(max_workers=1)
        self._io_futures: list = []
        # realized-N law: False = the reference's Poisson(pop_size) sizes
        # (`Simulation.cpp:2329-2337`); GE_EXACT_N=1 conditions every
        # generation on exactly pop_size, as the JAX engine does
        self.exact_n = os.environ.get("GE_EXACT_N") == "1"
        # `--profile` traces the whole run, from here to the end of `run`
        # (one subdirectory a rank under a mesh)
        trace = cfg.profile_dir
        if trace and mesh is not None:
            trace = os.path.join(trace, f"rank{rank}")
        self._trace = contextlib.ExitStack()
        self._trace.enter_context(telemetry.profiler_trace(trace,
                                                           self.device))
        try:
            with self.timer("load"):
                self._load()
                self._check_fits()
        except BaseException:
            self._trace.close()
            raise

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------ mesh
    _row_axis = 1  # the axis of the genome planes' rows (individuals)

    def _block_rows(self, st: PopState) -> int:
        """Rows of this rank's block of the planes."""
        return st.seg_st.shape[1]

    def _rows(self, st: PopState) -> int:
        """The planes' rows in the unsharded run."""
        return st.rows or self._block_rows(st)

    def _block(self, rows: int) -> int:
        """Rows an 'ind' rank holds of planes of `rows` rows."""
        return -(-rows // self._ind)

    def _own(self, x: torch.Tensor, rows: int, axis: int = 1):
        """This rank's block of the `rows` rows of a full array along
        `axis`; the last rank's block is edge-padded (a copy of the last
        row, masked as every padding row is)."""
        if self.mesh is None:
            return x
        return x.index_select(axis, self._block_ids(rows, x.device))

    def _own_host(self, a: np.ndarray, rows: int) -> torch.Tensor:
        """`_own` of a full host array's rows (axis 1), on the device: only
        this rank's block crosses to it."""
        if self.mesh is not None:
            a = np.take(a, self._block_ids(rows).numpy(), axis=1)
        return torch.as_tensor(a, device=self.device)

    def _block_ids(self, rows: int, device=None) -> torch.Tensor:
        """The rows of planes of `rows` rows this rank holds, in order
        (`_own`'s; every row on one 'ind' rank)."""
        b = self._block(rows)
        return torch.arange(self._me * b, (self._me + 1) * b,
                            device=device).clamp_(max=rows - 1)

    def _real_rows(self, st: PopState) -> int:
        """Rows of this rank's block that hold individuals (global row <
        n)."""
        b = self._block_rows(st)
        return max(0, min(st.n - self._me * b, b))

    def _reduce_ind(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced over the 'ind' ranks (itself on one)."""
        if self._ind == 1:
            return t
        return comm.all_reduce(t.contiguous(), op, self.mesh.group("ind"),
                               self.mesh.traffic)

    def _gather_ind(self, t: torch.Tensor, n: int, axis: int = 0):
        """The first `n` rows along `axis` of every 'ind' rank's block of
        `t`, in row order (its own on one 'ind' rank)."""
        if self._ind == 1:
            return t.narrow(axis, 0, n)
        g = gather_dim(t, axis, self.mesh.group("ind"), self.mesh.traffic)
        return g.narrow(axis, 0, n)

    def chrom_ledger(self, p: PopRuntime, ic: int):
        """(seg_st, seg_hap, mut) of chromosome `ic`, the population's n
        rows; under a mesh gathered over 'ind', a collective every rank
        joins."""
        st = p.state
        return tuple(self._gather_ind(x[ic], st.n)
                     for x in (st.seg_st, st.seg_hap, st.mut))

    def output_rows(self, st: PopState):
        """The rows this node writes: None (all of them) on one node, else
        its ranks' rows (`multihost.host_row_ranges`)."""
        if self.mesh is None or multihost.node_info()[1] == 1:
            return None
        ranges = multihost.host_row_ranges(self._rows(st),
                                           tuple(self.mesh.shape))
        return np.concatenate([np.arange(lo, min(hi, st.n))
                               for lo, hi in ranges] or [np.arange(0)])

    def _check_agree(self, plan: mating.MatingPlan, gen: int) -> None:
        """Every rank must hold the same mating plan: an all-reduce of its
        hash, failing on every rank together if any differs."""
        if self.mesh is None:
            return
        h = hashlib.sha256()
        for a in (plan.father_pos, plan.mother_pos, plan.child_couple):
            h.update(np.ascontiguousarray(a).tobytes())
        v = int.from_bytes(h.digest()[:7], "little")
        with telemetry.host_wait(self.timer, "plan_agree"):
            t = torch.tensor([v, -v], dtype=torch.int64, device=self.device)
            comm.all_reduce(t, "max", None, self.mesh.traffic)
            got = int(t[0]), -int(t[1])
        if got != (v, v):
            raise SimulationError(
                f"the ranks' mating plans differ at generation {gen}")

    # ------------------------------------------------------------------ load
    def _load_pop(self, ipop: int, pcfg, hap_offset: int) -> PopRuntime:
        """One population's schedule, founder panel addresses, maps and
        phenotypes (CV positions, effects and founder CV alleles)."""
        cfg = self.cfg
        schedule = tables.read_generation_info(pcfg.file_gen_info)
        if pcfg.file_ref_vcf:
            vcf_addr = tables.read_vcf_address(pcfg.file_ref_vcf)
            hap_addr = []
            chrs = [a[0] for a in vcf_addr]
            indv_ids = vcf_io.read_header_samples(vcf_addr[0][1])
        else:
            vcf_addr = []
            hap_addr = tables.read_hap_address(pcfg.file_hap_name)
            chrs = [a[0] for a in hap_addr]
            self._check_hap_panels(hap_addr)
            indv_ids = hap_io.read_indv(hap_addr[0][3])
        rmaps = tables.read_recom_map(pcfg.file_recom_map, chrs)
        mmaps = (
            tables.read_mutation_map(pcfg.file_mutation_map, chrs)
            if pcfg.file_mutation_map else None
        )
        maps = [ChromMaps.build(c, rmaps[c], mmaps[c] if mmaps else None)
                for c in chrs]
        if cfg.debug:
            # map spot-checks (`Population.cpp:400-411, 497-505`)
            for c in chrs:
                r = rmaps[c]
                tail = " ".join(f"{v:g}" for v in r.cM[-20:])
                print(f"  rmap bp distance in chr {c}={r.bin_width}")
                print(f"  rmap: {tail}")
                prob = r.prob
                print(f"  mean(recom_prob)={np.mean(prob):g}, "
                      f"recom_prob[end]={prob[-1]:g}")
        phenos = []
        n_founders = None
        for ph in pcfg.phenotypes:
            cv_info = tables.read_cv_info(ph.file_cv_info, chrs)
            cv_addr = tables.read_cvs_address(ph.file_cvs, chrs)
            founder_cv, cv_bp, a_eff, d_eff = [], [], [], []
            for c in chrs:
                mat = hap_io.read_hap(cv_addr[c])  # (2n0, ncv_chr)
                ncv_c = len(cv_info[c].bp)
                if mat.shape[1] < ncv_c:
                    raise SimulationError(
                        "fewer CVs in cv.hap than cv.info file "
                        f"(chr {c}: {mat.shape[1]} < {ncv_c})"
                    )
                mat = mat[:, :ncv_c]  # only the cv.info rows are indexed
                if n_founders is None:
                    n_founders = mat.shape[0] // 2
                elif n_founders != mat.shape[0] // 2:
                    raise SimulationError(
                        "founder count differs between CV hap files"
                    )
                founder_cv.append(mat)
                cv_bp.append(cv_info[c].bp)
                a_eff.append(cv_info[c].a)
                d_eff.append(cv_info[c].d)
            phenos.append(PhenoScheme(
                cv_bp=cv_bp, a=a_eff, d=d_eff, founder_cv=founder_cv,
                va=ph.va, vd=ph.vd, vc=ph.vc, ve=ph.ve, vf=ph.vf,
                omega=ph.omega, beta=ph.beta, lambda_=ph.lambda_,
            ))
        if n_founders is None:
            raise SimulationError("no phenotypes configured")
        p = PopRuntime(
            index=ipop, schedule=schedule, chrs=chrs, maps=maps,
            phenos=phenos, n_founders=n_founders, hap_offset=hap_offset,
            mm_percent=pcfg.mm_percent, rm=pcfg.rm, rmaps=rmaps,
            hap_addresses=hap_addr, vcf_addresses=vcf_addr,
            indv_ids=list(indv_ids),
        )
        p.smaps = segments.StackedMaps.build(maps, self.device)
        return p

    def _load(self) -> None:
        """Every population (`--next_population`), as the JAX `_load`: its
        founder haps follow the earlier populations' (`hap_offset`, 2 x
        founders each), so one ledger hap index names a founder haplotype
        of any population and its root population (`pop_starts`)."""
        cfg = self.cfg
        if cfg.n_pop > MAX_POPULATIONS:
            raise SimulationError(
                f"{cfg.n_pop} populations: the port paints root "
                f"populations as bytes, so at most {MAX_POPULATIONS}"
            )
        hap_offset = 0
        for ipop, pcfg in enumerate(cfg.populations):
            p = self._load_pop(ipop, pcfg, hap_offset)
            if self.pops and (p.schedule.n_generations
                              != self.pops[0].schedule.n_generations):
                raise SimulationError(
                    "the number of generations differs between populations"
                )
            self.pops.append(p)
            hap_offset += 2 * p.n_founders
        self.n_pop = len(self.pops)
        self.tot_gen = int(self.pops[0].schedule.n_generations)
        self.chrs = chrs = self.pops[0].chrs
        for p in self.pops[1:]:
            if p.chrs != chrs:
                raise SimulationError(
                    "all populations must use the same chromosome set"
                )
        self.pop_starts = np.array([p.hap_offset for p in self.pops],
                                   dtype=np.int64)
        self.migration = (
            tables.read_migration(cfg.file_migration, self.n_pop,
                                  self.tot_gen)
            if self.n_pop > 1 else None
        )
        self.out_gens = (
            tables.read_output_generations(cfg.file_output_generations)
            if cfg.file_output_generations else []
        )
        nchr = len(chrs)

        # CV tables stacked over chromosomes, padded to a common CV count
        # with zero-effect columns that probe the chromosome start: the
        # founder CV alleles concatenated over populations, the effects per
        # population (a chromatid's effect is its root population's)
        ncv_max = max(
            (len(p.phenos[j].cv_bp[ic]) for p in self.pops
             for j in range(self.n_pheno) for ic in range(nchr)),
            default=0,
        )
        self.ncv_pad = max(ncv_max, 1)
        self.ncv_real: List[List[int]] = []
        self.founder_cv: List[np.ndarray] = []  # [pheno] (nchr, H, ncv_pad)
        # [pheno] (nchr, n_pop, ncv_pad) f32
        self.eff_a: List[torch.Tensor] = []
        self.eff_d: List[torch.Tensor] = []
        cv_bp = []
        H = sum(2 * p.n_founders for p in self.pops)
        for j in range(self.n_pheno):
            gc = np.zeros((nchr, H, self.ncv_pad), dtype=np.uint8)
            ga = np.zeros((nchr, self.n_pop, self.ncv_pad), dtype=np.float32)
            gd = np.zeros_like(ga)
            gb = np.zeros((nchr, self.ncv_pad), dtype=np.int64)
            real = []
            for ic, c in enumerate(chrs):
                bp0 = self.pops[0].phenos[j].cv_bp[ic]
                for p in self.pops[1:]:
                    if not np.array_equal(p.phenos[j].cv_bp[ic], bp0):
                        raise SimulationError(
                            "CV positions must agree across populations "
                            f"(phenotype {j + 1}, chr {c})"
                        )
                k = len(bp0)
                real.append(k)
                gb[ic, :] = self.pops[0].maps[ic].chr_start
                if k:
                    gb[ic, :k] = bp0
                    gc[ic, :, :k] = np.concatenate(
                        [p.phenos[j].founder_cv[ic] for p in self.pops])
                    ga[ic, :, :k] = np.stack(
                        [p.phenos[j].a[ic] for p in self.pops])
                    gd[ic, :, :k] = np.stack(
                        [p.phenos[j].d[ic] for p in self.pops])
            self.founder_cv.append(gc)
            self.eff_a.append(torch.as_tensor(ga, device=self.device))
            self.eff_d.append(torch.as_tensor(gd, device=self.device))
            cv_bp.append(gb)
            self.ncv_real.append(real)
        # all phenotypes' CV positions on one axis: (nchr, npheno*ncv_pad)
        self.cv_bp_all = torch.as_tensor(
            np.concatenate(cv_bp, axis=1).astype(np.int32), device=self.device
        )

        # capacities, uniform across chromosomes and populations (sized for
        # the largest map): s_cap covers the ~Poisson(G*L) boundary count
        # with a 6-sigma margin; the probe grows it exactly when a draw
        # needs more
        G = self.tot_gen
        L = max(m.xo_lambda for p in self.pops for m in p.maps)
        lam_m = max(m.mut_lambda for p in self.pops for m in p.maps)
        gl = max(G * L, 1.0)
        self.s_cap = int(8 + np.ceil(gl + 6 * np.sqrt(gl)))
        self.xo_cap = int(8 + np.ceil(L + 6 * np.sqrt(max(L, 1.0))))
        if lam_m > 0:
            gm = G * lam_m
            self.m_cap = int(8 + np.ceil(gm + 6 * np.sqrt(max(gm, 1.0))))
            self.mn_cap = int(4 + np.ceil(lam_m + 6 * np.sqrt(max(lam_m, 0.25))))
            self.has_mut = True
        else:  # no mutation map: keep the (always-BIG) planes minimal
            self.m_cap = 2
            self.mn_cap = 2
            self.has_mut = False
        # founder-hap indices fit int16 up to 32k haplotypes (all
        # populations' founders together)
        self.hap_dtype = torch.int16 if H <= 32000 else torch.int32

        for q in self.pops:
            z = np.zeros((self.n_pheno, G + 1))
            q.traj = {
                k: z.copy() for k in ("var_A", "var_D", "var_G", "var_C",
                                       "var_E", "var_F", "var_P", "h2")
            }
            q.traj["var_mv"] = np.zeros(G + 1)
            q.traj["var_sv"] = np.zeros(G + 1)

    @staticmethod
    def _check_hap_panels(hap_addr) -> None:
        """.indv count vs .hap columns, equal across chromosomes
        (`Simulation.cpp:290-320`): a mismatched panel fails at load."""
        n_per_chr = []
        for _c, f_hap, _f_leg, f_indv in hap_addr:
            with open(f_hap) as fh:
                hap_ncol = len(fh.readline().split())
            with open(f_indv) as fi:
                indv_nrow = len(fi.read().split())
            if indv_nrow * 2 != hap_ncol:
                raise SimulationError(
                    f"Number of individuals are not equal in files "
                    f"[{f_hap}] and [{f_indv}]."
                )
            n_per_chr.append(indv_nrow)
        if any(x != n_per_chr[0] for x in n_per_chr):
            raise SimulationError(
                "Number of individuals are not equal in different chromosomes."
            )

    def _check_fits(self) -> None:
        """Decide whether the resident CV matrix stays on the card, and set
        `gather_chunk`, the chromosomes one stacked row gather of the real
        pass covers (`core/memory.reckon`, whose plan is kept in
        `self.mem_plan`; None off the card).

        Several populations always take the gather path, as in the JAX
        engine: a chromatid's A/D effects are its root population's, found
        from the founder hap it copies, which the resident matrix does not
        carry. When the resident path's need does not fit what is free, or
        under GE_NO_RESIDENT_CV=1 (the JAX package's switch), the run takes
        the gather path: no resident matrix, A/D painted from the ledger
        each generation. Re-run on every `[capacity grow]`: a grown ledger
        can move a run to the gather path. Under a mesh the bytes are a
        rank's, against the least free memory of any rank, so that every
        rank decides alike."""
        nchr = len(self.chrs)
        self.gather_chunk = nchr
        self.mem_plan = None
        if os.environ.get("GE_NO_RESIDENT_CV") == "1":
            self.resident_cv = False
        if self.n_pop > 1 and self.resident_cv:
            self.resident_cv = False
            self._log(
                f"    [mem] {self.n_pop} populations: a chromatid's A/D "
                "effects are its root population's, which the resident CV "
                "matrix does not carry; using the gather path"
            )
        if self.device.type != "cuda":
            return
        free, _total = torch.cuda.mem_get_info(self.device)
        if self.mesh is not None:
            free = int(comm.all_reduce(
                torch.tensor([free], dtype=torch.int64, device=self.device),
                "min", None, self.mesh.traffic)[0])
        plan = memory.reckon(self._sizes(), free,
                             memory.Switches.from_env(), self.resident_cv)
        if self.resident_cv and not plan.resident_cv:
            self._log(
                "    [mem] resident CV matrix + ledger state need "
                f"{plan.need_resident / 2**30:.1f} GiB, more than the free "
                f"device memory ({free / 2**30:.2f} GiB); using the gather "
                "path"
            )
        self.resident_cv = plan.resident_cv
        self.gather_chunk = plan.gather_chunk
        self.mem_plan = plan

    def _sizes(self) -> memory.Sizes:
        """The sizes `memory.reckon` takes: each population's largest plane
        rows (the Poisson headroom included), capacities and CV columns."""
        pop_rows, constant = [], True
        for p in self.pops:
            sizes = [int(s) for s in p.schedule.pop_size]
            r = max(sizes)
            pop_rows.append(max(r + 4 * int(np.sqrt(r)) + 16, p.n_founders))
            constant = constant and len(set(sizes)) == 1
        return memory.Sizes(
            nchr=len(self.chrs), pop_rows=tuple(pop_rows),
            founder_haps=2 * sum(p.n_founders for p in self.pops),
            n_pop=self.n_pop, c_all=self.n_pheno * self.ncv_pad,
            ncv_pad=self.ncv_pad, s_cap=self.s_cap, m_cap=self.m_cap,
            xo_cap=self.xo_cap, mn_cap=self.mn_cap,
            hap_bytes=2 if self.hap_dtype == torch.int16 else 4,
            ind=self._ind, constant=constant)

    # ------------------------------------------------------------------ gen0
    def init_generation0(self) -> None:
        for p in self.pops:
            p.state = self._init_gen0_state(p)
        self._init_gen0_phenotypes()

    def _gen0_host_fields(self, p: PopRuntime, n: int) -> dict:
        """Founder sex/ids/pedigree (self-parent IDs,
        `Simulation.cpp:3036-3044`)."""
        rng_sex = np.random.default_rng(
            np_seed(self.cfg.seed, 0, Stage.INIT_SEX, p.index)
        )
        ids = np.arange(n, dtype=np.int64)
        return dict(
            n=n,
            sex=rng_sex.integers(1, 3, size=n).astype(np.int8),
            ids=ids,
            ped={k: ids.copy() for k in ("father", "mother", "ff", "fm",
                                          "mf", "mm")},
            comp={},
            mv=np.zeros(n),
            sv=np.zeros(n),
            svf=np.ones(n),
        )

    def _gen0_rows(self, p: PopRuntime, n0: int) -> int:
        """Gen-0 plane rows: padded to the row count generation 1 will use
        (padding rows copy founder n0-1 and are masked from statistics)."""
        pop1 = int(p.schedule.pop_size[0])
        if p.rm or p.schedule.offspring_dist[0] in ("f", "F") or self.exact_n:
            target = pop1
        else:
            target = pop1 + 4 * int(np.sqrt(max(pop1, 1))) + 16
        return max(n0, target)

    def _init_gen0_state(self, p: PopRuntime) -> PopState:
        """Generation 0's planes, only this rank's block of rows under a
        mesh (a rank never holds the whole population's)."""
        n = p.n_founders
        rows = self._gen0_rows(p, n)
        ids = self._block_ids(rows)
        seg_st, seg_hap = segments.init_gen0_ledger_stacked(
            n, [m.chr_start for m in p.maps], p.hap_offset, self.s_cap,
            self.hap_dtype, device=self.device, ids=ids.to(self.device))
        mut = segments.empty_mutations_stacked(
            len(self.chrs), len(ids), self.m_cap, device=self.device
        )
        cv0 = None
        if self.resident_cv:
            # founder i's chromatids read founder haps 2i / 2i+1
            # (`Simulation.cpp:3024-3035`); padding rows copy founder n-1
            cv0 = np.concatenate(
                [np.stack([g[:, 0:2 * n:2], g[:, 1:2 * n:2]], axis=2)
                 for g in self.founder_cv],
                axis=3,
            )  # (nchr, n, 2, npheno*ncv_pad)
            cv0 = torch.as_tensor(
                np.take(cv0, np.minimum(ids.numpy(), n - 1), axis=1),
                device=self.device)
        return PopState(
            seg_st=seg_st, seg_hap=seg_hap, mut=mut, cv=cv0, rows=rows,
            **self._gen0_host_fields(p, n),
        )

    def _init_gen0_phenotypes(self) -> None:
        for p in self.pops:
            A_raw, D_raw = self._compute_ad(p)
            p.var_a_gen0 = np.array(
                [phenotype.var(A_raw[j]) for j in range(self.n_pheno)]
            )
            p.var_d_gen0 = np.array(
                [phenotype.var(D_raw[j]) for j in range(self.n_pheno)]
            )
            p.prev_phen = np.zeros((self.n_pheno, p.state.n))
            p.prev_F = np.zeros((self.n_pheno, p.state.n))
            self._assemble_phenotypes(p, 0, A_raw, D_raw, None)
        self._apply_gamma()
        for p in self.pops:
            self._mating_selection_values(p, gen=0)
        for p in self.pops:
            p.prev_phen = p.state.comp["P"].copy()
            p.prev_F = p.state.comp["F"].copy()
            self._save_info(p, 0)
            self._record_traj(p, 0)
            # adjust beta from gen-0 variances (`Simulation.cpp:648-658`)
            for j, ph in enumerate(p.phenos):
                var_P = phenotype.var(p.state.comp["P"][j])
                var_F = phenotype.var(p.state.comp["F"][j])
                if self.vt_type == 1:
                    ph.beta = (float(np.sqrt(ph.vf / (2 * var_P)))
                               if var_P > 0 else ph.beta)
                elif self.vt_type == 2 and var_F > 0:
                    ph.beta = float(np.sqrt(ph.vf / (2 * var_F)))

    # ----------------------------------------------------------------- A / D
    def _compute_ad(self, p: PopRuntime, gen: int = -1):
        """(npheno, n) float64 raw additive and dominance values
        (`Simulation.cpp:2624-2749`), from the resident CV matrix or, on the
        gather path, from CV columns painted from the ledger. Under
        --debug the final generation's CV alleles are dumped (`.cvval`).
        Under a mesh each rank computes its rows against the population's
        allele counts (an integer all-reduce) and A and D are
        all-gathered."""
        st = p.state
        A = np.zeros((self.n_pheno, st.n))
        D = np.zeros((self.n_pheno, st.n))
        dump_cv = self.cfg.debug and gen == self.tot_gen
        for j in range(self.n_pheno):
            if sum(self.ncv_real[j]) == 0:
                continue
            ad = (self.eff_a[j], self.eff_d[j], p.phenos[j].vd != 0)
            if st.cv is not None:
                c = st.cv[..., j * self.ncv_pad:(j + 1) * self.ncv_pad]
                if self._ind == 1:
                    A_j, D_j = _ad_resident(c, *ad, st.n, timer=self.timer)
                else:
                    k = self._real_rows(st)
                    A_j, D_j = _ad_resident(c, *ad, k,
                                            self._allele_counts(c, k), st.n,
                                            timer=self.timer)
            else:
                A_j, D_j, c = self._ad_gather(st, j, ad, dump_cv)
            with telemetry.host_wait(self.timer, "ad_to_host"):
                A[j] = self._gather_ind(A_j, st.n).double().cpu().numpy()
                D[j] = self._gather_ind(D_j, st.n).double().cpu().numpy()
            if dump_cv:
                c = self._gather_ind(c, st.n, axis=1)
                if self.is_root:
                    self._dump_cvval(p, gen, j, c)
        return A, D

    def _allele_counts(self, c: torch.Tensor, k: int) -> torch.Tensor:
        """(nchr, ncv) allele counts of the population from the CV alleles
        (nchr, rows, 2, ncv) of this rank's first `k` rows: exact integer
        sums (`_allele_sums`), all-reduced over 'ind'."""
        return self._reduce_ind(_allele_sums(c, k))

    def _ad_gather(self, st: PopState, j: int, ad, want_cv: bool):
        """The gather path's A/D of phenotype j (the JAX `_ad_all`): its CV
        columns painted from the ledger, one `paint` launch over every
        chromosome; with several populations a second launch paints the
        same ledger over the root panel (`_root_panel`) with no mutations,
        which gives each chromatid's root population at each CV (the JAX
        `searchsorted(pop_starts, hap) - 1`). Past GE_AD_CHUNK rows (unless
        the allele dump needs the whole matrix), two passes over row
        chunks: the population's allele counts first, then A/D a chunk
        against them. Under a mesh the counts are all-reduced over 'ind'.
        Returns (A, D, the painted alleles or None) of this rank's rows."""
        if self._cv_panels is None:  # the founders' CV columns, once
            with telemetry.host_wait(self.timer, "cv_panels"):
                self._cv_panels = [torch.as_tensor(g, device=self.device)
                                   for g in self.founder_cv]
        cols = slice(j * self.ncv_pad, (j + 1) * self.ncv_pad)
        pos = self.cv_bp_all[:, cols].contiguous()
        founder = self._cv_panels[j]
        roots = self._root_panel()
        chunk = int(os.environ.get("GE_AD_CHUNK", "131072"))
        rows = st.seg_st.shape[1]

        def ledger(lo, hi):
            return [x[:, lo:hi].contiguous()
                    for x in (st.seg_st, st.seg_hap, st.mut)]

        def painted(lo, hi):  # alleles, and roots with several populations
            led = ledger(lo, hi)
            c = paint(*led, founder, pos)
            if roots is None:
                return c, None
            none = led[2].new_empty(led[2].shape[:3] + (0,))
            return c, paint(led[0], led[1], none, roots, pos)

        k = self._real_rows(st)
        if want_cv or rows <= chunk:
            c, r = painted(0, rows)
            if self._ind == 1:
                return (*_ad_resident(c, *ad, st.n, roots=r,
                                      timer=self.timer), c)
            return (*_ad_resident(c, *ad, k, self._allele_counts(c, k),
                                  st.n, roots=r, timer=self.timer), c)
        spans = [(lo, min(lo + chunk, rows)) for lo in range(0, rows, chunk)]
        counts = 0
        for lo, hi in spans:
            c = paint(*ledger(lo, hi), founder, pos)
            counts = counts + _allele_sums(c, max(0, min(k - lo, hi - lo)))
        counts = self._reduce_ind(counts)
        parts = []
        for lo, hi in spans:
            c, r = painted(lo, hi)
            parts.append(_ad_resident(c, *ad, max(0, min(k - lo, hi - lo)),
                                      counts, st.n, roots=r,
                                      timer=self.timer))
        return (torch.cat([x[0] for x in parts]),
                torch.cat([x[1] for x in parts]), None)

    def _root_panel(self) -> Optional[torch.Tensor]:
        """(nchr, H, ncv_pad) uint8: the population of founder hap h at
        every CV column, the panel `paint` reads a chromatid's root
        population from; None with one population."""
        if self.n_pop == 1:
            return None
        if self._roots is None:
            nf = np.diff(np.append(self.pop_starts,
                                   self.founder_cv[0].shape[1]))
            r = np.repeat(np.arange(self.n_pop, dtype=np.uint8), nf)
            with telemetry.host_wait(self.timer, "root_panel"):
                r = torch.as_tensor(r, device=self.device)
            self._roots = r[None, :, None].expand(
                len(self.chrs), -1, self.ncv_pad).contiguous()
        return self._roots

    def _dump_cvval(self, p: PopRuntime, gen: int, j: int, c) -> None:
        """Per-chromatid CV alleles of the final generation, a file per
        chromosome (`Simulation.cpp:2665-2683`); the reference overwrites
        it per phenotype, and so does this."""
        st = p.state
        for ic in range(len(self.chrs)):
            k = self.ncv_real[j][ic]
            if k == 0:
                continue
            path = (f"{self.cfg.prefix}.pop{p.index + 1}.gen{gen}"
                    f".chr{self.chrs[ic]}.cvval")
            with telemetry.host_wait(self.timer, "cvval"):
                cv = c[ic, : st.n, :, :k].cpu().numpy()  # (n, 2, ncv)
            inter = np.empty((cv.shape[0], 2 * cv.shape[2]), dtype=cv.dtype)
            inter[:, 0::2] = cv[:, 0]
            inter[:, 1::2] = cv[:, 1]
            np.savetxt(path, inter, fmt="%d", delimiter=" ")

    # ------------------------------------------------------------ phenotypes
    def _assemble_phenotypes(self, p, gen, A_raw, D_raw, plan) -> None:
        """E/F/C/P assembly (`ras_scale_AD_compute_GEF`,
        `Simulation.cpp:3075-3206`)."""
        st = p.state
        n = st.n
        comp = {k: np.zeros((self.n_pheno, n)) for k in "ADGCEFP"}
        rng_e = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.E_NOISE, p.index)
        )
        rng_f = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.F_GEN0, p.index)
        )
        for j, ph in enumerate(p.phenos):
            e_std = rng_e.standard_normal(n)
            if gen == 0:
                par_eff = (
                    rng_f.normal(0.0, np.sqrt(ph.vf), size=n)
                    if ph.vf > 0 else np.zeros(n)
                )
                C = st.comp.get("C", None)
                C = C[j] if C is not None else self._gen0_common(p, j, n)
            else:
                src = self._prev_for_vt(p)[j]
                par_eff = ph.beta * (
                    src[plan.child_father] + src[plan.child_mother]
                )
                C = st.comp["C"][j]
            out = phenotype.scale_components(
                A_raw[j], D_raw[j], e_std, par_eff, C, ph.va, ph.vd, ph.ve,
                ph.vf, p.var_a_gen0[j], p.var_d_gen0[j],
            )
            for k in comp:
                comp[k][j] = out[k]
        st.comp = comp

    def _gen0_common(self, p: PopRuntime, j: int, n: int) -> np.ndarray:
        ph = p.phenos[j]
        if ph.vc <= 0:
            return np.zeros(n)
        rng_c = np.random.default_rng(
            np_seed(self.cfg.seed, 0, Stage.INIT_COMMON, p.index * 131 + j)
        )
        return rng_c.normal(0.0, np.sqrt(ph.vc), size=n)

    def _prev_for_vt(self, p: PopRuntime) -> np.ndarray:
        return p.prev_phen if self.vt_type == 1 else p.prev_F

    def _mating_selection_values(self, p: PopRuntime, gen: int) -> None:
        st = p.state
        omega = np.array([ph.omega for ph in p.phenos])
        lam = np.array([ph.lambda_ for ph in p.phenos])
        mv, sv = phenotype.mating_selection_values(st.comp["P"], omega, lam)
        st.mv = mv
        if gen == 0:
            p.sv_mean_gen0 = float(np.mean(sv))
            p.sv_var_gen0 = phenotype.var(sv)
        z = sv - p.sv_mean_gen0
        if p.sv_var_gen0 > 0:
            z = z / np.sqrt(p.sv_var_gen0)
        st.sv = z
        sched = p.schedule
        if gen == 0:
            st.svf = np.ones(st.n)
        else:
            g = gen - 1
            st.svf = phenotype.selection_prob(
                z, gen, sched.selection_func[g], sched.selection_par1[g],
                sched.selection_par2[g],
            )

    def _apply_gamma(self) -> None:
        """Population-specific environmental offsets
        (`Simulation.cpp:3345-3381`). Under a mesh the moments are f32
        device sums over 'ind' (`_device_moments`), as in the JAX
        engine."""
        if len(self.pops) < 2:
            return
        for j, g in enumerate(self.cfg.gamma):
            if g == 0:
                continue
            moments = [phenotype.pop_moments(p.state.comp["P"][j])
                       if self.mesh is None
                       else self._device_moments(p.state.comp["P"][j])
                       for p in self.pops]
            ah = phenotype.solve_gamma_offset_moments(moments, g)
            offs = phenotype.gamma_offsets(len(self.pops), ah)
            for i, p in enumerate(self.pops):
                p.state.comp["P"][j] += offs[i]

    def _device_moments(self, x: np.ndarray) -> tuple:
        """(n, sum, sumsq) of a phenotype vector: each 'ind' rank sums its
        block of it in f32 on its device, and one f32 all-reduce adds the
        blocks (the JAX `_device_moments`)."""
        n = x.shape[0]
        b = self._block(n)
        mine = np.asarray(x[self._me * b:(self._me + 1) * b], dtype=np.float32)
        with telemetry.host_wait(self.timer, "moments"):
            mine = torch.as_tensor(mine, device=self.device)
            t = self._reduce_ind(torch.stack([mine.sum(),
                                              (mine * mine).sum()]))
            return float(n), float(t[0]), float(t[1])

    # ------------------------------------------------------------------ step
    def _mate(self, p: PopRuntime, gen: int, pop_size: int,
              g: int) -> mating.MatingPlan:
        """Host mating (`core/mating.py`, the port's copy of the JAX
        package's numpy mating module), or under `--device_mating` the
        assortative pairing on the device (`_device_mate`)."""
        if self.cfg.device_mating and not p.rm:
            return self._device_mate(p, gen, pop_size, g)
        st = p.state
        rng_mate = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.MATE, p.index)
        )
        if p.rm:
            return mating.random_mate(rng_mate, st.svf, st.sex, pop_size)
        return mating.assort_mate(
            rng_mate, st.mv, st.svf, st.sex, st.ped,
            float(p.schedule.mat_cor[g]), p.mm_percent,
            self.cfg.avoid_inbreeding, p.schedule.offspring_dist[g], pop_size,
            exact_n=self.exact_n,
        )

    def _device_mate(self, p: PopRuntime, gen: int, pop_size: int,
                     g: int) -> mating.MatingPlan:
        """Assortative pairing on the device (`--device_mating`, the JAX
        engine's `_device_mate`): the sorts, rank match and veto run on
        the run's device and the plan lands in the same `MatingPlan` the
        reproduce path takes. Same law as the host mating, another random
        stream: a generator seeded from (seed, generation, population), so
        a resumed run draws the same plan."""
        from geneevolve_tpu_torch.parallel import mating_device as md

        st = p.state
        law = p.schedule.offspring_dist[g]
        if law in ("f", "F") or self.exact_n:
            n_emit = realized = pop_size
        else:
            # realized generation size ~ Poisson(pop_size)
            # (`Simulation.cpp:2329-2337`), drawn on the host; the device
            # plan emits a fixed padded child count and the realized total
            # is taken off the front (each child's draw is its own)
            rng_n = np.random.default_rng(
                np_seed(self.cfg.seed, gen, Stage.MATE, p.index)
            )
            n_emit = pop_size + 4 * int(np.sqrt(pop_size)) + 16
            drawn = max(1, int(rng_n.poisson(pop_size)))
            realized = min(drawn, n_emit)
            if drawn > n_emit:
                # ~3e-5/gen upper-tail truncation vs the host path's
                # unclamped law: rare, but made observable
                self._log(
                    f"      warning: realized generation size {drawn} "
                    f"clamped to device-mating emit capacity {n_emit}"
                )
        dev = self.device

        def put(x, dtype=None):
            with telemetry.host_wait(self.timer, "mate_upload"):
                return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        ped = {}
        if self.cfg.avoid_inbreeding:
            ped = {k: put(st.ped[k]) for k in ("father", "ff", "fm", "mf",
                                              "mm")}
        plan = md.assort_mate_device(
            generator(dev, self.cfg.seed, gen, Stage.MATE, p.index),
            put(st.mv, torch.float32),
            put(st.svf, torch.float32),
            put(st.sex),
            ped,
            float(p.schedule.mat_cor[g]),
            self.cfg.avoid_inbreeding,
            pop_size,
            mm_percent=p.mm_percent,
            offspring_dist=law,
            n_children=n_emit,
            timer=self.timer,
        )
        with telemetry.host_wait(self.timer, "mate_plan"):
            nc = int(plan.n_couples)
            if nc == 0:
                raise SimulationError("device mating produced zero couples")
            return mating.MatingPlan(
                father_pos=plan.father_pos[:nc].cpu().numpy(),
                mother_pos=plan.mother_pos[:nc].cpu().numpy(),
                inbred=plan.inbred[:nc].cpu().numpy(),
                child_couple=plan.child_couple[:realized].cpu().numpy(),
            )

    def step(self, gen: int) -> None:
        t_gen = time.time()
        with self.timer(telemetry.STEP):
            g = gen - 1  # schedule row
            for p in self.pops:
                with self.timer("mate"):
                    plan = self._mate(p, gen, int(p.schedule.pop_size[g]), g)
                    self._check_agree(plan, gen)
                mv = plan.couple_cor_mating_value(p.state.mv)
                self._log(
                    f"      pop {p.index + 1} gen {gen}: "
                    f"couples={plan.n_couples} couple_cor_mv={mv:.3f}"
                )
                # no reference to the parents' state outlives `_reproduce`:
                # on fresh planes they are freed with it, before the A/D and
                # the migration
                with self.timer("reproduce"):
                    p.state = self._reproduce(p, gen, plan)
                with self.timer("compute_ad"):
                    A_raw, D_raw = self._compute_ad(p, gen)
                with self.timer("phenotypes"):
                    self._assemble_phenotypes(p, gen, A_raw, D_raw, plan)
            with self.timer("gamma_mv_sv"):
                self._apply_gamma()
                for p in self.pops:
                    self._mating_selection_values(p, gen)
            if self.n_pop > 1:
                with self.timer("migration"):
                    self._migrate(gen)
            with self.timer("info_files"):
                for p in self.pops:
                    p.prev_phen = p.state.comp["P"].copy()
                    p.prev_F = p.state.comp["F"].copy()
                    self._save_info(p, gen)
                    self._record_traj(p, gen)
            if gen in self.out_gens:
                with self.timer("genotype_output"):
                    self.save_genotypes(gen)
            vm, rss = telemetry.process_mem_usage()
            self._log("      -------------------------")
            self._log(f"      memory used: VM = {vm:.0f} Mb, "
                      f"RSS = {rss:.0f} Mb")
            for dev, mb in telemetry.device_memory_mb(self.device).items():
                self._log(f"        {dev}: memory allocated = {mb:.0f} Mb")
            self._log(
                f"      time used for this generation: "
                f"{time.time() - t_gen:.2f} seconds"
            )

    def _child_rows(self, p: PopRuntime, gen: int, n_child: int,
                    par_rows: int) -> int:
        """Plane rows for `n_child` children: under the Poisson law, reuse
        the parents' row count when it covers the jitter, else take ~4
        sigma of headroom. Padding rows are meioses of parent 0, masked by
        `PopState.n` in A/D and never written to outputs."""
        law_p = not p.rm and p.schedule.offspring_dist[gen - 1] not in ("f", "F")
        if not law_p or self.exact_n:
            return n_child
        sigma = int(np.sqrt(max(n_child, 1)))
        if n_child <= par_rows <= n_child + 8 * sigma + 64:
            return par_rows
        return n_child + 4 * sigma + 16

    def _plan(self, p: PopRuntime, gen: int, n_pad: int, c0: int = 0,
              c1: Optional[int] = None):
        """Draw every random number of the coming reproduce pass for
        chromosomes [c0, c1) (all of them by default), per chromosome from
        its own generator: (xo_f, xo_m, sh, new_f, new_m) stacked over
        those chromosomes — (c1 - c0, n, xo_cap) crossovers of each
        parent's gamete, (c1 - c0, n, 2) start chromatids, (c1 - c0, n,
        mn_cap) de novo mutations split by chromatid. A range's plan is
        the same rows of the whole plan, draw for draw (the JAX
        `_plan_group`).

        Each chromosome draws, in this order, the father's crossovers, the
        mother's, the start chromatids, then the mutations and their
        chromatids; every chromosome's draw of one kind is taken before the
        next kind's, so the bins of each kind are one stacked `cdf_bins`
        launch (`segments.sample_point_process_stacked`)."""
        sm = p.smaps
        c1 = len(self.chrs) if c1 is None else c1
        cs = slice(c0, c1)
        dev = self.device
        gens = [generator(dev, self.cfg.seed, gen, Stage.CROSSOVER, p.index,
                          ci) for ci in range(c0, c1)]

        def part(a):
            return None if a is None else a[cs]

        xo_f, xo_m = (
            segments.sample_point_process_stacked(
                gens, n_pad, self.xo_cap, sm.xo_cum[cs], sm.xo_lambda[cs],
                sm.bp[cs], sm.bin_width[cs], False, bp0=part(sm.bp0),
                bp_step=None if sm.bp0 is None else sm.bp_step[cs],
            )
            for _ in range(2)
        )
        sh = torch.stack([
            torch.randint(0, 2, (n_pad, 2), generator=g, device=dev,
                          dtype=torch.int32)
            for g in gens
        ])
        if not self.has_mut:
            none = torch.full((c1 - c0, n_pad, 1), BIG, dtype=torch.int32,
                              device=dev)
            return xo_f, xo_m, sh, none, none
        new = segments.sample_point_process_stacked(
            gens, n_pad, self.mn_cap, sm.mut_cum[cs], sm.mut_lambda[cs],
            sm.mut_bp[cs], np.zeros(c1 - c0), True, bp0=part(sm.mut_bp0),
            bp_step=None if sm.mut_bp0 is None else sm.mut_bp_step[cs],
        )
        which = torch.stack([
            torch.randint(0, 2, (n_pad, self.mn_cap), generator=g,
                          device=dev)
            for g in gens
        ])
        return (xo_f, xo_m, sh, torch.where(which == 0, new, BIG),
                torch.where(which == 1, new, BIG))

    def _probe_counts(self, seg_st, mut, parents, plan, owned=None):
        """Ledger slots and (conservative) mutation slots the plan's
        chromosomes will need, from their parents' planes `seg_st` and
        `mut`: (seg, mut) device scalars. One count launch over those
        chromosomes and both parents. Under several 'ind' ranks `owned`
        (`_owned_gametes`) names the gametes whose parent this rank holds,
        counted from its own block of the planes and the plan's rows of
        those children (`_count_columns`): the largest over the ranks is
        the unsharded count."""
        if owned == ():  # this rank holds no parent of any child
            zero = torch.zeros((), dtype=torch.long, device=self.device)
            return zero, zero
        parents, xo_f, xo_m, sh, kids = self._count_columns(parents, plan,
                                                            owned)
        seg = merge_count(seg_st, parents, xo_f, xo_m, sh).amax().long()
        if not self.has_mut:
            return seg, torch.zeros_like(seg)
        # (nchr, rows) parent mutations: each row is ascending, BIG-padded,
        # so its count is the place of BIG in it
        big = torch.full(mut.shape[:-1] + (1,), BIG, dtype=mut.dtype,
                         device=mut.device)
        mreal = torch.searchsorted(mut, big).sum((2, 3))
        new_f, new_m = plan[3:]
        newr = ((new_f < BIG).sum(2, dtype=torch.int32)
                + (new_m < BIG).sum(2, dtype=torch.int32))  # (nchr, nc)
        p = parents.long()
        return seg, torch.maximum(mreal[:, p[0]] + newr[:, kids[0]],
                                  mreal[:, p[1]] + newr[:, kids[1]]).amax()

    @staticmethod
    def _count_columns(parents, plan, owned=None):
        """The operands of a count launch, whose two columns of gametes are
        the plan's father's and mother's gametes of every child, or, with
        `owned` (`_owned_gametes`), the gametes it names, read from this
        rank's rows of their parents: ((2, nc) parent rows, column 0's
        crossovers, column 1's, (nchr, nc, 2) start chromatids, each
        column's children as an index of the plan's rows)."""
        xo_f, xo_m, sh = plan[:3]
        if owned is None:
            return parents, xo_f, xo_m, sh, (slice(None), slice(None))
        (i0, g0, r0), (i1, g1, r1) = owned
        xo = (xo_f, xo_m)
        return (torch.stack([r0, r1]), xo[g0][:, i0], xo[g1][:, i1],
                torch.stack([sh[:, i0, g0], sh[:, i1, g1]], -1), (i0, i1))

    def _owned_gametes(self, parents, rows: int):
        """Under several 'ind' ranks, the gametes whose parent lies in this
        rank's block of planes of `rows` rows, as the two columns of one
        count launch: each column (its children, which parent, those
        parents' rows in the block), padded to a common length by repeating
        its last gamete (the count is a maximum); a column with no gamete
        takes the other's. Every gamete is counted once, on its parent's
        rank, and no parent row moves. None on one 'ind' rank (it holds
        every parent); () when this rank holds no parent."""
        if self._ind == 1:
            return None
        b = self._block(rows)
        with telemetry.host_wait(self.timer, "owned"):
            cols = [(torch.nonzero(parents[g] // b == self._me).squeeze(1), g)
                    for g in (0, 1)]
        h = max(len(ix) for ix, _ in cols)
        if h == 0:
            return ()
        cols = [c if len(c[0]) else cols[1 - i] for i, c in enumerate(cols)]
        out = []
        for ix, g in cols:
            ix = ix[torch.arange(h, device=ix.device).clamp_(max=len(ix) - 1)]
            out.append((ix, g, parents[g, ix] - self._me * b))
        return out

    def _needs(self, counts: list):
        """Exact ledger-slot and (conservative) mutation-slot needs of the
        coming real pass, (seg_need, mut_need) as host ints: the largest of
        the `_probe_counts` of its chromosomes. One sync; under a mesh the
        largest need of any rank."""
        t = torch.stack([torch.stack(x).amax() for x in zip(*counts)])
        with telemetry.host_wait(self.timer, "needs"):
            seg_need, mut_need = self._reduce_ind(t, "max").tolist()
        return seg_need, mut_need

    def _check_capacity_guard(self) -> None:
        """The previous real pass must have used exactly the slots the
        probe counted, and stayed within capacity: probe and real pass read
        one plan, so any drift means corrupted genomes."""
        pending, self._pending_used = self._pending_used, []
        if not pending:
            return
        # one sync; under a mesh the most any rank used
        used = torch.stack([
            torch.stack([torch.as_tensor(x, device=self.device).long()
                         for x in e[:2]]) for e in pending])
        with telemetry.host_wait(self.timer, "capacity_guard"):
            used = self._reduce_ind(used, "max").tolist()
        for (su, mu), (_su, _mu, seg_need, mut_need, s_cap, m_cap, gen,
                       pop, in_place, per_group) in zip(used, pending):
            self.capacity_log.append(dict(
                gen=gen, pop=pop, seg_need=seg_need, seg_used=su,
                mut_need=mut_need, mut_used=mu, s_cap=s_cap, m_cap=m_cap,
                in_place=in_place, per_group=per_group,
            ))
            # merge_ibd=False (--out_interval) drops boundaries at equal
            # positions after the count: it may keep fewer slots
            exact = su == seg_need if self.merge_ibd else su <= seg_need
            if su > s_cap or mu > m_cap or not exact:
                raise SimulationError(
                    f"capacity guard tripped at gen {gen} pop {pop}: real "
                    f"pass used seg={su}/{s_cap} (probe counted {seg_need}) "
                    f"mut={mu}/{m_cap}"
                )

    def _reproduce(self, p: PopRuntime, gen: int,
                   plan: mating.MatingPlan) -> PopState:
        """One population's children. A generation that keeps the parents'
        row count writes them in place, a group of chromosomes at a time,
        on any number of 'ind' ranks (`_real_pass_in_place`;
        GE_NO_INPLACE_REPRO=1 turns it off); a resize generation into fresh
        planes (`_real_pass`), as the JAX `_reproduce`. Past
        GE_PLAN_BYTES_MAX bytes of plan (or under GE_PLAN_PER_GROUP=1) the
        probe draws and counts a group at a time, keeping only the counts,
        and the real pass draws each group's plan again (the whole plan at
        once on fresh planes). Under several 'ind' ranks the probe counts
        each gamete on its parent's rank (`_owned_gametes`), so no parent
        row moves before the real pass."""
        st = p.state
        self._check_capacity_guard()
        n_child = len(plan.child_father)
        n_pad = self._child_rows(p, gen, n_child, self._rows(st))
        sw = memory.Switches.from_env()
        nchr = len(self.chrs)
        in_place = sw.in_place and n_pad == self._rows(st)
        per_group = sw.per_group(nchr, n_pad, self.xo_cap, self.mn_cap)
        g = sw.group_size(nchr)
        groups = [(c0, min(c0 + g, nchr)) for c0 in range(0, nchr, g)]

        # (2, n_pad) father's and mother's rows, padded with parent 0
        parents = np.pad(np.stack([plan.child_father, plan.child_mother]),
                         ((0, 0), (0, n_pad - n_child)))
        with telemetry.host_wait(self.timer, "parents"):
            parents = torch.as_tensor(parents, dtype=torch.int32,
                                      device=self.device)
        with self.timer("reproduce/probe"):
            draws = None if per_group else self._plan(p, gen, n_pad)
            owned = self._owned_gametes(parents, self._rows(st))
            if per_group:
                counts = []
                for c0, c1 in groups:
                    with self.timer("reproduce/probe/group"):
                        counts.append(self._probe_counts(
                            st.seg_st[c0:c1], st.mut[c0:c1], parents,
                            self._plan(p, gen, n_pad, c0, c1), owned))
            else:
                counts = [self._probe_counts(st.seg_st, st.mut, parents,
                                             draws, owned)]
            del owned
            seg_need, mut_need = self._needs(counts)
            if in_place:  # this rank's block of the plan's rows
                draws = self._own_draws(draws, n_pad)
        if seg_need > self.s_cap:
            self.s_cap = seg_need * 3 // 2 + 8
            st.seg_st = _pad_last(st.seg_st, self.s_cap, BIG)
            st.seg_hap = _pad_last(st.seg_hap, self.s_cap, 0)
            self._log(f"      [capacity grow] S={self.s_cap}")
            self._check_fits()
        if mut_need > self.m_cap:
            self.m_cap = mut_need * 3 // 2 + 8
            st.mut = _pad_last(st.mut, self.m_cap, BIG)
            self._log(f"      [capacity grow] M={self.m_cap}")
            self._check_fits()
        if not self.resident_cv:
            st.cv = None  # the gather path (a grown ledger may move a run)
        with self.timer("reproduce/real"):
            if in_place:
                planes, seg_used, mut_used = self._real_pass_in_place(
                    st, parents, draws, groups,
                    lambda c0, c1: self._own_draws(
                        self._plan(p, gen, n_pad, c0, c1), n_pad))
                # the parents' planes now hold the children
                st.seg_st = st.seg_hap = st.mut = st.cv = None
            else:
                if draws is None:
                    draws = self._plan(p, gen, n_pad)
                par, local, draws = self._fetch_parents(st, parents, draws,
                                                        n_pad)
                planes, seg_used, mut_used = self._real_pass(par, local,
                                                             draws)
                del par
            del draws
        self._pending_used.append((
            seg_used, mut_used, seg_need, mut_need, self.s_cap, self.m_cap,
            gen, p.index, in_place, per_group,
        ))
        seg_st, seg_hap, mut, cv = planes
        return PopState(
            n=n_child, seg_st=seg_st, seg_hap=seg_hap, mut=mut, cv=cv,
            rows=n_pad, **self._child_host_fields(p, gen, plan),
        )

    def _wants(self, parents, n_pad: int):
        """Under several 'ind' ranks: the parents' rows each rank wants
        (the sorted distinct parents of its block of the `n_pad` children,
        edge-padded; every rank knows every rank's), and this rank's
        children's parents as rows of its own wanted ones."""
        b = self._block(n_pad)
        full = parents[:, torch.arange(b * self._ind, device=self.device)
                       .clamp_(max=n_pad - 1)]  # edge-padded
        with telemetry.host_wait(self.timer, "wants"):
            wants = [torch.unique(full[:, r * b:(r + 1) * b])
                     for r in range(self._ind)]
        mine = full[:, self._me * b:(self._me + 1) * b].contiguous()
        return wants, torch.searchsorted(wants[self._me], mine).to(
            torch.int32)

    def _fetch(self, tables: list, wants, rows: int) -> list:
        """Rows `wants[me]` of `tables`, planes of `rows` unsharded rows
        held in blocks over 'ind', from the ranks that hold them in one
        exchange (each sends exactly the rows asked of it)."""
        with telemetry.host_wait(self.timer, "exchange"):
            return exchange_rows(tables, wants, self._block(rows),
                                 self.mesh.group("ind"), self.mesh.traffic,
                                 axis=self._row_axis)

    def _fetch_parents(self, st: PopState, parents, draws, n_pad: int):
        """This rank's part of a generation on fresh planes over several
        'ind' ranks: its block of the children's rows of the plan (drawn
        in full), and the rows of every parent they name in one exchange
        (`_fetch`). Returns (the fetched parents as a state, the children's
        parents as rows of it, the plan's block). One 'ind' rank (or no
        mesh) holds every row: the parents and the plan stay as they
        are."""
        if self._ind == 1:
            return st, parents, draws
        wants, local = self._wants(parents, n_pad)
        got = self._fetch(self._row_tables(st), wants, self._rows(st))
        return (self._from_tables(got, n=0), local,
                self._own_draws(draws, n_pad))

    def _own_draws(self, draws, n_pad: int):
        """This rank's block of the children's rows of a plan (the plan
        itself on one 'ind' rank)."""
        if self._ind == 1 or draws is None:
            return draws
        return tuple(None if x is None else self._own(x, n_pad,
                                                      self._row_axis)
                     for x in draws)

    def _row_tables(self, st: PopState) -> list:
        """The genome planes of a state whose rows a parents' fetch or a
        migration moves (rows on `_row_axis`)."""
        return [st.seg_st, st.seg_hap, st.mut] + (
            [st.cv] if st.cv is not None else [])

    def _from_tables(self, tabs: list, **fields) -> PopState:
        """A state of planes laid out as `_row_tables` gives them."""
        return PopState(seg_st=tabs[0], seg_hap=tabs[1], mut=tabs[2],
                        cv=tabs[3] if len(tabs) > 3 else None, **fields)

    def _real_pass(self, st: PopState, parents, draws):
        """Every chromosome's children, written into fresh planes
        (`reproduce`, `Simulation.cpp:2394-2493`; the JAX `_reproduce_all`
        / `_make_per_chr`): one merge launch over every chromosome. Returns
        ((seg_st, seg_hap, mut, cv), seg_used, mut_used) with the used
        counts still on the device."""
        return self._reproduce_group(st, parents, draws)

    def _real_pass_in_place(self, st: PopState, parents, draws, groups,
                            draw_group):
        """The children of a generation that keeps its parents' row count,
        written over the parents (the JAX `_reproduce_group_inplace`): for
        each group of chromosomes in order, one merge launch over the
        group's parent slab into a group-sized buffer, the group's stacked
        parent-row gathers, mutation inheritance and CV alleles, then a
        copy of the children into the group's slab of every plane. A
        chromosome's children read only that chromosome's parents, so a
        group's parent slab is dead once its children exist; every launch
        is on one stream, so the copy lands before the next group's launches
        read. Under several 'ind' ranks each group's parent rows come from
        their ranks in one exchange of the group's slabs (`_fetch`), and
        the children of this rank's block go over its block of the slab.
        Peak memory: the state once, one group's fetched rows and children.
        `draws`: the plan's rows of this rank's children, or None to draw
        each group's (`draw_group(c0, c1)`) just before it is used.
        Returns as `_real_pass`, the planes being the parents'."""
        rows = self._rows(st)
        if self._ind > 1:  # the children's parents as rows of the fetched
            wants, parents = self._wants(parents, rows)
        seg_used, mut_used = [], []
        for c0, c1 in groups:
            with self.timer("reproduce/real/group"):
                plan = (draw_group(c0, c1) if draws is None
                        else tuple(x[c0:c1] for x in draws))
                slab = [x[c0:c1] for x in self._row_tables(st)]
                par = (slab if self._ind == 1
                       else self._fetch(slab, wants, rows))
                kids, su, mu = self._reproduce_group(
                    self._from_tables(par, n=0), parents, plan, c0)
                # Other ranks never read this slab: `exchange_rows` packs
                # every row it sends into a buffer of its own
                # (`mesh._row_bytes`) on this rank's stream before the
                # all-to-all, so the copy, later on the same stream, cannot
                # reach what they receive (tests/test_torch_mesh_inplace.py:
                # byte-identical files at 2, 3 and 4 ranks).
                for dst, src in zip(slab, kids):
                    dst.copy_(src)
                del plan, par, kids  # freed before the next group's
                seg_used.append(su)
                mut_used.append(mu)
        return ((st.seg_st, st.seg_hap, st.mut, st.cv),
                torch.stack(seg_used).amax(), torch.stack(mut_used).amax())

    def _reproduce_group(self, st: PopState, parents, draws, c0: int = 0):
        """The children of the chromosomes whose parents' planes `st` holds
        (chromosomes [c0, c0 + its length) of the genome) from those planes
        and the chromosomes' plan rows `draws` ((chromosomes, nc, ...)
        each), in fresh group-sized tensors: ((seg_st, seg_hap, mut, cv),
        seg_used, mut_used), the used counts on the device. One merge
        launch over the group; the parents' CV and mutation rows in stacked
        gathers of at most `gather_chunk` chromosomes each (4 launches a
        group when it fits one gather: each parent's CV and mutation rows;
        2 on the gather path); each gather's gametes' mutation inheritance
        and CV alleles in one launch (`ops/gamete_inherit`), written into
        the children's planes."""
        xo_f, xo_m, sh, new_f, new_m = draws
        nc = parents.shape[1]
        ng = st.seg_st.shape[0]
        dev = self.device
        c_st, c_hap, nv = meiose_merge(
            st.seg_st, st.seg_hap, parents, xo_f, xo_m, sh, self.s_cap,
            self.merge_ibd)
        c_mut = torch.full((ng, nc, 2, self.m_cap), BIG, dtype=torch.int32,
                           device=dev)
        c_cv = None if st.cv is None else torch.empty(
            (ng, nc) + tuple(st.cv.shape[2:]), dtype=torch.uint8, device=dev)
        mut_used = []
        chunk = self.gather_chunk
        starts = (range(0, ng, chunk) if self.has_mut or c_cv is not None
                  else ())
        for g, k0 in itertools.product(range(2), starts):
            k1 = min(k0 + chunk, ng)
            par = parents[g]
            cv_rows = (None if c_cv is None
                       else gather_rows_stacked(st.cv[k0:k1], par))
            mut_rows = (gather_rows_stacked(st.mut[k0:k1], par)
                        if self.has_mut else None)
            nm = gamete_inherit(
                mut_rows, cv_rows, (xo_f, xo_m)[g][k0:k1], sh[k0:k1, :, g],
                (new_f, new_m)[g][k0:k1], self.cv_bp_all[c0 + k0:c0 + k1],
                c_mut[k0:k1, :, g] if self.has_mut else None,
                None if c_cv is None else c_cv[k0:k1, :, g])
            if nm is not None:
                mut_used.append(nm.amax())
            del cv_rows, mut_rows
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (
            (c_st, c_hap, c_mut, c_cv),
            nv.amax(),
            torch.stack(mut_used).max() if mut_used else zero,
        )

    def _child_host_fields(self, p: PopRuntime, gen: int,
                           plan: mating.MatingPlan) -> dict:
        """Children's sex/ids/pedigree/common-sibling effect
        (`Simulation.cpp:2416-2484`)."""
        st = p.state
        n_child = len(plan.child_father)
        rng_sex = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.SEX, p.index)
        )
        rng_c = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.COMMON, p.index)
        )
        fpos, mpos = plan.child_father, plan.child_mother
        ped = {
            "father": st.ids[fpos],
            "mother": st.ids[mpos],
            "ff": st.ped["father"][fpos],
            "fm": st.ped["mother"][fpos],
            "mf": st.ped["father"][mpos],
            "mm": st.ped["mother"][mpos],
        }
        C = np.zeros((self.n_pheno, n_child))
        for j, ph in enumerate(p.phenos):
            if ph.vc > 0:
                per_couple = rng_c.normal(0.0, np.sqrt(ph.vc),
                                          size=plan.n_couples)
                C[j] = per_couple[plan.child_couple]
        return dict(
            sex=rng_sex.integers(1, 3, size=n_child).astype(np.int8),
            ids=np.arange(n_child, dtype=np.int64),
            ped=ped,
            comp={"C": C},
            mv=np.zeros(n_child),
            sv=np.zeros(n_child),
            svf=np.ones(n_child),
        )

    # -------------------------------------------------------------- migration
    def _migrate(self, gen: int) -> None:
        """Moves between populations (`Simulation.cpp:877-989`), as the JAX
        `_migrate`: each population sends round(m_ij * n_i) of its rows to
        population j, drawn on the host from np_seed(seed, gen, MIGRATION,
        0) without replacement; each new population is its stayers followed
        by its immigrants, population by population."""
        mats = self.migration[gen - 1]
        rng_m = np.random.default_rng(
            np_seed(self.cfg.seed, gen, Stage.MIGRATION, 0)
        )
        sizes = [p.state.n for p in self.pops]
        leaving = []  # per source: (sampled rows, their destinations)
        for i in range(self.n_pop):
            counts = [0 if i == j else int(round(mats[i, j] * sizes[i]))
                      for j in range(self.n_pop)]
            sample = rng_m.choice(sizes[i], size=sum(counts), replace=False)
            others = [j for j in range(self.n_pop) if j != i]
            dests = np.repeat(others, [counts[j] for j in others])
            leaving.append((sample, dests))
        new_states = []
        for j in range(self.n_pop):
            keep = np.setdiff1d(np.arange(sizes[j]), leaving[j][0])
            parts = [(self.pops[j], keep)]
            for i, pi in enumerate(self.pops):
                idx = leaving[i][0][leaving[i][1] == j]
                if i != j and len(idx):
                    parts.append((pi, idx))
            new_states.append(self._gather_state(parts))
        for p, st in zip(self.pops, new_states):
            p.state = st
            self._log(f"      pop {p.index + 1} size after migration = "
                      f"{st.n}")

    def _gather_state(self, parts) -> PopState:
        """The selected rows of several populations' states, concatenated:
        the planes of `_migrant_tables` (the segment ledgers and mutations
        padded to the current capacities: a population that has not
        reproduced since another one grew them holds narrower planes),
        written part by part into planes allocated once, in row chunks of
        `memory.MIGRATION_CHUNK`, so that a new state is held once beside
        the old ones. Migrants keep their founder hap indices, which name
        their root population. Under a mesh each rank fetches the rows of
        its block from every source population in one exchange each."""
        if self.mesh is not None:
            return self._gather_state_mesh(parts)
        n = sum(len(idx) for _, idx in parts)
        ax, out, at = self._row_axis, None, 0
        for src, idx in parts:
            tabs = self._migrant_tables(src.state)
            if out is None:
                out = [x.new_empty(x.shape[:ax] + (n,) + x.shape[ax + 1:])
                       for x in tabs]
            with telemetry.host_wait(self.timer, "migrants"):
                idx = torch.as_tensor(idx, dtype=torch.long,
                                      device=self.device)
            for lo in range(0, len(idx), memory.MIGRATION_CHUNK):
                sub = idx[lo:lo + memory.MIGRATION_CHUNK]
                for o, x in zip(out, tabs):
                    o.narrow(ax, at + lo, len(sub)).copy_(
                        x.index_select(ax, sub))
            at += len(idx)
        return self._from_tables(out, **self._gather_host_fields(parts))

    def _gather_state_mesh(self, parts) -> PopState:
        """`_gather_state` under a mesh: the new state's block of rows on
        each rank, its rows fetched from every source population in one
        exchange each (the planes of `_row_tables`, the segment ledgers
        padded to the current capacities first)."""
        n = sum(len(idx) for _, idx in parts)
        b, me, ax = self._block(n), self._me, self._row_axis
        # (source part, row) of every row of the new state, edge-padded
        edge = np.minimum(np.arange(b * self._ind), n - 1)
        part_of = np.repeat(np.arange(len(parts)),
                            [len(idx) for _, idx in parts])[edge]
        row_of = np.concatenate([np.asarray(idx) for _, idx in parts])[edge]
        out = None
        for k, (src, _idx) in enumerate(parts):
            sst = src.state
            tabs = self._migrant_tables(sst)
            with telemetry.host_wait(self.timer, "migrants"):
                wants = [torch.as_tensor(
                    row_of[r * b:(r + 1) * b][part_of[r * b:(r + 1) * b] == k],
                    device=self.device) for r in range(self._ind)]
                got = exchange_rows(tabs, wants,
                                    self._block(self._rows(sst)),
                                    self.mesh.group("ind"), self.mesh.traffic,
                                    axis=ax)
                sel = torch.as_tensor(
                    np.flatnonzero(part_of[me * b:(me + 1) * b] == k),
                    device=self.device)
            if out is None:
                out = [x.new_empty(x.shape[:ax] + (b,) + x.shape[ax + 1:])
                       for x in got]
            for o, x in zip(out, got):
                o.index_copy_(ax, sel, x)
        return self._from_tables(out, rows=n,
                                 **self._gather_host_fields(parts))

    def _migrant_tables(self, st: PopState) -> list:
        """The planes a migration moves: the ledgers, padded to the
        current capacities (several populations take the gather path, so
        no CV matrix)."""
        return [_pad_last(x, c, v) for x, c, v in zip(
            (st.seg_st, st.seg_hap, st.mut), (self.s_cap, self.s_cap,
                                              self.m_cap), (BIG, 0, BIG))]

    def _gather_host_fields(self, parts) -> dict:
        """The host fields of the selected rows, concatenated (shared by
        both genome backends' migration)."""
        def cat(get):
            return np.concatenate(
                [get(src.state)[..., idx] for src, idx in parts], axis=-1)

        first = parts[0][0].state
        return dict(
            n=sum(len(idx) for _, idx in parts),
            sex=cat(lambda s: s.sex),
            ids=cat(lambda s: s.ids),
            ped={k: cat(lambda s, k=k: s.ped[k]) for k in first.ped},
            comp={k: cat(lambda s, k=k: s.comp[k]) for k in first.comp},
            mv=cat(lambda s: s.mv),
            sv=cat(lambda s: s.sv),
            svf=cat(lambda s: s.svf),
        )

    # ------------------------------------------------------------ checkpoint
    def _ckpt_genome_arrays(self, st: PopState) -> dict:
        """The genome arrays a checkpoint keeps, under the JAX package's
        keys and dtypes. Unlike the JAX package, the port keeps the planes'
        padding rows: torch's generators draw a plan's rows in sequence, so
        the coming draws depend on the row count, and a resumed run
        continues bit-identically only from planes of the same rows. Under
        a mesh the rows are gathered over 'ind' (a collective), so the
        arrays do not depend on the layout."""
        rows = self._rows(st)
        keys = ("seg_st", "seg_hap", "mut") + (("cv",) if st.cv is not None
                                                else ())
        return {k: self._gather_ind(getattr(st, k), rows, axis=1)
                .cpu().numpy() for k in keys}

    def _ckpt_make_state(self, z, pre: str, host: dict) -> PopState:
        """A population's state from checkpoint arrays and its host fields;
        the resident CV matrix is rebuilt from the ledger when the
        checkpoint has none (a gather-path run's)."""
        rows = z[f"{pre}.seg_st"].shape[1]
        seg_st, seg_hap, mut = (self._own_host(z[f"{pre}.{k}"], rows)
                                for k in ("seg_st", "seg_hap", "mut"))
        cv = None
        if self.resident_cv:
            if f"{pre}.cv" in z.files:
                cv = self._own_host(z[f"{pre}.cv"], rows)
            else:
                cv = paint(seg_st, seg_hap, mut,
                           torch.as_tensor(np.concatenate(self.founder_cv, 2),
                                           device=self.device),
                           self.cv_bp_all)
        return PopState(seg_st=seg_st, seg_hap=seg_hap, mut=mut, cv=cv,
                        rows=rows, **host)

    # ------------------------------------------------------------- recording
    def _record_traj(self, p: PopRuntime, gen: int) -> None:
        st = p.state
        for j in range(self.n_pheno):
            for k in ("A", "D", "G", "C", "E", "F", "P"):
                p.traj[f"var_{k}"][j, gen] = phenotype.var(st.comp[k][j])
            vP = p.traj["var_P"][j, gen]
            p.traj["h2"][j, gen] = (
                p.traj["var_A"][j, gen] / vP if vP != 0 else np.nan
            )
        p.traj["var_mv"][gen] = phenotype.var(st.mv)
        p.traj["var_sv"][gen] = phenotype.var(st.sv)

    def show_results(self) -> None:
        """End-of-run variance-component table (`ras_show_res`,
        `Simulation.cpp:704-780`)."""
        for p in self.pops:
            self._log(f" ---------- Population {p.index + 1}")
            m = min(p.traj["var_A"].shape[1], 40)
            for j in range(self.n_pheno):
                self._log(f" phenotype: {j + 1}")
                rows = [
                    ("   var_A:", p.traj["var_A"][j, :m]),
                    ("   var_D:", p.traj["var_D"][j, :m]),
                    ("   var_G:", p.traj["var_G"][j, :m]),
                    ("   var_C:", p.traj["var_C"][j]),  # full (`:735`)
                    ("   var_E:", p.traj["var_E"][j, :m]),
                    ("   var_F:", p.traj["var_F"][j, :m]),
                    ("   var_P:", p.traj["var_P"][j, :m]),
                    ("   h2   :", p.traj["h2"][j, :m]),
                ]
                for label, vals in rows:
                    self._log(label + "".join(f" {v:.3f}" for v in vals))
            self._log(" var_mating_value   :"
                      + "".join(f" {v:.3f}" for v in p.traj["var_mv"][:m]))
            self._log(" var_selection_value:"
                      + "".join(f" {v:.3f}" for v in p.traj["var_sv"][:m]))

    def _drain_io(self) -> None:
        """Wait for queued info-file writes; re-raise any writer error."""
        futures, self._io_futures = self._io_futures, []
        for f in futures:
            f.result()

    def _save_info(self, p: PopRuntime, gen: int) -> None:
        """Queue the per-individual info file on the background writer, so
        its text formatting overlaps the next generation's device work
        (rank 0 of a mesh writes it). The writer gets the state's host
        fields alone: a queued write must not keep the genome planes alive
        into the next generation, whose real pass on fresh planes would
        then hold them beside the children."""
        if not self.is_root:
            return
        done = [f for f in self._io_futures if f.done()]
        self._io_futures = [f for f in self._io_futures if not f.done()]
        for f in done:
            f.result()
        host = SimpleNamespace(**{k: getattr(p.state, k)
                                  for k in INFO_FIELDS})
        self._io_futures.append(
            self._io_pool.submit(self._save_info_sync, p, host, gen)
        )

    def _save_info_sync(self, p: PopRuntime, st: PopState, gen: int) -> None:
        """Schema per `Population::ras_save_human_info`
        (`Population.cpp:510-568`)."""
        from geneevolve_tpu_torch import native

        path = f"{self.cfg.prefix}.info.pop{p.index + 1}.gen{gen}.txt"
        cols = ["ID", "ID_Father", "ID_Mother", "ID_Fathers_Father",
                "ID_Fathers_Mother", "ID_Mothers_Father", "ID_Mothers_Mother",
                "sex"]
        for j in range(self.n_pheno):
            cols += [f"ph{j + 1}_{k}" for k in ("A", "D", "G", "C", "E", "F",
                                                "P")]
        cols += ["MV", "SV", "SV_f"]
        id_cols = [
            st.ids + 1, st.ped["father"] + 1, st.ped["mother"] + 1,
            st.ped["ff"] + 1, st.ped["fm"] + 1, st.ped["mf"] + 1,
            st.ped["mm"] + 1, st.sex,
        ]
        val_cols = [st.comp[k][j] for j in range(self.n_pheno)
                    for k in ("A", "D", "G", "C", "E", "F", "P")]
        val_cols += [st.mv, st.sv, st.svf]
        ids_arr = np.stack(id_cols, axis=1).astype(np.int64)
        vals_arr = np.stack(val_cols, axis=1).astype(np.float64)
        body = native.format_info(ids_arr, vals_arr)
        with open(path, "wb") as f:
            f.write((" ".join(cols) + "\n").encode())
            if body is not None:
                f.write(body)
            else:  # no C toolchain: Python row loop, same text
                for i in range(st.n):
                    f.write((
                        " ".join(str(x) for x in ids_arr[i]) + " "
                        + " ".join(f"{x:g}" for x in vals_arr[i]) + "\n"
                    ).encode())

    def write_summary(self) -> None:
        """`<prefix>.pop<i>.summary` (`Simulation.cpp:782-834`); rank 0 of
        a mesh writes it."""
        self._drain_io()
        if not self.is_root:
            return
        for p in self.pops:
            path = f"{self.cfg.prefix}.pop{p.index + 1}.summary"
            with open(path, "w") as f:
                cols = ["gen"]
                for j in range(self.n_pheno):
                    cols += [
                        f"ph{j + 1}_{k}"
                        for k in ("var_A", "var_D", "var_G", "var_C", "var_E",
                                  "var_F", "var_P", "h2", "var_G_std")
                    ]
                cols += ["var_mating_value", "var_selection_value"]
                f.write(" ".join(cols) + "\n")
                for gen in range(self.tot_gen + 1):
                    row = [str(gen)]
                    for j in range(self.n_pheno):
                        for k in ("var_A", "var_D", "var_G", "var_C", "var_E",
                                  "var_F", "var_P", "h2"):
                            row.append(f"{p.traj[k][j, gen]:g}")
                        g0 = p.traj["var_G"][j, 0]
                        gstd = (p.traj["var_G"][j, gen] / g0 if g0
                                else float("nan"))
                        row.append(f"{gstd:g}")
                    row.append(f"{p.traj['var_mv'][gen]:g}")
                    row.append(f"{p.traj['var_sv'][gen]:g}")
                    f.write(" ".join(row) + "\n")

    # --------------------------------------------------------------- outputs
    def save_genotypes(self, gen: int) -> None:
        output.save_genotypes(self, gen)

    # ------------------------------------------------------------------- run
    def run(self) -> None:
        """Generation 0 (or a checkpoint's state), the generations, the
        summary and the last generation's genotype files; closes the
        `--profile` trace that `__init__` opened."""
        with self._trace:
            cfg = self.cfg
            start_gen = 1
            ckpt = f"{cfg.prefix}.ckpt.npz"
            if cfg.resume:
                # `_load` built the maps and effect tables; the checkpoint
                # restores the state and every constant frozen at
                # generation 0
                with self.timer("resume"):
                    done = checkpoint.load(self, cfg.resume)
                    self._check_fits()  # at the checkpoint's capacities
                start_gen = done + 1
                self._log(f"    Resumed from {cfg.resume} after generation "
                          f"{done}")
            else:
                with self.timer("generation0"):
                    self.init_generation0()
                if cfg.checkpoint_every:
                    with self.timer("checkpoint"):
                        checkpoint.save(self, 0, ckpt)
            for gen in range(start_gen, self.tot_gen + 1):
                self._log(f"    Start generation {gen}")
                self.step(gen)
                if cfg.checkpoint_every and gen % cfg.checkpoint_every == 0:
                    with self.timer("checkpoint"):
                        checkpoint.save(self, gen, ckpt)
            with self.timer("summary"):
                self._check_capacity_guard()  # the last generation's
                self.timer.report(self._log)
                self.show_results()
                self.write_summary()
            if not self.out_gens and (cfg.out_hap or cfg.out_plink
                                      or cfg.out_plink01 or cfg.out_vcf
                                      or cfg.out_interval):
                with self.timer("genotype_output"):
                    self.save_genotypes(self.tot_gen)  # the last generation's
            self._io_pool.shutdown(wait=True)
