"""The comparison that decides `correct`.

After the window, the harness runs the window's last call again, the same
arguments and seed through the same entry, with hooks around every
generation's step. Before the step they copy each population's host fields
(the parents), and before generation 1 and the last also its planes: the
segment ledger's into host memory. After the step the plain reference
(`gebench/reference`) works the generation out again, a population and a
chromosome at a time, and the program's children are compared with it; the
device holds one chromosome of one population's parents and of the
reference's children at once, beside the program's own state:

- generation 0 whole, against the reference's own founders;
- generations 1 and the last from the parents' planes: mating, the
  meiosis, each child's ledger, mutations and CV alleles, A/D, phenotypes,
  gamma and migration, and the probe's ledger and mutation slots;
- every other generation from the parents' host fields and the program's
  own children's ledgers (no meiosis): mating, pedigree, CV alleles, A/D
  from those ledgers, phenotypes, gamma and migration, and the probe's
  ledger slots against the most the children hold.

On the dense backend (`--backend dense`, one population) the genome is the
packed panel (`gebench/reference/dense.py`): generation 0's planes against
the founder panel, generations 1 and the last's children planes against the
reference's (`plane_mismatch`, the SNPs only, padding left out), every
generation's resident CV alleles against the program's own planes at the CV
columns (`cv_mismatch`), and A/D from the reference's children at 1 and the
last, from the program's planes otherwise. The numbers of the ledger and
the probe (`probe_gap`, `ledger_mismatch`, `mutation_mismatch`) have no
meaning there and are not printed; `plane_mismatch` is printed only there.
Its parents' packed planes are copied on the device, where its reference
reads them a block of children at a time.

Every generation's `.info` file is read against the reference's fields
(numpy's C loader, a file at a time), and the call's
`.info` and `.summary` files must equal the timed call's byte for byte
(its digests were taken when the window closed), so the judgement holds
for what the window produced.

Every number compared has its limit in `LIMITS`; `numbers()` gives them
in print order."""

from __future__ import annotations

import hashlib
import time
import warnings
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gebench.reference import dense, inputs, sim
from gebench.reference.law import BIG

# limits, each set from readings of sound runs and of the control
# (PERF.md, "How correct is decided")
LIMITS = {
    "files_differ": 0,
    "pedigree_mismatch": 0,
    "probe_gap": 0,
    "ledger_mismatch": 0,
    "mutation_mismatch": 0,
    "plane_mismatch": 0,
    "cv_mismatch": 0,
    "pheno_gap": 3e-4,
    "info_gap": 1e-3,
}
KEYS = ("A", "D", "G", "C", "E", "F", "P")
PLANES = ("seg_st", "seg_hap", "mut")  # the segment ledger's planes
# the numbers that only one genome backend has
SEGMENT_ONLY = ("probe_gap", "ledger_mismatch", "mutation_mismatch")
DENSE_ONLY = ("plane_mismatch",)


def digests(prefix: Path) -> Dict[str, str]:
    """sha256 of every `.info` and `.summary` file a run wrote."""
    out = {}
    for f in sorted(prefix.parent.glob(prefix.name + ".*")):
        if f.name.endswith(".summary") or ".info." in f.name:
            out[f.name] = hashlib.sha256(f.read_bytes()).hexdigest()
    return out


def _read_info(path: Path):
    """(int columns (n, 8), float columns (n, k)) of an `.info` file, or
    (None, None) when it is missing or malformed."""
    try:
        with open(path, "rb") as f:
            ncol = len(f.readline().split())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # no rows
            a = np.loadtxt(path, dtype=np.float64, skiprows=1, ndmin=2)
    except (OSError, ValueError):
        return None, None
    if ncol < 9:
        return None, None
    if a.size == 0:
        a = a.reshape(0, ncol)
    if a.shape[1] != ncol:
        return None, None
    return a[:, :8].astype(np.int64), a[:, 8:].astype(np.float64)


def _rms_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if want.size == 0:
        return 0.0
    scale = float(np.sqrt(np.mean(want * want)))
    gap = float(np.max(np.abs(got - want)))
    if not np.isfinite(gap):  # a NaN on either side
        return float("inf")
    return gap / scale if scale > 0 else gap


def _snapshot(program, planes: bool, packed: bool = False) -> list:
    """Each population's state as the reference takes it: host fields
    copied, and with `planes` the planes copied: the segment ledger's into
    host memory, a chromosome at a time and cut after the last slot that
    any of its rows fills (`_live`), the dense backend's packed planes on
    the device."""
    out = []
    for p in program.pops:
        st = p.state
        rows = (st.rows or st.hap.shape[0]) if packed else st.seg_st.shape[1]
        out.append(dict(
            n=st.n, rows=rows, sex=st.sex.copy(),
            ids=st.ids.copy(), ped={k: v.copy() for k, v in st.ped.items()},
            comp={k: v[0].copy() for k, v in st.comp.items()},
            mv=st.mv.copy(), sv=st.sv.copy(), svf=st.svf.copy()))
        if planes and packed:
            out[-1].update(hap=st.hap.clone())
        elif planes:
            for c in range(st.seg_st.shape[0]):
                w, m = _live(st.seg_st[c]), _live(st.mut[c])
                for k, x in (("seg_st", st.seg_st[c, ..., :w]),
                             ("seg_hap", st.seg_hap[c, ..., :w]),
                             ("mut", st.mut[c, ..., :m])):
                    out[-1].setdefault(k, []).append(
                        x.to("cpu", copy=True))
    return out


def _live(plane) -> int:
    """The slots of a chromosome's ledger starts or mutations (rows, 2,
    width) up to the last that any row fills; at least one."""
    at = torch.arange(1, plane.shape[-1] + 1, device=plane.device)
    return max(1, int(torch.where(plane < BIG, at, 0).amax()))


def _chromosome(snap: dict, c: int, device) -> dict:
    """Chromosome c of a population's snapshotted ledger (a plane a
    chromosome), on the device."""
    return {k: snap[k][c].to(device) for k in PLANES}


def _held(pops) -> tuple:
    """(the most ledger slots, the most mutations) a chromatid holds in
    every row of the populations' planes, a chromosome at a time."""
    slots = muts = 0
    for p in pops:
        for c in range(p.state.seg_st.shape[0]):
            slots = max(slots, int((p.state.seg_st[c] < BIG).sum(-1).max()))
            muts = max(muts, int((p.state.mut[c] < BIG).sum(-1).max()))
    return slots, muts


def _genome(st: dict, c: int) -> tuple:
    """Chromosome c of a program state's children (`_state`) as the
    reference reads a genome's block: (pos, hap, mut), views of its
    planes."""
    n = st["n"]
    return tuple(st[k][c, :n] for k in PLANES)


def _rows(block: tuple, idx: np.ndarray) -> tuple:
    """The rows `idx` of a block (the block itself where they are all of
    its rows in order)."""
    if len(idx) == block[0].shape[0] and np.array_equal(
            idx, np.arange(len(idx))):
        return block
    rows = torch.as_tensor(idx, device=block[0].device)
    return tuple(x[rows] for x in block)


class Judge:
    """Holds the readings of one checked call."""

    packed = False  # the run's genome is the dense backend's packed planes

    def __init__(self, argv: List[str], seed: int, device, last_gen: int):
        sc = inputs.read(argv, seed)
        self.packed = sc.backend == "dense"
        self.ref = (dense.Reference if self.packed else sim.Reference)(
            sc, device)
        self.full = {1, last_gen}
        self.last = last_gen
        self.n = {k: 0 for k in LIMITS}
        self.n["pheno_gap"] = self.n["info_gap"] = 0.0
        self.want: Dict[tuple, dict] = {}  # (gen, pop) -> reference state
        self.probes: Dict[int, list] = {}  # the reference's slots
        self.held: Dict[int, tuple] = {}  # the children's, before migration
        self.resident = True
        self._snap = None
        self.seen = set()
        # seconds of the check's own work in the checked call and after it
        self.seconds = dict(snapshots=0.0, reference=0.0, files=0.0)

    # ------------------------------------------------------------ hooks
    def before(self, program, gen: int) -> None:
        t = time.perf_counter()
        self._snap = _snapshot(program, gen in self.full, self.packed)
        self.seconds["snapshots"] += time.perf_counter() - t
        if gen == 1:
            t = time.perf_counter()
            genomes, states = self.ref.generation0()  # fixes generation 0
            got = [_state(p.state) for p in program.pops]
            if self.packed:
                self._compare_packed(got, genomes, states, 0)
            else:
                for k, want in enumerate(states):
                    if self._host(got[k], want, 0, k):
                        for c, block in enumerate(genomes[k]):
                            self._compare_rows(got[k], c, 0, want["n"],
                                               block)
            self.seconds["reference"] += time.perf_counter() - t

    def migrating(self, program, gen: int) -> None:
        if not self.packed:
            t = time.perf_counter()
            self.held[gen] = _held(program.pops)
            self.seconds["reference"] += time.perf_counter() - t

    def after(self, program, gen: int) -> None:
        t = time.perf_counter()
        snap, self._snap = self._snap, None
        self.seen.add(gen)
        got = [_state(p.state) for p in program.pops]
        if self.packed:
            self._after_packed(got, snap, gen)
        else:
            self.held.setdefault(gen, _held(program.pops))
            self._generation(got, snap, gen)
        del snap
        self.seconds["reference"] += time.perf_counter() - t

    def _generation(self, got, snap, gen: int) -> None:
        """Generation `gen` on the segment ledger, a population and a
        chromosome at a time. At 1 and the last the reference's children,
        made from the parents' planes, are compared where migration put
        them in the program's planes, and give the A/D. Otherwise the
        program's own children, gathered back to where they were born, give
        the A/D, and its resident CV alleles are read against its ledgers.
        Then the host fields."""
        ref, full = self.ref, gen in self.full
        plans, sizes, moves = ref.prepare(gen, snap)
        ok = [st["n"] == n for st, n in zip(got, ref.rows_moved(moves))]
        ads, probes = [], []
        for k, n in enumerate(sizes):
            if full:
                probes.append([0, 0])
                blocks = self._born(got, ok, snap, plans, moves, gen, k,
                                    probes[-1])
            elif all(ok):
                blocks = (ref.unmigrate([_genome(st, c) for st in got],
                                        moves, k, n)
                          for c in range(len(ref.sc.chrs)))
            else:  # the program's children are not this generation's
                ads.append((np.full(n, np.nan), np.full(n, np.nan)))
                continue
            ads.append(ref.ad(blocks, n))
        if full:
            self.probes[gen] = [tuple(x) for x in probes]
        else:
            for j, st in enumerate(got):
                if ok[j]:
                    for c in range(len(ref.sc.chrs)):
                        self._cv(st, c, 0, st["n"], _genome(st, c))
        for j, want in enumerate(ref.finish(gen, snap, plans, moves, ads)):
            self._host(got[j], want, gen, j)

    def _born(self, got, ok, snap, plans, moves, gen: int, k: int, probe):
        """Population k's children, a chromosome's block at a time, made by
        the reference from the parents' planes; each compared, before it is
        handed on, with the program's rows that migration gave it, in the
        populations that hold the reference's number of rows. `probe`
        gathers the most ledger and mutation slots."""
        ref = self.ref
        n_pad = ref.n_pad(gen, k, snap[k], plans[k])
        for c in range(len(ref.sc.chrs)):
            block, muts = ref.born(_chromosome(snap[k], c, ref.device),
                                   plans[k], gen, k, c, n_pad)
            probe[0] = max(probe[0], sim.probe_need(block))
            probe[1] = max(probe[1], muts)
            for j, parts in enumerate(moves):
                lo = 0
                for i, idx in parts:
                    if ok[j] and i == k and len(idx):
                        self._compare_rows(got[j], c, lo, lo + len(idx),
                                           _rows(block, idx))
                    lo += len(idx)
            yield block

    # -------------------------------------------------------- comparison
    def _bump(self, key: str, v) -> None:
        if isinstance(self.n[key], float):
            self.n[key] = max(self.n[key], float(v))
        else:
            self.n[key] += int(v)

    def _host(self, st: dict, want: dict, gen: int, k: int) -> bool:
        """The host fields of population k's state `st` against the
        reference's `want`; whether both hold as many rows."""
        self.want[(gen, k)] = want
        n = want["n"]
        self._bump("pedigree_mismatch", abs(st["n"] - n))
        m = min(n, st["n"])
        bad = np.zeros(m, dtype=bool)
        bad |= st["sex"][:m] != want["sex"][:m]
        bad |= st["ids"][:m] != want["ids"][:m]
        for key, v in want["ped"].items():
            bad |= st["ped"][key][:m] != v[:m]
        self._bump("pedigree_mismatch", bad.sum())
        for key in KEYS:
            self._bump("pheno_gap", _rms_gap(st["comp"][key][:m],
                                             want["comp"][key][:m]))
        for key in ("mv", "sv", "svf"):
            self._bump("pheno_gap", _rms_gap(st[key][:m], want[key][:m]))
        return st["n"] == n

    def _compare_rows(self, st: dict, c: int, lo: int, hi: int,
                      block: tuple) -> None:
        """Rows [lo, hi) of chromosome c of the program's state `st`
        against the reference's block of those children: ledgers, mutations
        and resident CV alleles."""
        pos, hap, mut = block
        self._bump("ledger_mismatch", _ledgers_differ(
            st["seg_st"][c, lo:hi], st["seg_hap"][c, lo:hi], pos, hap))
        self._bump("mutation_mismatch", _muts_differ(st["mut"][c, lo:hi],
                                                     mut))
        self._cv(st, c, lo, hi, block)

    def _cv(self, st: dict, c: int, lo: int, hi: int, block: tuple) -> None:
        """The program's resident CV alleles of rows [lo, hi) of chromosome
        c against a block's; none where the program holds none."""
        if st["cv"] is None:
            self.resident = False
            return
        want = self.ref.alleles(block, c)
        got = st["cv"][c, lo:hi, :, :want.shape[-1]]
        self._bump("cv_mismatch", int((got != want).sum()))

    def _after_packed(self, got, snap, gen: int) -> None:
        """Generation `gen` on the dense backend: the reference's children
        from the parents' planes at 1 and the last, else A/D from the
        program's own planes."""
        if gen in self.full:
            genomes, states, _ = self.ref.generation(gen, snap)
        else:
            genomes = [self.ref.program_alleles(st["hap"], st["n"])
                       for st in got]
            _, states, _ = self.ref.generation(gen, snap, genomes)
        del snap
        self._compare_packed(got, genomes, states, gen)

    def _compare_packed(self, got, genomes, states, gen: int) -> None:
        """The dense backend's states `got` against the reference's: the
        host fields; generation 0's planes against the founder panel, the
        children's against the reference's `Children` where it made them;
        the resident CV alleles against the program's planes."""
        for k, want in enumerate(states):
            st = got[k]
            if not self._host(st, want, gen, k):
                continue
            n, hap = want["n"], st["hap"]
            if gen == 0:
                self._bump("plane_mismatch", self.ref.panel_differs(hap, n))
            elif isinstance(genomes[k], dense.Children):
                self._bump("plane_mismatch",
                           self.ref.children_differ(genomes[k], hap))
            planes = torch.cat(self.ref.program_alleles(hap, n), -1)
            self._bump("cv_mismatch", int((st["cv"][0][:n] != planes).sum()))

    def finish(self, program, prefix: Path, timed: Dict[str, str],
               checked: Dict[str, str]) -> None:
        """The numbers read after the run: the probe's counts against the
        children, every `.info` file against the reference, and the files
        against the timed call's."""
        t = time.perf_counter()
        self.n["files_differ"] = (
            len(set(timed) ^ set(checked))
            + sum(timed[f] != checked[f] for f in set(timed) & set(checked)))
        if not timed:
            self.n["files_differ"] += 1
        for gen in set(range(1, self.last + 1)) - self.seen:  # never stepped
            self._bump("pedigree_mismatch", 1)
        if not self.packed:
            self._probe_gaps(program)
        paths = [prefix.parent / f"{prefix.name}.info.pop{k + 1}.gen{gen}.txt"
                 for gen, k in self.want]
        for want, (ids, vals) in zip(self.want.values(),
                                     map(_read_info, paths)):
            if ids is None or len(ids) != want["n"]:
                self._bump("pedigree_mismatch", want["n"])
                continue
            cols = [want["ids"] + 1] + [want["ped"][x] + 1 for x in (
                "father", "mother", "ff", "fm", "mf", "mm")] + [want["sex"]]
            self._bump("pedigree_mismatch",
                       (ids != np.stack(cols, 1)).any(1).sum())
            wv = [want["comp"][x] for x in KEYS] + [
                want["mv"], want["sv"], want["svf"]]
            for j, w in enumerate(wv):
                self._bump("info_gap", _rms_gap(vals[:, j], w))
        self.seconds["files"] += time.perf_counter() - t

    def _probe_gaps(self, program) -> None:
        """The probe's counts of every generation against the children's
        rows, and at 1 and the last against the reference's."""
        log = {}
        for e in getattr(program, "capacity_log", []):
            g = log.setdefault(e["gen"], [0, 0])
            g[0], g[1] = max(g[0], e["seg_need"]), max(g[1], e["mut_need"])
        for gen in range(1, self.last + 1):
            if gen not in log or gen not in self.held:
                self._bump("probe_gap", 1)
                continue
            (need_s, need_m), (held_s, held_m) = log[gen], self.held[gen]
            # the probe counts exactly the slots the children's rows hold
            gap = abs(need_s - held_s)
            if gen in self.probes:
                # at least the reference's canonical ledgers' slots, and
                # exactly its count of the parents' and new mutations
                ref_s = max(x[0] for x in self.probes[gen])
                ref_m = max(x[1] for x in self.probes[gen])
                gap += max(0, ref_s - need_s) + abs(need_m - ref_m)
            else:
                gap += max(0, held_m - need_m)
            self._bump("probe_gap", gap)

    def numbers(self) -> Dict[str, float]:
        """Each number compared, in print order (`cv_mismatch` only where
        the program holds resident CV alleles, and each backend's own
        numbers only on it); a number that is not finite reads 1e300."""
        drop = SEGMENT_ONLY if self.packed else DENSE_ONLY
        out = {k: (v if np.isfinite(v) else 1e300) for k, v in self.n.items()
               if k not in drop}
        if not self.resident:
            out.pop("cv_mismatch")
        return out


def _state(st) -> dict:
    """A program state's fields as the comparison reads them (the planes
    are read in place, on the device): the segment ledger's planes, or the
    dense backend's packed planes `hap`."""
    planes = (dict(hap=st.hap) if hasattr(st, "hap") else
              dict(seg_st=st.seg_st, seg_hap=st.seg_hap, mut=st.mut))
    return dict(n=st.n, cv=st.cv, sex=st.sex, ids=st.ids, ped=st.ped,
                comp={k: v[0] for k, v in st.comp.items()},
                mv=st.mv, sv=st.sv, svf=st.svf, **planes)


def _ledgers_differ(st, hap, pos, want_hap) -> int:
    """Chromatids whose ledger, as a function of position, differs."""
    n = st.shape[0]
    bad = 0
    for lo in range(0, n, sim.CHUNK):
        hi = min(lo + sim.CHUNK, n)
        gp, gh = sim.canonical(st[lo:hi].reshape(-1, st.shape[-1]),
                               hap[lo:hi].reshape(-1, hap.shape[-1]))
        wp = pos[lo:hi].reshape(-1, pos.shape[-1])
        wh = want_hap[lo:hi].reshape(-1, want_hap.shape[-1])
        w = max(gp.shape[1], wp.shape[1])
        gp, wp = (torch.nn.functional.pad(x, (0, w - x.shape[1]), value=BIG)
                  for x in (gp, wp))
        gh, wh = (torch.nn.functional.pad(x, (0, w - x.shape[1]), value=-1)
                  for x in (gh, wh.long()))
        bad += int(((gp != wp) | (gh != wh)).any(1).sum())
    return bad


def _muts_differ(got, want) -> int:
    """Chromatids whose set of mutations differs."""
    g = torch.sort(got.reshape(-1, got.shape[-1]), 1).values
    w = torch.sort(want.reshape(-1, want.shape[-1]), 1).values
    width = max(int((g < BIG).sum(1).max()), int((w < BIG).sum(1).max()), 1)
    g, w = (torch.nn.functional.pad(x, (0, max(0, width - x.shape[1])),
                                    value=BIG)[:, :width] for x in (g, w))
    return int((g != w).any(1).sum())
