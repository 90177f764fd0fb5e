"""The comparison that decides `correct`.

After the window, the harness runs the window's last call again, the same
arguments and seed through the same entry, with hooks around every
generation's step. Before the step they copy each population's host fields
(the parents), and before generation 1 and the last also its planes on the
device. After the step the plain reference (`gebench/reference`) works the
generation out again and the program's children are compared with it:

- generation 0 whole, against the reference's own founders;
- generations 1 and the last from the parents' planes: mating, the
  meiosis, each child's ledger, mutations and CV alleles, A/D, phenotypes,
  gamma and migration, and the probe's ledger and mutation slots;
- every other generation from the parents' host fields and the program's
  own children's ledgers (no meiosis): mating, pedigree, CV alleles, A/D
  from those ledgers, phenotypes, gamma and migration, and the probe's
  ledger slots against the most the children hold.

Every generation's `.info` file is read against the reference's fields,
and the call's `.info` and `.summary` files must equal the timed call's
byte for byte (its digests were taken when the window closed), so the
judgement holds for what the window produced.

Every number compared has its limit in `LIMITS`; `numbers()` gives them
in print order."""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from gebench.reference import inputs, sim
from gebench.reference.law import BIG

# limits, each set from readings of sound runs and of the control
# (PERF.md, "How correct is decided")
LIMITS = {
    "files_differ": 0,
    "pedigree_mismatch": 0,
    "probe_gap": 0,
    "ledger_mismatch": 0,
    "mutation_mismatch": 0,
    "cv_mismatch": 0,
    "pheno_gap": 3e-4,
    "info_gap": 1e-3,
}
KEYS = ("A", "D", "G", "C", "E", "F", "P")


def digests(prefix: Path) -> Dict[str, str]:
    """sha256 of every `.info` and `.summary` file a run wrote."""
    out = {}
    for f in sorted(prefix.parent.glob(prefix.name + ".*")):
        if f.name.endswith(".summary") or ".info." in f.name:
            out[f.name] = hashlib.sha256(f.read_bytes()).hexdigest()
    return out


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


def _snapshot(program, planes: bool) -> list:
    """Each population's state as the reference takes it: host fields
    copied, and with `planes` the planes copied on the device."""
    out = []
    for p in program.pops:
        st = p.state
        out.append(dict(
            n=st.n, rows=st.seg_st.shape[1], sex=st.sex.copy(),
            ids=st.ids.copy(), ped={k: v.copy() for k, v in st.ped.items()},
            comp={k: v[0].copy() for k, v in st.comp.items()},
            mv=st.mv.copy(), sv=st.sv.copy(), svf=st.svf.copy()))
        if planes:
            out[-1].update(seg_st=st.seg_st.clone(),
                           seg_hap=st.seg_hap.clone(), mut=st.mut.clone(),
                           cv=None if st.cv is None else st.cv.clone())
    return out


def _held(pops) -> tuple:
    """(the most ledger slots, the most mutations) a chromatid holds in
    every row of the populations' planes, a chromosome at a time."""
    slots = muts = 0
    for p in pops:
        for c in range(p.state.seg_st.shape[0]):
            slots = max(slots, int((p.state.seg_st[c] < BIG).sum(-1).max()))
            muts = max(muts, int((p.state.mut[c] < BIG).sum(-1).max()))
    return slots, muts


def _genome(st) -> list:
    """A program state's children as the reference reads a genome:
    [(pos, hap, mut)] a chromosome, views of its planes."""
    return [(st.seg_st[c, :st.n], st.seg_hap[c, :st.n], st.mut[c, :st.n])
            for c in range(st.seg_st.shape[0])]


class Judge:
    """Holds the readings of one checked call."""

    def __init__(self, argv: List[str], seed: int, device, last_gen: int):
        self.ref = sim.Reference(inputs.read(argv, seed), device)
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

    # ------------------------------------------------------------ hooks
    def before(self, program, gen: int) -> None:
        self._snap = _snapshot(program, gen in self.full)
        if gen == 1:
            genomes, states = self.ref.generation0()  # fixes generation 0
            self._compare(self._snap, genomes, states, 0)

    def migrating(self, program, gen: int) -> None:
        self.held[gen] = _held(program.pops)

    def after(self, program, gen: int) -> None:
        snap, self._snap = self._snap, None
        self.seen.add(gen)
        self.held.setdefault(gen, _held(program.pops))
        got = [_state(p.state) for p in program.pops]
        if gen in self.full:
            genomes, states, self.probes[gen] = self.ref.generation(gen,
                                                                    snap)
            self._compare(got, genomes, states, gen)
        else:
            genomes = [_genome(p.state) for p in program.pops]
            _, states, _ = self.ref.generation(gen, snap, genomes)
            self._compare(got, genomes, states, gen, ledgers=False)
        del snap

    # -------------------------------------------------------- comparison
    def _bump(self, key: str, v) -> None:
        if isinstance(self.n[key], float):
            self.n[key] = max(self.n[key], float(v))
        else:
            self.n[key] += int(v)

    def _compare(self, got, genomes, states, gen: int,
                 ledgers: bool = True) -> None:
        """The program's states `got` against the reference's `states` and
        `genomes`; without `ledgers` the genomes are the program's own, and
        only the CV alleles are compared with them."""
        for k, want in enumerate(states):
            st = got[k]
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
            if st["n"] != n:
                continue
            for c, (pos, hap, mut) in enumerate(genomes[k]):
                if ledgers:
                    got_c = [x[c, :n] for x in (st["seg_st"], st["seg_hap"],
                                                st["mut"])]
                    self._bump("ledger_mismatch", _ledgers_differ(
                        got_c[0], got_c[1], pos, hap))
                    self._bump("mutation_mismatch",
                               _muts_differ(got_c[2], mut))
                if st["cv"] is None:
                    self.resident = False
                    continue
                want_cv = self.ref.alleles(genomes[k], c)
                got_cv = st["cv"][c, :n, :, :want_cv.shape[-1]]
                self._bump("cv_mismatch", int((got_cv != want_cv).sum()))

    def finish(self, program, prefix: Path, timed: Dict[str, str],
               checked: Dict[str, str]) -> None:
        """The numbers read after the run: the probe's counts against the
        children, every `.info` file against the reference, and the files
        against the timed call's."""
        self.n["files_differ"] = (
            len(set(timed) ^ set(checked))
            + sum(timed[f] != checked[f] for f in set(timed) & set(checked)))
        if not timed:
            self.n["files_differ"] += 1
        for gen in set(range(1, self.last + 1)) - self.seen:  # never stepped
            self._bump("pedigree_mismatch", 1)
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
        for (gen, k), want in self.want.items():
            path = prefix.parent / f"{prefix.name}.info.pop{k + 1}.gen{gen}.txt"
            ids, vals = _read_info(path)
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

    def numbers(self) -> Dict[str, float]:
        """Each number compared, in print order (`cv_mismatch` only where
        the program holds resident CV alleles); a number that is not
        finite reads 1e300."""
        out = {k: (v if np.isfinite(v) else 1e300) for k, v in self.n.items()}
        if not self.resident:
            out.pop("cv_mismatch")
        return out


def _state(st) -> dict:
    """A program state's fields as the comparison reads them (the planes
    are read in place, on the device)."""
    return dict(n=st.n, seg_st=st.seg_st, seg_hap=st.seg_hap, mut=st.mut,
                cv=st.cv, sex=st.sex, ids=st.ids, ped=st.ped,
                comp={k: v[0] for k, v in st.comp.items()},
                mv=st.mv, sv=st.sv, svf=st.svf)


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


def _read_info(path: Path):
    """(int columns (n, 8), float columns (n, k)) of an `.info` file, or
    (None, None) when it is missing or malformed."""
    try:
        text = path.read_bytes()
    except OSError:
        return None, None
    lines = text.split(b"\n", 1)
    ncol = len(lines[0].split())
    if len(lines) < 2 or ncol < 9:
        return None, None
    try:
        a = np.array(lines[1].split(), dtype=np.float64)
    except ValueError:
        return None, None
    if a.size % ncol:
        return None, None
    a = a.reshape(-1, ncol)
    return a[:, :8].astype(np.int64), a[:, 8:].astype(np.float64)
