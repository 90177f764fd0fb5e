"""The scenario's inputs as the reference reads them: maps, CV tables and
founder CV haplotypes of every population, where each chromosome's panel
lies, and the genome backend, parsed from the same files the program reads
(GeneEvolve's formats: `chr bp cM` recombination map, `chr bp rate`
mutation map, `chr pos a d` CV table, `.hap` rows of 0/1 alleles, one
column a founder haplotype)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np


def _flag(argv: List[str], name: str) -> List[str]:
    """Every value of `--name` in argv, in order (one a population)."""
    return [argv[i + 1] for i, a in enumerate(argv[:-1]) if a == f"--{name}"]


def _table(path: str) -> np.ndarray:
    return np.loadtxt(path, skiprows=1, ndmin=2)


def _hap(path: str) -> np.ndarray:
    """(haplotypes, rows) uint8 from a .hap text file whose rows are sites."""
    data = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    width = int(np.flatnonzero(data == ord("\n"))[0]) + 1
    mat = data.reshape(-1, width)[:, 0:width - 1:2] - ord("0")
    return np.ascontiguousarray(mat.T)


@dataclass
class Population:
    """One population's inputs, per chromosome."""

    n0: int
    cv_bp: List[np.ndarray]  # (ncv,) int64
    a: List[np.ndarray]  # (ncv,) float64 additive effects
    d: List[np.ndarray]
    founder_cv: List[np.ndarray]  # (2 n0, ncv) uint8
    pop_size: List[int]  # the schedule, a generation a row
    mat_cor: List[float]
    offspring: List[str]
    selection: List[tuple]  # (function, par1, par2)
    panels: List[tuple]  # (.hap file, .legend file) a chromosome


@dataclass
class Scenario:
    chrs: List[int]
    rmap: List[tuple]  # (bp int64, cM float64) a chromosome
    mmap: List[tuple]  # (bp int64, rate float64), or None
    pops: List[Population]
    migration: np.ndarray  # (gens, n_pop, n_pop) or None
    gamma: float
    seed: int
    backend: str  # the genome backend the run names (`--backend`)


def _schedule(path: str):
    rows = [line.split() for line in Path(path).read_text().splitlines()[1:]
            if line.strip()]
    return ([int(float(r[0])) for r in rows], [float(r[1]) for r in rows],
            [r[2] for r in rows],
            [(r[3], float(r[4]), float(r[5])) for r in rows])


def read(argv: List[str], seed: int) -> Scenario:
    """The scenario that CLI arguments `argv` name (one phenotype a
    population, as the benchmark's mixes write)."""
    chrs, rmap, mmap, pops = None, None, None, []
    for k, (info, haps, rm, cvi, cvs) in enumerate(zip(
            _flag(argv, "file_gen_info"), _flag(argv, "file_hap_name"),
            _flag(argv, "file_recom_map"), _flag(argv, "file_cv_info"),
            _flag(argv, "file_cvs"))):
        rows = [r.split() for r in Path(haps).read_text().splitlines()[1:]
                if r.strip()]
        panels = {int(r[0]): (r[1], r[2]) for r in rows}
        if chrs is None:
            chrs = [int(r[0]) for r in rows]
            raw = _table(rm)
            rmap = [(raw[raw[:, 0] == c, 1].astype(np.int64),
                     raw[raw[:, 0] == c, 2]) for c in chrs]
            mm = _flag(argv, "file_mutation_map")
            if mm:
                raw = _table(mm[0])
                mmap = [(raw[raw[:, 0] == c, 1].astype(np.int64),
                         raw[raw[:, 0] == c, 2]) for c in chrs]
        raw = _table(cvi)
        addr = dict(line.split()[:2] for line in
                    Path(cvs).read_text().splitlines() if line.strip())
        founder = [_hap(addr[str(c)]) for c in chrs]
        sizes, cors, offs, sels = _schedule(info)
        pops.append(Population(
            n0=founder[0].shape[0] // 2,
            cv_bp=[raw[raw[:, 0] == c, 1].astype(np.int64) for c in chrs],
            a=[raw[raw[:, 0] == c, 2] for c in chrs],
            d=[raw[raw[:, 0] == c, 3] for c in chrs],
            founder_cv=[f[:, :len(raw[raw[:, 0] == c])]
                        for f, c in zip(founder, chrs)],
            pop_size=sizes, mat_cor=cors, offspring=offs, selection=sels,
            panels=[panels[c] for c in chrs]))
    mig = _flag(argv, "file_migration")
    migration = None
    if mig:
        n = len(pops)
        migration = np.loadtxt(mig[0], ndmin=2).reshape(-1, n, n)
    gamma = _flag(argv, "gamma")
    backend = _flag(argv, "backend")
    return Scenario(chrs=chrs, rmap=rmap, mmap=mmap, pops=pops,
                    migration=migration,
                    gamma=float(gamma[0]) if gamma else 0.0, seed=seed,
                    backend=backend[-1] if backend else "segment")
