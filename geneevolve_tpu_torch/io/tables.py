"""Small scenario table formats.

Readers match the reference's file contracts:
  gen-info        header; 6 cols `pop_size mat_cor offspring_dist
                  selection_func p1 p2`; one row per generation, with the
                  reference's silent-fixup warnings (`Population.cpp:13-96`)
  hap address     header; `chr hap legend indv` (`Population.cpp:103-142`)
  vcf address     header; `chr vcf` (`Population.cpp:149-183`)
  cv_info         header; `chr pos a d`, only active chrs (`Population.cpp:197-260`)
  cvs address     NO header; `chr cv.hap` (`Population.cpp:280-309`)
  recom map       header; `chr bp cM`; bin width = bp[1]-bp[0]
                  (`Population.cpp:349-414`); p_k = (cM_k - cM_{k-1})/100
                  (`Population.cpp:471-507`)
  mutation map    header; `chr bp rate`, rate clamped to [0,1] else 0
                  (`Population.cpp:420-468`)
  migration       no header; tot_gen rows x n_pop^2 cols, row-major matrix,
                  each matrix row must sum to 1 (`Simulation.cpp:839-896`)
  output gens     one generation number per line (`Simulation.cpp:3481-3512`)
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_SEL_FUNCS = ("logit", "probit", "stab", "thr")


@dataclass
class GenerationSchedule:
    pop_size: np.ndarray  # (G,) int64
    mat_cor: np.ndarray  # (G,) float64
    offspring_dist: List[str]  # "p" | "f"
    selection_func: List[str]
    selection_par1: np.ndarray  # (G,) float64
    selection_par2: np.ndarray  # (G,) float64

    @property
    def n_generations(self) -> int:
        return len(self.pop_size)


def read_generation_info(path: str | os.PathLike) -> GenerationSchedule:
    ps, mc, od, sf, p1, p2 = [], [], [], [], [], []
    with open(path, "r") as f:
        header = f.readline()
        if len(header.split()) != 6:
            raise ValueError(
                f"file [{path}] must have 6 columns: pop_size, mat_cor, "
                "offspring_dist, selection_func, selection_func_par1 and "
                "selection_func_par2."
            )
        for line in f:
            t = line.split()
            if not t:
                continue
            size = int(float(t[0]))
            corr = float(t[1])
            dist = t[2]
            func = t[3]
            par1 = float(t[4])
            par2 = float(t[5])
            if corr > 1 or corr < -1:
                warnings.warn(f"[{path}]: mate_corr outside [-1,1]; set to 0")
                corr = 0.0
            if dist not in ("p", "f"):
                warnings.warn(f"[{path}]: offspring_dist not [p|f]; set to p")
                dist = "p"
            if func not in _SEL_FUNCS:
                warnings.warn(
                    f"[{path}]: selection_func not in {_SEL_FUNCS}; "
                    "set to [logit 0 1]"
                )
                func, par1, par2 = "logit", 0.0, 1.0
            ps.append(size)
            mc.append(corr)
            od.append(dist)
            sf.append(func)
            p1.append(par1)
            p2.append(par2)
    if not ps:
        raise ValueError(f"no generations in [{path}]")
    return GenerationSchedule(
        pop_size=np.array(ps, dtype=np.int64),
        mat_cor=np.array(mc),
        offspring_dist=od,
        selection_func=sf,
        selection_par1=np.array(p1),
        selection_par2=np.array(p2),
    )


def read_hap_address(path: str | os.PathLike) -> List[Tuple[int, str, str, str]]:
    """Rows of (chr, hap_path, legend_path, indv_path); paths are resolved
    relative to the address file's directory (the reference relies on cwd;
    relative resolution is a strict superset for the bundled examples)."""
    base = os.path.dirname(os.fspath(path))
    out = []
    with open(path, "r") as f:
        next(f)  # header
        for line in f:
            t = line.split()
            if not t:
                continue
            out.append(
                (
                    int(t[0]),
                    _resolve(base, t[1]),
                    _resolve(base, t[2]),
                    _resolve(base, t[3]),
                )
            )
    return out


def read_vcf_address(path: str | os.PathLike) -> List[Tuple[int, str]]:
    base = os.path.dirname(os.fspath(path))
    out = []
    with open(path, "r") as f:
        next(f)  # header
        for line in f:
            t = line.split()
            if not t:
                continue
            out.append((int(t[0]), _resolve(base, t[1])))
    return out


def _resolve(base: str, p: str) -> str:
    return p if os.path.isabs(p) or os.path.exists(p) else os.path.join(base, p)


@dataclass
class CvInfo:
    """Per-chromosome causal-variant table for one phenotype."""

    bp: np.ndarray  # (ncv,) int64
    a: np.ndarray  # (ncv,) float64  additive effect
    d: np.ndarray  # (ncv,) float64  dominance effect


def read_cv_info(
    path: str | os.PathLike, active_chrs: List[int]
) -> Dict[int, CvInfo]:
    rows: Dict[int, List[Tuple[int, float, float]]] = {c: [] for c in active_chrs}
    with open(path, "r") as f:
        header = f.readline()
        if len(header.split()) != 4:
            raise ValueError(f"file [{path}] should have 4 columns (chr pos a d)")
        for line in f:
            t = line.split()
            if not t:
                continue
            chrom = int(t[0])
            if chrom not in rows:
                raise ValueError(
                    f"in file [{path}]: chromosome [{chrom}] is not defined in "
                    "the --file_hap_name file"
                )
            rows[chrom].append((int(float(t[1])), float(t[2]), float(t[3])))
    out = {}
    for c in active_chrs:
        r = rows[c]
        out[c] = CvInfo(
            bp=np.array([x[0] for x in r], dtype=np.int64),
            a=np.array([x[1] for x in r]),
            d=np.array([x[2] for x in r]),
        )
    return out


def read_cvs_address(
    path: str | os.PathLike, active_chrs: List[int]
) -> Dict[int, str]:
    base = os.path.dirname(os.fspath(path))
    out: Dict[int, str] = {}
    with open(path, "r") as f:  # no header
        for line in f:
            t = line.split()
            if not t:
                continue
            chrom = int(t[0])
            if chrom in active_chrs:
                out[chrom] = _resolve(base, t[1])
    return out


@dataclass
class RecombinationMap:
    """One chromosome's map. `bp[k]` are bin anchors; the reference treats
    bins as fixed width `bp[1]-bp[0]` and positions a crossover hit on bin k
    at `bp[k] + U[0, width)` (`Simulation.cpp:2973-2995`)."""

    bp: np.ndarray  # (K,) int64
    cM: np.ndarray  # (K,) float64
    bin_width: int

    @property
    def prob(self) -> np.ndarray:
        """Per-bin crossover probability; prob[0] = 0 (`Population.cpp:471-480`)."""
        p = np.diff(self.cM, prepend=self.cM[0]) * 0.01
        p[0] = 0.0
        return p

    @property
    def chr_start(self) -> int:
        return int(self.bp[0])

    @property
    def chr_end(self) -> int:
        return int(self.bp[-1])


def read_recom_map(
    path: str | os.PathLike, active_chrs: List[int]
) -> Dict[int, RecombinationMap]:
    raw = np.loadtxt(path, skiprows=1, ndmin=2)
    out = {}
    for c in active_chrs:
        sel = raw[:, 0].astype(np.int64) == c
        if not sel.any():
            raise ValueError(f"recom map [{path}] has no rows for chromosome {c}")
        bp = raw[sel, 1].astype(np.int64)
        cm = raw[sel, 2]
        out[c] = RecombinationMap(bp=bp, cM=cm, bin_width=int(bp[1] - bp[0]))
    return out


@dataclass
class MutationMap:
    bp: np.ndarray  # (K,) int64
    rate: np.ndarray  # (K,) float64 per-bin mutation probability


def read_mutation_map(
    path: str | os.PathLike, active_chrs: List[int]
) -> Dict[int, MutationMap]:
    raw = np.loadtxt(path, skiprows=1, ndmin=2)
    out = {}
    for c in active_chrs:
        sel = raw[:, 0].astype(np.int64) == c
        if not sel.any():
            raise ValueError(f"mutation map [{path}] has no rows for chromosome {c}")
        rate = raw[sel, 2].copy()
        rate[(rate < 0) | (rate > 1)] = 0.0
        out[c] = MutationMap(bp=raw[sel, 1].astype(np.int64), rate=rate)
    return out


def read_migration(path: str | os.PathLike, n_pop: int, n_gen: int) -> np.ndarray:
    """(n_gen, n_pop, n_pop) row-stochastic matrices, one per generation."""
    raw = np.loadtxt(path, ndmin=2)
    if raw.shape[1] != n_pop * n_pop:
        raise ValueError(
            f"[{path}] must have n^2={n_pop * n_pop} columns per row"
        )
    if raw.shape[0] != n_gen:
        raise ValueError(f"[{path}] must have {n_gen} lines (one per generation)")
    mats = raw.reshape(n_gen, n_pop, n_pop)
    sums = mats.sum(axis=2)
    if np.any(np.abs(sums - 1.0) > 1e-5):
        raise ValueError(
            "the sum of rows of the transition matrix in "
            "[--file_migration] must be 1"
        )
    return mats


def read_output_generations(path: str | os.PathLike) -> List[int]:
    out = []
    with open(path, "r") as f:
        for line in f:
            if line.strip():
                out.append(int(float(line)))
    return out
