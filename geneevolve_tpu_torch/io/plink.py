"""PLINK .ped / .map writers.

Output contract matches the reference writers (`format_plink.cpp:5-137`,
fields assembled at `Simulation.cpp:1390-1413`):
  .ped   one row per individual: `FID IID PID MID sex phen  a1 a2  a1 a2 ...`
         FID = father's ID (reference quirk, `Simulation.cpp:1396`), phen = -9,
         alleles as legend letters (write_ped_map) or 0/1 (write_ped01_map).
  .map   `chr rs cM pos` with cM always 0 (`Simulation.cpp:1409`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class PedIds:
    fid: np.ndarray  # (n,) int (already 1-based)
    iid: np.ndarray
    pid: np.ndarray
    mid: np.ndarray
    sex: np.ndarray  # (n,) 1/2


def _write_ped(
    path: str,
    geno: np.ndarray,  # (n, m, 2) uint8, [:, j, h] = allele h of SNP j
    ids: PedIds,
    allele_strings: np.ndarray,  # (m, 2) object: column g -> printed token
) -> None:
    n, m, _ = geno.shape
    # token lookup per SNP: tok[j, g]
    with open(path, "w") as f:
        for i in range(n):
            head = (
                f"{ids.fid[i]} {ids.iid[i]} {ids.pid[i]} {ids.mid[i]} "
                f"{ids.sex[i]} -9"
            )
            g = geno[i]  # (m, 2)
            toks = allele_strings[np.arange(m)[:, None], g]  # (m, 2)
            f.write(head)
            f.write(" ")
            f.write(" ".join(toks.ravel()))
            f.write("\n")


def write_ped_map(
    out_prefix: str | os.PathLike,
    geno: np.ndarray,  # (n, m, 2) uint8
    ids: PedIds,
    chrom: int,
    rs: np.ndarray,
    pos: np.ndarray,
    al0: np.ndarray,
    al1: np.ndarray,
    letters: bool = True,
) -> None:
    out_prefix = os.fspath(out_prefix)
    m = len(pos)
    if letters:
        allele_strings = np.stack(
            [al0.astype(object), al1.astype(object)], axis=1
        )
    else:
        allele_strings = np.tile(np.array(["0", "1"], dtype=object), (m, 1))
    _write_ped(out_prefix + ".ped", geno, ids, allele_strings)
    with open(out_prefix + ".map", "w") as f:
        for j in range(m):
            f.write(f"{chrom} {rs[j]} 0 {pos[j]}\n")
