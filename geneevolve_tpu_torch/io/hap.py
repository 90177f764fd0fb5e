"""SHAPEIT/IMPUTE2 reference-panel formats: .hap / .legend / .indv.

Format contract (matches `src/format_hap.cpp`):
  .hap    no header; one row per SNP; 2n space-separated 0/1 columns
          (the reference parses strictly positionally, `format_hap.cpp:95-106`;
          writes a trailing space per row, `:17-25`)
  .legend header `id pos al0 al1`; one row per SNP (`:125-156`)
  .indv   no header; one sample id per line (`:160-183`)

In memory we hold haplotypes as a `(2n, m)` uint8 matrix (hap-major), the
transpose of the on-disk SNP-major layout, same as the reference's
`Hap_SNP.hap`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class Legend:
    ids: np.ndarray  # (m,) object/str
    pos: np.ndarray  # (m,) int64
    al0: np.ndarray  # (m,) str
    al1: np.ndarray  # (m,) str

    @property
    def nsnp(self) -> int:
        return len(self.pos)


def read_hap(path: str | os.PathLike) -> np.ndarray:
    """Read a .hap file into a (2n, m) uint8 matrix."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(f"empty hap file [{path}]")
    if not data.endswith(b"\n"):
        data += b"\n"
    nl = data.count(b"\n")
    native = _read_hap_native(data, nl)
    if native is not None:
        return native
    # fast path: uniform line length -> one reshape + stride
    if len(data) % nl == 0:
        width = len(data) // nl
        mat = np.frombuffer(data, dtype=np.uint8).reshape(nl, width)
        if np.all(mat[:, -1] == ord("\n")):
            cols = mat[:, 0 : width - 1 : 2]  # positional parse: chars 0,2,4,...
            bad = ~np.isin(cols, (ord("0"), ord("1")))
            if not bad.any():
                return np.ascontiguousarray((cols - ord("0")).T)
    # robust path
    rows: List[np.ndarray] = []
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        rows.append(np.frombuffer(line[0 : len(line) : 2], dtype=np.uint8))
    arr = np.stack(rows)
    bad = ~np.isin(arr, (ord("0"), ord("1")))
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise ValueError(
            f"undefined character [{chr(arr[i, j])}] in file [{path}], line {i}"
        )
    return np.ascontiguousarray((arr - ord("0")).T)


def _read_hap_native(data: bytes, nl: int) -> np.ndarray | None:
    """C codec parse (strict positional, like `format_hap.cpp:95-106`)."""
    from geneevolve_tpu_torch import native

    lib = native.load()
    if lib is None or nl == 0:
        return None
    first = data.index(b"\n")
    ncols = (first + 1) // 2
    if ncols == 0:
        return None
    out = np.empty((nl, ncols), dtype=np.uint8)
    import ctypes

    rc = lib.hap_parse(
        data,
        len(data),
        nl,
        ncols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        return None  # ragged or bad char: let the Python path diagnose
    return np.ascontiguousarray(out.T)


def hap_bytes(hap: np.ndarray) -> bytes:
    """SNP-major text rows for a (2n, m) 0/1 block, byte-compatible with the
    reference writer (`format_hap.cpp:6-30`): space after every column
    including the last. Usable per loci chunk for streamed writes."""
    hap = np.asarray(hap, dtype=np.uint8)
    nhap, nsnp = hap.shape
    out = np.empty((nsnp, 2 * nhap + 1), dtype=np.uint8)
    out[:, 0:-1:2] = hap.T + ord("0")
    out[:, 1:-1:2] = ord(" ")
    out[:, -1] = ord("\n")
    return out.tobytes()


def write_hap(path: str | os.PathLike, hap: np.ndarray) -> None:
    """Write a (2n, m) 0/1 matrix as a SNP-major .hap file."""
    with open(path, "wb") as f:
        f.write(hap_bytes(hap))


def read_legend(path: str | os.PathLike) -> Legend:
    ids: List[str] = []
    pos: List[int] = []
    al0: List[str] = []
    al1: List[str] = []
    with open(path, "r") as f:
        next(f)  # header
        for line in f:
            parts = line.split()
            if not parts:
                continue
            ids.append(parts[0])
            pos.append(int(float(parts[1])))
            al0.append(parts[2])
            al1.append(parts[3])
    return Legend(
        ids=np.array(ids, dtype=object),
        pos=np.array(pos, dtype=np.int64),
        al0=np.array(al0, dtype=object),
        al1=np.array(al1, dtype=object),
    )


def read_indv(path: str | os.PathLike) -> List[str]:
    """Whitespace-delimited sample ids — exactly the reference's
    `while (ifile >> id)` tokenization (`format_hap.cpp:173-177`): ids
    containing spaces split into multiple samples in BOTH implementations,
    so the counts stay in lockstep."""
    with open(path, "r") as f:
        return f.read().split()


def write_indv(path: str | os.PathLike, ids: Sequence) -> None:
    with open(path, "w") as f:
        for i in ids:
            f.write(f"{i}\n")
