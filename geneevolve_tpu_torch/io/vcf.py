"""Host-side VCF codec (replaces the reference's libStatGen dependency).

Reader semantics match `format_vcf::read_vcf_file`
(`src/format_vcf.cpp:74-360`): keep biallelic records with
recognizable ref/alt alleles, skip multi-allelic ones, do NOT drop
filter-failing records; `.` IDs become `chrom:pos`; GT parsed phased into a
`(2n, m)` uint8 matrix. Gzip transparently supported (extension `.gz`).

Writer matches `format_vcf::write_vcf_file` (`format_vcf.cpp:5-66`) and the
meta lines created at `Simulation.cpp:1715-1724`.
"""

from __future__ import annotations

import gzip
import os
import time
from dataclasses import dataclass, field
from typing import IO, List

import numpy as np

_ALLELE_CODES = set("AaCcGgTtDdIiRr")


@dataclass
class VcfData:
    """One chromosome's VCF content (sites + phased haplotype matrix)."""

    samples: List[str]
    chrom: np.ndarray  # (m,) str
    pos: np.ndarray  # (m,) int64
    ids: np.ndarray  # (m,) str
    ref: np.ndarray  # (m,) str
    alt: np.ndarray  # (m,) str
    qual: np.ndarray  # (m,) str ('.' or number, passed through)
    filt: np.ndarray  # (m,) str
    info: np.ndarray  # (m,) str
    fmt: np.ndarray  # (m,) str
    hap: np.ndarray  # (2n, m) uint8, 0=REF 1=ALT
    meta_lines: List[str] = field(default_factory=list)

    @property
    def nsnp(self) -> int:
        return len(self.pos)


def _open(path: str | os.PathLike, mode: str) -> IO:
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, mode + "t" if "b" not in mode else mode)
    return open(path, mode)


def read_header_samples(path: str | os.PathLike) -> List[str]:
    """Sample ids from the #CHROM header line (`format_vcf.cpp:367-389`)."""
    with _open(path, "r") as f:
        for line in f:
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                return line.rstrip("\n").split("\t")[9:]
            break
    raise ValueError(f"no #CHROM header line in [{path}]")


def read_vcf(path: str | os.PathLike) -> VcfData:
    native = _read_vcf_native(path)
    if native is not None:
        return native
    return _read_vcf_python(path)


def _read_vcf_native(path: str | os.PathLike) -> VcfData | None:
    """Two-pass native parse (count + GT fill) with Python slicing of the
    per-record fixed columns; mirrors the reference's two-pass libStatGen
    read (`format_vcf.cpp:74-360`)."""
    from geneevolve_tpu_torch import native

    lib = native.load()
    if lib is None:
        return None
    with _open(path, "rb") as f:
        data = f.read()
    import ctypes

    n_rec = ctypes.c_int64()
    n_smp = ctypes.c_int64()
    lib.vcf_count(data, len(data), ctypes.byref(n_rec), ctypes.byref(n_smp))
    n_records, n_samples = n_rec.value, n_smp.value
    if n_records <= 0 or n_samples <= 0:
        return None  # fall back for the error path/reporting
    gt = np.empty((2 * n_samples, n_records), dtype=np.uint8)
    rec_off = np.empty(n_records, dtype=np.int64)
    rec_len = np.empty(n_records, dtype=np.int64)
    rc = lib.vcf_parse_gt(
        data,
        len(data),
        n_records,
        n_samples,
        gt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rec_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rec_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        return None
    meta: List[str] = []
    samples: List[str] = []
    for line in data.split(b"\n"):
        if line.startswith(b"##"):
            meta.append(line.decode())
        elif line.startswith(b"#CHROM"):
            samples = line.decode().rstrip("\n").split("\t")[9:]
            break
    chrom, pos, ids, ref, alt, qual, filt = [], [], [], [], [], [], []
    keep = np.ones(n_records, dtype=bool)
    for r in range(n_records):
        t = data[rec_off[r] : rec_off[r] + rec_len[r]].decode().split("\t")
        rr, aa = t[3], t[4]
        if len(rr) == 1 and rr not in _ALLELE_CODES:
            keep[r] = False
            continue
        if len(aa) == 1 and aa not in _ALLELE_CODES and aa != "0":
            keep[r] = False
            continue
        chrom.append(t[0])
        pos.append(int(t[1]))
        ids.append(t[2] if t[2] != "." else f"{t[0]}:{t[1]}")
        ref.append(rr)
        alt.append(aa)
        qual.append(t[5])
        filt.append(t[6])
    if not chrom:
        return None
    hap = gt[:, keep] if not keep.all() else gt
    m = len(pos)
    return VcfData(
        samples=samples,
        chrom=np.array(chrom, dtype=object),
        pos=np.array(pos, dtype=np.int64),
        ids=np.array(ids, dtype=object),
        ref=np.array(ref, dtype=object),
        alt=np.array(alt, dtype=object),
        qual=np.array(qual, dtype=object),
        filt=np.array(filt, dtype=object),
        info=np.full(m, ".", dtype=object),
        fmt=np.full(m, "GT", dtype=object),
        hap=np.ascontiguousarray(hap),
        meta_lines=meta,
    )


def _read_vcf_python(path: str | os.PathLike) -> VcfData:
    meta: List[str] = []
    samples: List[str] = []
    chrom, pos, ids, ref, alt, qual, filt = [], [], [], [], [], [], []
    gt_rows: List[np.ndarray] = []
    with _open(path, "r") as f:
        for line in f:
            if line.startswith("##"):
                meta.append(line.rstrip("\n"))
                continue
            if line.startswith("#CHROM"):
                samples = line.rstrip("\n").split("\t")[9:]
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 10:
                continue
            r, a = t[3], t[4]
            if "," in a:  # multi-allelic: skipped (`format_vcf.cpp:114-118`)
                continue
            if len(r) == 1 and r not in _ALLELE_CODES:
                continue
            if len(a) == 1 and a not in _ALLELE_CODES and a != "0":
                continue
            # parse GT: first colon field, phased or unphased separator
            row = np.empty(2 * len(samples), dtype=np.uint8)
            ok = True
            for i, cell in enumerate(t[9:]):
                g = cell.split(":", 1)[0]
                sep = "|" if "|" in g else "/"
                ab = g.split(sep)
                if len(ab) == 1:  # haploid/missing second allele -> 0
                    ab = [ab[0], "."]
                elif len(ab) != 2:
                    ok = False
                    break
                row[2 * i] = 0 if ab[0] in ("0", ".") else 1
                row[2 * i + 1] = 0 if ab[1] in ("0", ".") else 1
            if not ok:
                continue
            chrom.append(t[0])
            pos.append(int(t[1]))
            ids.append(t[2] if t[2] != "." else f"{t[0]}:{t[1]}")
            ref.append(r)
            alt.append(a)
            qual.append(t[5])
            filt.append(t[6])
            gt_rows.append(row)
    if not gt_rows:
        raise ValueError(f"no usable biallelic records in [{path}]")
    hap = np.stack(gt_rows).T  # (2n, m)
    m = len(pos)
    return VcfData(
        samples=samples,
        chrom=np.array(chrom, dtype=object),
        pos=np.array(pos, dtype=np.int64),
        ids=np.array(ids, dtype=object),
        ref=np.array(ref, dtype=object),
        alt=np.array(alt, dtype=object),
        qual=np.array(qual, dtype=object),
        filt=np.array(filt, dtype=object),
        info=np.full(m, ".", dtype=object),
        fmt=np.full(m, "GT", dtype=object),
        hap=np.ascontiguousarray(hap),
        meta_lines=meta,
    )


def default_meta_lines() -> List[str]:
    """The reference's generated meta block (`Simulation.cpp:1715-1724`)."""
    return [
        "##fileformat=VCFv4.1",
        "##Phasing=phased",
        "##CreatedBy=GeneEvolve",
        "##fileDate=" + time.strftime("%Y%m%d"),
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    ]


def write_vcf(path: str | os.PathLike, v: VcfData) -> None:
    n = len(v.samples)
    assert v.hap.shape == (2 * n, v.nsnp)
    a = np.ascontiguousarray(v.hap[0::2, :])  # (n, m)
    b = np.ascontiguousarray(v.hap[1::2, :])
    tails = _gt_tails(a, b)
    with _open(path, "w") as f:
        for line in v.meta_lines:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for s in v.samples:
            f.write("\t" + str(s))
        f.write("\n")
        for j in range(v.nsnp):
            f.write(
                f"{v.chrom[j]}\t{v.pos[j]}\t{v.ids[j]}\t{v.ref[j]}\t{v.alt[j]}"
                f"\t{v.qual[j]}\t{v.filt[j]}\t{v.info[j]}\t{v.fmt[j]}"
            )
            f.write(tails[j])


class VcfStreamWriter:
    """Record-streaming VCF writer: header up front, then `write_block`
    per loci chunk — peak memory is one chunk's GT text, never the whole
    (2n, m) matrix. Same output bytes as `write_vcf`."""

    def __init__(self, path: str | os.PathLike, v: VcfData):
        self.v = v
        self.f = _open(path, "w")
        for line in v.meta_lines:
            self.f.write(line + "\n")
        self.f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT")
        for s in v.samples:
            self.f.write("\t" + str(s))
        self.f.write("\n")

    def write_block(self, lo: int, a: np.ndarray, b: np.ndarray) -> None:
        """Records [lo, lo + mc) from (n, mc) chromatid allele blocks."""
        v = self.v
        tails = _gt_tails(np.ascontiguousarray(a), np.ascontiguousarray(b))
        for jj in range(a.shape[1]):
            j = lo + jj
            self.f.write(
                f"{v.chrom[j]}\t{v.pos[j]}\t{v.ids[j]}\t{v.ref[j]}\t{v.alt[j]}"
                f"\t{v.qual[j]}\t{v.filt[j]}\t{v.info[j]}\t{v.fmt[j]}"
            )
            self.f.write(tails[jj])

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _gt_tails(a: np.ndarray, b: np.ndarray) -> List[str]:
    """Per-record '\\ta|b...\\n' strings for (n, m) allele matrices."""
    from geneevolve_tpu_torch import native

    n, m = a.shape
    lib = native.load()
    if lib is not None and n and m:
        import ctypes

        buf = np.empty(m * (4 * n + 1), dtype=np.uint8)
        written = lib.gt_format(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n,
            m,
            buf.ctypes.data,
        )
        text = buf[:written].tobytes().decode()
        per = 4 * n + 1
        return [text[j * per : (j + 1) * per] for j in range(m)]
    out = []
    for j in range(m):
        col = np.char.add(
            np.char.add(a[:, j].astype("U1"), "|"), b[:, j].astype("U1")
        )
        out.append("\t" + "\t".join(col) + "\n")
    return out
