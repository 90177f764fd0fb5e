"""The benchmark's traffic generator: a cell's scenario files from its
configuration, its mix and the run's seed.

A frozen copy of the repository's scenario writers, so that later changes
to them cannot move the yardstick: `make_scenario` is `tools/mkscenario.py`
(the Table 3.1 file set: GRCh37 chromosome lengths, a 1.3 cM/Mb map in 50 kb
bins, CV tables and founder CV haplotypes, 2-SNP stub panels), and
`mutation_map`, `extra_population` and the schedule and migration files are
`chip_smoke.py`'s `_mutation_map`, `_second_population`, `_popinfo` and
`_two_populations`. `gebench/tests/test_gebench_frozen.py` holds each
equal to its original, byte for byte.

A configuration (`configs/<name>.json`) gives the sizes, a mix
(`mixes/<name>.json`) the schedule, the populations and the migration;
`write_inputs` writes the files and returns the CLI arguments of one whole
run and of the warm-up run, whose schedule is `WARMUP_GENERATIONS` long.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

# generations of the warm-up run that set-up makes before the window
WARMUP_GENERATIONS = 2

# GRCh37 chromosome lengths, Mb (1..22)
CHR_MB = [249, 243, 198, 191, 181, 171, 159, 146, 141, 136,
          135, 134, 115, 107, 102, 90, 83, 78, 59, 63, 48, 51]


def _hap_line(row: np.ndarray) -> bytes:
    """One .hap text row: every allele followed by a space, then newline."""
    line = bytearray(2 * len(row) + 1)
    line[0:-1:2] = (row + ord("0")).tobytes()
    line[1:-1:2] = b" " * len(row)
    line[-1:] = b"\n"
    return bytes(line)


def make_scenario(
    out: str,
    n0: int = 10_000,
    pop_size: int = 300_000,
    gens: int = 10,
    nchr: int = 22,
    ncv: int = 100,  # per chromosome
    snps: int = 0,  # per chromosome; 0 = stub panel (evolution never reads it)
    mat_cor: float = 0.0,
    selection: str = "thr 1 1",
    offspring_dist: str = "p",
    bin_kb: int = 50,
    cm_per_mb: float = 1.3,
    seed: int = 1,
) -> dict:
    """Write every scenario file under `out`; returns the CLI argument map
    (`tools/mkscenario.py`'s `make_scenario`, frozen: the same bytes, with
    the text written in bulk)."""
    root = Path(out)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    chrs = list(range(1, nchr + 1))
    lengths = [CHR_MB[(c - 1) % 22] * 1_000_000 for c in chrs]

    with open(root / "popinfo.txt", "w") as f:
        f.write(
            "pop_size mat_cor offspring_dist selection_func "
            "selection_func_par1 selection_func_par2\n"
        )
        for _ in range(gens):
            f.write(
                f"{pop_size} {mat_cor:g} {offspring_dist} {selection}\n"
            )

    with open(root / "rmap.txt", "w") as f:
        f.write("chr bp cM\n")
        step = bin_kb * 1000
        for c, L in zip(chrs, lengths):
            for bp in range(0, L + step, step):
                f.write(f"{c} {bp} {bp / 1e6 * cm_per_mb:.6f}\n")

    with open(root / "ref.indv", "w") as f:
        f.writelines(f"id{i + 1}\n" for i in range(n0))

    cv_rows = []
    for c, L in zip(chrs, lengths):
        # draws as `rng.choice(np.arange(10_000, L - 10_000), ...)` does,
        # without the arange
        pos = np.sort(10_000 + rng.choice(L - 20_000, ncv, replace=False))
        a = rng.normal(size=ncv)
        mat = rng.integers(0, 2, size=(ncv, 2 * n0)).astype(np.uint8)
        body = bytearray()
        for r in range(ncv):
            body += _hap_line(mat[r])
        with open(root / f"cv.chr{c}.hap", "wb") as f:
            f.write(bytes(body))
        for p, aa in zip(pos, a):
            cv_rows.append((c, int(p), float(aa)))
    with open(root / "cv.info", "w") as f:
        f.write("chr pos a d\n")
        for c, p, aa in cv_rows:
            f.write(f"{c} {p} {aa:.6f} 0\n")
    with open(root / "cv_address.txt", "w") as f:
        for c in chrs:
            f.write(f"{c} {root}/cv.chr{c}.hap\n")

    m = max(snps, 2)
    for c, L in zip(chrs, lengths):
        pos = np.sort(1 + rng.choice(L - 1, m, replace=False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            for i, p in enumerate(pos):
                f.write(f"rs{c}_{i} {p} A G\n")
        mat = rng.integers(0, 2, size=(m, 2 * n0)).astype(np.uint8)
        body = bytearray()
        for r in range(m):
            body += _hap_line(mat[r])
        with open(root / f"ref.chr{c}.hap", "wb") as f:
            f.write(bytes(body))
    with open(root / "hap_address.txt", "w") as f:
        f.write("chr hap legend sample\n")
        for c in chrs:
            f.write(
                f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                f"{root}/ref.indv\n"
            )

    return {
        "file_gen_info": str(root / "popinfo.txt"),
        "file_hap_name": str(root / "hap_address.txt"),
        "file_recom_map": str(root / "rmap.txt"),
        "file_cv_info": str(root / "cv.info"),
        "file_cvs": str(root / "cv_address.txt"),
    }


def mutation_map(path: Path, rmap: Path, rate=None) -> Path:
    """`chr bp rate` on the recombination map's bins: per-bin rate 1/K so a
    gamete carries ~1 de novo mutation per chromosome, or `rate` in every
    bin (`chip_smoke.py`'s `_mutation_map`, frozen)."""
    rows = [line.split() for line in rmap.read_text().splitlines()[1:]]
    per_chr = {}
    for c, bp, _cm in rows:
        per_chr.setdefault(c, []).append(bp)
    with open(path, "w") as f:
        f.write("chr bp rate\n")
        for c, bps in per_chr.items():
            r = 1.0 / len(bps) if rate is None else rate
            f.writelines(f"{c} {bp} {r:.8g}\n" for bp in bps)
    return path


def write_hap(path: Path, mat) -> None:
    """A `.hap` text file of the (rows, haplotypes) 0/1 matrix."""
    n = mat.shape[1]
    body = np.full((mat.shape[0], 2 * n + 1), ord(" "), dtype=np.uint8)
    body[:, 0:2 * n:2] = mat + ord("0")
    body[:, -1] = ord("\n")
    path.write_bytes(body.tobytes())


def extra_population(root: Path, nchr: int, ncv: int, n0: int,
                     rng: np.random.Generator) -> None:
    """Turn the scenario under `root`, written from the first population's
    seed (the same maps and CV positions), into another population: fresh
    CV effects in its `cv.info` and fresh founder CV alleles
    (`chip_smoke.py`'s `_second_population`, frozen). Equal tables would
    make a wrong root population invisible."""
    head, *rows = (root / "cv.info").read_text().splitlines()
    (root / "cv.info").write_text("\n".join([head] + [
        " ".join(r.split()[:2] + [f"{rng.normal():.6f}", "0"])
        for r in rows]) + "\n")
    for c in range(1, nchr + 1):
        write_hap(root / f"cv.chr{c}.hap", rng.integers(
            0, 2, size=(ncv, 2 * n0), dtype=np.uint8))


def schedule(path: Path, pop_size: int, gens: int, mix: dict) -> Path:
    """A generation-info file of `gens` rows of the mix's schedule."""
    row = (f"{pop_size} {mix['mat_cor']:g} {mix['offspring_dist']} "
           f"{mix['selection']}\n")
    path.write_text(
        "pop_size mat_cor offspring_dist selection_func selection_func_par1 "
        "selection_func_par2\n" + row * gens)
    return path


@dataclass
class Inputs:
    """A cell's written scenario: the CLI arguments of one whole run and of
    the warm-up run (the same files but for the schedule and migration
    rows), and where each population's files are."""

    argv: List[str]
    warm_argv: List[str]
    pop_dirs: List[Path]
    generations: int
    bytes_written: int


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def write_inputs(root: Path, config: dict, mix: dict, seed: int) -> Inputs:
    """Every file of a cell's scenario under `root`, from `--seed`."""
    root.mkdir(parents=True, exist_ok=True)
    gens, warm = int(mix["generations"]), WARMUP_GENERATIONS
    n_pop = int(mix["populations"])
    nchr, ncv = int(config["chromosomes"]), int(config["cvs_per_chromosome"])
    n0, pop_size = int(config["founders"]), int(config["pop_size"])
    argv, warm_argv, dirs = [], [], []
    for k in range(n_pop):
        d = root / f"pop{k + 1}"
        flags = make_scenario(
            str(d), n0=n0, pop_size=pop_size, gens=gens, nchr=nchr, ncv=ncv,
            mat_cor=float(mix["mat_cor"]), selection=mix["selection"],
            offspring_dist=mix["offspring_dist"],
            bin_kb=int(config["recombination_bin_kb"]),
            cm_per_mb=float(config["recombination_cm_per_mb"]), seed=seed)
        if k:
            extra_population(d, nchr, ncv, n0,
                             np.random.default_rng([seed, k + 1]))
        flags["file_mutation_map"] = str(mutation_map(
            d / "mut.txt", Path(flags["file_recom_map"]),
            config.get("mutation_rate_per_bin")))
        pop = []
        for key, v in flags.items():
            pop += [f"--{key}", v]
        warm_info = schedule(d / "popinfo_warm.txt", pop_size, warm, mix)
        if k:
            argv.append("--next_population")
            warm_argv.append("--next_population")
        argv += pop
        warm_argv += [str(warm_info) if a == flags["file_gen_info"] else a
                      for a in pop]
        dirs.append(d)
    if n_pop > 1:
        rows = " ".join(f"{x:g}" for r in mix["migration"] for x in r) + "\n"
        (root / "migration.txt").write_text(rows * gens)
        (root / "migration_warm.txt").write_text(rows * warm)
        extra = ["--gamma", f"{float(mix['gamma']):g}"]
        argv += ["--file_migration", str(root / "migration.txt"), *extra]
        warm_argv += ["--file_migration", str(root / "migration_warm.txt"),
                      *extra]
    size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    return Inputs(argv=argv, warm_argv=warm_argv, pop_dirs=dirs,
                  generations=gens, bytes_written=size)
