"""The benchmark's traffic generator: a cell's scenario files from its
configuration, its mix and the run's seed.

A frozen copy of the repository's scenario writers, so that later changes
to them cannot move the yardstick: `make_scenario` is `tools/mkscenario.py`
(the Table 3.1 file set: GRCh37 chromosome lengths, a 1.3 cM/Mb map in 50 kb
bins, CV tables and founder CV haplotypes, 2-SNP stub panels), and
`mutation_map`, `extra_population`, `cvs_on_panel` and the schedule and
migration files are `chip_smoke.py`'s `_mutation_map`, `_second_population`,
`_cvs_on_panel`, `_popinfo` and `_two_populations`.
`gebench/tests/test_gebench_frozen.py` holds each equal to its original,
byte for byte.

A configuration (`configs/<name>.json`) gives the sizes, a mix
(`mixes/<name>.json`) the schedule, the populations and the migration;
`write_inputs` writes the files and returns the CLI arguments of one whole
run and of the warm-up run, whose schedule is the first
`WARMUP_GENERATIONS` rows of the run's.
`founders` and `pop_size` may each be a list, one entry a population; with
`growth_per_generation` (a rate r a population) population k's size at
generation g of G is round(pop_size[k] e^(-r_k (G - g))), so that the last
generation has the stated size (`sizes`). Populations after the first keep
the first's maps and CV sites and draw their own effects, founder CV
alleles and, with another founder count, stub panel (`founder_panel`).
A configuration may also state `backend` (`dense` adds `--backend dense`),
`snps_per_chromosome` (a panel of that many SNPs on each chromosome, in
place of the 2-SNP stub) and `cvs_on_panel` (every CV moved onto a panel
site, as the dense backend reads a CV's alleles from its column).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

# generations of the warm-up run that set-up makes before the window
WARMUP_GENERATIONS = 2

# GRCh37 chromosome lengths, Mb (1..22)
CHR_MB = [249, 243, 198, 191, 181, 171, 159, 146, 141, 136,
          135, 134, 115, 107, 102, 90, 83, 78, 59, 63, 48, 51]


def make_scenario(
    out: str,
    n0: int = 10_000,
    pop_size: int = 300_000,
    gens: int = 10,
    nchr: int = 22,
    ncv: int = 100,  # per chromosome
    snps=0,  # per chromosome, or a list of one count a chromosome; 0 = stub
    #          panel (the segment backend never reads it)
    mat_cor: float = 0.0,
    selection: str = "thr 1 1",
    offspring_dist: str = "p",
    bin_kb: int = 50,
    cm_per_mb: float = 1.3,
    seed: int = 1,
) -> dict:
    """Write every scenario file under `out`; returns the CLI argument map
    (`tools/mkscenario.py`'s `make_scenario`, frozen: the same bytes, with
    the text written in bulk; `snps` may also give each chromosome its own
    count, drawn in the same order)."""
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
        write_hap(root / f"cv.chr{c}.hap", mat)
        for p, aa in zip(pos, a):
            cv_rows.append((c, int(p), float(aa)))
    with open(root / "cv.info", "w") as f:
        f.write("chr pos a d\n")
        for c, p, aa in cv_rows:
            f.write(f"{c} {p} {aa:.6f} 0\n")
    with open(root / "cv_address.txt", "w") as f:
        for c in chrs:
            f.write(f"{c} {root}/cv.chr{c}.hap\n")

    counts = list(snps) if isinstance(snps, (list, tuple)) else [snps] * nchr
    for c, L, m in zip(chrs, lengths, (max(int(x), 2) for x in counts)):
        pos = np.sort(1 + rng.choice(L - 1, m, replace=False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            f.writelines(f"rs{c}_{i} {p} A G\n" for i, p in enumerate(pos))
        mat = rng.integers(0, 2, size=(m, 2 * n0)).astype(np.uint8)
        write_hap(root / f"ref.chr{c}.hap", mat)
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


def cvs_on_panel(root: Path, seed: int) -> None:
    """Move every CV onto a panel site, as when CVs are taken from the
    reference panel: `cv.info` keeps each chromosome's effects at sites
    drawn from its legend, and each CV hap row becomes the panel's row at
    that site (`chip_smoke.py`'s `_cvs_on_panel`, frozen). The founders'
    CV alleles then equal their panel's at the CV columns."""
    rng = np.random.default_rng(seed)
    head, *rows = (root / "cv.info").read_text().splitlines()
    by_chr = {}
    for r in rows:
        by_chr.setdefault(r.split()[0], []).append(r.split())
    out = [head]
    for c, rs in by_chr.items():
        legend = (root / f"ref.chr{c}.legend").read_text().splitlines()[1:]
        idx = np.sort(rng.choice(len(legend), len(rs), replace=False))
        panel = (root / f"ref.chr{c}.hap").read_bytes().splitlines(True)
        (root / f"cv.chr{c}.hap").write_bytes(b"".join(panel[i] for i in idx))
        out += [" ".join([c, legend[i].split()[1], *r[2:]])
                for i, r in zip(idx, rs)]
    (root / "cv.info").write_text("\n".join(out) + "\n")


def founder_panel(root: Path, nchr: int, n0: int,
                  rng: np.random.Generator) -> None:
    """Give the scenario under `root` `n0` founders in its stub panel:
    `ref.indv` and each chromosome's `.hap` rows, drawn anew at its
    legend's sites (the founders' CV alleles are `extra_population`'s)."""
    (root / "ref.indv").write_text("".join(f"id{i + 1}\n"
                                           for i in range(n0)))
    for c in range(1, nchr + 1):
        sites = len((root / f"ref.chr{c}.legend").read_text()
                    .splitlines()) - 1
        write_hap(root / f"ref.chr{c}.hap", rng.integers(
            0, 2, size=(sites, 2 * n0), dtype=np.uint8))


def per_population(config: dict, key: str, n_pop: int) -> List[int]:
    """A configuration's `key` for each population: a list gives one entry
    a population, a number the same for all."""
    v = config[key]
    if not isinstance(v, list):
        return [int(v)] * n_pop
    if len(v) != n_pop:
        raise ValueError(f"{key} gives {len(v)} populations, the mix "
                         f"{n_pop}")
    return [int(x) for x in v]


def sizes(config: dict, n_pop: int, gens: int) -> List[List[int]]:
    """Each population's schedule, generations 1..gens: its `pop_size`
    every generation, or under `growth_per_generation` round(pop_size
    e^(-r (gens - g))) at generation g."""
    ends = per_population(config, "pop_size", n_pop)
    rates = config.get("growth_per_generation")
    if rates is None:
        return [[n] * gens for n in ends]
    if len(rates) != n_pop:
        raise ValueError(f"growth_per_generation gives {len(rates)} "
                         f"populations, the mix {n_pop}")
    return [[int(round(n * math.exp(-float(r) * (gens - g))))
             for g in range(1, gens + 1)] for n, r in zip(ends, rates)]


def schedule(path: Path, rows: List[int], mix: dict) -> Path:
    """A generation-info file of the mix's schedule, one row a size."""
    rest = f" {mix['mat_cor']:g} {mix['offspring_dist']} {mix['selection']}\n"
    path.write_text(
        "pop_size mat_cor offspring_dist selection_func selection_func_par1 "
        "selection_func_par2\n" + "".join(f"{n}{rest}" for n in rows))
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
    founders = per_population(config, "founders", n_pop)
    rows = sizes(config, n_pop, gens)
    snps = config.get("snps_per_chromosome", 0)
    argv, warm_argv, dirs = [], [], []
    for k in range(n_pop):
        d = root / f"pop{k + 1}"
        # the first population's founder count, so that every population
        # draws the same maps and CV sites
        flags = make_scenario(
            str(d), n0=founders[0], pop_size=rows[k][0], gens=gens,
            nchr=nchr, ncv=ncv, snps=snps, mat_cor=float(mix["mat_cor"]),
            selection=mix["selection"], offspring_dist=mix["offspring_dist"],
            bin_kb=int(config["recombination_bin_kb"]),
            cm_per_mb=float(config["recombination_cm_per_mb"]), seed=seed)
        if len(set(rows[k])) > 1:
            schedule(Path(flags["file_gen_info"]), rows[k], mix)
        if k:
            rng = np.random.default_rng([seed, k + 1])
            extra_population(d, nchr, ncv, founders[k], rng)
            if founders[k] != founders[0]:
                founder_panel(d, nchr, founders[k], rng)
        if config.get("cvs_on_panel"):
            cvs_on_panel(d, seed)
        flags["file_mutation_map"] = str(mutation_map(
            d / "mut.txt", Path(flags["file_recom_map"]),
            config.get("mutation_rate_per_bin")))
        pop = []
        for key, v in flags.items():
            pop += [f"--{key}", v]
        warm_info = schedule(d / "popinfo_warm.txt", rows[k][:warm], mix)
        if k:
            argv.append("--next_population")
            warm_argv.append("--next_population")
        argv += pop
        warm_argv += [str(warm_info) if a == flags["file_gen_info"] else a
                      for a in pop]
        dirs.append(d)
    if n_pop > 1:
        mig = " ".join(f"{x:g}" for r in mix["migration"] for x in r) + "\n"
        (root / "migration.txt").write_text(mig * gens)
        (root / "migration_warm.txt").write_text(mig * warm)
        extra = ["--gamma", f"{float(mix['gamma']):g}"]
        argv += ["--file_migration", str(root / "migration.txt"), *extra]
        warm_argv += ["--file_migration", str(root / "migration_warm.txt"),
                      *extra]
    if config.get("backend", "segment") != "segment":
        argv += ["--backend", config["backend"]]
        warm_argv += ["--backend", config["backend"]]
    size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    return Inputs(argv=argv, warm_argv=warm_argv, pop_dirs=dirs,
                  generations=gens, bytes_written=size)
