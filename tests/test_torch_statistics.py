"""Whole runs of the port's own samplers held to population-genetics theory:
the single-population checks of `tests/test_statistics.py`, at its sizes
and with its tolerances, on `geneevolve_tpu_torch` (CPU torch, the
kernels' plain versions). Heterozygosity decay under drift, unbiased
allele frequencies, directional selection shifting the phenotype, the
neutral run and LD preservation run on the byte dense step
(`dense.step`) from one seeded `torch.Generator`; var(A) growth under
assortative mating runs the port's segment `Simulation`, and couple
correlation its host `assort_mate`. Torch's generators draw other numbers
than `jax.random`, so these compare laws, not bits; every run is seeded
and gives the same numbers each time."""

import numpy as np
import torch

from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core.engine import Simulation
from geneevolve_tpu_torch.core.mating import assort_mate
from geneevolve_tpu_torch.dense.step import (DenseConfig, init_state,
                                             make_step)

torch.set_num_threads(1)


def _evolve(cfg, state, seed, gens):
    step = make_step(cfg)
    g = torch.Generator().manual_seed(seed)
    for _ in range(gens):
        state = step(state, g)
    return state


def _freq(state):
    t = state["hapA"].float() + state["hapB"].float()
    return (t.mean(0) / 2.0).numpy()


def _het(state):
    """Mean expected heterozygosity 2p(1-p) over loci."""
    p = _freq(state)
    return float(np.mean(2 * p * (1 - p)))


def _dosage_value(s):
    """Un-centered genetic value: a selection response shows in the mean."""
    ci = s["cv_idx"].long()
    t = (s["hapA"][:, ci] + s["hapB"][:, ci]).float()
    return float((t @ s["eff"]).mean())


def test_heterozygosity_decay_under_drift():
    """h(t) = (1 - 1/2N)^t h(0) under pure drift (PDF Table 3.2)."""
    cfg = DenseConfig(n=50, m=4096, n_chr=4, morgans_per_chr=1.0, xo_cap=8)
    gens = 30
    reps = []
    for r in range(4):
        state = init_state(torch.Generator().manual_seed(r), cfg)
        h0 = _het(state)
        out = _evolve(cfg, state, 100 + r, gens)
        reps.append(_het(out) / h0)
    got = float(np.mean(reps))
    want = (1 - 1 / (2 * cfg.n)) ** gens
    assert abs(got - want) < 0.06, (got, want)


def test_allele_frequency_unbiased():
    """Drift is unbiased: E[p_t] = p_0 (PDF §3.2). With many loci the mean
    frequency shift is ~0."""
    cfg = DenseConfig(n=200, m=8192, n_chr=4)
    state = init_state(torch.Generator().manual_seed(1), cfg)
    p0 = _freq(state)
    p1 = _freq(_evolve(cfg, state, 2, 10))
    assert abs(float(np.mean(p1 - p0))) < 0.01


def test_directional_selection_shifts_phenotype():
    """Logistic selection on the phenotype raises the mean breeding value."""
    cfg = DenseConfig(n=256, m=4096, n_chr=4, ncv=64, selection=True)
    state = init_state(torch.Generator().manual_seed(3), cfg)
    v0 = _dosage_value(state)
    v1 = _dosage_value(_evolve(cfg, state, 4, 8))
    assert v1 > v0 + 0.5, (v0, v1)


def test_neutral_run_no_phenotype_shift():
    cfg = DenseConfig(n=256, m=4096, n_chr=4, ncv=64, selection=False)
    state = init_state(torch.Generator().manual_seed(3), cfg)
    v0 = _dosage_value(state)
    v1 = _dosage_value(_evolve(cfg, state, 4, 8))
    # drift-only: movement stays within a few SE of zero
    assert abs(v1 - v0) < 2.0, (v0, v1)


def _mosaic_founders(rng, cfg, n_anc=16, switches_per_chr=4.0):
    """Founder planes with realistic LD: each founder chromatid is a mosaic
    of a small ancestral haplotype pool (switch points ~ Poisson per
    chromosome), the standard way a real phased panel carries LD blocks."""
    freqs = rng.uniform(0.1, 0.9, size=cfg.m)
    anc = (rng.random((n_anc, cfg.m)) < freqs).astype(np.uint8)
    chr_len = cfg.chr_len
    planes = []
    for _ in range(2):
        plane = np.empty((cfg.n, cfg.m), dtype=np.uint8)
        for i in range(cfg.n):
            for c in range(cfg.n_chr):
                k = rng.poisson(switches_per_chr)
                cuts = np.sort(rng.integers(0, chr_len, size=k))
                bounds = np.concatenate([[0], cuts, [chr_len]])
                for b in range(len(bounds) - 1):
                    a = rng.integers(n_anc)
                    s, e = bounds[b] + c * chr_len, bounds[b + 1] + c * chr_len
                    plane[i, s:e] = anc[a, s:e]
        planes.append(torch.from_numpy(plane))
    return planes[0], planes[1]


def _adjacent_r2(hapA, hapB, n_chr):
    """r^2 between adjacent intra-chromosome columns over all 2n haplotypes,
    plus a keep mask for pairs polymorphic enough to estimate (MAF > 0.05)."""
    h = np.concatenate([hapA.numpy().astype(np.float64),
                        hapB.numpy().astype(np.float64)])
    m = h.shape[1]
    chr_len = m // n_chr
    p = h.mean(axis=0)
    cov = (h[:, :-1] * h[:, 1:]).mean(axis=0) - p[:-1] * p[1:]
    var = p * (1 - p)
    denom = var[:-1] * var[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(denom > 0, cov * cov / denom, 0.0)
    intra = (np.arange(m - 1) % chr_len) != chr_len - 1  # drop cross-chr pairs
    maf = np.minimum(p, 1 - p)
    return r2, intra & (maf[:-1] > 0.05) & (maf[1:] > 0.05)


def test_ld_preservation_over_generations():
    """LD (r^2) between tightly linked loci is preserved through 30
    generations of mating+recombination (PDF Table 3.3: corr between gen-0
    and gen-30 adjacent-pair r^2 ~= 0.994 at panel scale; drift at 2N=4096
    loosens that, hence the 0.85 floor)."""
    cfg = DenseConfig(n=2048, m=2048, n_chr=2, morgans_per_chr=1.0, xo_cap=8)
    hapA, hapB = _mosaic_founders(np.random.default_rng(7), cfg)
    state = {
        "hapA": hapA,
        "hapB": hapB,
        "cv_idx": torch.linspace(0, cfg.m - 1, cfg.ncv).to(torch.int32),
        "eff": torch.zeros(cfg.ncv),
        "clip": torch.zeros((), dtype=torch.int64),
    }
    r2_0, keep0 = _adjacent_r2(hapA, hapB, cfg.n_chr)
    out = _evolve(cfg, state, 8, 30)
    r2_t, keep_t = _adjacent_r2(out["hapA"], out["hapB"], cfg.n_chr)
    keep = keep0 & keep_t
    assert keep.sum() > 500  # enough informative pairs
    corr = float(np.corrcoef(r2_0[keep], r2_t[keep])[0, 1])
    assert corr > 0.85, corr
    # and no systematic collapse of LD level between tightly linked loci
    ratio = float(np.mean(r2_t[keep]) / np.mean(r2_0[keep]))
    assert 0.7 < ratio < 1.4, ratio


def test_var_a_growth_under_assortative_mating(tmp_path):
    """Assortative mating builds positive gametic-phase disequilibrium and
    inflates var(A) toward ~VA0/(1 - rho_A/2) with rho_A = r * h^2 (Fisher
    1918; PDF section 3.5 / Table 3.4 validates GeneEvolve the same way).
    With r=0.8 and h^2=0.8 the equilibrium ratio is ~1.47; random mating
    must stay flat. Runs the port's segment engine on the CPU."""
    root = tmp_path / "am"
    root.mkdir()
    rng = np.random.default_rng(11)
    n0, nsnp, ncv_chr, chrs, gens, pop = 300, 120, 40, [1, 2], 8, 600
    cv_rows = []
    for c in chrs:
        hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
        np.savetxt(root / f"ref.chr{c}.hap", hap, fmt="%d")
        pos = np.sort(rng.choice(np.arange(1_000_000, 50_000_000), nsnp, False))
        with open(root / f"ref.chr{c}.legend", "w") as f:
            f.write("id position a0 a1\n")
            for i, p in enumerate(pos):
                f.write(f"rs{c}_{i} {p} A G\n")
        with open(root / f"ref.chr{c}.indv", "w") as f:
            f.writelines(f"{i + 1}\n" for i in range(n0))
        cv_cols = np.sort(rng.choice(nsnp, ncv_chr, replace=False))
        np.savetxt(root / f"cv.chr{c}.hap", hap[cv_cols], fmt="%d")
        for i in cv_cols:
            cv_rows.append((c, pos[i], rng.normal(), 0.0))
    with open(root / "cv.info", "w") as f:
        f.write("chr pos a d\n")
        for c, p, a, d in cv_rows:
            f.write(f"{c} {p} {a} {d}\n")
    with open(root / "hap_address.txt", "w") as f:
        f.write("chr hap legend sample\n")
        for c in chrs:
            f.write(f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                    f"{root}/ref.chr{c}.indv\n")
    with open(root / "cv_address.txt", "w") as f:
        for c in chrs:
            f.write(f"{c} {root}/cv.chr{c}.hap\n")
    with open(root / "rmap.txt", "w") as f:
        f.write("chr bp cM\n")
        for c in chrs:
            for bp in range(0, 60_000_000, 500_000):
                f.write(f"{c} {bp} {bp / 1_000_000:.6f}\n")

    def run(mat_cor, outdir):
        outdir.mkdir()
        with open(root / f"popinfo_{mat_cor}.txt", "w") as f:
            f.write("pop_size mat_cor offspring_dist selection_func "
                    "selection_func_par1 selection_func_par2\n")
            for _ in range(gens):
                f.write(f"{pop} {mat_cor} p thr 1 1\n")
        cfg = parse_args([
            "--file_gen_info", str(root / f"popinfo_{mat_cor}.txt"),
            "--file_hap_name", str(root / "hap_address.txt"),
            "--file_recom_map", str(root / "rmap.txt"),
            "--file_cv_info", str(root / "cv.info"),
            "--file_cvs", str(root / "cv_address.txt"),
            "--va", "1.0", "--ve", "0.25",
            "--seed", "2024",
            "--prefix", str(outdir / "out"),
        ])
        Simulation(cfg, device="cpu", verbose=False).run()
        lines = (outdir / "out.pop1.summary").read_text().splitlines()
        col = lines[0].split().index("ph1_var_A")
        return np.array([float(l.split()[col]) for l in lines[1:]])

    va_am = run(0.8, tmp_path / "am_run")
    va_rm = run(0.0, tmp_path / "rm_run")
    ratio_am = float(np.mean(va_am[-3:]) / va_am[0])
    ratio_rm = float(np.mean(va_rm[-3:]) / va_rm[0])
    assert ratio_am > 1.15, (ratio_am, va_am)
    assert 0.75 < ratio_rm < 1.25, (ratio_rm, va_rm)
    assert ratio_am > ratio_rm + 0.1, (ratio_am, ratio_rm)


def test_assortative_mating_couple_correlation():
    """Rank-matching through an MVN(r) template yields couple mating-value
    correlation ~= r (reference `assort_mate`, Simulation.cpp:2257-2301)."""
    rng = np.random.default_rng(5)
    n = 4000
    mv = rng.normal(size=n)
    sex = rng.integers(1, 3, size=n)
    ped = {k: np.arange(n) for k in ("father", "ff", "fm", "mf", "mm")}
    for r_target in (0.0, 0.5, 0.9):
        plan = assort_mate(
            np.random.default_rng(6), mv, np.ones(n), sex, ped,
            r_target, 0.0, False, "p", n,
        )
        got = plan.couple_cor_mating_value(mv)
        assert abs(got - r_target) < 0.08, (r_target, got)
