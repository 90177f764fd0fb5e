"""The byte dense engine in PyTorch (counterpart of
geneevolve_tpu/dense/step.py).

One call of `make_step`'s step advances the whole population one
generation:

  1. additive phenotype from the CV columns (gather + (n, ncv) @ (ncv,)),
  2. selection-weighted random mating (categorical over parents),
  3. per-(gamete, chromosome) Poisson crossover sampling,
  4. meiosis: `childA[c, l] = father_planes[phase(l)][f_c, l]` with
     `phase(l) = (start[chr(l)] + #crossovers <= l in chr) & 1`
     (`ops/meiose_planes`: the CUDA kernel on the card, `_meiose_xla` on
     the CPU),
  5. de novo mutation XOR at Poisson-sampled loci.

State: the two chromatids of every individual in two (n, m) uint8 planes,
`hapA` (paternally inherited) and `hapB` (maternally inherited).

Draws come from one `torch.Generator`, in a fixed order: parents, the
paternal plan, the maternal plan, the paternal mutations, the maternal
mutations. The packed step (`dense/packed.py`) draws the same numbers in
the same order, so the two steps driven from identically seeded generators
give the same genomes. Torch's generators give other numbers than
`jax.random`: the two packages agree in law, and bit for bit only when
both are fed the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DenseConfig:
    n: int  # individuals per generation
    m: int  # loci
    n_chr: int = 1
    morgans_per_chr: float = 1.0
    xo_cap: int = 16  # per gamete per chromosome
    mut_rate: float = 0.0  # expected de novo mutations per gamete (genome)
    mut_cap: int = 8
    ncv: int = 128
    selection: bool = False  # weight parents by a logistic of phenotype

    @property
    def chr_len(self) -> int:
        return self.m // self.n_chr


def _random_plane(gen: torch.Generator, thresh: torch.Tensor, rows: int,
                  m: int) -> torch.Tensor:
    """(rows, m) uint8 Bernoulli(thresh/256) plane, drawn in row chunks of
    ~256 MB of random bytes so the peak stays ~1x the plane."""
    out = torch.empty((rows, m), dtype=torch.uint8, device=thresh.device)
    chunk = max(1, min(rows, (1 << 28) // max(m, 1)))
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        bits = torch.randint(0, 256, (r1 - r0, m), dtype=torch.uint8,
                             generator=gen, device=thresh.device)
        out[r0:r1] = bits < thresh[None, :]
    return out


def cv_columns(m: int, ncv: int, device) -> torch.Tensor:
    """(ncv,) int32 CV loci spread evenly over the genome."""
    return torch.linspace(0, m - 1, ncv, dtype=torch.float64,
                          device=device).to(torch.int32)


def locus_thresholds(gen: torch.Generator, m: int, maf_min: float):
    """(m,) uint8 per-locus allele-frequency thresholds, frequencies uniform
    in [maf_min, 1 - maf_min] (thresholded random bytes, not uniforms)."""
    u = torch.rand(m, generator=gen, device=gen.device)
    return (u * (1.0 - 2.0 * maf_min) + maf_min).mul(256.0).to(torch.uint8)


def init_state(gen: torch.Generator, cfg: DenseConfig, maf_min: float = 0.05):
    """Founder chromatid planes with loci-specific allele frequencies, plus
    CV columns/effects for the phenotype path, on `gen`'s device."""
    thresh = locus_thresholds(gen, cfg.m, maf_min)
    hapA = _random_plane(gen, thresh, cfg.n, cfg.m)
    hapB = _random_plane(gen, thresh, cfg.n, cfg.m)
    return {
        "hapA": hapA,
        "hapB": hapB,
        "cv_idx": cv_columns(cfg.m, cfg.ncv, gen.device),
        "eff": torch.randn(cfg.ncv, generator=gen, device=gen.device),
        "clip": torch.zeros((), dtype=torch.int64, device=gen.device),
    }


def _phase_batch(xo: torch.Tensor, start: torch.Tensor, m: int,
                 n_chr: int) -> torch.Tensor:
    """(n, m) int8 phase per locus: scatter the crossovers into an
    indicator (pad slots land in a dropped column m), cumsum within each
    chromosome, add the chromosome's start chromatid, take parity. int8
    throughout, as the JAX version, so the peak is a few bytes per locus."""
    n = xo.shape[0]
    cols = xo.reshape(n, -1).long()
    cols = torch.where((cols < 0) | (cols >= m), m, cols)
    ind = torch.zeros((n, m + 1), dtype=torch.int8, device=xo.device)
    ind.scatter_add_(1, cols, torch.ones_like(cols, dtype=torch.int8))
    per_chr = ind[:, :m].reshape(n, n_chr, m // n_chr)
    cnt = torch.cumsum(per_chr, 2, dtype=torch.int8)
    del ind, per_chr
    cnt += start[:, :, None].to(torch.int8)
    return cnt.remainder_(2).reshape(n, m)


def _sample_gamete_plan(gen: torch.Generator, cfg: DenseConfig, n: int,
                        cdf=None):
    """Per-chromosome crossover columns (n, n_chr, K) int32 — real slots
    first and unsorted, pad = m — plus per-chromosome start chromatids
    (n, n_chr) int32 and the count of Poisson draws truncated at the cap K
    (a 0-d tensor).

    With `cdf` (an (m,) monotone f32 array of cumulative Morgans at each
    column), counts are Poisson in each chromosome's map mass and positions
    follow the map by inverse CDF (`searchsorted`, side left;
    `ras_sim_loc_rec` semantics, `Simulation.cpp:2973-2995`); without it
    the map is uniform with `morgans_per_chr` per chromosome."""
    dev = gen.device
    K, nc, L = cfg.xo_cap, cfg.n_chr, cfg.chr_len
    if cdf is None:
        lam = torch.full((n, nc), float(cfg.morgans_per_chr), device=dev)
        raw = torch.poisson(lam, generator=gen)
        u = torch.rand((n, nc, K), generator=gen, device=dev)
        base = (torch.arange(nc, device=dev, dtype=torch.int32) * L)
        pos = base[None, :, None] + (u * L).to(torch.int32)
    else:
        hi = cdf[(torch.arange(nc, device=dev) + 1) * L - 1]
        lo = torch.cat([hi.new_zeros(1), hi[:-1]])
        lam = hi - lo  # (n_chr,) Morgans per chromosome
        raw = torch.poisson(lam[None, :].expand(n, nc).contiguous(),
                            generator=gen)
        u = torch.rand((n, nc, K), generator=gen, device=dev,
                       dtype=cdf.dtype)
        u = lo[None, :, None] + u * lam[None, :, None]
        pos = torch.searchsorted(cdf, u.reshape(n, -1)).reshape(
            n, nc, K).to(torch.int32)
    slot = torch.arange(K, device=dev)
    xo = torch.where(slot[None, None, :] < raw.clamp(max=K)[..., None], pos,
                     cfg.m).to(torch.int32)
    start = torch.randint(0, 2, (n, nc), generator=gen, device=dev,
                          dtype=torch.int32)
    # cap-sizing honesty: truncated Poisson draws are counted, not hidden
    return xo, start, (raw > K).sum()


def _meiose_xla(hapA, hapB, parent, xo, start, cfg: DenseConfig):
    """(n_child, m) uint8 gametes: gather both parent planes, select by
    phase (the plain version of the byte meiosis kernel)."""
    phase = _phase_batch(xo, start, cfg.m, cfg.n_chr)
    p = parent.long()
    return torch.where(phase == 0, hapA[p], hapB[p])


def _mutation_draws(gen: torch.Generator, n: int, cfg: DenseConfig):
    """((n, mut_cap) int32 loci, (n, mut_cap) bool real-slot mask, count of
    Poisson draws truncated at mut_cap): the draws of both engines'
    mutation steps."""
    dev = gen.device
    raw = torch.poisson(torch.full((n,), float(cfg.mut_rate), device=dev),
                        generator=gen)
    pos = torch.randint(0, cfg.m, (n, cfg.mut_cap), generator=gen,
                        device=dev, dtype=torch.int32)
    slot = torch.arange(cfg.mut_cap, device=dev)
    valid = slot[None, :] < raw.clamp(max=cfg.mut_cap)[:, None]
    return pos, valid, (raw > cfg.mut_cap).sum()


def flip_loci(gametes: torch.Tensor, pos: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """XOR the real slots (`valid`) of the (n, Km) de novo mutation loci
    `pos` into the (n, m) uint8 gametes, in place, one slot column at a time
    (rows are distinct within a column). Per occurrence: a locus drawn
    twice flips twice and cancels (`Simulation.cpp:1218-1222`)."""
    rows = torch.arange(gametes.shape[0], device=gametes.device)
    for k in range(pos.shape[1]):
        col = pos[:, k].long()
        gametes[rows, col] ^= valid[:, k].to(torch.uint8)
    return gametes


def phenotype_additive(hapA, hapB, cv_idx, eff):
    """Breeding values via the generation-recomputed-frequency alpha model
    (`Simulation.cpp:2647-2711`, additive-only)."""
    ci = cv_idx.long()
    t = (hapA[:, ci] + hapB[:, ci]).to(torch.float32)  # (n, ncv)
    p = t.mean(0) / 2.0
    return (t - 2.0 * p[None, :]) @ eff


def selection_logits(bv: torch.Tensor) -> torch.Tensor:
    """Standardized breeding values: the categorical parent law's logits."""
    return (bv - bv.mean()) / (bv.std(correction=0) + 1e-9)


def _categorical(gen: torch.Generator, w: torch.Tensor, n: int):
    """n draws of the categorical law of weights `w` (summing to ~1), by
    inverse CDF over an int64 fixed-point CDF (2^-40 steps). An integer
    prefix sum is exact in any order, so the draws are a function of the
    generator alone; a float prefix sum on CUDA (`torch.multinomial` takes
    one over a single distribution) may round in an order that varies from
    run to run, and a resumed run could then pick other parents."""
    cdf = torch.cumsum(torch.round(w.double() * 2.0**40).long(), 0)
    u = torch.rand(n, generator=gen, device=w.device, dtype=torch.float64)
    pick = torch.searchsorted(cdf, (u * cdf[-1]).long(), right=True)
    return pick.clamp_(max=w.shape[0] - 1)


def draw_parents(gen: torch.Generator, n: int, n_par: int, logits=None):
    """(fathers, mothers) int32 parent rows: categorical over `logits`
    (`_categorical` of their softmax), or uniform when there are none."""
    if logits is not None:
        w = torch.softmax(logits, 0)
        f = _categorical(gen, w, n)
        m = _categorical(gen, w, n)
    else:
        f = torch.randint(0, n_par, (n,), generator=gen, device=gen.device)
        m = torch.randint(0, n_par, (n,), generator=gen, device=gen.device)
    return f.to(torch.int32), m.to(torch.int32)


def draw_generation(gen: torch.Generator, cfg: DenseConfig, n_par: int,
                    logits=None, xo_cdf=None) -> dict:
    """Every draw of one byte-step generation, in the step's order: the
    parents, the paternal and maternal plans, then (with mutations) the
    paternal and maternal gametes' mutation loci and real-slot masks
    (`mut`: ((pos, valid), (pos, valid)) or None), and the count of Poisson
    draws truncated at their caps."""
    fathers, mothers = draw_parents(gen, cfg.n, n_par, logits)
    xo_p, st_p, clip_p = _sample_gamete_plan(gen, cfg, cfg.n, xo_cdf)
    xo_m, st_m, clip_m = _sample_gamete_plan(gen, cfg, cfg.n, xo_cdf)
    clip, mut = clip_p + clip_m, None
    if cfg.mut_rate > 0:
        a, b = (_mutation_draws(gen, cfg.n, cfg) for _ in range(2))
        mut = (a[:2], b[:2])
        clip = clip + a[2] + b[2]
    return dict(fathers=fathers, mothers=mothers, xo_p=xo_p, st_p=st_p,
                xo_m=xo_m, st_m=st_m, mut=mut, clip=clip)


def make_step(cfg: DenseConfig, xo_cdf=None):
    """Returns step(state, gen) -> state. `xo_cdf`: optional (m,)
    cumulative-Morgans-per-column array for map-aware crossovers."""
    from geneevolve_tpu_torch.ops.meiose_planes import meiose_planes

    def step(state, gen: torch.Generator):
        hapA, hapB = state["hapA"], state["hapB"]
        logits = None
        if cfg.selection:
            logits = selection_logits(
                phenotype_additive(hapA, hapB, state["cv_idx"], state["eff"])
            )
        d = draw_generation(gen, cfg, hapA.shape[0], logits, xo_cdf)
        childA, childB = meiose_planes(
            hapA, hapB, d["fathers"], d["mothers"], d["xo_p"], d["st_p"],
            d["xo_m"], d["st_m"], n_chr=cfg.n_chr)
        if d["mut"] is not None:
            childA = flip_loci(childA, *d["mut"][0])
            childB = flip_loci(childB, *d["mut"][1])
        return {
            "hapA": childA,
            "hapB": childB,
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            "clip": state["clip"] + d["clip"],
        }

    return step
