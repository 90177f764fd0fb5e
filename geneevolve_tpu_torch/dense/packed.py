"""The bit-packed dense engine in PyTorch: 32 loci per word (counterpart of
geneevolve_tpu/dense/packed.py).

The haplotype planes pack into one `(n, 2, mw)` array with `mw = m / 32`:
locus l lives in word `l >> 5`, bit `l & 31`, LSB-first; plane 0/1 =
chromatid A/B. Words are held as `torch.int32`, never `torch.uint32`
(shifts and compares on uint32 are missing from torch's CPU kernels): the
bit patterns are the JAX package's uint32 words, and `.view(np.int32)` /
`.view(np.uint32)` carry them across. An arithmetic `>>` followed by `& 1`
still reads a bit, and `-1 << s` is the boundary-word mask.

The crossover phase is a word mask: parity-of-count is XOR of
per-crossover indicators, and the indicator of "locus >= xo" restricted to
one chromosome is, per word w,

    mask_k[w] = ~0                  if w >  xo >> 5
              = ~0 << (xo & 31)     if w == xo >> 5     (boundary word)
              = 0                   otherwise

so `phase = (start ? ~0 : 0) ^ XOR_k mask_k` and the gamete is
`A ^ (phase & (A ^ B))`; de novo mutations XOR single bits. On the card
`make_reproduce` runs all of it as one kernel (`ops/meiose_packed`).
Reference semantics: `recombine` + `ras_sim_loc_rec` + `ras_add_mutation`
(`Simulation.cpp:2903-2995, 2497-2552`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from geneevolve_tpu_torch.dense import step as dense_step
from geneevolve_tpu_torch.dense.step import DenseConfig
from geneevolve_tpu_torch.ops.materialize import gather_rows

FULL = -1  # all 32 bits of an int32 word


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) 0/1 -> (..., m/32) int32 words, LSB-first. Bit 31 is set by
    an int32 shift, never by an int64 -> int32 cast."""
    m = bits.shape[-1]
    if m % 32:
        raise ValueError(f"pack_bits: {m} loci are not a multiple of 32")
    b = bits.reshape(*bits.shape[:-1], m // 32, 32)
    w = torch.zeros(b.shape[:-1], dtype=torch.int32, device=bits.device)
    for i in range(32):
        w |= b[..., i].to(torch.int32) << i
    return w


def unpack_bits(packed: torch.Tensor, m: int) -> torch.Tensor:
    """(..., mw) int32 -> (..., m) 0/1 uint8."""
    sh = torch.arange(32, dtype=torch.int32, device=packed.device)
    w = (packed[..., None] >> sh) & 1
    return w.reshape(*packed.shape[:-1], packed.shape[-1] * 32)[
        ..., :m
    ].to(torch.uint8)


@dataclass(frozen=True)
class PackedConfig:
    n: int
    m: int  # loci; must be divisible by 32*n_chr
    n_chr: int = 1
    morgans_per_chr: float = 1.0
    xo_cap: int = 16
    mut_rate: float = 0.0
    mut_cap: int = 8
    ncv: int = 128
    selection: bool = False
    couples: bool = False  # couple-structured mating: n//2 couples,
    # multinomial children SORTED by couple (the reference's household law,
    # `Simulation.cpp:2329-2355`)

    @property
    def chr_len(self) -> int:
        return self.m // self.n_chr

    @property
    def mw(self) -> int:
        return self.m // 32

    def as_dense(self) -> DenseConfig:
        return DenseConfig(
            n=self.n, m=self.m, n_chr=self.n_chr,
            morgans_per_chr=self.morgans_per_chr, xo_cap=self.xo_cap,
            mut_rate=self.mut_rate, mut_cap=self.mut_cap, ncv=self.ncv,
            selection=self.selection,
        )


def init_state(gen: torch.Generator, cfg: PackedConfig,
               maf_min: float = 0.05):
    """Packed founder planes + CV columns/effects: the byte engine's
    `init_state`, packed, so both engines start from the same founders."""
    if cfg.chr_len % 32 or cfg.n_chr * cfg.chr_len != cfg.m:
        raise ValueError("packed chromosomes must hold a multiple of 32 loci")
    st = dense_step.init_state(gen, cfg.as_dense(), maf_min)
    hap = torch.stack([pack_bits(st["hapA"]), pack_bits(st["hapB"])], 1)
    return {
        "hap": hap,
        "cv": cv_from_planes(hap, st["cv_idx"]),
        "cv_idx": st["cv_idx"],
        "eff": st["eff"],
        "clip": st["clip"],
    }


def cv_from_planes(hap: torch.Tensor, cv_idx: torch.Tensor) -> torch.Tensor:
    """(n, 2, ncv) uint8 CV alleles read from the packed planes — used at
    init and as the oracle of the resident matrix the step maintains."""
    return torch.stack([popcount_dosage(hap[:, 0], cv_idx),
                        popcount_dosage(hap[:, 1], cv_idx)], 1)


def init_state_streamed(gen: torch.Generator, cfg: PackedConfig,
                        maf_min: float = 0.05, chunk_loci: int = 1 << 15):
    """Packed founder planes drawn chunk by chunk over loci, so the peak is
    one (n, chunk) byte buffer beside the packed output — never the (n, m)
    byte planes. Same per-locus allele-frequency law as `init_state`, a
    different stream of bits."""
    while cfg.m % chunk_loci or chunk_loci % 32:
        chunk_loci //= 2
        if chunk_loci < 32:
            raise ValueError("m must be a multiple of 32")
    dev = gen.device
    thresh = dense_step.locus_thresholds(gen, cfg.m, maf_min)
    hap = torch.empty((cfg.n, 2, cfg.mw), dtype=torch.int32, device=dev)
    for plane in (0, 1):
        for c0 in range(0, cfg.m, chunk_loci):
            b = torch.randint(0, 256, (cfg.n, chunk_loci), dtype=torch.uint8,
                              generator=gen, device=dev)
            hap[:, plane, c0 // 32:(c0 + chunk_loci) // 32] = pack_bits(
                b < thresh[None, c0:c0 + chunk_loci])
    cv_idx = dense_step.cv_columns(cfg.m, cfg.ncv, dev)
    return {
        "hap": hap,
        "cv": cv_from_planes(hap, cv_idx),
        "cv_idx": cv_idx,
        "eff": torch.randn(cfg.ncv, generator=gen, device=dev),
        "clip": torch.zeros((), dtype=torch.int64, device=dev),
    }


def phase_word_masks(xo: torch.Tensor, start: torch.Tensor,
                     cfg: PackedConfig) -> torch.Tensor:
    """(n, mw) int32 phase mask per gamete: bit set -> take chromatid B.
    xo: (n, n_chr, K) crossover loci (global columns, pad = m); start:
    (n, n_chr). Every slot is XORed in; padding contributes zero."""
    n, n_chr, K = xo.shape
    cw = cfg.chr_len // 32
    dev = xo.device
    cols = torch.arange(cw, dtype=torch.int32, device=dev)[None, None, :]
    chr_base = (torch.arange(n_chr, dtype=torch.int32, device=dev)
                * cfg.chr_len)[None, :, None]
    mask = -(start[:, :, None] & 1).to(torch.int32)
    mask = mask.expand(n, n_chr, cw).contiguous()
    for k in range(K):
        x = xo[:, :, k:k + 1] - chr_base  # local locus; pad -> past the end
        xw = x >> 5
        partial = torch.full_like(x, FULL) << (x & 31)
        mask ^= -(cols > xw).to(torch.int32) | (
            partial & -(cols == xw).to(torch.int32))
    return mask.reshape(n, cfg.mw)


def apply_mutations_packed(child: torch.Tensor,
                           pos: torch.Tensor) -> torch.Tensor:
    """XOR single-bit flips at loci `pos` ((n, Km) int32, pad = m) into
    packed rows (n, mw), as a full-plane XOR-mask pass. Repeated draws flip
    twice and cancel (per-occurrence semantics,
    `Simulation.cpp:1218-1222`)."""
    n, mw = child.shape
    cols = torch.arange(mw, dtype=torch.int32, device=child.device)[None, :]
    hit = torch.zeros((n, mw), dtype=torch.int32, device=child.device)
    for k in range(pos.shape[1]):
        p = pos[:, k:k + 1]
        bit = torch.ones_like(p) << (p & 31)
        hit ^= bit & -(cols == (p >> 5)).to(torch.int32)
    return child ^ hit


def meiose_words_xla(hapA, hapB, parent, xo, start, cfg: PackedConfig):
    """(n_child, mw) packed gametes from split parent planes (N, mw)."""
    mask = phase_word_masks(xo, start, cfg)
    p = parent.long()
    a = hapA[p]
    b = hapB[p]
    return a ^ (mask & (a ^ b))


def meiose_packed_xla(hap, parent, xo, start, cfg: PackedConfig):
    """(n_child, mw) packed gametes from parent planes (N, 2, mw)."""
    return meiose_words_xla(hap[:, 0], hap[:, 1], parent, xo, start, cfg)


def mutation_positions(gen: torch.Generator, n: int, cfg: PackedConfig):
    """(n, mut_cap) int32 de novo mutation loci, pad = m, plus the count of
    Poisson draws truncated at mut_cap. The byte engine's
    `draw_generation` draws the same numbers, so both engines flip the
    same loci."""
    pos, valid, clip = dense_step._mutation_draws(gen, n, cfg.as_dense())
    return torch.where(valid, pos, cfg.m).to(torch.int32), clip


def popcount_dosage(packed: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """0/1 alleles (uint8) at loci `idx` of packed word rows (..., mw): a
    scattered single-word column gather, used at init and as an oracle,
    never per generation (the step keeps the CV matrix resident)."""
    word = packed[..., (idx >> 5).long()]
    return ((word >> (idx & 31)) & 1).to(torch.uint8)


def cv_child(
    cv_par: torch.Tensor,  # (N, 2, ncv) uint8 parent CV alleles
    parent: torch.Tensor,  # (n,) int32 parent rows for this gamete
    xo: torch.Tensor,  # (n, n_chr, K) crossover loci (global, pad = m)
    start: torch.Tensor,  # (n, n_chr) start chromatid
    mu,  # (n, Km) de novo mutation loci of this gamete (pad = m) | None
    cv_idx: torch.Tensor,  # (ncv,) int32 global CV columns
    chr_len: int,
) -> torch.Tensor:
    """(n, ncv) uint8 gamete CV alleles — the packed meiosis law restricted
    to the CV columns: phase = (start + #{xo <= l}) & 1 over the CV's own
    chromosome, mutations flip per occurrence. The parent rows are read by
    the `gather_rows` kernel on the card; the counts loop over slots so no
    (n, ncv, K) tensor is built."""
    c_of = (cv_idx // chr_len).long()  # (ncv,) chromosome of each CV
    rows = gather_rows(cv_par, parent)  # (n, 2, ncv)
    cnt = torch.zeros((parent.shape[0], cv_idx.shape[0]), dtype=torch.int32,
                      device=cv_par.device)
    for k in range(xo.shape[2]):
        cnt += xo[:, c_of, k] <= cv_idx[None, :]
    phase = (start[:, c_of] + cnt) & 1
    child = torch.where(phase == 0, rows[:, 0], rows[:, 1])
    if mu is not None:
        flips = torch.zeros_like(child, dtype=torch.bool)
        for k in range(mu.shape[1]):
            flips ^= mu[:, k:k + 1] == cv_idx[None, :]
        child = child ^ flips.to(torch.uint8)
    return child


def phenotype_from_cv(cv, eff):
    """Breeding values from the resident (n, 2, ncv) CV matrix, with
    per-generation allele-frequency centering (`Simulation.cpp:2647-2711`,
    additive-only)."""
    t = (cv[:, 0] + cv[:, 1]).to(torch.float32)
    p = t.mean(0) / 2.0
    return (t - 2.0 * p[None, :]) @ eff


def make_reproduce(cfg: PackedConfig):
    """reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu) ->
    (n, 2, mw) child planes, mutations (mu: (n, 2, Km) loci or None) fused:
    the `meiose_packed` kernel on the card, its plain version on the CPU."""
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed

    def reproduce(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu=None):
        return meiose_packed(hap, fathers, mothers, xo_p, st_p, xo_m, st_m,
                             mu, n_chr=cfg.n_chr, chr_len=cfg.chr_len)

    return reproduce


def make_step(cfg: PackedConfig, xo_cdf=None):
    """Packed generation step, step(state, gen) -> state; the byte
    engine's law (`dense/step.py:make_step`), bit-identical after
    unpacking when driven from identically seeded generators (with
    `couples` off: the household draw has no byte-engine counterpart).
    xo_cdf: optional (m,) cumulative-Morgans array for map-aware
    crossovers."""
    reproduce = make_reproduce(cfg)

    def step(state, gen: torch.Generator):
        hap = state["hap"]
        d = draw_generation(gen, cfg, state["cv"], state["eff"],
                            hap.shape[0], xo_cdf)
        child = reproduce(hap, d["fathers"], d["mothers"], d["xo_p"],
                          d["st_p"], d["xo_m"], d["st_m"], d["mu"])
        # the resident CV matrix advances through the SAME meiosis law:
        # no genome-plane traffic for the phenotype path
        return {
            "hap": child,
            "cv": cv_children(state["cv"], d, state["cv_idx"], cfg.chr_len),
            "cv_idx": state["cv_idx"],
            "eff": state["eff"],
            "clip": state["clip"] + d["clip"],
        }

    return step


def draw_generation(gen: torch.Generator, cfg: PackedConfig, cv, eff,
                    n_par: int, xo_cdf=None) -> dict:
    """Every draw of one packed-step generation, in the step's order: the
    parents (by selection on the (n_par, 2, ncv) CV matrix `cv`, when
    configured; then the household draw under `couples`), the paternal and
    maternal plans, the paternal and maternal mutation loci (`mu`: (n, 2,
    Km), or None), and the count of Poisson draws truncated at their
    caps."""
    n, dense_cfg = cfg.n, cfg.as_dense()
    logits = None
    if cfg.selection:
        logits = dense_step.selection_logits(phenotype_from_cv(cv, eff))
    fathers, mothers = dense_step.draw_parents(gen, n, n_par, logits)
    if cfg.couples:
        # households: the first n//2 draws act as the couple pool and
        # children land multinomially, sorted so siblings are adjacent
        c = max(n // 2, 1)
        cc = torch.randint(0, c, (n,), generator=gen,
                           device=gen.device).sort().values
        fathers, mothers = fathers[cc], mothers[cc]
    xo_p, st_p, clip_p = dense_step._sample_gamete_plan(gen, dense_cfg, n,
                                                        xo_cdf)
    xo_m, st_m, clip_m = dense_step._sample_gamete_plan(gen, dense_cfg, n,
                                                        xo_cdf)
    clip, mu = clip_p + clip_m, None
    if cfg.mut_rate > 0:
        mu_a, clip_a = mutation_positions(gen, n, cfg)
        mu_b, clip_b = mutation_positions(gen, n, cfg)
        mu = torch.stack([mu_a, mu_b], 1)
        clip = clip + clip_a + clip_b
    return dict(fathers=fathers, mothers=mothers, xo_p=xo_p, st_p=st_p,
                xo_m=xo_m, st_m=st_m, mu=mu, clip=clip)


def cv_children(cv, d: dict, cv_idx, chr_len: int) -> torch.Tensor:
    """(n, 2, ncv) children's CV alleles from the parents' (N, 2, ncv) and
    one generation's draws `d` (`draw_generation`'s keys)."""
    mu = d["mu"]
    return torch.stack([
        cv_child(cv, d["fathers"], d["xo_p"], d["st_p"],
                 None if mu is None else mu[:, 0], cv_idx, chr_len),
        cv_child(cv, d["mothers"], d["xo_m"], d["st_m"],
                 None if mu is None else mu[:, 1], cv_idx, chr_len),
    ], 1)
