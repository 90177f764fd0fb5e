"""One generation of GeneEvolve's forward simulation, in plain NumPy and
PyTorch: mating, meiosis over the IBD ledger, mutation inheritance, CV
alleles, A/D, phenotypes, gamma and migration (GeneEvolve documentation
v2.0.0, chapter 2; the semantics of `src/Simulation.cpp`).

A genome is held as each chromatid's ledger of segments: positions where a
segment starts (ascending, BIG-padded) and the founder haplotype it copies,
and the positions of its de novo mutations. The reference builds a child's
ledger as a function of position: at each candidate boundary (the
chromosome start, the crossovers, the parent chromatids' boundaries) the
founder haplotype of the chromatid the gamete copies there. `canonical`
reduces any ledger to the one form of a function (the last entry of equal
positions, and only where the haplotype changes), so ledgers are compared
as functions, whatever redundant boundaries either side keeps.

A state is a dict: `n`, `rows`, the planes `seg_st`, `seg_hap`, `mut`
((nchr, rows, 2, width) tensors) and the host fields `sex`, `ids`, `ped`,
`comp` (A D G C E F P), `mv`, `sv`, `svf`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from gebench.reference import law
from gebench.reference.law import BIG

CHUNK = 1 << 17  # gamete rows a meiosis pass takes at once

# GeneEvolve's phenotype defaults (`parameters.cpp:153-209`): the effects as
# given, unique environment 1, no common or familial environment
VA, VD, VC, VE, VF = -1.0, -1.0, 0.0, 1.0, 0.0
OMEGA, LAMBDA = 1.0, 1.0


def canonical(st: torch.Tensor, hap: torch.Tensor):
    """(positions, haplotypes) of the ledger rows (N, S) in canonical form,
    BIG / -1 padded to the widest row: the last entry of equal positions,
    kept only where its haplotype differs from the entry before."""
    N, S = st.shape
    valid = st < BIG
    same_next = torch.zeros_like(valid)
    same_next[:, :-1] = st[:, 1:] == st[:, :-1]
    keep = valid & ~same_next
    idx = torch.where(keep, torch.arange(S, device=st.device), -1)
    prev = torch.cummax(idx, dim=1).values
    prev = torch.cat([torch.full_like(prev[:, :1], -1), prev[:, :-1]], 1)
    hap = hap.long()
    before = hap.gather(1, prev.clamp(min=0))
    keep &= ~((prev >= 0) & (hap == before))
    key = torch.where(keep, st, BIG)
    order = torch.sort(key, dim=1, stable=True).indices
    w = max(int(keep.sum(1).max()) if N else 1, 1)
    order = order[:, :w]
    pos = key.gather(1, order)
    return pos, torch.where(pos < BIG, hap.gather(1, order), -1)


def hap_at(st: torch.Tensor, hap: torch.Tensor, q: torch.Tensor):
    """The founder haplotype each ledger row (N, S) copies at q (N, Q)."""
    i = torch.searchsorted(st.contiguous(), q.contiguous(), right=True) - 1
    got = hap.long().gather(1, i.clamp(min=0))
    return torch.where(i >= 0, got, 0)


def copied(xo: torch.Tensor, start: torch.Tensor, q: torch.Tensor):
    """(N, Q) the parent chromatid (0/1) a gamete copies at q: its start
    chromatid, switched at every crossover at or before q."""
    xs = torch.sort(xo, dim=1).values
    c = torch.searchsorted(xs, q.contiguous(), right=True)
    return (start.long()[:, None] + c) % 2


def gamete(p_st, p_hap, p_mut, xo, start, new):
    """One gamete a row from its parent's rows: (canonical positions,
    haplotypes, sorted BIG-padded mutations). p_st, p_hap (N, 2, S),
    p_mut (N, 2, M), xo (N, K), start (N,), new (N, m)."""
    a, b = p_st[:, 0], p_st[:, 1]
    cand = torch.cat([a[:, :1], xo, a[:, 1:], b[:, 1:]], 1)
    which = copied(xo, start, cand)
    h = torch.where(which == 0, hap_at(a, p_hap[:, 0], cand),
                    hap_at(b, p_hap[:, 1], cand))
    key = torch.where(cand < BIG, cand, BIG)
    order = torch.sort(key, dim=1).indices
    pos, hp = canonical(key.gather(1, order), h.gather(1, order))
    m0, m1 = p_mut[:, 0], p_mut[:, 1]
    k0 = torch.where((m0 < BIG) & (copied(xo, start, m0) == 0), m0, BIG)
    k1 = torch.where((m1 < BIG) & (copied(xo, start, m1) == 1), m1, BIG)
    s = torch.sort(torch.cat([k0, k1, new.to(torch.int32)], 1), 1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = (s[:, 1:] == s[:, :-1])
    s = torch.sort(torch.where(dup, BIG, s), 1).values
    return pos, hp, s


def _cat_padded(parts, value):
    w = max(p.shape[1] for p in parts)
    return torch.cat([torch.nn.functional.pad(p, (0, w - p.shape[1]),
                                              value=value) for p in parts])


def cv_alleles(pos, hap, mut, founder, q):
    """(N, C) alleles at the CV positions q (C,) of chromatids given as
    canonical ledgers and mutations: the founder haplotype's allele, flipped
    where the chromatid carries a de novo mutation (membership)."""
    qq = q[None, :].expand(pos.shape[0], -1)
    h = hap_at(pos, hap, qq)
    allele = founder[h, torch.arange(q.shape[0], device=q.device)[None, :]]
    ms = torch.sort(mut, 1).values
    i = torch.searchsorted(ms, qq.contiguous())
    hit = ms.gather(1, i.clamp(max=ms.shape[1] - 1)) == qq
    return allele ^ (hit & (i < ms.shape[1]) & (qq < BIG)).to(torch.uint8)


def meiosis(parents: dict, plan_f, plan_m, m: law.Maps, seed: int,
            gen: int, pop: int, n_child: int, n_pad: int, device):
    """Every chromosome's children of one population, [(pos (n, 2, w), hap,
    mut (n, 2, w'))] a chromosome: each child's gamete of its father and of
    its mother, drawn for the `n_pad` rows the program's planes hold; and
    the mutation slots the program's probe reserves for them: over the
    `n_pad` rows (a padding row's parents are row 0), the most of a
    parent's mutations on both its chromatids, plus the row's new ones."""
    out, mut_need = [], 0
    pad = torch.zeros(n_pad - n_child, dtype=plan_f.dtype, device=device)
    for ci in range(parents["seg_st"].shape[0]):
        d = law.draws(m, seed, gen, pop, ci, n_pad, device)
        held = (parents["mut"][ci] < BIG).sum((1, 2))
        new = sum((x < BIG).sum(1) for x in d.new)
        mut_need = max(mut_need, int((torch.maximum(
            held[torch.cat([plan_f, pad])], held[torch.cat([plan_m, pad])])
            + new).max()))
        sides = []
        for g, rows in enumerate((plan_f, plan_m)):
            ps, pp, pm = [], [], []
            for lo in range(0, n_child, CHUNK):
                hi = min(lo + CHUNK, n_child)
                r = rows[lo:hi]
                pos, hp, mu = gamete(
                    parents["seg_st"][ci][r], parents["seg_hap"][ci][r],
                    parents["mut"][ci][r], d.xo[g][lo:hi],
                    d.start[lo:hi, g], d.new[g][lo:hi])
                ps.append(pos)
                pp.append(hp)
                pm.append(mu)
            sides.append((_cat_padded(ps, BIG), _cat_padded(pp, -1),
                          _cat_padded(pm, BIG)))
        out.append(tuple(_cat_padded([s[k] for s in sides], v).view(
            2, n_child, -1).transpose(0, 1)
            for k, v in ((0, BIG), (1, -1), (2, BIG))))
    return out, mut_need


def additive_dominance(c0, c1, a0, a1, d0, d1, n: int, dtype):
    """(A, D) of one chromosome for rows of CV alleles c0, c1 (rows, C),
    frequencies over the first n rows; effects (rows, C) or (C,) seen by
    each chromatid; every step in `dtype`."""
    t = (c0.long() + c1.long())
    p = t[:n].sum(0).to(torch.float64) / (2.0 * n)
    t = t.to(dtype)
    p = p.to(dtype)
    q = 1.0 - p
    a = 0.5 * (a0.to(dtype) + a1.to(dtype))
    d = 0.5 * (d0.to(dtype) + d1.to(dtype))
    alpha = a + d * (q - p)
    A = ((t - 2.0 * p) * alpha).sum(1)
    c_t = torch.where(t == 0, -2.0 * p * p,
                      torch.where(t == 1, 2.0 * p * q, -2.0 * q * q))
    return A, (c_t * d).sum(1)


def var(x) -> float:
    x = np.asarray(x, dtype=np.float64)
    return float(np.var(x, ddof=1)) if len(x) > 1 else 0.0


@dataclass
class Gen0:
    """What generation 0 fixes for the rest of a run, a population."""

    var_a: float
    var_d: float
    sv_mean: float
    sv_var: float
    beta: float = 1.0


class Reference:
    """The reference's view of one scenario: its inputs on `device`."""

    def __init__(self, sc, device, dtype=torch.float64):
        self.sc, self.device, self.dtype = sc, device, dtype
        self.m = law.maps(sc, device)
        self.n_pop = len(sc.pops)
        # founder haps of every population, one global index
        self.offsets = np.cumsum([0] + [2 * p.n0 for p in sc.pops])
        nchr = len(sc.chrs)
        self.cv_q = [torch.as_tensor(sc.pops[0].cv_bp[c].astype(np.int32),
                                     device=device) for c in range(nchr)]
        self.founder = [torch.as_tensor(np.concatenate(
            [p.founder_cv[c] for p in sc.pops]), device=device)
            for c in range(nchr)]
        self.root = torch.as_tensor(np.repeat(
            np.arange(self.n_pop), [2 * p.n0 for p in sc.pops]),
            device=device)
        self.a = [torch.as_tensor(np.stack([p.a[c] for p in sc.pops]),
                                  device=device) for c in range(nchr)]
        self.d = [torch.as_tensor(np.stack([p.d[c] for p in sc.pops]),
                                  device=device) for c in range(nchr)]
        self.gen0: List[Gen0] = []

    # ------------------------------------------------------------ genomes
    def founders(self, pop: int):
        """Generation 0's ledgers: founder i's chromatids copy founder haps
        2i and 2i+1 of this population whole; (pos, hap, mut) a chromosome,
        rows (n0, 2, 1)."""
        n0 = self.sc.pops[pop].n0
        h = torch.arange(2 * n0, device=self.device).view(n0, 2, 1)
        h = h + int(self.offsets[pop])
        out = []
        for c in range(len(self.sc.chrs)):
            pos = torch.full((n0, 2, 1), int(self.m.chr_start[c]),
                             dtype=torch.int32, device=self.device)
            out.append((pos, h, torch.full((n0, 2, 1), BIG, dtype=torch.int32,
                                           device=self.device)))
        return out

    def alleles(self, genome, c: int):
        """(n, 2, C) CV alleles of chromosome c of a genome [(pos, hap,
        mut)]."""
        pos, hap, mut = genome[c]
        n = pos.shape[0]
        flat = [x.reshape(2 * n, -1) for x in (pos, hap, mut)]
        return cv_alleles(*flat, self.founder[c], self.cv_q[c]).view(n, 2, -1)

    def ad(self, genome, n: int):
        """(A, D) float64 numpy of a population's genome [(pos, hap, mut)]
        a chromosome, ledgers in any layout whose positions ascend."""
        A = D = 0
        for c in range(len(self.sc.chrs)):
            al = self.alleles(genome, c)
            pos, hap, _ = genome[c]
            if self.n_pop == 1:
                a0 = a1 = self.a[c][0]
                d0 = d1 = self.d[c][0]
            else:
                qq = self.cv_q[c][None, :].expand(2 * n, -1)
                r = self.root[hap_at(pos.reshape(2 * n, -1),
                                     hap.reshape(2 * n, -1), qq)].view(n, 2, -1)
                col = torch.arange(qq.shape[1], device=self.device)[None, :]
                a0, a1 = (self.a[c][r[:, k], col] for k in (0, 1))
                d0, d1 = (self.d[c][r[:, k], col] for k in (0, 1))
            A_c, D_c = additive_dominance(al[:, 0], al[:, 1], a0, a1, d0, d1,
                                          n, self.dtype)
            A, D = A + A_c, D + D_c
        return (A.to(torch.float64).cpu().numpy(),
                D.to(torch.float64).cpu().numpy())

    # ---------------------------------------------------------- phenotypes
    def phenotypes(self, pop: int, gen: int, A, D, C, par_eff=None):
        """The components of a population's phenotype from raw A and D
        (`ras_scale_AD_compute_GEF`)."""
        n = len(A)
        e = law.rng(self.sc.seed, gen, law.E_NOISE, pop).standard_normal(n)
        if gen == 0:
            rf = law.rng(self.sc.seed, gen, law.F_GEN0, pop)
            par_eff = (rf.normal(0.0, np.sqrt(VF), size=n) if VF > 0
                       else np.zeros(n))
            g0 = None
        else:
            g0 = self.gen0[pop]
        va0 = var(A) if g0 is None else g0.var_a
        vd0 = var(D) if g0 is None else g0.var_d
        s_a = np.sqrt(va0 / VA) if VA > 0 else 1.0
        s_d = np.sqrt(vd0 / VD) if VD > 0 else (1.0 if VD == -1 else 0.0)
        s_e = np.sqrt(var(e) / VE) if VE > 0 else 0.0
        E = e / s_e if s_e > 0 else np.zeros(n)
        A = A / s_a
        D = D / s_d if s_d > 0 else np.zeros(n)
        F = par_eff if VF > 0 else np.zeros(n)
        return {"A": A, "D": D, "G": A + D, "C": C, "E": E, "F": F,
                "P": A + D + C + E + F}, (va0, vd0)

    def gamma(self, comps: list) -> None:
        """Offsets between populations' phenotypes so that their pooled
        variance is (1 + gamma) times its value (`Simulation.cpp:3345`)."""
        g = self.sc.gamma
        if self.n_pop < 2 or g == 0:
            return
        mom = [(float(len(c["P"])), float(c["P"].sum()),
                float((c["P"] * c["P"]).sum())) for c in comps]
        N = sum(x[0] for x in mom)
        k = self.n_pop

        def offsets(a):
            i = np.arange(k)
            return a * ((2 * i) // (k - 1) - 1).astype(np.float64)

        def var_with(b):
            s = sum(x[1] + x[0] * b[i] for i, x in enumerate(mom))
            ss = sum(x[2] + 2 * b[i] * x[1] + x[0] * b[i] * b[i]
                     for i, x in enumerate(mom))
            return (ss - s * s / N) / (N - 1.0)

        base = var_with([0.0] * k)

        def f(a):
            return var_with(offsets(a)) - (1.0 + g) * base

        a = 10.0
        for _ in range(200):
            fa = f(a)
            fp = (f(a + 1e-3) - f(a - 1e-3)) / 2e-3
            if fp == 0:
                break
            a = a - fa / fp
            if abs(f(a)) < 1e-4:
                break
        for i, c in enumerate(comps):
            c["P"] = c["P"] + offsets(a)[i]

    def values(self, pop: int, gen: int, P, first: bool):
        """(mating value, standardized selection value, marriage
        probability) from P."""
        mv, sv = OMEGA * P, LAMBDA * P
        if first:
            return mv, sv, np.ones(len(P))
        g0 = self.gen0[pop]
        z = sv - g0.sv_mean
        if g0.sv_var > 0:
            z = z / np.sqrt(g0.sv_var)
        func, p1, p2 = self.sc.pops[pop].selection[gen - 1]
        return mv, z, selection_prob(z, func, p1, p2)

    # --------------------------------------------------------- generation 0
    def generation0(self):
        """Every population's generation 0: (genomes, states)."""
        genomes, states = [], []
        for k, p in enumerate(self.sc.pops):
            g = self.founders(k)
            A, D = self.ad(g, p.n0)
            sex = law.rng(self.sc.seed, 0, law.INIT_SEX, k).integers(
                1, 3, size=p.n0).astype(np.int8)
            C = (law.rng(self.sc.seed, 0, law.INIT_COMMON, k * 131)
                 .normal(0.0, np.sqrt(VC), size=p.n0) if VC > 0
                 else np.zeros(p.n0))
            comp, (va0, vd0) = self.phenotypes(k, 0, A, D, C)
            ids = np.arange(p.n0, dtype=np.int64)
            states.append(dict(n=p.n0, sex=sex, ids=ids,
                               ped={x: ids.copy() for x in
                                    ("father", "mother", "ff", "fm", "mf",
                                     "mm")}, comp=comp, var0=(va0, vd0)))
            genomes.append(g)
        self.gamma([s["comp"] for s in states])
        self.gen0 = []
        for k, s in enumerate(states):
            mv, sv, svf = self.values(k, 0, s["comp"]["P"], True)
            s.update(mv=mv, sv=np.zeros_like(sv), svf=svf)
            g0 = Gen0(var_a=s["var0"][0], var_d=s["var0"][1],
                      sv_mean=float(np.mean(sv)), sv_var=var(sv))
            z = sv - g0.sv_mean
            s["sv"] = z / np.sqrt(g0.sv_var) if g0.sv_var > 0 else z
            var_p = var(s["comp"]["P"])
            g0.beta = (float(np.sqrt(VF / (2 * var_p))) if var_p > 0
                       else 1.0)
            self.gen0.append(g0)
        return genomes, states

    # ------------------------------------------------------ generation k
    def generation(self, gen: int, parents: list, children=None):
        """Generation `gen` from the parents' states (one a population, as
        the program holds them): (genomes, states) of the children after
        migration, and a population's (ledger slots, mutation slots) that the
        probe reserves. Without `children` the reference makes the meiosis
        from the parents' planes. With `children`, the program's genomes of
        the children after migration ([(pos, hap, mut)] a chromosome, a
        population), it makes none: it works out A/D from those genomes and
        all else from the parents' host fields, and gives no slots."""
        plans = [mate(self.sc.seed, gen, k, par, p)
                 for k, (p, par) in enumerate(zip(self.sc.pops, parents))]
        sizes = [len(plan[2]) for plan in plans]
        moves = self.moves(gen, sizes)
        born = None if children is None else self.unmigrate(
            children, moves, sizes)
        genomes, states, probes = [], [], []
        for k, (p, par, plan) in enumerate(zip(self.sc.pops, parents,
                                               plans)):
            n_child = sizes[k]
            if children is None:
                n_pad = child_rows(n_child, par["rows"], p.offspring[gen - 1])
                cf = torch.as_tensor(plan[0][plan[2]], device=self.device)
                cm = torch.as_tensor(plan[1][plan[2]], device=self.device)
                g, mut_need = meiosis(par, cf, cm, self.m, self.sc.seed, gen,
                                      k, n_child, n_pad, self.device)
                probes.append((probe_need(g), mut_need))
                A, D = self.ad(g, n_child)
            elif born is not None:
                g = born[k]
                A, D = self.ad(g, n_child)
            else:  # the program's children are not this generation's
                g, A, D = None, np.full(n_child, np.nan), np.full(n_child,
                                                                 np.nan)
            st = child_fields(self.sc.seed, gen, k, par, plan)
            prev = par["comp"]["P"]
            par_eff = self.gen0[k].beta * (prev[plan[0][plan[2]]]
                                           + prev[plan[1][plan[2]]])
            st["comp"], _ = self.phenotypes(k, gen, A, D, st["comp"]["C"],
                                            par_eff)
            genomes.append(g)
            states.append(st)
        self.gamma([s["comp"] for s in states])
        for k, s in enumerate(states):
            s["mv"], s["sv"], s["svf"] = self.values(k, gen, s["comp"]["P"],
                                                     False)
        if children is not None:
            return children, self.migrate(moves, None, states)[1], probes
        return (*self.migrate(moves, genomes, states), probes)

    def moves(self, gen: int, sizes: list) -> list:
        """Each population's rows after migration, as parts (source
        population, its rows): each population sends round(m_ij n_i) of its
        rows, drawn without replacement, to population j; a population is
        then its stayers and its immigrants, source by source
        (`Simulation.cpp:877-989`)."""
        if self.n_pop == 1:
            return [[(0, np.arange(sizes[0]))]]
        mats = self.sc.migration[gen - 1]
        r = law.rng(self.sc.seed, gen, law.MIGRATION, 0)
        leaving = []
        for i in range(self.n_pop):
            counts = [0 if i == j else int(round(mats[i, j] * sizes[i]))
                      for j in range(self.n_pop)]
            sample = r.choice(sizes[i], size=sum(counts), replace=False)
            others = [j for j in range(self.n_pop) if j != i]
            leaving.append((sample, np.repeat(others,
                                              [counts[j] for j in others])))
        out = []
        for j in range(self.n_pop):
            parts = [(j, np.setdiff1d(np.arange(sizes[j]), leaving[j][0]))]
            for i in range(self.n_pop):
                idx = leaving[i][0][leaving[i][1] == j]
                if i != j and len(idx):
                    parts.append((i, idx))
            out.append(parts)
        return out

    def unmigrate(self, children: list, moves: list, sizes: list):
        """The genomes of each population's children as born, from the
        genomes after migration (`moves`); None where a population holds
        another number of rows than `moves` gives it."""
        if any(g[0][0].shape[0] != sum(len(idx) for _, idx in parts)
               for g, parts in zip(children, moves)):
            return None
        out = []
        for i, n in enumerate(sizes):
            genome = []
            for c in range(len(self.sc.chrs)):
                planes = []
                for x in range(3):
                    w = max(g[c][x].shape[-1] for g in children)
                    src = children[0][c][x]
                    planes.append(torch.full((n, 2, w), BIG if x != 1 else -1,
                                             dtype=src.dtype,
                                             device=src.device))
                for j, parts in enumerate(moves):
                    lo = 0
                    for k, idx in parts:
                        if k == i:
                            rows = torch.as_tensor(idx, device=self.device)
                            for x in range(3):
                                part = children[j][c][x][lo:lo + len(idx)]
                                planes[x][rows, :, :part.shape[-1]] = part
                        lo += len(idx)
                genome.append(tuple(planes))
            out.append(genome)
        return out

    def migrate(self, moves: list, genomes, states: list):
        """The genomes (unless None) and states after migration
        (`moves`)."""
        if self.n_pop == 1:
            return genomes, states
        new_g, new_s = [], []
        for j, parts in enumerate(moves):
            new_g.append(None if genomes is None else [tuple(_cat_padded(
                [genomes[i][c][x][torch.as_tensor(idx, device=self.device)]
                 .flatten(0, 1) for i, idx in parts],
                BIG if x != 1 else -1).view(-1, 2, max(
                    genomes[i][c][x].shape[-1] for i, _ in parts))
                for x in range(3)) for c in range(len(self.sc.chrs))])
            cat = lambda get: np.concatenate(  # noqa: E731
                [get(states[i])[..., idx] for i, idx in parts], axis=-1)
            new_s.append(dict(
                n=sum(len(idx) for _, idx in parts),
                sex=cat(lambda s: s["sex"]), ids=cat(lambda s: s["ids"]),
                ped={k: cat(lambda s, k=k: s["ped"][k])
                     for k in states[j]["ped"]},
                comp={k: cat(lambda s, k=k: s["comp"][k])
                      for k in states[j]["comp"]},
                mv=cat(lambda s: s["mv"]), sv=cat(lambda s: s["sv"]),
                svf=cat(lambda s: s["svf"])))
        return new_g, new_s


def selection_prob(z, func: str, p1: float, p2: float):
    """Marriage probability from the standardized selection value."""
    if func in ("logit", ""):
        b0, b1 = (0.0, 1.0) if func == "" else (p1, p2)
        y = np.exp(b0 + b1 * z)
        return y / (1.0 + y)
    if func == "probit":
        from scipy.special import erf

        return 0.5 * (1.0 + erf((z - p1) / (np.sqrt(2) * p2)))
    if func == "stab":
        return (1.0 / (np.sqrt(2 * np.pi) * p2)
                * np.exp(-0.5 * ((z - p1) / p2) ** 2))
    if func == "thr":
        return np.where(z <= p2, p1, 1.0)
    return np.ones_like(z)


def mate(seed: int, gen: int, pop: int, par: dict, p):
    """The mating plan of assortative mating with GeneEvolve's law
    (`Simulation.cpp:2167-2360`; no second spouses, no inbreeding veto):
    (father rows, mother rows of the couples, each child's couple)."""
    r = law.rng(seed, gen, law.MATE, pop)
    g = gen - 1
    n = len(par["sex"])
    ok = r.random(n) < par["svf"]
    males = np.flatnonzero(ok & (par["sex"] == 1))
    females = np.flatnonzero(ok & (par["sex"] == 2))
    nc = min(len(males), len(females))
    if len(males) > nc:
        males = r.permutation(males)[:nc]
    if len(females) > nc:
        females = r.permutation(females)[:nc]
    mv = par["mv"]
    males = males[np.argsort(mv[males], kind="stable")]
    females = females[np.argsort(mv[females], kind="stable")]
    rho = p.mat_cor[g]
    t = r.multivariate_normal(np.zeros(2), np.array([[1.0, rho], [rho, 1.0]]),
                              size=nc)
    father = males[np.argsort(np.argsort(t[:, 0], kind="stable"),
                              kind="stable")]
    mother = females[np.argsort(np.argsort(t[:, 1], kind="stable"),
                                kind="stable")]
    eligible = np.arange(nc)
    if p.offspring[g] in ("f", "F"):
        k = p.pop_size[g] // nc
        child = np.repeat(eligible, k)
        rem = p.pop_size[g] - k * nc
        if rem:
            child = np.concatenate([child, r.permutation(eligible)[:rem]])
    else:  # the realized size ~ Poisson(pop_size), couples uniform
        realized = max(1, int(r.poisson(p.pop_size[g])))
        child = eligible[r.integers(0, nc, size=realized)]
    return father, mother, child


def child_rows(n_child: int, par_rows: int, law_: str) -> int:
    """The plane rows of the children, which size every draw of the plan:
    the parents' rows where they cover the Poisson jitter, else ~4 sigma
    over the children."""
    if law_ in ("f", "F"):
        return n_child
    sigma = int(np.sqrt(max(n_child, 1)))
    if n_child <= par_rows <= n_child + 8 * sigma + 64:
        return par_rows
    return n_child + 4 * sigma + 16


def child_fields(seed: int, gen: int, pop: int, par: dict, plan) -> dict:
    """The children's sex, ids, pedigree and common environment."""
    father, mother, child = plan
    n = len(child)
    fpos, mpos = father[child], mother[child]
    C = (law.rng(seed, gen, law.COMMON, pop).normal(0.0, np.sqrt(VC),
                                                     size=len(father))[child]
         if VC > 0 else np.zeros(n))
    ped = par["ped"]
    return dict(
        n=n,
        sex=law.rng(seed, gen, law.SEX, pop).integers(1, 3, size=n).astype(
            np.int8),
        ids=np.arange(n, dtype=np.int64),
        ped={"father": par["ids"][fpos], "mother": par["ids"][mpos],
             "ff": ped["father"][fpos], "fm": ped["mother"][fpos],
             "mf": ped["father"][mpos], "mm": ped["mother"][mpos]},
        comp={"C": C})


def probe_need(genome) -> int:
    """The most ledger slots any child's gamete holds in the reference's
    canonical ledgers: what the program's probe must reserve at least."""
    return max(int((pos < BIG).sum(-1).max()) for pos, _, _ in genome)
