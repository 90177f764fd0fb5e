"""Phenotype construction (counterpart of geneevolve_tpu/core/phenotype.py).

`additive_dominance_chr` runs on the device in float32, like the JAX
version; its row sums are taken in another order, so A and D agree with
the JAX package to f32 rounding, not bit for bit. The rest is the JAX
module's host half (float64 numpy), copied because that module imports
JAX. Formulas follow the reference (`Simulation.cpp:2624-2749`,
`:3075-3206`, `:3300-3428`, `:3254-3297`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from geneevolve_tpu_torch.utils import telemetry


def additive_dominance_chr(
    c0: torch.Tensor,  # (n, ncv) uint8 paternal-chromatid CV alleles
    c1: torch.Tensor,  # (n, ncv) maternal
    a0: torch.Tensor,  # (n, ncv) or (ncv,) f32 additive effect seen by
    a1: torch.Tensor,  # chromatid 0 / 1 (its root population's)
    d0: torch.Tensor,  # (n, ncv) or (ncv,) f32 dominance effects
    d1: torch.Tensor,
    dominance_on: bool,  # False when vd == 0
    n_real: int,  # rows >= n_real are padding, excluded from frequencies
    tsum: torch.Tensor = None,  # optional (ncv,) allele counts of the WHOLE
    # population: when its rows come in chunks, the frequency is the
    # population's, not the chunk's
    n_freq: int = None,  # the population size behind `tsum`
    timer=None,  # the run's `StageTimer`: the door of the size's upload
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chromosome's (A, D) contribution for every row, f32. One
    population passes its (ncv,) effect rows, broadcast over the rows."""
    t_int = c0.to(torch.int32) + c1.to(torch.int32)  # (n, ncv) in {0,1,2}
    t = t_int.to(torch.float32)
    if tsum is None:
        tsum = t_int[:n_real].sum(0)  # exact integer allele counts
        n_freq = n_real
    with telemetry.host_wait(timer, "ad_frequency"):
        nr = torch.tensor(float(n_freq), dtype=torch.float32,
                          device=c0.device)
    p = tsum.to(torch.float32) / (2.0 * nr)  # current-gen allele frequency
    q = 1.0 - p
    a = 0.5 * (a0 + a1)
    d = 0.5 * (d0 + d1) if dominance_on else torch.zeros_like(d0)
    alpha = a + d * (q - p)
    A = ((t - 2.0 * p[None, :]) * alpha).sum(1)
    c_t = torch.where(
        t == 0.0, -2.0 * p * p, torch.where(t == 1.0, 2.0 * p * q, -2.0 * q * q)
    )
    D = (c_t * d).sum(1)
    return A, D


# ----------------------------------------------------------------- host side
def var(x: np.ndarray) -> float:
    """Sample variance, n-1 denominator (`CommFunc.cpp:57-68`)."""
    return float(np.var(np.asarray(x, dtype=np.float64), ddof=1)) if len(x) > 1 else 0.0


def scale_components(
    A_raw: np.ndarray,
    D_raw: np.ndarray,
    e_std: np.ndarray,  # N(0,1) draws
    par_eff: np.ndarray,  # raw parental effect (already beta-weighted, or gen-0 draws)
    C: np.ndarray,
    va: float,
    vd: float,
    ve: float,
    vf: float,
    var_a_gen0: float,
    var_d_gen0: float,
) -> dict:
    s_a = np.sqrt(var_a_gen0 / va) if va > 0 else 1.0
    if vd > 0:
        s_d = np.sqrt(var_d_gen0 / vd)
    elif vd == -1:
        s_d = 1.0
    else:
        s_d = 0.0
    s_ev = np.sqrt(var(e_std) / ve) if ve > 0 else 0.0

    E = e_std / s_ev if s_ev > 0 else np.zeros_like(e_std)
    A = A_raw / s_a
    D = D_raw / s_d if s_d > 0 else np.zeros_like(D_raw)
    F = par_eff if vf > 0 else np.zeros_like(par_eff)
    G = A + D
    P = A + D + C + E + F
    return {"A": A, "D": D, "G": G, "C": C, "E": E, "F": F, "P": P}


def selection_prob(
    z: np.ndarray, gen: int, func: str, par1: float, par2: float
) -> np.ndarray:
    """Marriage probability from the standardized selection value."""
    if gen == 0:
        return np.ones_like(z)
    if func == "logit" or func == "":
        b0, b1 = (0.0, 1.0) if func == "" else (par1, par2)
        y = np.exp(b0 + b1 * z)
        return y / (1.0 + y)
    if func == "probit":
        from scipy.special import erf

        return 0.5 * (1.0 + erf((z - par1) / (np.sqrt(2) * par2)))
    if func == "stab":
        return (
            1.0 / (np.sqrt(2 * np.pi) * par2)
            * np.exp(-0.5 * ((z - par1) / par2) ** 2)
        )
    if func == "thr":
        return np.where(z <= par2, par1, 1.0)
    return np.ones_like(z)


def mating_selection_values(
    P: np.ndarray,  # (npheno, n)
    omega: np.ndarray,  # (npheno,)
    lam: np.ndarray,  # (npheno,)
) -> Tuple[np.ndarray, np.ndarray]:
    return omega @ P, lam @ P


def gamma_offsets(n_pop: int, a: float) -> np.ndarray:
    """b_i = a * (2i // (n_pop-1) - 1), reproducing the reference's C++
    integer division (`Simulation.cpp:3269,3289`)."""
    i = np.arange(n_pop)
    return a * ((2 * i) // (n_pop - 1) - 1).astype(np.float64)


def pop_moments(x) -> tuple:
    """(n, sum, sumsq) of one population's phenotype vector, float64."""
    x = np.asarray(x, dtype=np.float64)
    return float(x.shape[0]), float(x.sum()), float((x * x).sum())


def solve_gamma_offset_moments(
    moments: list, gamma: float, x0: float = 10.0, precision: float = 1e-4
) -> float:
    """Newton-Raphson for the offset scale `a` s.t.
    var(concat(P_i + b_i)) = (1+gamma) var(concat(P_i)), from per-pop
    moments (n_i, sum_i, sumsq_i) only."""
    n_pop = len(moments)
    N = sum(m[0] for m in moments)

    def var_with(b) -> float:
        s = sum(m[1] + m[0] * b[i] for i, m in enumerate(moments))
        ss = sum(
            m[2] + 2.0 * b[i] * m[1] + m[0] * b[i] * b[i]
            for i, m in enumerate(moments)
        )
        return (ss - s * s / N) / (N - 1.0)

    s2x = var_with([0.0] * n_pop)

    def f(a: float) -> float:
        return var_with(gamma_offsets(n_pop, a)) - (1.0 + gamma) * s2x

    dx = 1e-3
    a = x0
    for _ in range(200):
        fa = f(a)
        fp = (f(a + dx) - f(a - dx)) / (2 * dx)
        if fp == 0:
            break
        a = a - fa / fp
        if abs(f(a)) < precision:
            return a
    return a
