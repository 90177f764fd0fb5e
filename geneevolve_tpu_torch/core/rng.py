"""Deterministic seed schedule (counterpart of geneevolve_tpu/core/rng.py).

Host stages (sex, mating, environment, common, migration) seed numpy from
`np_seed`, exactly as the JAX package does, so they draw the same numbers.
Device stages draw from a `torch.Generator` on the run's device, one per
(seed, generation, stage, population, chromosome): results do not depend
on the order the chromosomes run in. Torch's generators give other numbers
than `jax.random`, so device draws agree with the JAX package in law, not
bit for bit.
"""

from __future__ import annotations

import enum

import torch


class Stage(enum.IntEnum):
    INIT_SEX = 0
    INIT_COMMON = 1
    MATE = 2
    CROSSOVER = 3
    START_HAP = 4
    MUTATION = 5
    SEX = 6
    COMMON = 7
    E_NOISE = 8
    F_GEN0 = 9
    MIGRATION = 10
    DENSE_STEP = 11


def np_seed(seed: int, gen: int, stage: Stage, pop: int = 0) -> int:
    """A stable 63-bit seed for host-side numpy RNG stages."""
    x = (seed * 1000003 + gen) & 0x7FFFFFFFFFFFFFFF
    x = (x * 1000033 + int(stage)) & 0x7FFFFFFFFFFFFFFF
    x = (x * 1000211 + pop) & 0x7FFFFFFFFFFFFFFF
    return x


def generator(device, seed: int, gen: int, stage: Stage, pop: int = 0,
              chrom: int = 0) -> torch.Generator:
    """A fresh generator on `device` for one (seed, gen, stage, pop, chr)."""
    g = torch.Generator(device=device)
    x = (np_seed(seed, gen, stage, pop) * 1000249 + chrom) & 0x7FFFFFFFFFFFFFFF
    g.manual_seed(x)
    return g
