"""Device-side mate pairing (counterpart of
geneevolve_tpu/parallel/mating_device.py): the reference's `assort_mate`
as tensor work on the run's device, so the pairing of a large population
needs no host round trip (`--device_mating`).

Semantics mirror `core/mating.assort_mate` (`Simulation.cpp:2167-2360`):
selection gate, optional second marriages (MM), random trim of the larger
sex, stable sort of each sex by mating value, an MVN(0, [[1, r], [r, 1]])
template matched by rank, the 8-way grandparent inbreeding veto, and the
offspring law: "p" (each child picks an eligible couple uniformly; the
engine draws the realized Poisson total) or "f" (floor(pop_size/eligible)
children a couple plus a randomly ordered remainder). Shapes stay (n,),
(N,) or (n_children,); counts live in masks and 0-d tensors.

Each pairing is split in two: `draw_assort` takes every random number from
one `torch.Generator`, and `pair` is a pure function of those draws. Fed
the JAX function's own draws, `pair` gives its plan exactly (the tests do
so). One law is drawn differently: JAX draws the "p" children with
`jax.random.categorical` over (n_children, N) logits, a Gumbel matrix of
~3.7 GB at 30,000 individuals. Here a child takes a float64 uniform u and
the eligible slot of packed rank floor(u * eligible): the same law (uniform
over eligible couple slots) through a different stream, and no matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geneevolve_tpu_torch.utils import telemetry

BIG = 3.4e38  # float32 sort key of dropped members: they sort last


class DevicePlan(NamedTuple):
    father_pos: torch.Tensor  # (N,) int32; slots >= n_couples are -1
    mother_pos: torch.Tensor  # (N,)
    valid: torch.Tensor  # (N,) bool: the slot is a real couple
    inbred: torch.Tensor  # (N,) bool
    child_couple: torch.Tensor  # (n_children,) int32 couple slot a child
    n_couples: torch.Tensor  # () int32


class MateDraws(NamedTuple):
    """Every random number of one `pair` call (N = 2n under MM, else n)."""

    gate: torch.Tensor  # (n,) f32 uniforms: the selection gate
    mm: Optional[torch.Tensor]  # (n,) f32 uniforms: second marriages
    trim_m: torch.Tensor  # (N,) f32 uniforms: the men's trim priority
    trim_f: torch.Tensor  # (N,) f32 uniforms: the women's
    z: torch.Tensor  # (2, N) f32 standard normals: the MVN template
    extra: Optional[torch.Tensor]  # (N,) f32 uniforms: "f" remainder order
    child: Optional[torch.Tensor]  # (n_children,) f64 uniforms: "p" law


def _fixed(offspring_dist: str) -> bool:
    return offspring_dist in ("f", "F")


def _rank(x: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of x[i] in a stable ascending sort (the inverse
    of the sort's permutation, scattered: the JAX double argsort)."""
    perm = torch.argsort(x, stable=True)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(x.shape[0], device=x.device)
    return rank


def _sorted_members(keep: torch.Tensor, key_vals: torch.Tensor):
    """Positions of kept members sorted ascending by key_vals, packed to
    the front; dropped members sort to the back (key BIG)."""
    return torch.argsort(torch.where(keep, key_vals, BIG), stable=True)


def _packed(mask: torch.Tensor) -> torch.Tensor:
    """Positions where `mask` holds, in order, packed to the front."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def _pick(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A uniform choice among the positions where `mask` holds, one per
    float64 uniform in `u` (position 0 when none holds)."""
    count = mask.sum().clamp(min=1)
    idx = torch.minimum((u * count).to(torch.int64), count - 1)
    return _packed(mask)[idx]


def draw_assort(gen: torch.Generator, n: int, mm_percent: float = 0.0,
                offspring_dist: str = "p",
                n_children: Optional[int] = None) -> MateDraws:
    """The draws of one assortative pairing of n individuals, from `gen`
    on its device, in a fixed order."""
    dev = gen.device
    N = 2 * n if mm_percent > 0 else n

    def uniform(k, dtype=torch.float32):
        return torch.rand(k, generator=gen, device=dev, dtype=dtype)

    gate = uniform(n)
    mm = uniform(n) if mm_percent > 0 else None
    trim_m, trim_f = uniform(N), uniform(N)
    z = torch.randn((2, N), generator=gen, device=dev)
    if _fixed(offspring_dist):
        return MateDraws(gate, mm, trim_m, trim_f, z, uniform(N), None)
    return MateDraws(gate, mm, trim_m, trim_f, z, None,
                     uniform(n_children, torch.float64))


def pair(
    draws: MateDraws,
    mating_value: torch.Tensor,  # (n,) float32
    selection_prob: torch.Tensor,  # (n,) float32
    sex: torch.Tensor,  # (n,) 1 = male, 2 = female
    pedigree: dict,  # father, ff, fm, mf, mm -> (n,) ids (veto only)
    mat_cor: float,
    avoid_inbreeding: bool,
    pop_size: int,
    mm_percent: float = 0.0,
    offspring_dist: str = "p",
    n_children: Optional[int] = None,
    timer=None,
) -> DevicePlan:
    """The pairing plan as a pure function of `draws`. father_pos and
    mother_pos hold ORIGINAL positions, also under MM duplication.
    `timer`: the run's `StageTimer`, for the door of the template's two
    scalar uploads."""
    n = mating_value.shape[0]
    dev = mating_value.device
    if n_children is None:
        n_children = pop_size
    gate = draws.gate < selection_prob
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    if mm_percent > 0:
        # double-spouse (`Simulation.cpp:2199-2213`): slot n+i is person
        # i's second marriage, active with prob MM after the gate
        dup = draws.mm < mm_percent
        pos = torch.cat([pos, pos])
        gate = torch.cat([gate, gate & dup])
        sex = torch.cat([sex, sex])
        mating_value = torch.cat([mating_value, mating_value])
    N = pos.shape[0]
    is_m = gate & (sex == 1)
    is_f = gate & (sex == 2)
    nc = torch.minimum(is_m.sum(), is_f.sum())  # couples

    # random trim of the larger sex (`Simulation.cpp:2233-2246`): rank a
    # uniform priority within each sex, keep the first nc
    keep_m = is_m & (_rank(torch.where(is_m, draws.trim_m, BIG)) < nc)
    keep_f = is_f & (_rank(torch.where(is_f, draws.trim_f, BIG)) < nc)
    msorted = _sorted_members(keep_m, mating_value)
    fsorted = _sorted_members(keep_f, mating_value)

    # MVN(0, [[1, r], [r, 1]]) template, ranks matched within the first nc
    # slots; each product rounded to float32 on its own, as JAX computes
    # it op by op (r and sqrt(1 - r^2) are float32 scalars)
    with telemetry.host_wait(timer, "mate_upload"):
        r = torch.tensor(mat_cor, dtype=torch.float32, device=dev)
        s = torch.tensor(1.0 - mat_cor * mat_cor, dtype=torch.float32,
                         device=dev)
    s = torch.sqrt(s)
    t1 = draws.z[0]
    t2 = r * draws.z[0] + s * draws.z[1]
    in_nc = torch.arange(N, device=dev) < nc
    r1 = _rank(torch.where(in_nc, t1, BIG))
    r2 = _rank(torch.where(in_nc, t2, BIG))
    none = torch.full_like(pos, -1)
    father = torch.where(in_nc, pos[msorted[r1]], none)
    mother = torch.where(in_nc, pos[fsorted[r2]], none)

    if avoid_inbreeding:
        # sibs share a father; cousins share any grandparent
        # (`Simulation.cpp:2304-2320`)
        fa = father.clamp(0, n - 1).long()
        mo = mother.clamp(0, n - 1).long()
        inbred = pedigree["father"][fa] == pedigree["father"][mo]
        for group in (("ff", "mf"), ("fm", "mm")):
            for a in group:
                for b in group:
                    inbred |= pedigree[a][fa] == pedigree[b][mo]
        inbred &= in_nc
    else:
        inbred = torch.zeros(N, dtype=torch.bool, device=dev)

    eligible = in_nc & ~inbred
    if _fixed(offspring_dist):
        # fixed law (`Simulation.cpp:2340-2355`): floor(pop_size/eligible)
        # a couple plus a randomly ordered remainder of one-extras
        ne = eligible.sum().clamp(min=1)
        nf = torch.div(pop_size, ne, rounding_mode="floor")
        elig_pos = _packed(eligible)
        extra_sorted = torch.argsort(torch.where(eligible, draws.extra, BIG),
                                     stable=True)
        k = torch.arange(n_children, device=dev)
        base = torch.clamp(k // nf.clamp(min=1), max=N - 1)
        rem = torch.clamp(k - nf * ne, 0, N - 1)
        child = torch.where(k < nf * ne, elig_pos[base], extra_sorted[rem])
    else:
        # "p": a uniform eligible couple slot a child
        child = _pick(draws.child, eligible)
    return DevicePlan(
        father_pos=father,
        mother_pos=mother,
        valid=in_nc,
        inbred=inbred,
        child_couple=child.to(torch.int32),
        n_couples=nc.to(torch.int32),
    )


def assort_mate_device(
    gen: torch.Generator,
    mating_value: torch.Tensor,
    selection_prob: torch.Tensor,
    sex: torch.Tensor,
    pedigree: dict,
    mat_cor: float,
    avoid_inbreeding: bool,
    pop_size: int,
    mm_percent: float = 0.0,
    offspring_dist: str = "p",
    n_children: Optional[int] = None,
    timer=None,
) -> DevicePlan:
    """Assortative pairing on `gen`'s device: `draw_assort`, then `pair`.
    pop_size is the schedule's nominal size; n_children the child slots
    emitted (the engine takes the realized Poisson total off the front)."""
    if n_children is None:
        n_children = pop_size
    draws = draw_assort(gen, mating_value.shape[0], mm_percent,
                        offspring_dist, n_children)
    return pair(draws, mating_value, selection_prob, sex, pedigree, mat_cor,
                avoid_inbreeding, pop_size, mm_percent, offspring_dist,
                n_children, timer)


def random_mate_device(
    gen: torch.Generator,
    selection_prob: torch.Tensor,
    sex: torch.Tensor,
    pop_size: int,
) -> DevicePlan:
    """`random_mate` (`Simulation.cpp:2090-2157`) on `gen`'s device:
    pop_size couples drawn uniformly with replacement from the marriageable
    of each sex (a float64 uniform a parent over the packed members, where
    JAX draws a categorical over (pop_size, n) logits)."""
    dev = gen.device
    n = sex.shape[0]
    gate = torch.rand(n, generator=gen, device=dev) < selection_prob
    u_f, u_m = (torch.rand(pop_size, generator=gen, device=dev,
                           dtype=torch.float64) for _ in range(2))
    return DevicePlan(
        father_pos=_pick(u_f, gate & (sex == 1)).to(torch.int32),
        mother_pos=_pick(u_m, gate & (sex == 2)).to(torch.int32),
        valid=torch.ones(pop_size, dtype=torch.bool, device=dev),
        inbred=torch.zeros(pop_size, dtype=torch.bool, device=dev),
        child_couple=torch.arange(pop_size, dtype=torch.int32, device=dev),
        n_couples=torch.tensor(pop_size, dtype=torch.int32, device=dev),
    )
