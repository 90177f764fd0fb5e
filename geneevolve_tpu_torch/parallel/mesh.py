"""The device mesh and the sharded packed steps, over `torch.distributed`
(counterpart of geneevolve_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a `Mesh` and lets XLA insert
the collectives from sharding annotations. Here every device is a process
(a rank) of one `torch.distributed` world laid out as an (ind, loci) grid,
rank r at (r // loci, r % loci), and each step runs its collectives
itself (`parallel/comm.py`) over the grid's row and column groups:

- `make_sharded_step`: the panmictic step, bit-identical to the one-rank
  step for any (ind, loci). Every rank draws the whole generation from an
  identically seeded generator (with selection, from the CV rows gathered
  over 'ind'), keeps its own children, fetches the parent rows they need
  from their owners (`exchange_rows`, exact split sizes) and runs the
  meiosis on its window of loci (any split of the words, or of the byte
  step's loci, over 'loci', as the JAX step takes): the window cut at
  chromosome boundaries into a run of whole chromosomes and at most two
  partial ones (`loci_pieces`), one kernel launch a piece on the window in
  place, each piece's crossovers shifted into it and clipped, so that
  crossovers before it still set its phase (`piece_plan`). The dense
  backend's mesh (`dense/backend.py`) reproduces through the same
  pieces.
- `make_deme_step`: each 'ind' row of the grid is a deme; per-rank
  streams keyed as the JAX step keys them, the global allele-count
  centering as an integer all-reduce, the CV matrix reassembled by an
  integer sum over 'loci', ring or matrix migration.
- `routed_fetch` / `make_routed_step`: the request-routed panmictic step
  (owner sort, (D, cap) request packets, two all-to-alls, overflows
  counted).

The deme and routed steps take optional per-rank `draws`, so tests can
feed them the JAX steps' own draws.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from geneevolve_tpu_torch.dense import packed as pk
from geneevolve_tpu_torch.dense import step as dense_step
from geneevolve_tpu_torch.dense.packed import PackedConfig
from geneevolve_tpu_torch.dense.step import DenseConfig
from geneevolve_tpu_torch.ops.meiose_packed import (
    meiose_packed,
    meiose_packed_window,
)
from geneevolve_tpu_torch.ops.meiose_planes import meiose_planes_window
from geneevolve_tpu_torch.parallel import comm
from geneevolve_tpu_torch.parallel.comm import Traffic

AXES = ("ind", "loci")
_MASK = 0x7FFFFFFFFFFFFFFF


def _factor(n: int) -> tuple:
    """Split n devices into (ind, loci) favoring the individuals axis."""
    best = (n, 1)
    for loci in (1, 2, 4, 8):
        if n % loci == 0 and loci * loci <= n:
            best = (n // loci, loci)
    return best


@dataclass
class Mesh:
    """This rank's view of the grid: axis names and sizes, its coordinate
    on each axis, the process group of each axis (the ranks that differ
    from it on that axis alone), the device its tensors live on, and the
    exchange record of its collectives."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[str, object]
    device: torch.device
    backend: str = "gloo"
    traffic: Traffic = field(default_factory=Traffic)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def dims(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_mesh(shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """The (ind, loci) grid over the whole process group (`_factor` of
    its size when `shape` is None), its tensors on `device` (the rank's
    current card for "cuda")."""
    world = dist.get_world_size()
    shape = tuple(shape or _factor(world))
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} ranks")
    backend = dist.get_backend()
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                          mesh_dim_names=AXES)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(AXES, shape, tuple(dm.get_local_rank(a) for a in AXES),
                {a: dm.get_group(a) for a in AXES}, device, backend)


def state_specs(packed: bool = True) -> dict:
    """The axis each dimension of a state entry is sharded over (None:
    replicated): haplotype planes in (ind, loci) blocks, the CV matrix
    over individuals, CV columns, effects and the clip count replicated."""
    if packed:
        return {"hap": ("ind", None, "loci"), "cv": ("ind", None, None),
                "cv_idx": (), "eff": (), "clip": ()}
    return {"hapA": ("ind", "loci"), "hapB": ("ind", "loci"),
            "cv_idx": (), "eff": (), "clip": ()}


def _block(t: torch.Tensor, dim: int, d: int, c: int) -> torch.Tensor:
    if t.shape[dim] % d:
        raise ValueError(f"axis of {t.shape[dim]} does not split over {d}")
    b = t.shape[dim] // d
    return t.narrow(dim, c * b, b)


def shard_state(state: dict, mesh: Mesh) -> dict:
    """This rank's shard of a full state (tensors or numpy arrays, on any
    device), on the mesh's device."""
    specs = state_specs(packed="hap" in state)
    out = {}
    for k, v in state.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        for dim, ax in enumerate(specs[k]):
            if ax is not None:
                t = _block(t, dim, mesh.size(ax), mesh.coord(ax))
        out[k] = t.to(mesh.device).contiguous()
    return out


def gather_dim(t: torch.Tensor, dim: int, group, log=None) -> torch.Tensor:
    """The blocks of `t` along `dim` of every rank of `group`, in rank
    order."""
    g = comm.all_gather_rows(t.movedim(dim, 0).contiguous(), group, log)
    return g.movedim(0, dim).contiguous()


def unshard_state(state: dict, mesh: Mesh) -> dict:
    """The full state on every rank, from each rank's shard."""
    specs = state_specs(packed="hap" in state)
    out = {}
    for k, t in state.items():
        for dim, ax in enumerate(specs[k]):
            if ax is not None and mesh.size(ax) > 1:
                t = gather_dim(t, dim, mesh.group(ax))
        out[k] = t
    return out


# ------------------------------------------------------------ row exchange
def _width(t: torch.Tensor, axis: int) -> int:
    """Bytes of one row of `t` along `axis`."""
    return int(np.prod(t.shape[:axis] + t.shape[axis + 1:])) \
        * t.element_size()


def _row_bytes(tables: Sequence[torch.Tensor], idx: torch.Tensor,
               axis: int) -> torch.Tensor:
    """(K, bytes) rows `idx` along `axis` of every table, side by side,
    written table by table into one buffer."""
    widths = [_width(t, axis) for t in tables]
    out = torch.empty((idx.numel(), sum(widths)), dtype=torch.uint8,
                      device=tables[0].device)
    c0 = 0
    for t, w in zip(tables, widths):
        out[:, c0:c0 + w] = comm.row_bytes(t.movedim(axis, 0)
                                           .index_select(0, idx))
        c0 += w
    return out


def _split_rows(got: torch.Tensor, inv: torch.Tensor,
                tables: Sequence[torch.Tensor],
                axis: int) -> List[torch.Tensor]:
    """Rows `inv` of the received row bytes, as rows along `axis` of
    tables shaped like `tables`, one table at a time."""
    out, c0 = [], 0
    for t in tables:
        rest = t.shape[:axis] + t.shape[axis + 1:]
        w = _width(t, axis)
        part = comm.from_row_bytes(got[:, c0:c0 + w].index_select(0, inv),
                                   t.dtype, rest)
        out.append(part.movedim(0, axis).contiguous())
        c0 += w
    return out


def exchange_rows(tables: Sequence[torch.Tensor],
                  wants: Sequence[torch.Tensor], block: int, group,
                  log: Optional[Traffic] = None,
                  axis: int = 0) -> List[torch.Tensor]:
    """Rows of tables sharded in blocks over `group` (rank k holds global
    rows [k * block, (k + 1) * block), on `axis` of each table): returns
    the rows `wants[me]` (global indices) of each table, in that order.
    `wants[r]` lists what rank r needs and is known on every rank, so each
    owner sends exactly the rows asked of it, all tables in one
    all-to-all of row bytes. The send buffer is freed before the received
    rows are split into tables, so at most the received bytes and one
    table's rows are held beside the results. A group of one rank holds
    every row: each table's rows are taken in place, one `index_select`
    a table, with no bytes packed or exchanged."""
    d = dist.get_world_size(group)
    if d == 1:
        return [t.index_select(axis, wants[0].long()) for t in tables]
    me = dist.get_rank(group)
    owners = [(w // block).long() for w in wants]
    cnt = torch.stack([torch.bincount(o, minlength=d)[:d]
                       for o in owners]).tolist()  # [dest][owner]
    send = [cnt[r][me] for r in range(d)]
    recv = [cnt[me][k] for k in range(d)]
    idx = torch.cat([wants[r][owners[r] == me].long() for r in range(d)]) \
        - me * block
    got = comm.all_to_all_rows(_row_bytes(tables, idx, axis), send, recv,
                               group, log)
    # received in owner order; row j of the result is row inv[j] of `got`
    order = torch.argsort(owners[me], stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return _split_rows(got, inv, tables, axis)


# --------------------------------------------------- the panmictic step
def refuse_split(what: str, shape, dim: int, d: int) -> None:
    """Raise unless axis `dim` of `shape` splits into `d` equal blocks, in
    the words of the JAX package's refusal of such a sharding."""
    if shape[dim] % d:
        raise ValueError(
            f"{what} was given a sharding which implies that the global "
            f"size of its dimension {dim} should be divisible by {d}, but "
            f"it is equal to {shape[dim]} (full shape: {tuple(shape)})")


@dataclass(frozen=True)
class Piece:
    """A run of a loci rank's window: `n_chr` chromosomes from `c0`, each
    `length` loci from its locus `off` (whole chromosomes: off 0 and
    length chr_len; else one partial chromosome), at locus `lo` of the
    window."""

    c0: int
    n_chr: int
    off: int
    length: int
    lo: int

    @property
    def m(self) -> int:
        return self.n_chr * self.length


def loci_pieces(n_chr: int, chr_len: int, lo: int, m_loc: int):
    """The window [lo, lo + m_loc) of the genome cut at chromosome
    boundaries: the tail of the chromosome it starts in, a run of whole
    chromosomes, the head of the one it ends in (each present when not
    empty; one partial piece when the window lies inside a chromosome),
    so at most three pieces."""
    out, pos, end = [], lo, lo + m_loc
    if pos % chr_len and pos < end:
        c = pos // chr_len
        e = min(end, (c + 1) * chr_len)
        out.append(Piece(c, 1, pos - c * chr_len, e - pos, pos - lo))
        pos = e
    whole = (end - pos) // chr_len
    if whole:
        out.append(Piece(pos // chr_len, whole, 0, chr_len, pos - lo))
        pos += whole * chr_len
    if pos < end:
        out.append(Piece(pos // chr_len, 1, 0, end - pos, pos - lo))
    if n_chr * chr_len < end:
        raise ValueError(f"loci [{lo}, {end}) lie past {n_chr} chromosomes "
                         f"of {chr_len}")
    return out


def piece_plan(xo, st, pc: Piece, chr_len: int):
    """Crossovers (n, n_chr, K) and starts (n, n_chr) of the whole genome
    made local to piece `pc`: each of its chromosomes' crossovers shifted
    into it, those before it clipped to its first locus (they set its
    phase), those past it made padding (pc.m)."""
    dev = xo.device
    cs = slice(pc.c0, pc.c0 + pc.n_chr)
    k = torch.arange(pc.n_chr, dtype=torch.int32, device=dev)
    g0 = (pc.c0 + k) * chr_len + pc.off  # each chromosome's first locus
    x = xo[:, cs, :] - g0[None, :, None]
    loc = torch.where(x >= pc.length, pc.m,
                      x.clamp(min=0) + (k * pc.length)[None, :, None])
    return loc.to(torch.int32).contiguous(), st[:, cs].contiguous()


def local_loci(pos, lo: int, m_loc: int):
    """Loci made local to [lo, lo + m_loc); the rest padding (m_loc)."""
    inr = (pos >= lo) & (pos < lo + m_loc)
    return torch.where(inr, pos - lo, m_loc).to(torch.int32), inr


def meiose_window(hap, fathers, mothers, plan, mu, pieces, chr_len: int,
                  lo: int, m_loc: int) -> torch.Tensor:
    """(n, 2, m_loc / 32) packed child words of the genome window [lo, lo +
    m_loc) from the parents' words of it (N, 2, m_loc / 32): kernel
    `meiose_packed` once a piece of `loci_pieces` (whole chromosomes in one
    launch, a partial one in its own), on the window in place. `plan`:
    (xo_p, st_p, xo_m, st_m) of the whole genome; `mu` (n, 2, Km) global
    mutation loci or None."""
    out = torch.empty((fathers.shape[0], 2, m_loc // 32), dtype=torch.int32,
                      device=hap.device)
    xo_p, st_p, xo_m, st_m = plan
    for pc in pieces:
        mu_pc = None if mu is None else local_loci(mu, lo + pc.lo, pc.m)[0]
        meiose_packed_window(hap, out, pc.lo // 32, fathers, mothers,
                             *piece_plan(xo_p, st_p, pc, chr_len),
                             *piece_plan(xo_m, st_m, pc, chr_len), mu_pc,
                             n_chr=pc.n_chr, chr_len=pc.length)
    return out


def _cv_columns(hapA, hapB, cv_idx, lo: int, m_loc: int, group):
    """(nloc, ncv) alleles of both chromatids at the CV columns, each
    column read by the loci rank that holds it and summed over 'loci'."""
    idx, inr = local_loci(cv_idx, lo, m_loc)
    idx = idx.clamp(max=m_loc - 1).long()
    cols = torch.stack([hapA[:, idx], hapB[:, idx]]) * inr.to(torch.uint8)
    return comm.all_reduce(cols.contiguous(), "sum", group)


def make_sharded_step(cfg, mesh: Mesh):
    """step(state, gen) -> state on this rank's shard: the panmictic step
    of `cfg` (a `DenseConfig`: the byte step, kernel `meiose_planes`; a
    `PackedConfig`: the packed step, kernel `meiose_packed` + `cv_child`),
    bit-identical to `dense.step.make_step` / `dense.packed.make_step` on
    the whole state when every rank's `gen` is seeded alike. Any (ind,
    loci) whose blocks divide the rows and the word (byte step: locus)
    axis is taken; the rest are refused as the JAX step refuses them.
    `draws` (packed step: `pk.draw_generation`'s dict over the whole
    generation, arrays or tensors) replaces the generator's, so tests can
    feed it the JAX step's draws."""
    packed = isinstance(cfg, PackedConfig)
    if not packed and not isinstance(cfg, DenseConfig):
        raise TypeError("make_sharded_step takes a DenseConfig or a "
                        "PackedConfig")
    ind, loci = mesh.size("ind"), mesh.size("loci")
    i, j = mesh.coord("ind"), mesh.coord("loci")
    name = "state['hap']" if packed else "state['hapA']"
    shape = (cfg.n, 2, cfg.mw) if packed else (cfg.n, cfg.m)
    refuse_split(name, shape, 0, ind)
    refuse_split(name, shape, len(shape) - 1, loci)
    nloc, m_loc = cfg.n // ind, cfg.m // loci
    lo = j * m_loc
    pieces = loci_pieces(cfg.n_chr, cfg.chr_len, lo, m_loc)
    rows = slice(i * nloc, (i + 1) * nloc)
    g_ind, log = mesh.group("ind"), mesh.traffic

    def draw(state, gen):
        if packed:
            cv = (gather_dim(state["cv"], 0, g_ind, log) if cfg.selection
                  else None)
            return pk.draw_generation(gen, cfg, cv, state["eff"], cfg.n)
        logits = None
        if cfg.selection:
            ca, cb = _cv_columns(state["hapA"], state["hapB"],
                                 state["cv_idx"], lo, m_loc,
                                 mesh.group("loci"))
            ca, cb = (gather_dim(c, 0, g_ind, log) for c in (ca, cb))
            ar = torch.arange(ca.shape[1], dtype=torch.int32,
                              device=ca.device)
            logits = dense_step.selection_logits(
                dense_step.phenotype_additive(ca, cb, ar, state["eff"]))
        return dense_step.draw_generation(gen, cfg, cfg.n, logits)

    def step(state, gen: torch.Generator, draws=None):
        d = draw(state, gen) if draws is None else _to(draws, mesh.device)
        wants = [torch.unique(torch.cat([d["fathers"][r * nloc:(r + 1) * nloc],
                                         d["mothers"][r * nloc:(r + 1) * nloc]]))
                 for r in range(ind)]
        tables = ([state["hap"], state["cv"]] if packed
                  else [state["hapA"], state["hapB"]])
        par = exchange_rows(tables, wants, nloc, g_ind, log)
        fl, ml = (torch.searchsorted(wants[i], d[k][rows]).to(torch.int32)
                  for k in ("fathers", "mothers"))
        plan = [d[k][rows] for k in ("xo_p", "st_p", "xo_m", "st_m")]
        if packed:
            mu = None if d["mu"] is None else d["mu"][rows]
            child = meiose_window(par[0], fl, ml, plan, mu, pieces,
                                  cfg.chr_len, lo, m_loc)
            mine = dict(fathers=fl, mothers=ml, mu=mu,
                        **{k: d[k][rows] for k in ("xo_p", "st_p", "xo_m",
                                                   "st_m")})
            cv = pk.cv_children(par[1], mine, state["cv_idx"], cfg.chr_len)
            return {"hap": child, "cv": cv, "cv_idx": state["cv_idx"],
                    "eff": state["eff"], "clip": state["clip"] + d["clip"]}
        children = [torch.empty((nloc, m_loc), dtype=torch.uint8,
                                device=par[0].device) for _ in range(2)]
        for pc in pieces:
            meiose_planes_window(par[0], par[1], *children, pc.lo, fl, ml,
                                 *piece_plan(plan[0], plan[1], pc,
                                             cfg.chr_len),
                                 *piece_plan(plan[2], plan[3], pc,
                                             cfg.chr_len),
                                 n_chr=pc.n_chr, chr_len=pc.length)
        if d["mut"] is not None:
            for g, (pos, valid) in enumerate(d["mut"]):
                loc, inr = local_loci(pos[rows], lo, m_loc)
                dense_step.flip_loci(children[g], loc.clamp(max=m_loc - 1),
                                     valid[rows] & inr)
        return {"hapA": children[0], "hapB": children[1],
                "cv_idx": state["cv_idx"], "eff": state["eff"],
                "clip": state["clip"] + d["clip"]}

    return step


# ------------------------------------------------ deme and routed steps
def _base_seed(gen: torch.Generator) -> int:
    return int(torch.randint(0, 1 << 62, (1,), generator=gen,
                             device=gen.device).item())


def _stream(device, base: int, *keys: int) -> torch.Generator:
    """A generator derived from `base` and `keys`, as `fold_in` derives
    the JAX steps' keys."""
    x = base
    for k in keys:
        x = (x * 1000249 + k + 1) & _MASK
    g = torch.Generator(device=device)
    g.manual_seed(x)
    return g


def _local_config(cfg: PackedConfig, ind: int, loci: int, **kw):
    if cfg.n % ind or cfg.n_chr % loci:
        raise ValueError(f"n {cfg.n} and {cfg.n_chr} chromosomes must "
                         f"split over (ind {ind}, loci {loci})")
    return dataclasses.replace(cfg, n=cfg.n // ind, m=cfg.m // loci,
                               n_chr=cfg.n_chr // loci, **kw)


def _to(draws: dict, device) -> dict:
    return {k: v if v is None or isinstance(v, (int, float))
            else torch.as_tensor(np.asarray(v)).to(device)
            for k, v in draws.items()}


def _plan(gen, cfg_loc: PackedConfig, n: int):
    """The per-shard stream's draws: both gametes' plans, then (with
    mutations) both gametes' mutation loci."""
    dl = cfg_loc.as_dense()
    xo_p, st_p, c1 = dense_step._sample_gamete_plan(gen, dl, n)
    xo_m, st_m, c2 = dense_step._sample_gamete_plan(gen, dl, n)
    clip, mu = c1 + c2, None
    if cfg_loc.mut_rate > 0:
        mu_a, ca = pk.mutation_positions(gen, n, cfg_loc)
        mu_b, cb = pk.mutation_positions(gen, n, cfg_loc)
        mu = torch.stack([mu_a, mu_b], 1)
        clip = clip + ca + cb
    return dict(xo_p=xo_p, st_p=st_p, xo_m=xo_m, st_m=st_m, mu=mu,
                clip=clip)


def _global_z(cv, eff, n_total: int, group, log):
    """Standardized breeding values of this rank's rows, centred on the
    whole population's allele counts (an integer sum over 'ind') and
    standardized to its moments (f32 sums over 'ind')."""
    t = (cv[:, 0].to(torch.int32) + cv[:, 1].to(torch.int32))
    tsum = comm.all_reduce(t.sum(0, dtype=torch.int32), "sum", group, log)
    p = tsum.to(torch.float32) / (2.0 * n_total)
    bv = (t.to(torch.float32) - 2.0 * p[None, :]) @ eff
    mu = comm.all_reduce(bv.sum().reshape(1), "sum", group, log) / n_total
    var = comm.all_reduce(((bv - mu) ** 2).sum().reshape(1), "sum", group,
                          log) / n_total
    return (bv - mu) / (torch.sqrt(var) + 1e-9)


def _reproduce(hap, fathers, mothers, plan: dict, cfg_loc: PackedConfig):
    """Both gametes of every child on this rank's words (kernel
    `meiose_packed`)."""
    return meiose_packed(hap, fathers, mothers, plan["xo_p"], plan["st_p"],
                         plan["xo_m"], plan["st_m"], plan["mu"],
                         n_chr=cfg_loc.n_chr, chr_len=cfg_loc.chr_len)


def _cv_advance(cv_par, par, plan, cv_idx, lo: int, cfg_loc, group, log):
    """The children's (n, 2, ncv) CV matrix: each loci rank applies its
    own plan to the CV columns it holds, the rest zero, and one integer sum
    over 'loci' reassembles it."""
    m_loc = cfg_loc.m
    inr = ((cv_idx >= lo) & (cv_idx < lo + m_loc)).to(torch.uint8)
    idx = (cv_idx - lo).clamp(0, m_loc - 1).to(torch.int32)
    mu = plan["mu"]
    parts = [pk.cv_child(cv_par, p, plan[x], plan[s],
                         None if mu is None else mu[:, g], idx,
                         cfg_loc.chr_len) * inr[None, :]
             for g, (p, x, s) in enumerate(((par[0], "xo_p", "st_p"),
                                            (par[1], "xo_m", "st_m")))]
    cv = comm.all_reduce(torch.stack(parts, 1).to(torch.int32), "sum",
                         group, log)
    return cv.to(torch.uint8)


def make_deme_step(cfg: PackedConfig, mesh: Mesh, mig_rate: float = 0.0,
                   mig_matrix=None):
    """step(state, gen, draws=None) -> state: deme mode (the JAX
    `make_deme_step`). Each 'ind' coordinate is a deme whose children pick
    parents within it; each loci rank holds whole chromosomes. With
    `mig_rate`, round(mig_rate * n_deme) children sampled without
    replacement move to the next deme in a ring; with `mig_matrix` (D, D)
    row-stochastic, deme i sends round(m_ij * n_deme) children to deme j
    in one all-to-all and arrivals replace the departed slots first.

    Streams, from a base seed drawn from `gen`: a loci-invariant one per
    deme (mating, then the emigrant permutation) and one per rank
    (crossovers, then mutations). `draws` replaces them: `fathers`,
    `mothers` (deme-local rows), `xo_p`, `st_p`, `xo_m`, `st_m` (local
    loci), `mu` ((n_loc, 2, Km) local loci, or None), `perm` (or None) and
    `clip` (this rank's truncated draws)."""
    if not isinstance(cfg, PackedConfig):
        raise TypeError("make_deme_step takes a PackedConfig")
    ind_n, loci_n = mesh.size("ind"), mesh.size("loci")
    cfg_loc = _local_config(cfg, ind_n, loci_n,
                            mut_rate=cfg.mut_rate / loci_n)
    n_loc, m_loc = cfg_loc.n, cfg_loc.m
    n_emig = int(round(mig_rate * n_loc)) if ind_n > 1 else 0
    if not 0 <= n_emig <= n_loc:
        raise ValueError(f"mig_rate {mig_rate} out of range")
    counts = None
    if mig_matrix is not None:
        if n_emig:
            raise ValueError("give either mig_rate or mig_matrix, not both")
        M = np.asarray(mig_matrix, dtype=np.float64)
        if M.shape != (ind_n, ind_n):
            raise ValueError(f"mig_matrix must be ({ind_n}, {ind_n})")
        if np.any(np.abs(M.sum(axis=1) - 1.0) > 1e-5):
            raise ValueError("mig_matrix rows must sum to 1")
        counts = np.round(M * n_loc).astype(np.int64)
        np.fill_diagonal(counts, 0)  # stayers are not exchanged
        if counts.sum(axis=1).max() > n_loc:
            raise ValueError("mig_matrix emigrates more than a whole deme")
        k_pad = max(int(counts.max()), 1)
        # send_off[i, j]: offset of the i->j emigrants in deme i's perm;
        # recv_off[s, j]: ordinal of deme s's arrivals among deme j's
        send_off = np.concatenate(
            [np.zeros((ind_n, 1), np.int64),
             np.cumsum(counts, axis=1)[:, :-1]], axis=1)
        recv_off = np.concatenate(
            [np.zeros((1, ind_n), np.int64),
             np.cumsum(counts, axis=0)[:-1, :]], axis=0)
    i, j = mesh.coord("ind"), mesh.coord("loci")
    dev, log = mesh.device, mesh.traffic
    g_ind, g_loci = mesh.group("ind"), mesh.group("loci")

    def step(state, gen: torch.Generator, draws: Optional[dict] = None):
        hap, cv = state["hap"], state["cv"]
        if draws is None:
            base = _base_seed(gen)
            k_ind = _stream(dev, base, i)  # loci-invariant: mating
            k_loc = _stream(dev, base, i, 1 + j)  # per rank: xo, mutation
            if cfg.selection:
                w = torch.softmax(_global_z(cv, state["eff"], cfg.n, g_ind,
                                            log), 0)
                fathers = dense_step._categorical(k_ind, w, n_loc)
                mothers = dense_step._categorical(k_ind, w, n_loc)
            else:
                fathers, mothers = (torch.randint(0, n_loc, (n_loc,),
                                                  generator=k_ind, device=dev)
                                    for _ in range(2))
            plan = _plan(k_loc, cfg_loc, n_loc)
            perm = (torch.randperm(n_loc, generator=k_ind, device=dev)
                    if n_emig or counts is not None else None)
            fathers, mothers = fathers.to(torch.int32), mothers.to(torch.int32)
        else:
            dr = _to(draws, dev)
            fathers, mothers = (dr[k].to(torch.int32)
                                for k in ("fathers", "mothers"))
            plan = {k: dr[k] for k in ("xo_p", "st_p", "xo_m", "st_m", "mu",
                                       "clip")}
            perm = dr.get("perm")
        child = _reproduce(hap, fathers, mothers, plan, cfg_loc)
        cv = _cv_advance(cv, (fathers, mothers), plan, state["cv_idx"],
                         j * m_loc, cfg_loc, g_loci, log)
        if n_emig:
            slots = perm[:n_emig].long()
            child[slots] = comm.ring_permute(child[slots], 1, g_ind, log)
            cv[slots] = comm.ring_permute(cv[slots], 1, g_ind, log)
        if counts is not None:
            perm = perm.long()
            lane = torch.arange(k_pad, device=dev)[None, :]
            soff = torch.as_tensor(send_off[i], device=dev)
            rows = perm[(soff[:, None] + lane).clamp(0, n_loc - 1)].reshape(-1)
            recv_hap = comm.all_to_all_rows(child[rows], [k_pad] * ind_n,
                                            [k_pad] * ind_n, g_ind, log)
            recv_cv = comm.all_to_all_rows(cv[rows], [k_pad] * ind_n,
                                           [k_pad] * ind_n, g_ind, log)
            cnt = torch.as_tensor(counts[:, i], device=dev)
            roff = torch.as_tensor(recv_off[:, i], device=dev)
            valid = (lane < cnt[:, None]).reshape(-1)
            slot = perm[(roff[:, None] + lane).clamp(0, n_loc - 1)
                        ].reshape(-1)
            child[slot[valid]] = recv_hap[valid]
            cv[slot[valid]] = recv_cv[valid]
        clip = comm.all_reduce(torch.as_tensor(plan["clip"], device=dev)
                               .to(torch.int64).reshape(1), "sum", None, log)
        return {"hap": child, "cv": cv, "cv_idx": state["cv_idx"],
                "eff": state["eff"], "clip": state["clip"] + clip[0]}

    return step


def routed_fetch(local_rows: torch.Tensor, global_idx: torch.Tensor,
                 nloc: int, n_dev: int, cap: int, group=None,
                 log: Optional[Traffic] = None):
    """Rows `global_idx` of an array sharded in blocks of `nloc` rows over
    `group`, fetched by request routing (the JAX `routed_fetch`): requests
    sorted by owning rank, exchanged as (D, cap) index packets in one
    all-to-all, served from local rows and returned in a second. `cap`
    bounds the requests a rank sends each owner; the rest are dropped and
    counted (the second return value), and read whatever row their clipped
    slot holds, as in JAX."""
    D = n_dev
    R = global_idx.shape[0]
    dev = local_rows.device
    my = dist.get_rank(group)
    gi = global_idx.long()
    owner = (gi // nloc).clamp(0, D - 1)
    order = torch.argsort(owner, stable=True)
    owner_s, idx_s = owner[order], gi[order]
    cnt = torch.bincount(owner_s, minlength=D)[:D]
    base = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(R, device=dev) - base[owner_s]
    overflow = (pos >= cap).sum()
    req = torch.full((D, cap), -1, dtype=torch.int32, device=dev)
    keep = pos < cap
    req[owner_s[keep], pos[keep]] = idx_s[keep].to(torch.int32)
    ones = [1] * D
    req_in = comm.all_to_all_rows(req, ones, ones, group, log)
    loc = (req_in.long() - my * nloc).clamp(0, nloc - 1).reshape(-1)
    rest = tuple(local_rows.shape[1:])
    served = local_rows[loc].reshape((D, cap) + rest)
    back = comm.all_to_all_rows(served, ones, ones, group, log)
    del served
    flat = back.reshape((D * cap,) + rest)
    slot = (owner_s * cap + pos).clamp(0, D * cap - 1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(R, device=dev)
    return flat[slot[inv]], overflow  # request k's row back in its place


def make_routed_step(cfg: PackedConfig, mesh: Mesh):
    """step(state, gen, draws=None) -> state: the request-routed panmictic
    step (the JAX `make_routed_step`). Children stay on their rank; mates
    are drawn over the whole population (with selection, from the
    standardized values all-gathered over 'ind'), and the parents' planes
    and CV rows come by `routed_fetch` with cap = R/D + 6 sqrt(R/D) + 8
    (R = 2 n/D requests); overflows join the clip count.

    Streams: a mesh-invariant one for mating and one per rank for
    crossovers and mutations. `draws` replaces them: `fathers`, `mothers`
    ((n,) global rows), `xo_p`, `st_p`, `xo_m`, `st_m`, `mu` (local), and
    `clip`."""
    if not isinstance(cfg, PackedConfig):
        raise TypeError("make_routed_step takes a PackedConfig")
    ind_n, loci_n = mesh.size("ind"), mesh.size("loci")
    cfg_loc = _local_config(cfg, ind_n, loci_n)
    nloc = cfg_loc.n
    R = 2 * nloc
    cap = int(R // ind_n + 6 * np.sqrt(max(R // ind_n, 1)) + 8)
    i, j = mesh.coord("ind"), mesh.coord("loci")
    dev, log = mesh.device, mesh.traffic
    g_ind, g_loci = mesh.group("ind"), mesh.group("loci")

    def step(state, gen: torch.Generator, draws: Optional[dict] = None):
        hap, cv = state["hap"], state["cv"]
        if draws is None:
            base = _base_seed(gen)
            k_mate = _stream(dev, base, 0)  # mesh-invariant: mating
            k_loc = _stream(dev, base, 1 + i, 1 + j)  # per rank
            if cfg.selection:
                z = gather_dim(_global_z(cv, state["eff"], cfg.n, g_ind, log),
                               0, g_ind, log)
                w = torch.softmax(z, 0)
                fathers = dense_step._categorical(k_mate, w, cfg.n)
                mothers = dense_step._categorical(k_mate, w, cfg.n)
            else:
                fathers, mothers = (torch.randint(0, cfg.n, (cfg.n,),
                                                  generator=k_mate,
                                                  device=dev)
                                    for _ in range(2))
            plan = _plan(k_loc, cfg_loc, nloc)
        else:
            dr = _to(draws, dev)
            fathers, mothers = dr["fathers"], dr["mothers"]
            plan = {k: dr[k] for k in ("xo_p", "st_p", "xo_m", "st_m", "mu",
                                       "clip")}
        mine = slice(i * nloc, (i + 1) * nloc)
        want = torch.cat([fathers[mine], mothers[mine]])
        par_hap, ov1 = routed_fetch(hap, want, nloc, ind_n, cap, g_ind, log)
        par_cv, ov2 = routed_fetch(cv, want, nloc, ind_n, cap, g_ind, log)
        fi = torch.arange(nloc, dtype=torch.int32, device=dev)
        mi = fi + nloc
        child = _reproduce(par_hap, fi, mi, plan, cfg_loc)
        new_cv = _cv_advance(par_cv, (fi, mi), plan, state["cv_idx"],
                             j * cfg_loc.m, cfg_loc, g_loci, log)
        clip = (torch.as_tensor(plan["clip"], device=dev).to(torch.int64)
                + ov1 + ov2).reshape(1)
        clip = comm.all_reduce(clip, "sum", None, log)
        return {"hap": child, "cv": new_cv, "cv_idx": state["cv_idx"],
                "eff": state["eff"], "clip": state["clip"] + clip[0]}

    return step

