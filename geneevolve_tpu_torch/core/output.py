"""Genotype output of the segment engine: the ledger painted over the
founder panel (counterpart of geneevolve_tpu/core/output.py).

Painting is one `ops.paint` launch a chunk of rows and loci (the CUDA
kernel on the card, its plain version on the CPU); the painted block comes
to the host and is written. Founder panels are read per chromosome at
output time (`Simulation.cpp:1105-1138`, `:1186-1230`). Files and their
bytes are the JAX package's: `<prefix>.pop<i>.gen<g>.chr<c>.{hap,indv,
ped,map,vcf,int}`.

Under a mesh each chromosome's ledger rows are gathered over 'ind'
(`Simulation.chrom_ledger`, a collective every rank joins) and the node's
first rank paints and writes them: gathering painted genotypes instead
would move 2 x m bytes a row. On several nodes each node writes its
ranks' rows into `.hostK` files (`Simulation.output_rows`). The JAX
package paints chunks of 2^20 loci, a TPU memory choice (at 30,000 rows
it would be a 64 GB block); the port sizes its chunks from the card's
free memory (`_chunks`).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from geneevolve_tpu_torch.core import segments
from geneevolve_tpu_torch.io import hap as hap_io
from geneevolve_tpu_torch.io import plink as plink_io
from geneevolve_tpu_torch.io import vcf as vcf_io
from geneevolve_tpu_torch.ops.paint import SPAN as _SPAN  # loci a block
from geneevolve_tpu_torch.ops.paint import paint
from geneevolve_tpu_torch.parallel import multihost
from geneevolve_tpu_torch.utils import telemetry


def _chunks(n: int, m: int, H: int, device: torch.device):
    """(rows, loci) one paint call covers: everything when the painted
    block and the panel's slice fit in half the card's free memory, else
    fewer loci (a multiple of the kernel's span), then fewer rows. On the
    CPU the plain version bounds its own temporaries: everything."""
    if device.type != "cuda":
        return n, m
    free, _total = torch.cuda.mem_get_info(device)
    budget = free // 2
    per_locus = 2 * n + H  # painted bytes and panel bytes a locus
    mc = m
    if per_locus * mc > budget:
        mc = min(m, max(_SPAN, budget // per_locus // _SPAN * _SPAN))
    rc = n
    if 2 * rc * mc + H * mc > budget:
        rc = max(1, (budget - H * mc) // (2 * mc))
    return rc, mc


def paint_chunks(
    seg_st: torch.Tensor,  # (n, 2, S)
    seg_hap: torch.Tensor,
    mut: torch.Tensor,
    founder: np.ndarray,  # (H, m) uint8, concatenated over populations
    legend_pos: np.ndarray,  # (m,) int64
    timer=None,
):
    """Yield (lo, (n, 2, mc) uint8) painted loci chunks on the host — the
    streaming form: SNP-major outputs (.hap, VCF) consume each chunk and
    drop it. With a `StageTimer`, adds the fenced paint time and the
    device-to-host copy time under `genotype_output/paint` and
    `genotype_output/copy`, and takes each upload, fence and copy through
    its door (`telemetry.host_wait`)."""
    dev = seg_st.device
    n, m, H = seg_st.shape[0], len(legend_pos), founder.shape[0]
    rc, mc = _chunks(n, m, H, dev)
    ledger = [x.contiguous()[None] for x in (seg_st, seg_hap, mut)]
    for lo in range(0, m, mc):
        hi = min(lo + mc, m)
        pos = np.asarray(legend_pos[lo:hi], dtype=np.int32)
        fd = np.ascontiguousarray(founder[:, lo:hi])
        with telemetry.host_wait(timer, "paint_upload"):
            pos = torch.as_tensor(pos, device=dev)[None]
            fd = torch.as_tensor(fd, device=dev)[None]
        blk = np.empty((n, 2, hi - lo), dtype=np.uint8)
        for r0 in range(0, n, rc):
            t0 = time.perf_counter()
            out = paint(*(x[:, r0:r0 + rc] for x in ledger), fd, pos)
            with telemetry.host_wait(timer, "paint"):
                telemetry.device_fence(dev)
            t1 = time.perf_counter()
            with telemetry.host_wait(timer, "paint_to_host"):
                blk[r0:r0 + rc] = out[0].cpu().numpy()
            if timer is not None:
                timer.add("genotype_output/paint", t1 - t0)
                timer.add("genotype_output/copy", time.perf_counter() - t1)
        yield lo, blk


def paint_chromosome(seg_st, seg_hap, mut, founder: np.ndarray,
                     legend_pos: np.ndarray) -> np.ndarray:
    """(n, 2, m) uint8 simulated haplotypes, fully materialized (PED output
    and tests; the streaming writers use `paint_chunks`)."""
    return np.concatenate(
        [blk for _, blk in paint_chunks(seg_st, seg_hap, mut, founder,
                                        legend_pos)],
        axis=2,
    )


def _load_founder_chr(sim, ic: int):
    """Concatenated founder panel + per-pop legends for one chromosome."""
    legends, panels = [], []
    for p in sim.pops:
        if p.vcf_addresses:
            v = vcf_io.read_vcf(p.vcf_addresses[ic][1])
            legends.append(v)
            panels.append(v.hap)
        else:
            _, hap_path, legend_path, _ = p.hap_addresses[ic]
            legends.append(hap_io.read_legend(legend_path))
            panels.append(hap_io.read_hap(hap_path))
    m0 = panels[0].shape[1]
    for pan in panels[1:]:
        if pan.shape[1] != m0:
            raise RuntimeError(
                "founder panels must have the same SNP count across "
                "populations for genotype output"
            )
    return legends, np.concatenate(panels, axis=0)


def _host_fields(st, rows):
    """(ids, ped, sex) of the rows this node writes (all with None)."""
    if rows is None:
        return st.ids, st.ped, st.sex
    return st.ids[rows], {k: v[rows] for k, v in st.ped.items()}, \
        st.sex[rows]


def save_genotypes(sim, gen: int) -> None:
    cfg = sim.cfg
    timer = sim.timer
    suffix = multihost.host_suffix() if sim.mesh is not None else ""
    want_paint = cfg.out_hap or cfg.out_plink or cfg.out_plink01 or cfg.out_vcf
    if want_paint:
        for ic, chrom in enumerate(sim.chrs):
            if sim.writes_genotypes:
                t0 = time.perf_counter()
                legends, founder = _load_founder_chr(sim, ic)
                timer.add("genotype_output/load_panel",
                          time.perf_counter() - t0)
            for p in sim.pops:
                st = p.state
                ledger = sim.chrom_ledger(p, ic)  # a collective on a mesh
                if not sim.writes_genotypes:
                    continue
                rows = sim.output_rows(st)
                if rows is not None:
                    with telemetry.host_wait(timer, "output_rows"):
                        ledger = [x[torch.as_tensor(rows, device=x.device)]
                                  for x in ledger]
                ids, ped, sex = _host_fields(st, rows)
                n_out = len(ids)
                base = (f"{cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
                        f"{suffix}")
                leg = legends[p.index]
                pos = _legend_pos(leg)
                m = len(pos)
                t0 = time.perf_counter()
                hap_f = None
                vcf_w = None
                if cfg.out_hap:
                    hap_f = open(base + ".hap", "wb")
                    hap_io.write_indv(base + ".indv", ids + 1)
                if cfg.out_vcf:
                    v = vcf_io.VcfData(
                        samples=[f"g{gen}_{i + 1}" for i in ids],
                        chrom=np.full(m, str(chrom), dtype=object),
                        pos=pos,
                        ids=_legend_ids(leg),
                        ref=_legend_al0(leg),
                        alt=_legend_al1(leg),
                        qual=np.full(m, ".", dtype=object),
                        filt=np.full(m, ".", dtype=object),
                        info=np.full(m, ".", dtype=object),
                        fmt=np.full(m, "GT", dtype=object),
                        hap=np.empty((0, 0), dtype=np.uint8),  # streamed
                        meta_lines=vcf_io.default_meta_lines(),
                    )
                    if isinstance(leg, vcf_io.VcfData):
                        v.chrom = leg.chrom
                        v.qual = leg.qual
                        v.filt = leg.filt
                    vcf_w = vcf_io.VcfStreamWriter(base + ".vcf", v)
                need_full = cfg.out_plink or cfg.out_plink01 or cfg.debug
                full_blocks = [] if need_full else None
                timer.add("genotype_output/write", time.perf_counter() - t0)
                chunks = paint_chunks(*ledger, founder, pos, timer)
                for lo, blk in chunks:
                    t0 = time.perf_counter()
                    if hap_f is not None:
                        hap_f.write(hap_io.hap_bytes(blk.reshape(n_out * 2,
                                                                 -1)))
                    if vcf_w is not None:
                        vcf_w.write_block(lo, blk[:, 0], blk[:, 1])
                    if full_blocks is not None:
                        full_blocks.append(blk)
                    timer.add("genotype_output/write",
                              time.perf_counter() - t0)
                t0 = time.perf_counter()
                if hap_f is not None:
                    hap_f.close()
                if vcf_w is not None:
                    vcf_w.close()
                if need_full:
                    painted = np.concatenate(full_blocks, axis=2)
                    del full_blocks
                    if cfg.debug:
                        # AF spot-check on the last SNPs
                        # (`Simulation.cpp:1368-1387`)
                        print("The last allele frequencies")
                        for af in painted[:, :, -10:].mean(axis=(0, 1)):
                            print(f"AF = {af:g}")
                if cfg.out_plink or cfg.out_plink01:
                    ped_ids = plink_io.PedIds(
                        fid=ped["father"] + 1,  # FID = father (`Simulation.cpp:1396`)
                        iid=ids + 1,
                        pid=ped["father"] + 1,
                        mid=ped["mother"] + 1,
                        sex=sex,
                    )
                    plink_io.write_ped_map(
                        base, np.moveaxis(painted, 1, 2), ped_ids, chrom,
                        _legend_ids(leg), pos, _legend_al0(leg),
                        _legend_al1(leg), letters=cfg.out_plink,
                    )
                timer.add("genotype_output/write", time.perf_counter() - t0)
    if cfg.out_interval:
        t0 = time.perf_counter()
        write_interval(sim, gen)
        timer.add("genotype_output/interval", time.perf_counter() - t0)


def _legend_pos(leg):
    return leg.pos


def _legend_ids(leg):
    return leg.ids


def _legend_al0(leg):
    return leg.ref if isinstance(leg, vcf_io.VcfData) else leg.al0


def _legend_al1(leg):
    return leg.alt if isinstance(leg, vcf_io.VcfData) else leg.al1


# ------------------------------------------------------------ .int writer
def _int_cells(x: np.ndarray):
    """(N, w) uint8 decimal text of the int array x, right-aligned, and
    the (N, w) mask of its used cells (a '-' for negatives)."""
    x = np.asarray(x, dtype=np.int64)
    a = np.abs(x)
    w = len(str(int(a.max()))) + 1 if a.size else 1
    cells = np.empty((len(x), w), dtype=np.uint8)
    nd = np.ones(len(x), dtype=np.int64)  # digits: at least one
    for k in range(w - 1, -1, -1):
        cells[:, k] = a % 10 + ord("0")
        a = a // 10
        nd += (a > 0) & (k > 0)
    neg = x < 0
    cells[np.arange(len(x))[neg], w - 1 - nd[neg]] = ord("-")
    used = nd + neg
    return cells, np.arange(w)[None, :] >= (w - used)[:, None]


def _text_cells(strings: List[str], idx: np.ndarray):
    """Cells and mask of `strings[idx]` (left-aligned)."""
    enc = [s.encode() for s in strings]
    w = max((len(s) for s in enc), default=0)
    table = np.zeros((len(enc), max(w, 1)), dtype=np.uint8)
    lens = np.array([len(s) for s in enc], dtype=np.int64)
    for i, s in enumerate(enc):
        table[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    cells = table[idx]
    return cells, np.arange(table.shape[1])[None, :] < lens[idx][:, None]


def _join_lines(fields) -> bytes:
    """Concatenate per-line fields (each (cells, mask), or a constant
    `bytes` for every line) into the lines' bytes."""
    n = next(f[0].shape[0] for f in fields if not isinstance(f, bytes))
    if n == 0:
        return b""
    cells, masks = [], []
    for f in fields:
        if isinstance(f, bytes):
            row = np.frombuffer(f, dtype=np.uint8)
            cells.append(np.broadcast_to(row, (n, len(row))))
            masks.append(np.ones((n, len(row)), dtype=bool))
        else:
            cells.append(f[0])
            masks.append(f[1])
    return np.concatenate(cells, 1)[np.concatenate(masks, 1)].tobytes()


def write_interval(sim, gen: int) -> None:
    """IBD ground-truth dump, schema per `ras_write_hap_to_interval_format`
    (`Simulation.cpp:1582-1639`): `h_ID chr hap st en hap_index gen0_indv
    root_pop`, 1-based IDs, gen0_indv = founder sample id + `.1/.2`.

    When `--out_interval` is set the engine runs meiosis with
    `merge_ibd=False`, so the ledger keeps every crossover-split part
    boundary like the reference's `recombine` (`Simulation.cpp:2903-2958`).
    The JAX package writes a line at a time; here every line of a file is
    built at once in numpy, with the same bytes. Under a mesh every rank
    joins the ledger gathers and the node's first rank writes."""
    offsets = np.array([p.hap_offset for p in sim.pops])
    # every founder hap's tail `hap_index gen0_indv root_pop`
    tails = []
    for rp, q in enumerate(sim.pops):
        for local in range(2 * len(q.indv_ids)):
            tails.append(f" {local + 1} {q.indv_ids[local // 2]}."
                         f"{local % 2 + 1} {rp + 1}\n")
    tail_base = np.array([2 * len(q.indv_ids) for q in sim.pops])
    tail_base = np.concatenate([[0], np.cumsum(tail_base)[:-1]])
    big = segments.BIG
    suffix = multihost.host_suffix() if sim.mesh is not None else ""
    for p in sim.pops:
        st = p.state
        rows_out = sim.output_rows(st)
        ids = st.ids if rows_out is None else st.ids[rows_out]
        for ic, chrom in enumerate(sim.chrs):
            led = sim.chrom_ledger(p, ic)  # a collective on a mesh
            if not sim.writes_genotypes:
                continue
            path = (f"{sim.cfg.prefix}.pop{p.index + 1}.gen{gen}.chr{chrom}"
                    f"{suffix}.int")
            with telemetry.host_wait(sim.timer, "interval"):
                seg_st = led[0].cpu().numpy()  # (n, 2, S)
                seg_hap = led[1].cpu().numpy().astype(np.int64)
            if rows_out is not None:
                seg_st, seg_hap = seg_st[rows_out], seg_hap[rows_out]
            n, _, S = seg_st.shape
            k = (seg_st < big).sum(-1, keepdims=True)  # (n, 2, 1)
            slot = np.arange(S)[None, None, :]
            keep = slot < k
            nxt = np.concatenate(
                [seg_st[..., 1:], np.zeros((n, 2, 1), seg_st.dtype)], -1)
            ens = np.where(slot + 1 < k, nxt, p.rmaps[chrom].chr_end)
            rows = np.broadcast_to(np.arange(n)[:, None, None], keep.shape)
            hs = np.broadcast_to(np.arange(2)[None, :, None], keep.shape)
            ghap = seg_hap[keep]
            rp = np.searchsorted(offsets, ghap, side="right") - 1
            local = ghap - offsets[rp]
            n_local = np.array([2 * len(q.indv_ids) for q in sim.pops])[rp]
            if (local >= n_local).any():
                raise IndexError("a ledger hap lies past its population's "
                                 "founder samples")
            body = _join_lines([
                _int_cells(ids[rows[keep]] + 1),
                f" {chrom} ".encode(),
                _int_cells(hs[keep]),
                b" ",
                _int_cells(seg_st[keep]),
                b" ",
                _int_cells(ens[keep]),
                _text_cells(tails, tail_base[rp] + local),
            ])
            with open(path, "wb") as f:
                f.write(b"h_ID chr hap st en hap_index gen0_indv root_pop\n")
                f.write(body)
