#!/usr/bin/env python3
"""Time the meiosis kernels (`meiose_packed`, its three entries and its
window entry, and `meiose_planes`) or the paint kernel (`paint`) of two
checkouts of the PyTorch/CUDA port in turns, on one CUDA card.

    python3 kernel_ab.py OTHER_TREE           # OTHER, this, this, OTHER
    python3 kernel_ab.py --paint OTHER_TREE   # the same for paint
    python3 kernel_ab.py --one TREE [--paint] # one tree, one JSON line

Each tree runs in a process of its own (both ports are one package name),
builds its kernels from its own sources and times each entry on the same
inputs, made from a seed by this script: the flagship shape (n 16,384 x
1 Mi loci, 8 chromosomes of 1 Morgan, K 8, Km 8 at 1 mutation a gamete,
couple-sorted parents, `bench.py:200-211`) and the dense slice's shape
(30,563 children of 30,708 parent rows, 22 chromosomes of 64 words, K 23,
~1.6 crossovers a chromosome, Km 8 at 4.3e-4 mutations a gamete, parents in
no order), and their odd twins: `flagship_odd` (8 chromosomes of 4,095
words) and `dense_odd` (22 of 63 words, the dense backend's padding of
2,000 SNPs), whose child rows are not whole 16-byte vectors; and
`dense_edges` (20 x 63 words: heads and tails, no plane shifted) and
`dense_shift` (22 x 64 words, the parent planes one word past 16 bytes:
every plane shifted, no head or tail), which take those costs apart. At the
flagship's planes the window entry (`meiose_packed_window`) also runs on
four whole chromosomes, the second half of one and a chromosome less its
first word (an odd word offset), each with the plan made local to the
piece as the sharded steps make it. `meiose_planes` runs at n 4,096 x 1
Mi loci (8 chromosomes), its window entry on four whole chromosomes and
on a chromosome less its first 5 loci (an odd byte offset), and at 8
chromosomes of 131,071 loci (`m_odd`: rows 8 bytes off 16 every other
row). Per entry: bit-exact against the tree's plain version, then the
median ms of one call (CUDA events, 20 calls, entries in turns), of a call
with 10 queued between two events (5 runs), the bound as `chip_smoke.py`
counts it (for the packed meiosis the parent words a gamete takes a bit
from, and both planes of every distinct parent row as
`full_rows_bound_ms`), and the launch plan where the tree's wrapper
records one. The card's name and power limit come first; the JSON is the
last line.

`--paint` times `paint` at the segment slice's three shapes, on ledgers
made from a seed (starts 1 + Poisson(9) a row, at most S 49, int16 haps;
Poisson(5) mutations, at most M 27, one row in eight carrying a painted
position; BIG padding): one full-width chromosome (29,978 x 2 rows x
14,588 sorted loci, 8 before the chromosome's start, panel 20,000 x
14,588), all 22 chromosomes in one launch, and the gather path's call (22
chromosomes x 30,708 x 2 rows x 100 sorted CV positions, panel 20,000 x
100). Per shape: bit-exact against the tree's plain version (each
chromosome of the 22), the median ms of one call and of a call with 10
queued, the bound as `chip_smoke.py` counts it and the need bound (only
the ledger and mutation slots before each row's first BIG).
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
# name -> n, parent rows, n_chr, words a chromosome, K, crossovers a
# chromosome, Km, mutations a gamete, couple-sorted parents
CASES = {
    "flagship": (16_384, 16_384, 8, 4096, 8, 1.0, 8, 1.0, True),
    "flagship_odd": (16_384, 16_384, 8, 4095, 8, 1.0, 8, 1.0, True),
    "dense_slice": (30_563, 30_708, 22, 64, 23, 1.6, 8, 4.3e-4, False),
    "dense_odd": (30_563, 30_708, 22, 63, 23, 1.6, 8, 4.3e-4, False),
    # the odd twin's two costs apart: rows of 63 words with every plane at
    # its child row's phase (20 chromosomes, mw % 4 == 0: heads and tails
    # only), and rows of 64 words with the parent planes one word past 16
    # bytes (every plane shifted, no head or tail)
    "dense_edges": (30_563, 30_708, 20, 63, 23, 1.6, 8, 4.3e-4, False),
    "dense_shift": (30_563, 30_708, 22, 64, 23, 1.6, 8, 4.3e-4, False),
}
# window entries at the flagship's planes: name -> first chromosome,
# chromosomes, first locus in it, loci each
WINDOWS = {
    "window_whole_chromosomes": (4, 4, 0, 131_072),
    "window_half_chromosome": (3, 1, 65_536, 65_536),
    "window_odd_word": (2, 1, 32, 131_040),
}
# the byte meiosis: name -> rows, chromosomes, loci each, window (first
# chromosome, chromosomes, first locus in it, loci each) or None
PLANES = {
    "whole_planes": (4096, 8, 131_072, None),
    "window_whole_chromosomes": (4096, 8, 131_072, (4, 4, 0, 131_072)),
    "window_odd_offset": (4096, 8, 131_072, (2, 1, 5, 131_067)),
    "m_odd": (4096, 8, 131_071, None),
}


def _inputs(dev, n, rows, n_chr, cw, K, lam, km, lam_mu, couples):
    import torch

    g = torch.Generator(device=dev).manual_seed(2024)
    kw = dict(generator=g, device=dev)
    chr_len, mw = 32 * cw, n_chr * cw
    m = mw * 32
    hap = torch.randint(-2**31, 2**31 - 1, (rows, 2, mw), dtype=torch.int32,
                        **kw)
    par = [torch.randint(0, rows, (n,), dtype=torch.int32, **kw)
           for _ in range(2)]
    if couples:  # children sorted by couple: siblings adjacent
        cc = torch.randint(0, n // 2, (n,), **kw).sort().values
        par = [p[cc] for p in par]
    plan = []
    for _ in range(2):
        cnt = torch.poisson(torch.full((n, n_chr, 1), lam, device=dev),
                            generator=g).clamp(max=K)
        x = (torch.randint(0, chr_len, (n, n_chr, K), **kw)
             + torch.arange(n_chr, device=dev)[:, None] * chr_len)
        x = torch.where(torch.arange(K, device=dev) < cnt, x, m)
        plan += [x.to(torch.int32),
                 torch.randint(0, 2, (n, n_chr), dtype=torch.int32, **kw)]
    cnt = torch.poisson(torch.full((n, 2, 1), lam_mu, device=dev),
                        generator=g).clamp(max=km)
    mu = torch.where(torch.arange(km, device=dev) < cnt,
                     torch.randint(0, m, (n, 2, km), **kw), m)
    return hap, (*par, *plan), mu.to(torch.int32), chr_len


# name -> C, rows, loci, panel haplotypes
PAINT_CASES = {
    "full_width": (1, 29_978, 14_588, 20_000),
    "all_22": (22, 29_978, 14_588, 20_000),
    "gather_path": (22, 30_708, 100, 20_000),
}
PAINT_S, PAINT_M, CHR_BP = 49, 27, 100_000_000


def _paint_inputs(dev, C, rows, Q, H):
    import torch

    from geneevolve_tpu_torch.core.segments import BIG

    g = torch.Generator(device=dev).manual_seed(2024)
    kw = dict(generator=g, device=dev)
    shape = (C, rows, 2)

    def ledger_rows(lam, cap):
        k = torch.poisson(torch.full(shape, lam, device=dev),
                          generator=g).clamp(max=cap)
        v = torch.randint(1, CHR_BP, (*shape, cap), **kw)
        v = torch.where(torch.arange(cap, device=dev) < k[..., None], v, BIG)
        return v.sort(-1).values.to(torch.int32)

    st = ledger_rows(9.0, PAINT_S - 1)  # after the chromosome's start
    st = torch.cat([torch.zeros((*shape, 1), dtype=torch.int32,
                                device=dev), st], -1)[..., :PAINT_S]
    st = st.contiguous()
    hap = torch.randint(0, H, st.shape, **kw).to(torch.int16)
    hap = torch.where(st < BIG, hap, 0).to(torch.int16)
    pos = torch.randint(0, CHR_BP, (C, Q), **kw).to(torch.int32)
    if Q > 8:
        pos[:, :8] = -torch.arange(1, 9, device=dev, dtype=torch.int32)
    pos = pos.sort(-1).values.contiguous()
    mut = ledger_rows(5.0, PAINT_M)
    hit = torch.randint(0, Q, shape, **kw)  # one row in 8: a painted locus
    at = torch.gather(pos, 1, hit.view(C, -1)).view(shape)
    sel = torch.randint(0, 8, shape, **kw) == 0
    mut[..., 0] = torch.where(sel, at, mut[..., 0])
    mut = mut.sort(-1).values.contiguous()
    founder = torch.randint(0, 2, (C, H, Q), dtype=torch.uint8, **kw)
    return st, hap, mut, founder, pos


def _load(tree: Path, name: str):
    """The port's `ops` module `name` from `tree`, its kernels built."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    sys.path.insert(0, str(tree))
    mod = importlib.import_module(f"geneevolve_tpu_torch.ops.{name}")
    if not Path(mod.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"imported {mod.__file__}, not from {tree}")
    importlib.import_module("geneevolve_tpu_torch.ops._build").lib()
    return mod


def one_paint(tree: Path) -> dict:
    import dataclasses

    import torch

    tp = _load(tree, "paint")
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}
    for case, spec in PAINT_CASES.items():
        args = _paint_inputs(dev, *spec)
        got = tp.paint(*args)
        for c in range(spec[0]):
            want = tp.paint_plain(*(x[c:c + 1] for x in args))
            if cs._max_abs_err(got[c:c + 1], want):
                raise AssertionError(f"paint/{case}: chromosome {c + 1} "
                                     "differs from plain")
            del want
        del got
        plan = getattr(tp.paint, "plan", None)
        res = dict(cs._paint_work(*args), **cs._paint_need(*args),
                   exact=True, plan=plan and dataclasses.asdict(plan))
        torch.cuda.empty_cache()
        kern = {"paint": lambda: tp.paint(*args)}
        res["ms"] = cs._time_turns(kern, {"paint": 20})["paint"]
        res["queued_ms"] = cs._time_queued(kern)["paint"]
        for k in ("ms", "queued_ms"):
            res[k.replace("ms", "share")] = res["bound_ms"] / res[k]
            res[k.replace("ms", "need_share")] = \
                res["need_bound_ms"] / res[k]
        out[case] = res
        del args
        torch.cuda.empty_cache()
    return out


def _windows(mp, pm, hap, args, mu, chr_len):
    """The window entries at `hap`'s planes, each as (kernel, plain,
    local args, local mutations, keywords)."""
    import torch

    f, mo, xo_p, st_p, xo_m, st_m = args
    outs = [torch.zeros_like(hap) for _ in range(2)]
    entries = {}
    for name, (c0, n_chr, off, length) in WINDOWS.items():
        pc = pm.Piece(c0, n_chr, off, length, 0)
        lo = c0 * chr_len + off
        local = (f, mo, *pm.piece_plan(xo_p, st_p, pc, chr_len),
                 *pm.piece_plan(xo_m, st_m, pc, chr_len))
        mu_pc = pm.local_loci(mu, lo, pc.m)[0]
        kw = dict(n_chr=n_chr, chr_len=length)
        entries[name] = (
            lambda lo=lo, local=local, mu_pc=mu_pc, kw=kw:
                mp.meiose_packed_window(hap, outs[0], lo // 32, *local,
                                        mu_pc, **kw),
            lambda lo=lo, local=local, mu_pc=mu_pc, kw=kw:
                mp.meiose_packed_window_plain(hap, outs[1], lo // 32,
                                              *local, mu_pc, **kw),
            local, mu_pc, kw)
    return entries


def one(tree: Path) -> dict:
    import dataclasses

    import torch

    mp = _load(tree, "meiose_packed")
    pm = importlib.import_module("geneevolve_tpu_torch.parallel.mesh")
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}
    for case, spec in CASES.items():
        hap, args, mu, chr_len = _inputs(dev, *spec)
        if case == "dense_shift":  # the same words, one word further on
            flat = torch.empty(hap.numel() + 1, dtype=hap.dtype, device=dev)
            hap = flat[1:].view(hap.shape).copy_(hap)
        kw = dict(n_chr=spec[2], chr_len=chr_len)
        hapA, hapB = hap[:, 0].contiguous(), hap[:, 1].contiguous()
        need = cs._packed_need(hap.shape[0], args, **kw)
        entries = {
            "combined": (lambda: mp.meiose_packed(hap, *args, mu, **kw),
                         lambda: mp.meiose_packed_plain(hap, *args, mu, **kw),
                         args, mu, kw, mp.meiose_packed),
            "no_mutations": (
                lambda: mp.meiose_packed(hap, *args, None, **kw),
                lambda: mp.meiose_packed_plain(hap, *args, None, **kw),
                args, None, kw, mp.meiose_packed),
            "split_planes": (
                lambda: mp.meiose_packed_split(hapA, hapB, *args, **kw),
                lambda: mp.meiose_packed_split_plain(hapA, hapB, *args,
                                                     **kw),
                args, None, kw, mp.meiose_packed_split),
        }
        if case == "flagship":
            entries.update({
                k: (*w, mp.meiose_packed_window)
                for k, w in _windows(mp, pm, hap, args, mu,
                                     chr_len).items()})
        res = {}
        for name, (kern, plain, a, m, k, wrapper) in entries.items():
            err = cs._max_abs_err(kern(), plain())
            if err:
                raise AssertionError(f"{case}/{name}: differs by {err}")
            plan = getattr(wrapper, "plan", None)
            n_need = (need if a is args else
                      cs._packed_need(hap.shape[0], a, **k))
            res[name] = dict(cs._packed_work(n_need, a, m, **k),
                             plan=plan and dataclasses.asdict(plan))
            torch.cuda.empty_cache()
        kerns = {k: e[0] for k, e in entries.items()}
        single = cs._time_turns(kerns, dict.fromkeys(kerns, 20))
        queued = cs._time_queued(kerns)
        for k, r in res.items():
            r.update(ms=single[k], queued_ms=queued[k],
                     share=r["bound_ms"] / single[k],
                     queued_share=r["bound_ms"] / queued[k])
        out[case] = res
        del hap, hapA, hapB, args, mu, entries, kerns
        torch.cuda.empty_cache()
    out.update(planes(tree))
    return out


def planes(tree: Path) -> dict:
    """`meiose_planes` of `tree` at the `PLANES` shapes, each against its
    plain version, then timed in turns; its bound as `chip_smoke.py`
    counts it (the distinct parent rows' bytes of the loci launched, the
    plan, the child bytes written)."""
    import dataclasses

    import torch

    mpl = _load(tree, "meiose_planes")
    pm = importlib.import_module("geneevolve_tpu_torch.parallel.mesh")
    step = importlib.import_module("geneevolve_tpu_torch.dense.step")
    dev = torch.device("cuda", 0)
    out, res, outs = {}, {}, None
    for case, (n, n_chr, chr_len, win) in PLANES.items():
        g = torch.Generator(device=dev).manual_seed(2024)
        m = n_chr * chr_len
        hapA, hapB = (torch.randint(0, 2, (n, m), generator=g, device=dev,
                                    dtype=torch.uint8) for _ in range(2))
        cc = torch.randint(0, n // 2, (n,), generator=g, device=dev).sort()
        par = [torch.randint(0, n, (n,), generator=g, device=dev,
                             dtype=torch.int32)[cc.values] for _ in range(2)]
        dcfg = step.DenseConfig(n=n, m=m, n_chr=n_chr, xo_cap=8)
        plan = []
        for _ in range(2):
            plan += step._sample_gamete_plan(g, dcfg, n)[:2]
        args = (*par, *plan)
        rows = cs._rows_read(hapA, *par) + cs._rows_read(hapB, *par)
        if win is None:
            kern = lambda a=args: mpl.meiose_planes(hapA, hapB, *a,
                                                    n_chr=n_chr)
            plain = lambda a=args: mpl.meiose_planes_plain(hapA, hapB, *a,
                                                           n_chr=n_chr)
            loci, wrapper = m, mpl.meiose_planes
        else:
            pc = pm.Piece(win[0], win[1], win[2], win[3], 0)
            lo = pc.c0 * chr_len + pc.off
            local = (*par, *pm.piece_plan(plan[0], plan[1], pc, chr_len),
                     *pm.piece_plan(plan[2], plan[3], pc, chr_len))
            outs = [[torch.zeros_like(hapA) for _ in range(2)]
                    for _ in range(2)]
            kw = dict(n_chr=pc.n_chr, chr_len=pc.length)
            kern = lambda lo=lo, a=local, o=outs[0], kw=kw: \
                mpl.meiose_planes_window(hapA, hapB, *o, lo, *a, **kw)
            plain = lambda lo=lo, a=local, o=outs[1], kw=kw: \
                mpl.meiose_planes_window_plain(hapA, hapB, *o, lo, *a, **kw)
            loci, wrapper, args = pc.m, mpl.meiose_planes_window, local
        err = cs._max_abs_err(kern(), plain())
        if err:
            raise AssertionError(f"meiose_planes/{case}: differs by {err}")
        p = getattr(wrapper, "plan", None)
        r = cs._bound(rows * loci // m + cs._nbytes(*args) + 2 * n * loci,
                      2 * n * loci)
        r["plan"] = p and dataclasses.asdict(p)
        kerns = {case: kern}
        r["ms"] = cs._time_turns(kerns, {case: 20})[case]
        r["queued_ms"] = cs._time_queued(kerns)[case]
        r.update(share=r["bound_ms"] / r["ms"],
                 queued_share=r["bound_ms"] / r["queued_ms"])
        res[case] = r
        del hapA, hapB, args, kern, plain, kerns
        outs = None
        torch.cuda.empty_cache()
    out["planes"] = res
    return out


def main(argv) -> int:
    paint = "--paint" in argv
    argv = [a for a in argv if a != "--paint"]
    if argv[:1] == ["--one"]:
        run = (one_paint if paint else one)(Path(argv[1]).resolve())
        print(json.dumps(run))
        return 0
    if len(argv) != 1:
        raise SystemExit(__doc__)
    other = Path(argv[0]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f" card: {smi}")
    runs = []
    for label, tree in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        p = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"),
                            "--one", str(tree), *(["--paint"] * paint)],
                           capture_output=True, text=True, timeout=900)
        if p.returncode:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        run = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append(dict(label=label, **run))
        if paint:
            for case in PAINT_CASES:
                r = run[case]
                print(f" {label:5s} {case:11s} exact {r['exact']}  "
                      f"{r['ms']:.4f} ms / queued {r['queued_ms']:.4f} ms  "
                      f"bound {r['bound_ms']:.4f} ({r['queued_share']:.1%})"
                      f"  need {r['need_bound_ms']:.4f} "
                      f"({r['queued_need_share']:.1%})  plan {r['plan']}")
            continue
        for case in (*CASES, "planes"):
            print(f" {label:5s} {case:12s} " + "   ".join(
                f"{k} {r['ms']:.4f} / queued {r['queued_ms']:.4f} ms "
                f"({r['queued_share']:.1%})" for k, r in run[case].items()))
    print(smi)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
