#!/usr/bin/env python3
"""Time the packed meiosis kernel (`meiose_packed`, its three entries) or the
paint kernel (`paint`) of two checkouts of the PyTorch/CUDA port in turns,
on one CUDA card.

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
no order). Per entry: bit-exact against the tree's plain version, then the
median ms of one call (CUDA events, 20 calls, entries in turns), of a call
with 10 queued between two events (5 runs), the bound as `chip_smoke.py`
counts it (the parent words a gamete takes a bit from, and both planes of
every distinct parent row as `full_rows_bound_ms`), and the launch plan
where the tree's wrapper records one. The card's name and power limit come
first; the JSON is the last line.

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
    "dense_slice": (30_563, 30_708, 22, 64, 23, 1.6, 8, 4.3e-4, False),
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
    import importlib

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


def one(tree: Path) -> dict:
    import dataclasses

    import torch

    mp = _load(tree, "meiose_packed")
    dev = torch.device("cuda", 0)
    out = {"tree": str(tree)}
    for case, spec in CASES.items():
        hap, args, mu, chr_len = _inputs(dev, *spec)
        kw = dict(n_chr=spec[2], chr_len=chr_len)
        hapA, hapB = hap[:, 0].contiguous(), hap[:, 1].contiguous()
        need = cs._packed_need(hap.shape[0], args, **kw)
        entries = {
            "combined": (lambda: mp.meiose_packed(hap, *args, mu, **kw),
                         lambda: mp.meiose_packed_plain(hap, *args, mu, **kw),
                         mu, mp.meiose_packed),
            "no_mutations": (
                lambda: mp.meiose_packed(hap, *args, None, **kw),
                lambda: mp.meiose_packed_plain(hap, *args, None, **kw),
                None, mp.meiose_packed),
            "split_planes": (
                lambda: mp.meiose_packed_split(hapA, hapB, *args, **kw),
                lambda: mp.meiose_packed_split_plain(hapA, hapB, *args,
                                                     **kw),
                None, mp.meiose_packed_split),
        }
        res = {}
        for name, (kern, plain, m, wrapper) in entries.items():
            err = cs._max_abs_err(kern(), plain())
            if err:
                raise AssertionError(f"{case}/{name}: differs by {err}")
            plan = getattr(wrapper, "plan", None)
            res[name] = dict(cs._packed_work(need, args, m, **kw),
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
        del hap, hapA, hapB, args, mu
        torch.cuda.empty_cache()
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
        for case in CASES:
            print(f" {label:5s} {case:11s} " + "   ".join(
                f"{k} {r['ms']:.4f} / queued {r['queued_ms']:.4f} ms "
                f"({r['queued_share']:.1%})" for k, r in run[case].items()))
    print(smi)
    print(json.dumps({"card": smi, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
