#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`geneevolve_tpu_torch`) once on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

0. build: compile every kernel in `geneevolve_tpu_torch/csrc/` with nvcc
   for sm_90a (seconds printed);
1. kernels: each of the four kernels against its plain PyTorch version on
   the card at main-path shapes (n = 30,000 children, K ~ 5,000 map bins,
   S ~ 50 ledger slots, ~25 crossover slots), bit-exact (integer outputs),
   with median times from CUDA events;
2. parity: the slice on `cuda` and on `cpu` (plain versions) on a small
   scenario, the CUDA run fed the CPU run's mating and reproduce plans;
   ledgers, mutations and resident CVs identical after every generation;
3. slice: the middle row of the reference's Table 3.1 (pop_size 30,000,
   10,000 founders, 22 chromosomes, 100 CVs each, here 5 generations, plus
   a mutation map of ~1 de novo mutation per gamete per chromosome) through
   `geneevolve_tpu_torch.cli.main`, with every kernel's launch count, the
   probe/real-pass slot tripwire, the outputs' shape and law, s/gen, the
   stage split and peak device memory.

Prints the card's name and power limit, then one JSON line of kernel
results, then, last, `{"ok": true, "device": {...}}`. Without a CUDA
device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_CHILD = 30_000
SCENARIO = dict(n0=10_000, pop_size=30_000, gens=5, nchr=22, ncv=100)
KERNELS = {  # name -> (source, TPU function it replaces)
    "cdf_bins": ("geneevolve_tpu_torch/csrc/cdf_bins.cu",
                 "geneevolve_tpu/ops/cdf_bins_pallas.py:119"),
    "merge_count": ("geneevolve_tpu_torch/csrc/merge_count.cu",
                    "geneevolve_tpu/ops/merge_count_pallas.py:90"),
    "gather_rows": ("geneevolve_tpu_torch/csrc/gather_rows.cu",
                    "geneevolve_tpu/ops/materialize.py:72"),
    "meiose_merge": ("geneevolve_tpu_torch/csrc/meiose_merge.cu",
                     "geneevolve_tpu/core/segments.py:749"),
}


def _wrappers():
    from geneevolve_tpu_torch.ops.cdf_bins import cdf_bins
    from geneevolve_tpu_torch.ops.materialize import gather_rows
    from geneevolve_tpu_torch.ops.meiose_merge import meiose_merge
    from geneevolve_tpu_torch.ops.merge_count import merge_count

    return dict(cdf_bins=cdf_bins, merge_count=merge_count,
                gather_rows=gather_rows, meiose_merge=meiose_merge)


def _time_ms(fn, reps=20):
    """Median ms of `fn()` over `reps` runs, CUDA events, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_abs_err(got, want) -> int:
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max()))
    torch.cuda.synchronize()
    return err


def kernel_phase(dev) -> list:
    """Each kernel vs its plain version at main-path shapes."""
    import torch

    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.ops import cdf_bins as cb
    from geneevolve_tpu_torch.ops import materialize as mat
    from geneevolve_tpu_torch.ops import meiose_merge as mm
    from geneevolve_tpu_torch.ops import merge_count as mc

    BIG = segments.BIG
    g = torch.Generator(device=dev).manual_seed(1234)
    n = N_CHILD + 4 * int(N_CHILD ** 0.5) + 16  # plane rows at 30k
    # chr1 at 50 kb bins (4,981 bins), uneven mass with flat runs
    K, width, chr_len = 4981, 50_000, 249_000_000
    mass = torch.rand(K, generator=g, device=dev) * 1.3e-3
    mass[torch.rand(K, generator=g, device=dev) < 0.2] = 0.0
    mass[0] = 0.0
    cum = torch.cumsum(mass, 0)
    bp = torch.arange(K, device=dev, dtype=torch.int32) * width
    xo_cap, S, live, M, C = 23, 49, 16, 27, 100
    # the sampler's own u, as the main path produces it
    lam = float(cum[-1])
    counts = torch.poisson(torch.full((n,), lam, device=dev),
                           generator=g).clamp_max(xo_cap).long()
    s = torch.cumsum(-torch.log1p(-torch.rand((n, xo_cap + 1), generator=g,
                                              device=dev)), 1)
    u = s[:, :xo_cap] / s.gather(1, counts[:, None]).clamp_min(1e-30) * cum[-1]
    # parent ledgers: sorted valid prefix of ~16 boundaries, BIG padded
    lens = torch.randint(1, live * 2, (n, 2, 1), generator=g, device=dev)
    pos = torch.randint(1, chr_len, (n, 2, S), generator=g, device=dev,
                        dtype=torch.int32)
    slot = torch.arange(S, device=dev)
    pos = torch.where(slot < lens, pos, BIG).sort(-1).values
    pos[..., 0] = 0
    par_st = pos.contiguous()
    par_hap = torch.randint(0, 20_000, (n, 2, S), generator=g, device=dev,
                            dtype=torch.int16)
    par_hap[par_st >= BIG] = 0
    xo = segments.sample_point_process(g, n, xo_cap, cum, lam, bp,
                                       float(width), False)
    start = torch.randint(0, 2, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(0, n, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    mut = torch.full((n, 2, M), BIG, dtype=torch.int32, device=dev)
    cv = torch.randint(0, 2, (n, 2, C), generator=g, device=dev,
                       dtype=torch.uint8)
    cases = {
        "cdf_bins": (lambda: cb.cdf_bins(u, cum),
                     lambda: cb.cdf_bins_plain(u, cum)),
        "merge_count": (lambda: mc.merge_count(par_st, idx, xo, start),
                        lambda: mc.merge_count_plain(par_st, idx, xo, start)),
        "gather_rows": (lambda: mat.gather_rows(cv, idx),
                        lambda: mat.gather_rows_plain(cv, idx)),
        "meiose_merge": (
            lambda: mm.meiose_merge(par_st, par_hap, idx, xo, start, S),
            lambda: mm.meiose_merge_plain(par_st, par_hap, idx, xo, start, S,
                                          True),
        ),
    }
    results = []
    for name, (kern, plain) in cases.items():
        err = _max_abs_err(kern(), plain())
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain by {err}")
        results.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], max_abs_err=err,
            ms=_time_ms(kern), plain_ms=_time_ms(plain),
        ))
    # the other merge mode and the mutation-row gather: exactness only
    for got, want in (
        (mm.meiose_merge(par_st, par_hap, idx, xo, start, S, False),
         mm.meiose_merge_plain(par_st, par_hap, idx, xo, start, S, False)),
        (mat.gather_rows(mut, idx), mat.gather_rows_plain(mut, idx)),
    ):
        if _max_abs_err(got, want) != 0:
            raise AssertionError("kernel differs from plain version")
    for r in results:
        print(f" kernel {r['name']:<13s} {r['ms']:.4f} ms   plain "
              f"{r['plain_ms']:.4f} ms   (n={n}, median of 20)")
    return results


def _mutation_map(path: Path, rmap: Path) -> Path:
    """`chr bp rate` on the recombination map's bins: per-bin rate 1/K so a
    gamete carries ~1 de novo mutation per chromosome."""
    rows = [line.split() for line in rmap.read_text().splitlines()[1:]]
    per_chr = {}
    for c, bp, _cm in rows:
        per_chr.setdefault(c, []).append(bp)
    with open(path, "w") as f:
        f.write("chr bp rate\n")
        for c, bps in per_chr.items():
            rate = 1.0 / len(bps)
            f.writelines(f"{c} {bp} {rate:.8g}\n" for bp in bps)
    return path


def _scenario(root: Path, **kw) -> list:
    sys.path.insert(0, str(REPO / "tools"))
    from mkscenario import make_scenario

    flags = make_scenario(str(root), **kw)
    flags["file_mutation_map"] = str(
        _mutation_map(root / "mut.txt", Path(flags["file_recom_map"]))
    )
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    return argv


def parity_phase(dev, work: Path) -> int:
    """Slice on `dev` vs on the CPU, the device run fed the CPU run's
    plans: identical planes every generation. Returns generations checked."""
    import torch

    from geneevolve_tpu.config import parse_args
    from geneevolve_tpu_torch.core.engine import Simulation

    argv = _scenario(work / "parity", n0=200, pop_size=300, gens=3, nchr=3,
                     ncv=12, seed=3)
    sims = {}
    for name, d in (("cpu", "cpu"), ("dev", dev)):
        cfg = parse_args(argv + ["--seed", "7", "--prefix",
                                 str(work / "parity" / name)])
        sims[name] = Simulation(cfg, device=d, verbose=False)
    ref, sim = sims["cpu"], sims["dev"]
    mates, plans = {}, {}
    ref_mate, ref_plan = ref._mate, ref._plan
    ref._mate = lambda p, gen, ps, g: mates.setdefault(
        gen, ref_mate(p, gen, ps, g))
    ref._plan = lambda p, gen, n_pad: plans.setdefault(
        gen, ref_plan(p, gen, n_pad))
    sim._mate = lambda p, gen, ps, g: mates[gen]
    sim._plan = lambda p, gen, n_pad: tuple(x.to(dev) for x in plans[gen])
    for s in (ref, sim):
        s.init_generation0()
    for gen in range(ref.tot_gen + 1):
        if gen:
            ref.step(gen)
            sim.step(gen)
        a, b = ref.pops[0].state, sim.pops[0].state
        for k in ("seg_st", "seg_hap", "mut", "cv"):
            if not torch.equal(getattr(a, k), getattr(b, k).cpu()):
                raise AssertionError(f"parity: {k} differs at gen {gen}")
    if not (ref.pops[0].state.mut < 2**30).any():
        raise AssertionError("parity: no mutation was inherited")
    for s in (ref, sim):
        s.write_summary()
        s._io_pool.shutdown(wait=True)
    print(f" parity: cuda == cpu for gens 0..{ref.tot_gen} (ledger, "
          "mutations, resident CVs)")
    return ref.tot_gen + 1


def _read_table(path: Path):
    import numpy as np

    lines = path.read_text().splitlines()
    return lines[0].split(), np.array([l.split() for l in lines[1:]],
                                      dtype=np.float64)


def slice_phase(dev, work: Path, wrappers: dict, scenario=SCENARIO) -> dict:
    """The Table 3.1 middle row through the CLI, with its checks."""
    import numpy as np
    import torch

    from geneevolve_tpu_torch import cli
    from geneevolve_tpu_torch.core import engine

    root = work / "table31"
    argv = _scenario(root, **scenario, seed=1)
    argv += ["--seed", "12345", "--prefix", str(root / "out"),
             "--stage_sync"]
    seen, gen_s = [], []
    run, step = engine.Simulation.run, engine.Simulation.step

    def run_rec(self):
        seen.append(self)
        return run(self)

    def step_rec(self, gen):
        t0 = time.perf_counter()
        step(self, gen)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)

    engine.Simulation.run, engine.Simulation.step = run_rec, step_rec
    try:
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(argv, device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        engine.Simulation.run, engine.Simulation.step = run, step
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    sim = seen[0]
    if any(v <= 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched: {launches}")
    # outputs: sizes and law
    G, pop = scenario["gens"], scenario["pop_size"]
    for gen in range(G + 1):
        _, info = _read_table(root / f"out.info.pop1.gen{gen}.txt")
        if gen == 0 and info.shape[0] != scenario["n0"]:
            raise AssertionError(f"gen 0 has {info.shape[0]} founders")
        if gen and abs(info.shape[0] - pop) > 6 * pop ** 0.5:
            raise AssertionError(f"gen {gen} size {info.shape[0]}")
        if not np.isfinite(info).all():
            raise AssertionError(f"non-finite values in gen {gen} .info")
    hdr, summ = _read_table(root / "out.pop1.summary")
    var_a, h2 = summ[:, hdr.index("ph1_var_A")], summ[:, hdr.index("ph1_h2")]
    if summ.shape[0] != G + 1 or not np.isfinite(var_a).all() \
            or not ((h2 > 0) & (h2 <= 1)).all():
        raise AssertionError(f"summary: var_A {var_a}, h2 {h2}")
    # tripwire: the probe's predicted slots equal the merge's used slots
    log = sim.capacity_log
    if len(log) != G or any(c["seg_need"] != c["seg_used"] for c in log):
        raise AssertionError(f"capacity tripwire: {log}")
    if sum(c["mut_used"] for c in log) == 0:
        raise AssertionError("no de novo mutation was carried")
    t = sim.timer.totals
    split = {k: round(t.get(k, 0.0), 4) for k in (
        "mate", "reproduce/probe", "reproduce/real", "compute_ad",
        "phenotypes", "gamma_mv_sv", "info_files")}
    out = dict(
        wall_s=wall, s_per_gen=gen_s, stage_split_s=split,
        max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20,
        launches=launches,
        seg_need_used=[(c["seg_need"], c["seg_used"]) for c in log],
    )
    print(" slice: s/gen " + " ".join(f"{x:.3f}" for x in gen_s))
    print(f" slice: stage split (s, all gens) {json.dumps(split)}")
    print(f" slice: max_memory_allocated "
          f"{out['max_memory_allocated_mb']:.1f} MiB, wall {wall:.1f} s")
    print(f" slice: launches {json.dumps(launches)}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from geneevolve_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f" card: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f" build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"   {line.strip()}")
    wrappers = _wrappers()
    kernels = kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        parity_phase(dev, work)
        res = slice_phase(dev, work, wrappers)
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
    print(json.dumps({"slice": {
        k: res[k] for k in ("s_per_gen", "stage_split_s",
                            "max_memory_allocated_mb", "seg_need_used")}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
