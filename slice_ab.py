#!/usr/bin/env python3
"""Time the segment slice of `chip_smoke.py` (`table31`: Table 3.1's
middle row, pop_size 30,000, 10,000 founders, 22 chromosomes x 100 CVs,
the smoke's mutation map, 5 generations, `--stage_sync`) in this tree and
in another checkout, in turns, each run in its own process on one CUDA
card:

    python3 slice_ab.py OTHER_CHECKOUT [--turns N] [--multipop]

With `--multipop` the run is `chip_smoke.py`'s `multipop31` instead (two
populations of the slice's shape, 3 generations, migration `0.9 0.1 0.1
0.9`, `--gamma 0.5`: the gather path, whose peak the migration sets).
The scenario is written once (this tree's `tools/mkscenario.py`); the
runs go other, this, this, other, ... (N turns of a pair, reversed every
other turn, so that a drift of the card's clock hits both alike). Each
process builds its tree's kernels before the run (outside the timing) and
prints s/gen (each `Simulation.step` to a device sync), the stage split
and the peak device memory (`torch.cuda.max_memory_allocated`). Prints
the card's name and power limit, one JSON line a run, then a summary
line: each tree's median s/gen and its peaks.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent

CHILD = r"""
import json, sys, time
tree, argv = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, tree)
import torch
from geneevolve_tpu_torch import cli
from geneevolve_tpu_torch.core import engine
from geneevolve_tpu_torch.ops import _build

_build.lib()
gen_s, seen, step, run = [], [], engine.Simulation.step, engine.Simulation.run

def step_rec(self, gen):
    t0 = time.perf_counter()
    step(self, gen)
    torch.cuda.synchronize()
    gen_s.append(time.perf_counter() - t0)

def run_rec(self):
    seen.append(self)
    return run(self)

engine.Simulation.step, engine.Simulation.run = step_rec, run_rec
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
rc = cli.main(argv, device="cuda")
torch.cuda.synchronize()
assert rc == 0, rc
sim = seen[0]
print("RESULT " + json.dumps(dict(
    wall_s=time.perf_counter() - t0, s_per_gen=gen_s,
    stage_split_s={k: round(v, 4) for k, v in sim.timer.totals.items()},
    max_memory_allocated_mb=torch.cuda.max_memory_allocated() / 2**20)))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other checkout's root")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--multipop", action="store_true",
                    help="two populations with migration (multipop31)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("slice_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    trees = {"other": str(Path(args.other).resolve()), "this": str(REPO)}
    got = {k: [] for k in trees}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "table31"
        base = chip_smoke._scenario(root, **chip_smoke.SCENARIO, seed=1)
        if args.multipop:
            gens = chip_smoke.MULTIPOP_GENS
            base = chip_smoke._two_populations(
                Path(tmp) / "multipop31", base,
                dict(chip_smoke.SCENARIO, gens=gens), gens)
        for turn in range(args.turns):
            order = ["other", "this"] if turn % 2 == 0 else ["this", "other"]
            for name in order:
                prefix = Path(tmp) / f"{name}{turn}"
                argv = base + ["--seed", "12345", "--prefix", str(prefix),
                               "--stage_sync"]
                out = subprocess.run(
                    [sys.executable, "-c", CHILD, trees[name],
                     json.dumps(argv)], capture_output=True, text=True,
                    timeout=900)
                if out.returncode != 0:
                    print(out.stdout[-3000:], out.stderr[-3000:],
                          file=sys.stderr)
                    return 1
                line = [x for x in out.stdout.splitlines()
                        if x.startswith("RESULT ")][-1]
                res = dict(tree=name, turn=turn, **json.loads(line[7:]))
                got[name].append(res)
                print(json.dumps(res), flush=True)
    print(json.dumps({k: dict(
        median_s_per_gen=statistics.median(
            x for r in v for x in r["s_per_gen"]),
        max_memory_allocated_mb=[r["max_memory_allocated_mb"] for r in v])
        for k, v in got.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
