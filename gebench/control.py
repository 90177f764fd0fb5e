"""The control of the comparison that decides `correct`: the program with
its A and D taken in bfloat16, the nearest precision below the float32 the
configurations state, planted underneath the harness. Each seed makes a
whole run of the cell through `run.run_cell` (one run in the window, then
the check) and prints its numbers and `correct`, which has to come out
false. The benchmark's own runs do not run it.

    python3 gebench/control.py --workload <cell> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gebench import run  # noqa: E402


@contextlib.contextmanager
def planted():
    """The program's per-chromosome A and D rounded to bfloat16 where they
    are made (`phenotype.additive_dominance_chr`, both A/D paths)."""
    from geneevolve_tpu_torch.core import phenotype

    ad = phenotype.additive_dominance_chr

    def bf16(*a, **k):
        A, D = ad(*a, **k)
        return A.bfloat16().float(), D.bfloat16().float()

    phenotype.additive_dominance_chr = bf16
    try:
        yield
    finally:
        phenotype.additive_dominance_chr = ad


def readings(cell, seeds, device="cuda", work=None) -> list:
    """The control's result of each seed: `correct` and the checks."""
    work = Path(work or tempfile.gettempdir()) / "gebench-control"
    out = []
    with planted():
        for seed in seeds:
            res = run.run_cell(cell, seed, 0.0, False, device=device,
                               work=work, log=lambda s: None, min_runs=1)
            out.append(dict(correct=res["correct"], checks=res["checks"]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(run.HOST_THREADS)
    cell = run.load_cell(ROOT, args.workload)
    for seed, r in zip(args.seeds, readings(cell, args.seeds)):
        print(json.dumps(dict(workload=cell.name, seed=seed, **r)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
