"""Run one benchmark cell once.

    python3 gebench/run.py --workload <config>.<mix> --seed N --seconds S \
        --trace 0|1

A cell is a configuration (`gebench/configs/<name>.json`: the population's
sizes) under a mix (`gebench/mixes/<name>.json`: the schedule, the
populations, the migration), both named in `BENCHMARK.json`. One run:

1. set-up (`setup_s`): the scenario files written from `--seed`, the
   program imported and its kernels loaded (built on a checkout's first
   run), one warm-up run of `scenario.WARMUP_GENERATIONS` generations;
2. the window: whole scenario runs through `geneevolve_tpu_torch.cli.main`,
   each with its own simulation seed, until `--seconds` have passed and the
   run in progress has ended, and at least `PEAK_RUNS` runs (`s_per_gen`:
   the runs' time over the generations they simulated; `peak_gib`: the
   highest peak of allocated device memory of the window's first
   `PEAK_RUNS` runs);
3. with `--trace 1`, one more whole run under `--stage_sync` and
   `torch.profiler`, reduced to the cell's per-layer metrics by their
   readers (`gebench/metrics/<name>.py`);
4. the check: the window's last run again, its generations judged against
   the plain reference (`gebench/check.py`).

The last line of standard output is the result as one JSON object; the
last lines of standard error are each number compared beside its limit.
The run fails, printing no result, without a CUDA card, or if JAX or the
JAX package was loaded. The host's thread pools are fixed at
`HOST_THREADS`, so that a run's host work does not spread with the
machine's load.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "geneevolve_tpu")
HOST_THREADS = 4
# the window's first runs whose highest peak is `peak_gib`: the same number
# of runs in every window, whatever the program's speed, so that the rare
# run whose draws outgrow the ledger's capacity margin is as likely in each
PEAK_RUNS = 3


class BenchError(RuntimeError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list
    root: Path


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, its configuration's file,
    its mix's file and the metrics it reports, found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mix = root / "gebench" / "mixes" / f"{w['traffic']}.json"

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name=name, chips=int(w["chips"]),
                config=json.loads((root / cfg["file"]).read_text()),
                mix=json.loads(mix.read_text()),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)],
                root=root)


def reader(root: Path, metric: str):
    """The module `gebench/metrics/<metric>.py` under `root`."""
    path = root / "gebench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gebench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def sim_seed(seed: int, index: int) -> int:
    """The simulation seed of a run: from `--seed` and the run's index,
    never 0 (the CLI reads 0 as 'from the clock') and exact in a float
    (the CLI parses it through one)."""
    return 1 + (seed % 2**40) * 4096 + index


def card() -> dict:
    import torch

    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return dict(kind=torch.cuda.get_device_name(0),
                count=torch.cuda.device_count(), power_limit=limit)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _out_bytes(prefix: Path) -> int:
    return sum(f.stat().st_size for f in prefix.parent.glob(prefix.name + ".*"))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", work: Path = None, log=print,
             min_runs: int = PEAK_RUNS) -> dict:
    """One run of `cell`; returns the result object (without the checks'
    print-out). The window holds at least `min_runs` runs."""
    import torch

    from gebench import check, scenario

    seed %= 2**63
    work = work or Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    work = work / "gebench" / cell.name
    t = time.perf_counter()
    inp = scenario.write_inputs(work / "scenario", cell.config, cell.mix,
                                seed)
    log(f"gebench: scenario {inp.bytes_written} bytes written "
        f"({len(inp.pop_dirs)} population(s)) in "
        f"{time.perf_counter() - t:.4f} s, {t - T0:.4f} s after start")
    t = time.perf_counter()
    from geneevolve_tpu_torch import cli

    pkg = Path(cli.__file__).resolve().parent.parent
    if pkg != cell.root.resolve() and pkg != ROOT:
        raise BenchError(f"the program was imported from {pkg}, not from "
                         "this checkout")
    prefix = work / "out" / "run"
    prefix.parent.mkdir(parents=True, exist_ok=True)
    program_log = work / "program.log"

    def call(argv, index, extra=()):
        a = argv + ["--seed", str(sim_seed(seed, index)),
                    "--prefix", str(prefix), *extra]
        with open(program_log, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(a, device=device)
        _sync(device)
        if rc != 0:
            raise BenchError(f"the CLI exited {rc} (see {program_log})")

    log(f"gebench: program imported in {time.perf_counter() - t:.4f} s")
    t = time.perf_counter()
    call(inp.warm_argv, 0)
    gc.collect()
    _sync(device)
    log(f"gebench: warm-up run in {time.perf_counter() - t:.4f} s")
    gens = inp.generations
    setup_s = time.perf_counter() - T0
    times, peaks, index = [], [], 0
    while sum(times) < seconds or len(times) < min_runs:
        index += 1
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        call(inp.argv, index)
        times.append(time.perf_counter() - t)
        peaks.append(torch.cuda.max_memory_allocated()
                     if device == "cuda" else 0)
        gc.collect()
    window = sum(times)
    s_per_gen = window / (len(times) * gens)
    peak = max(peaks[:PEAK_RUNS])
    out_bytes = _out_bytes(prefix)
    timed = check.digests(prefix)
    log(f"gebench: setup_s {setup_s:.4f}; window {window:.4f} s, "
        f"{len(times)} runs of {gens} generations, s_per_gen "
        f"{s_per_gen:.6f}; run times {[round(x, 4) for x in times]}")
    log(f"gebench: peak of the first {PEAK_RUNS} runs {peak} bytes "
        f"({peak / 2**30:.4f} GiB), of the window {max(peaks)}; the runs' "
        f"peaks {peaks}")
    log(f"gebench: bytes written a run {out_bytes} (outputs) + "
        f"{inp.bytes_written} (scenario, once a process)")
    result = dict(correct=False, attempted=len(times), failed=0,
                  metrics={}, device=dict(platform="gpu", count=cell.chips,
                                          memory_peak_bytes=int(max(peaks))))
    if trace:
        result["metrics"], result["breakdown"], busy = traced(
            cell, call, inp, index + 1, work, s_per_gen, log)
        result["device"].update(busy)
    else:
        e2e = dict(s_per_gen=(s_per_gen, "s/gen"),
                   peak_gib=(peak / 2**30, "GiB"), setup_s=(setup_s, "s"))
        result["metrics"] = {m["name"]: dict(value=e2e[m["name"]][0],
                                             unit=e2e[m["name"]][1])
                             for m in cell.end_to_end}
    t = time.perf_counter()
    judge = checked_call(call, inp, index, seed, device, prefix,
                         timed)
    log(f"gebench: check in {time.perf_counter() - t:.4f} s")
    plan = getattr(judge.program, "mem_plan", None)
    if plan is not None:
        log(f"gebench: reckoned need {plan.need} bytes "
            f"({plan.need / 2**30:.4f} GiB) beside `peak_gib` "
            f"{peak / 2**30:.4f} GiB")
    numbers = judge.numbers()
    result["correct"] = all(numbers[k] <= check.LIMITS[k] for k in numbers)
    result["checks"] = {k: dict(value=v, limit=check.LIMITS[k])
                        for k, v in numbers.items()}
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"modules of JAX or the JAX package loaded: {bad}")
    return result


def traced(cell: Cell, call, inp, index: int, work: Path, s_per_gen: float,
           log):
    """One whole run under `--stage_sync` and the profiler: the cell's
    per-layer metrics, the breakdown and the device's busy seconds."""
    from gebench import trace

    readers = {m["name"]: reader(cell.root, m["name"])
               for m in cell.per_layer}
    with trace.Wrappers(readers) as w:
        t = time.perf_counter()
        events = trace.profile(lambda: call(inp.argv, index, ["--stage_sync"]),
                               work / "trace.json")
        wall = time.perf_counter() - t
    red = trace.reduce(events)
    del events
    log(f"gebench: traced run {red['window_s']:.4f} s ({wall:.4f} s with "
        f"the trace's export), s_per_gen "
        f"{red['window_s'] / inp.generations:.6f} traced against "
        f"{s_per_gen:.6f} untraced (the tracing overhead)")
    launches = {k: [x() for x in v] for k, v in w.launches.items()}
    ctx = dict(stages=dict(w.timer.totals) if w.timer else {},
               gens=inp.generations, trace=red, launches=launches)
    metrics = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(dict(ctx, metric=m["name"]))
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    breakdown = dict(device_ops=red["device_ops"],
                     idle_gaps=red["idle_gaps"])
    return metrics, breakdown, dict(busy_s=red["busy_s"],
                                    window_s=red["window_s"])


def checked_call(call, inp, index: int, seed: int, device: str,
                 prefix: Path, timed: dict):
    """The window's last run again under the check's hooks; the judge."""
    from gebench import check
    from geneevolve_tpu_torch.core import engine

    judge = check.Judge(inp.argv, sim_seed(seed, index), device,
                        inp.generations)
    step, migrate, seen = engine.Simulation.step, \
        engine.Simulation._migrate, []

    def hooked(self, gen):
        if not seen:
            seen.append(self)
        judge.before(self, gen)
        step(self, gen)
        judge.after(self, gen)

    def migrating(self, gen):
        judge.migrating(self, gen)
        migrate(self, gen)

    engine.Simulation.step = hooked
    engine.Simulation._migrate = migrating
    try:
        call(inp.argv, index)
    finally:
        engine.Simulation.step = step
        engine.Simulation._migrate = migrate
    judge.program = seen[0] if seen else None
    judge.finish(judge.program, prefix, timed, check.digests(prefix))
    return judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)

    if not torch.cuda.is_available():
        print("gebench: no CUDA device; the benchmark never runs on the CPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"gebench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = card()
    print(f"gebench: device {dev}", flush=True)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          log=lambda s: print(s, flush=True))
    except BenchError as e:
        print(f"gebench: {e}", file=sys.stderr)
        return 3
    result["device"]["kind"] = dev["kind"]
    result["device"]["power_limit"] = dev["power_limit"]
    checks = result.pop("checks")
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    result["checks"] = {k: [v["value"], v["limit"]] for k, v in
                        checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
