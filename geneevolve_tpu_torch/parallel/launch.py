"""Start the ranks of a mesh in this machine and collect their results.

`launch(fn, nprocs, args)` spawns `nprocs` processes (the spawn start
method), joins them into one `torch.distributed` world through a file
store in a fresh temporary directory (so concurrent runs never race for a
port), runs `fn(rank, *args)` in each and returns every rank's result in
rank order. CUDA ranks take one card each over NCCL unless the caller
names another backend (`backend="gloo"` lets several ranks share a card:
their collectives are staged through host memory, `parallel/comm.py`);
CPU ranks run over gloo with one intra-op thread each. Every process group
has a timeout, and the parent waits with a deadline: when a rank fails,
the parent kills the others and raises that rank's traceback, so no rank
carries on after another has failed.

`fn` must be importable from a module that the ranks can import (spawned
processes import the module that holds it).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank failed, or the ranks missed their deadline."""


def _rank_main(rank: int, world: int, fn: Callable, args: Sequence,
               device: str, backend: str, tmp: str, pg_timeout: float) -> None:
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)
        os.environ.setdefault("LOCAL_RANK", str(rank))
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout))
        out = fn(rank, *args)
        path = os.path.join(tmp, f"result{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)  # peers blocked in a collective are killed by the parent
    # The result is written and the group destroyed: end here, without the
    # interpreter's teardown, whose C++ destructors can abort a gloo rank
    # under load ("terminate called without an active exception") after
    # its work is done.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def launch(fn: Callable, nprocs: int, args: Sequence = (), *,
           device: str = "cuda", backend: Optional[str] = None,
           timeout_s: float = 3600.0, pg_timeout_s: float = 600.0) -> list:
    """Run `fn(rank, *args)` on `nprocs` ranks; returns their results in
    rank order. Raises `RankError` with the failed rank's traceback if any
    rank fails, and when the ranks do not finish within `timeout_s`."""
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="ge_mesh_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, nprocs, fn, tuple(args), device, backend,
                               tmp, pg_timeout_s))
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed:
                break
            if time.monotonic() > deadline:
                _kill(procs)
                raise RankError(f"{nprocs} ranks did not finish within "
                                f"{timeout_s:.0f} s")
            time.sleep(0.02)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (0,
                                                                        None)]
        if failed:
            _kill(procs)

            def err(r):
                return os.path.join(tmp, f"error{r}.txt")

            # the first rank to fail (its peers fail after it, in the
            # collectives it left)
            r = min(failed, key=lambda r: os.path.getmtime(err(r))
                    if os.path.exists(err(r)) else float("inf"))
            text = (open(err(r)).read() if os.path.exists(err(r))
                    else f"exit code {procs[r].exitcode}")
            raise RankError(f"rank {r} of {nprocs} failed:\n{text}")
        for p in procs:
            p.join()
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
