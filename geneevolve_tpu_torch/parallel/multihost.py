"""Several processes and nodes: joining `torch.distributed`, and which rows
each node writes (counterpart of geneevolve_tpu/parallel/multihost.py).

In the JAX package a host is a process driving all its local devices. Here
every device has its own process (a rank), and a host is a node: torchrun's
`GROUP_RANK` (the node's index) and `LOCAL_WORLD_SIZE` (its ranks); without
them the whole world is one node. Output files carry `.hostK` only when
there are several nodes, so a one-node mesh writes the same single files
as an unsharded run.

- `maybe_init_distributed()`: join the process group torchrun describes
  (`MASTER_ADDR`/`MASTER_PORT`/`WORLD_SIZE`/`RANK`) or the JAX module's
  `GE_COORDINATOR_ADDRESS`/`GE_NUM_PROCESSES`/`GE_PROCESS_ID`; a no-op when
  neither is set, and safe to call twice.
- `process_info()`: (rank, world size) without requiring a group.
- `host_suffix()`: this node's file suffix.
- `host_row_ranges(n, shape)`: the [lo, hi) rows of an n-row array sharded
  in blocks over the mesh's 'ind' axis that this node's ranks hold.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # a process group's collective timeout


def _env_world() -> Optional[Tuple[str, int, int]]:
    """(init_method, world size, rank) from the environment, or None."""
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("WORLD_SIZE") and "RANK" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    coord = env.get("GE_COORDINATOR_ADDRESS")
    if coord and env.get("GE_NUM_PROCESSES") and "GE_PROCESS_ID" in env:
        return (f"tcp://{coord}", int(env["GE_NUM_PROCESSES"]),
                int(env["GE_PROCESS_ID"]))
    return None


def default_backend(device: str = "cuda") -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_init_distributed(device: str = "cuda") -> Tuple[int, int]:
    """Join the process group the environment describes (NCCL for CUDA
    ranks, gloo on the CPU); returns (rank, world size)."""
    if not dist.is_initialized():
        found = _env_world()
        if found is not None:
            init, world, rank = found
            if torch.device(device).type == "cuda":
                torch.cuda.set_device(
                    int(os.environ.get("LOCAL_RANK", rank))
                    % torch.cuda.device_count())
            dist.init_process_group(
                default_backend(device), init_method=init, world_size=world,
                rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return process_info()


def process_info() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def node_info() -> Tuple[int, int, int]:
    """(this node's index, the number of nodes, ranks a node)."""
    _rank, world = process_info()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return int(os.environ.get("GROUP_RANK", 0)), max(1, world // local), local


def host_suffix() -> str:
    """This node's output suffix: empty on one node."""
    node, nodes, _local = node_info()
    return f".host{node}" if nodes > 1 else ""


def is_node_writer() -> bool:
    """The node's first rank writes the node's files."""
    rank, _world = process_info()
    node, _nodes, local = node_info()
    return rank == node * local


def host_row_ranges(n: int, shape: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Sorted, merged [lo, hi) row ranges of an n-row array, sharded in
    blocks of ceil(n / ind) rows over the 'ind' axis of an (ind, loci)
    mesh (rank r at ind coordinate r // loci), that the ranks of this node
    hold. One node holds [(0, n)]."""
    ind, loci = shape
    node = int(os.environ.get("GROUP_RANK", 0))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", ind * loci))
    block = -(-n // ind)
    ranges = []
    for r in range(node * local, (node + 1) * local):
        c = r // loci
        lo, hi = min(n, c * block), min(n, (c + 1) * block)
        if hi > lo:
            ranges.append((lo, hi))
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(set(ranges)):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return merged
