"""The collectives the mesh runs, over `torch.distributed` (the JAX package
has no counterpart: there XLA inserts its collectives from sharding
annotations).

Each function takes the process group it runs over. Under NCCL the tensors
stay on the card. Under gloo, tensors on a card are staged through pinned
host buffers here and copied back: gloo's CUDA support is partial, and
NCCL puts at most one rank on a device, so two ranks sharing one card run
over gloo. Every call adds the bytes that crossed this rank's boundary
and its time to a `Traffic` record when one is given: CUDA events on the
card (read when the record is summed), the host clock on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class Traffic:
    """Exchange bytes and seconds of the collectives of one rank."""

    calls: int = 0
    bytes: int = 0
    host_s: float = 0.0  # CPU tensors: seconds on the host clock
    _events: List[tuple] = field(default_factory=list)  # (start, end)

    def seconds(self) -> float:
        """Total seconds; syncs the card to read its events."""
        s = self.host_s
        if self._events:
            self._events[-1][1].synchronize()
            s += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
        return s

    def summary(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "seconds": self.seconds()}

    def reset(self) -> None:
        self.calls, self.bytes, self.host_s = 0, 0, 0.0
        self._events = []


class _Timed:
    """Context that adds one call's bytes and time to `log`."""

    def __init__(self, log: Optional[Traffic], device: torch.device,
                 nbytes: int):
        self.log, self.device, self.nbytes = log, device, nbytes

    def __enter__(self):
        if self.log is None:
            return self
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.log is None or exc[0] is not None:
            return False
        self.log.calls += 1
        self.log.bytes += self.nbytes
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self.log._events.append((self.start, end))
        else:
            self.log.host_s += time.perf_counter() - self.t0
        return False


# the one-tensor all-gather (renamed in recent torch releases)
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a card tensor (gloo staging)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def row_bytes(t: torch.Tensor) -> torch.Tensor:
    """(rows, bytes) uint8 view of a tensor's rows: the moving collectives
    move bytes, whatever the dtype (gloo takes no int16)."""
    t = t.contiguous()
    width = int(np.prod(t.shape[1:])) * t.element_size()
    return t.reshape(t.shape[0], -1 if t.numel() else 0).view(torch.uint8) \
        .reshape(t.shape[0], width)


def from_row_bytes(b: torch.Tensor, dtype, row_shape) -> torch.Tensor:
    """The rows of `row_bytes`'s layout back as `dtype` rows of
    `row_shape`."""
    return b.view(dtype).reshape((b.shape[0],) + tuple(row_shape))


def all_reduce(t: torch.Tensor, op: str = "sum", group=None,
               log: Optional[Traffic] = None) -> torch.Tensor:
    """In-place sum or max of `t` over the group (integer or f32); returns
    `t`."""
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}[op]
    d = dist.get_world_size(group)
    with _Timed(log, t.device, 2 * t.numel() * t.element_size() * (d - 1)
                // max(d, 1)):
        if t.device.type == "cuda" and _staged(group):
            h = _host(t)
            dist.all_reduce(h, op=red, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=red, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group=None,
                    log: Optional[Traffic] = None) -> torch.Tensor:
    """(D * rows, ...) rows of every rank of the group, in rank order (every
    rank gives the same row count)."""
    d = dist.get_world_size(group)
    src = row_bytes(t)
    out = src.new_empty((d * src.shape[0], src.shape[1]))
    with _Timed(log, t.device, (d - 1) * src.numel()):
        if t.device.type == "cuda" and _staged(group):
            h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            _all_gather(h, _host(src), group=group)
            out.copy_(h)
        else:
            _all_gather(out, src, group=group)
    return from_row_bytes(out, t.dtype, t.shape[1:])


def all_to_all_rows(t: torch.Tensor, send: Sequence[int],
                    recv: Sequence[int], group=None,
                    log: Optional[Traffic] = None) -> torch.Tensor:
    """Rows of `t` sent to the group's ranks in rank order, `send[k]` rows
    to rank k; returns the rows received, `recv[k]` from rank k, in rank
    order. Both split lists must agree across the group."""
    me = dist.get_rank(group)
    send, recv = [int(x) for x in send], [int(x) for x in recv]
    src = row_bytes(t)
    out = src.new_empty((sum(recv), src.shape[1]))
    moved = src.shape[1] * (sum(send) - send[me] + sum(recv) - recv[me])
    with _Timed(log, t.device, moved):
        if t.device.type == "cuda" and _staged(group):
            h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            dist.all_to_all_single(h, _host(src), recv, send, group=group)
            out.copy_(h)
        else:
            dist.all_to_all_single(out, src, recv, send, group=group)
    return from_row_bytes(out, t.dtype, t.shape[1:])


def ring_permute(t: torch.Tensor, shift: int = 1, group=None,
                 log: Optional[Traffic] = None) -> torch.Tensor:
    """Every rank sends `t` to rank (r + shift) mod D and returns what rank
    (r - shift) mod D sent (the same row count on every rank)."""
    d = dist.get_world_size(group)
    me = dist.get_rank(group)
    k = t.shape[0]
    send = [0] * d
    recv = [0] * d
    send[(me + shift) % d] += k
    recv[(me - shift) % d] += k
    return all_to_all_rows(t, send, recv, group, log)
