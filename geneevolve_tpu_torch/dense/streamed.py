"""The packed evolve loop with the genome on the host: chromosome slabs
stream host <-> device (counterpart of geneevolve_tpu/dense/streamed.py).

A materialized-genome run whose packed state need not fit the card: the
genome lives in host memory as per-slab packed planes (a slab = a
contiguous group of whole chromosomes); each generation every slab
round-trips through the device: upload the parents, one packed meiosis
launch (`ops/meiose_packed`, no mutations), download the children.
Chromosomes are independent given the generation's mating plan, so
slab-local meiosis with slab-local crossover plans is exactly the
monolithic law: the parents are drawn once a generation for every slab,
and crossovers never span chromosomes.

On a CUDA device the host slabs live in pinned memory, allocated once in
`build`; the next slab's upload runs on a copy stream while the current
slab computes (events order it after the compute that last read its
buffer and before the compute that reads it), and each child slab goes
back to its pinned slab on a second copy stream while the next slab
computes. `h2d_s` / `d2h_s` sum each copy's own time on its stream (CUDA
events, read after the generation's sync), so the split is real and the
overlap stays. On the CPU the slabs are the tensors the meiosis reads.

Scope, as the JAX engine's: one population, uniform mating, no selection
and no de novo mutation.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional

import torch

from geneevolve_tpu_torch.core.rng import Stage, generator
from geneevolve_tpu_torch.dense.packed import (
    PackedConfig,
    init_state,
    make_reproduce,
)
from geneevolve_tpu_torch.dense.step import _sample_gamete_plan


@dataclass
class StreamedPacked:
    cfg: PackedConfig  # FULL-genome config (n, m, n_chr)
    slab_chrs: int  # chromosomes per slab (must divide n_chr)
    host: List[torch.Tensor]  # per-slab (n, 2, w_slab) int32, host memory
    cfg_slab: PackedConfig
    device: torch.device
    h2d_s: float = 0.0
    d2h_s: float = 0.0
    _bufs: list = field(default_factory=list, repr=False)

    @staticmethod
    def slab_config(cfg: PackedConfig, slab_chrs: int) -> PackedConfig:
        if cfg.n_chr % slab_chrs:
            raise ValueError(f"{slab_chrs} chromosomes a slab do not divide "
                             f"{cfg.n_chr}")
        return replace(cfg, m=cfg.m * slab_chrs // cfg.n_chr,
                       n_chr=slab_chrs, ncv=0, selection=False,
                       mut_rate=0.0)

    @classmethod
    def build(cls, seed: int, cfg: PackedConfig, slab_chrs: int,
              device="cuda", verbose: bool = False) -> "StreamedPacked":
        """Founder slabs, each drawn on `device` from a generator of its
        own (seeded from (seed, slab)) and moved to host memory, pinned on
        a CUDA device."""
        dev = torch.device(device)
        cfg_slab = cls.slab_config(cfg, slab_chrs)
        host = []
        for s in range(cfg.n_chr // slab_chrs):
            st = init_state(generator(dev, seed, 0, Stage.DENSE_STEP, chrom=s),
                            cfg_slab)
            slab = torch.empty(st["hap"].shape, dtype=torch.int32,
                               pin_memory=dev.type == "cuda")
            slab.copy_(st["hap"])
            host.append(slab)
            del st
            if verbose:
                print(f"  founder slab {s + 1}/{len(host)} "
                      f"({slab.nbytes / 2 ** 30:.2f} GiB)", flush=True)
        return cls(cfg=cfg, slab_chrs=slab_chrs, host=host,
                   cfg_slab=cfg_slab, device=dev)

    @property
    def state_bytes(self) -> int:
        return sum(h.nbytes for h in self.host)

    def draw(self, gen: torch.Generator):
        """One generation's draws from `gen` on the device: the parents,
        drawn once for every slab, then each slab's gamete plans
        (xo_p, st_p, xo_m, st_m)."""
        n, dev = self.cfg.n, gen.device
        fathers = torch.randint(0, n, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        mothers = torch.randint(0, n, (n,), generator=gen, device=dev,
                                dtype=torch.int32)
        dense_slab = self.cfg_slab.as_dense()
        plans = []
        for _ in self.host:
            xo_p, st_p, _ = _sample_gamete_plan(gen, dense_slab, n)
            xo_m, st_m, _ = _sample_gamete_plan(gen, dense_slab, n)
            plans.append((xo_p, st_p, xo_m, st_m))
        return fathers, mothers, plans

    def step(self, gen: torch.Generator) -> None:
        """One generation over every slab: `draw`, then `apply`."""
        self.apply(*self.draw(gen))

    def apply(self, fathers: torch.Tensor, mothers: torch.Tensor,
              plans: list) -> None:
        """Replace every host slab by its children under these parents and
        per-slab plans."""
        reproduce = make_reproduce(self.cfg_slab)
        if self.device.type != "cuda":
            self.host = [reproduce(h, fathers, mothers, *plan, None)
                         for h, plan in zip(self.host, plans)]
            return
        if not self._bufs:  # two device buffers of parents, reused
            self._bufs = [torch.empty_like(self.host[0], device=self.device)
                          for _ in range(2)]
        compute = torch.cuda.current_stream(self.device)
        up = torch.cuda.Stream(self.device)
        down = torch.cuda.Stream(self.device)

        def timed(stream, fn):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            fn()
            b.record(stream)
            return a, b

        h2d, d2h = [], []
        freed: List[Optional[torch.cuda.Event]] = [None, None]
        uploaded = []

        def upload(s):
            buf = self._bufs[s % 2]
            with torch.cuda.stream(up):
                if freed[s % 2] is not None:  # its last reader is done
                    up.wait_event(freed[s % 2])
                h2d.append(timed(up, lambda: buf.copy_(self.host[s],
                                                       non_blocking=True)))
                ev = torch.cuda.Event()
                ev.record(up)
            uploaded.append(ev)

        upload(0)
        for s, plan in enumerate(plans):
            compute.wait_event(uploaded[s])
            child = reproduce(self._bufs[s % 2], fathers, mothers, *plan,
                              None)
            done = torch.cuda.Event()
            done.record(compute)
            freed[s % 2] = done
            if s + 1 < len(self.host):
                upload(s + 1)
            with torch.cuda.stream(down):
                down.wait_event(done)
                d2h.append(timed(down, lambda: self.host[s].copy_(
                    child, non_blocking=True)))
            child.record_stream(down)
        torch.cuda.synchronize(self.device)
        self.h2d_s += sum(a.elapsed_time(b) for a, b in h2d) / 1e3
        self.d2h_s += sum(a.elapsed_time(b) for a, b in d2h) / 1e3

    def allele_mean(self, slab: int = 0) -> float:
        """Mean set-bit fraction of one slab (drift sanity), counted on the
        engine's device."""
        words = self.host[slab].to(self.device)
        bits = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(32):
            bits += ((words >> i) & 1).sum()
        return float(bits) / (words.numel() * 32)
