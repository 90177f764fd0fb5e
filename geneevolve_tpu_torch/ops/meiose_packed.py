"""Packed meiosis: both gametes of every child, 32 loci per int32 word, with
de novo mutations fused.

CUDA kernel: `csrc/meiose_packed.cu` (replaces geneevolve_tpu/ops/
meiosis_packed_pallas.py `meiose_packed_pallas`, and its layout
experiments tools/kexp.py `meiose_v3` (combined planes, no mutations:
`meiose_packed` with `mu=None`) and `meiose_v2` (split planes:
`meiose_packed_split`)). The plain version is `dense/packed.py`'s
`meiose_packed_xla` + `apply_mutations_packed`; the kernel equals it bit for
bit. A CPU tensor goes to the plain version; a CUDA tensor to the kernel.
"""

from __future__ import annotations

import torch

from geneevolve_tpu_torch.dense import packed
from geneevolve_tpu_torch.ops import _build

MAX_SMEM = 48 * 1024  # bytes of staged plan per block (no opt-in needed)


def _cfg(mw: int, n_chr: int, chr_len: int) -> packed.PackedConfig:
    if n_chr * chr_len != 32 * mw or chr_len % 32:
        raise ValueError(
            f"meiose_packed: {n_chr} x {chr_len} loci do not fill {mw} words"
        )
    return packed.PackedConfig(n=0, m=32 * mw, n_chr=n_chr)


def meiose_packed_split_plain(hapA, hapB, fathers, mothers, xo_p, st_p,
                              xo_m, st_m, *, n_chr, chr_len):
    cfg = _cfg(hapA.shape[1], n_chr, chr_len)
    return (packed.meiose_words_xla(hapA, hapB, fathers, xo_p, st_p, cfg),
            packed.meiose_words_xla(hapA, hapB, mothers, xo_m, st_m, cfg))


def meiose_packed_plain(hap, fathers, mothers, xo_p, st_p, xo_m, st_m,
                        mu=None, *, n_chr, chr_len):
    ab = meiose_packed_split_plain(hap[:, 0], hap[:, 1], fathers, mothers,
                                   xo_p, st_p, xo_m, st_m, n_chr=n_chr,
                                   chr_len=chr_len)
    if mu is not None:
        ab = [packed.apply_mutations_packed(x, mu[:, g])
              for g, x in enumerate(ab)]
    return torch.stack(ab, 1)


def _launch(planes, outs, par_stride, out_stride, fathers, mothers, xo_p,
            st_p, xo_m, st_m, mu, n_chr, chr_len, mw):
    dev = planes[0].device
    ts = [*planes, fathers, mothers, xo_p, st_p, xo_m, st_m]
    if mu is not None:
        ts.append(mu)
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("meiose_packed: all tensors must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.int32 for t in ts):
        raise TypeError("meiose_packed takes int32 words, rows and loci")
    _cfg(mw, n_chr, chr_len)
    n = fathers.shape[0]
    K = xo_p.shape[2]
    km = 0 if mu is None else mu.shape[2]
    if (mothers.shape != (n,) or xo_p.shape != (n, n_chr, K)
            or xo_m.shape != xo_p.shape or st_p.shape != (n, n_chr)
            or st_m.shape != st_p.shape
            or (mu is not None and mu.shape != (n, 2, km))):
        raise ValueError("meiose_packed: shape mismatch")
    if 4 * (2 * n_chr * K + 4 * n_chr + 2 * km + 2) > MAX_SMEM:
        raise ValueError("meiose_packed: plan too large for shared memory")
    if n * ((mw + 4095) // 4096) >= 2**31:
        raise ValueError("meiose_packed: too many blocks")
    fathers, mothers, xo_p, st_p, xo_m, st_m = (
        t.contiguous() for t in (fathers, mothers, xo_p, st_p, xo_m, st_m)
    )
    mu = None if mu is None else mu.contiguous()
    code = _build.lib().ge_meiose_packed(
        planes[0].data_ptr(), planes[1].data_ptr(), par_stride,
        outs[0].data_ptr(), outs[1].data_ptr(), out_stride,
        fathers.data_ptr(), mothers.data_ptr(), xo_p.data_ptr(),
        st_p.data_ptr(), xo_m.data_ptr(), st_m.data_ptr(),
        None if mu is None else mu.data_ptr(), km, n, n_chr, K,
        chr_len // 32, mw, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "meiose_packed")


def meiose_packed(
    hap: torch.Tensor,  # (N, 2, mw) int32 parent planes
    fathers: torch.Tensor,  # (n,) int32
    mothers: torch.Tensor,  # (n,) int32
    xo_p: torch.Tensor,  # (n, n_chr, K) int32 crossover loci, pad = m
    st_p: torch.Tensor,  # (n, n_chr) int32 start chromatid
    xo_m: torch.Tensor,
    st_m: torch.Tensor,
    mu=None,  # (n, 2, Km) int32 de novo mutation loci, pad = m
    *,
    n_chr: int,
    chr_len: int,
) -> torch.Tensor:
    """(n, 2, mw) int32 child planes, the gamete from the father in plane
    0: meiosis of both parents with the mutations XORed in."""
    if hap.device.type == "cpu":
        return meiose_packed_plain(hap, fathers, mothers, xo_p, st_p, xo_m,
                                   st_m, mu, n_chr=n_chr, chr_len=chr_len)
    if hap.dim() != 3 or hap.shape[1] != 2:
        raise ValueError("meiose_packed takes (N, 2, mw) planes")
    hap = hap.contiguous()
    mw = hap.shape[2]
    out = torch.empty((fathers.shape[0], 2, mw), dtype=torch.int32,
                      device=hap.device)
    _launch((hap, hap[:, 1]), (out, out[:, 1]), 2 * mw, 2 * mw, fathers,
            mothers, xo_p, st_p, xo_m, st_m, mu, n_chr, chr_len, mw)
    meiose_packed.launches += 1
    return out


def meiose_packed_split(hapA, hapB, fathers, mothers, xo_p, st_p, xo_m,
                        st_m, *, n_chr, chr_len):
    """(childA, childB), each (n, mw) int32, from split parent planes hapA,
    hapB (N, mw), without mutations: the same kernel, addressed with the
    split layout's strides."""
    if hapA.device.type == "cpu":
        return meiose_packed_split_plain(hapA, hapB, fathers, mothers, xo_p,
                                         st_p, xo_m, st_m, n_chr=n_chr,
                                         chr_len=chr_len)
    if hapA.dim() != 2 or hapB.shape != hapA.shape:
        raise ValueError("meiose_packed_split takes two (N, mw) planes")
    hapA, hapB = hapA.contiguous(), hapB.contiguous()
    n, mw = fathers.shape[0], hapA.shape[1]
    outA = torch.empty((n, mw), dtype=torch.int32, device=hapA.device)
    outB = torch.empty_like(outA)
    _launch((hapA, hapB), (outA, outB), mw, mw, fathers, mothers, xo_p,
            st_p, xo_m, st_m, None, n_chr, chr_len, mw)
    meiose_packed_split.launches += 1
    return outA, outB


meiose_packed.launches = 0  # kernel launches since the last reset
meiose_packed_split.launches = 0
