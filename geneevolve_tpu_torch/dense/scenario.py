"""The standalone dense scenario: the bit-packed engine on a real founder
panel with a real recombination map (counterpart of
geneevolve_tpu/dense/scenario.py).

This is the mode for runs that consume every generation's genotypes
(GWAS-simulation pipelines, method benchmarking): the whole panel lives on
the device as two packed chromatid planes, each generation is one packed
meiosis launch (`ops/meiose_packed`), and any generation can be written
back out as .hap files.

Capabilities: hap/legend/indv founder input, map-aware Poisson
crossovers, de novo mutation, an additive phenotype on CV columns with
per-generation allele-frequency centering, neutral or logistic directional
selection, hap output, checkpoints in the JAX package's format.

Usage (module CLI; runs on a CUDA device):
    python -m geneevolve_tpu_torch.dense.scenario \\
        --file_hap_name <address file> --file_recom_map <map> \\
        --gens 20 [--pop_size N] [--mut_rate L] [--selection] \\
        [--file_cv_info cv.info] [--out_hap] [--prefix out.dense] [--seed 1] \\
        [--checkpoint_every N] [--resume <prefix>.ckpt.npz]
"""

from __future__ import annotations

import argparse
import io
import os
import time
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from geneevolve_tpu_torch.core.rng import Stage, generator
from geneevolve_tpu_torch.dense.packed import (
    PackedConfig,
    cv_from_planes,
    make_step,
    pack_bits,
    unpack_bits,
)
from geneevolve_tpu_torch.io import hap as hap_io
from geneevolve_tpu_torch.io import tables

# chromosomes are padded to a multiple of 32 loci, the packed kernel's unit
# (`ops/meiose_packed.py`); padding columns carry no map mass
PAD_UNIT = 32
CKPT_VERSION = 1


@dataclass
class PanelScenario:
    cfg: PackedConfig
    state: dict
    xo_cdf: torch.Tensor  # (m_padded,) f32 cumulative Morgans per column
    chrs: List[int]
    m_real: List[int]  # real SNPs per chromosome (before padding)
    legends: List  # per chr legend tables
    indv_ids: List[str]

    @property
    def chr_len(self) -> int:
        return self.cfg.chr_len


def _pad_to(x: np.ndarray, length: int, value) -> np.ndarray:
    if x.shape[-1] == length:
        return x
    pad = np.full((*x.shape[:-1], length - x.shape[-1]), value, x.dtype)
    return np.concatenate([x, pad], axis=-1)


def load_panel(
    file_hap_name: str,
    file_recom_map: str,
    cv_info: str = "",
    pop_size: Optional[int] = None,
    mut_rate: float = 0.0,
    selection: bool = False,
    ncv: int = 128,
    xo_cap: int = 8,
    seed: int = 1,
    device="cuda",
) -> PanelScenario:
    """Pack a hap/legend/indv founder panel into dense engine state on
    `device`. Chromosomes are padded to a common multiple of 32 columns;
    padding columns carry zero map mass (never recombine) and are dropped
    at output. Without `cv_info` a neutral marker set spread over the
    first chromosome's columns takes random effects; with `pop_size` the
    founders are bootstrapped to that size. Both draws come from
    generators seeded from `seed`."""
    dev = torch.device(device)
    addresses = tables.read_hap_address(file_hap_name)
    chrs = [a[0] for a in addresses]
    rmaps = tables.read_recom_map(file_recom_map, chrs)
    indv_ids = hap_io.read_indv(addresses[0][3])

    panels, legends, cMs, m_real = [], [], [], []
    for chrom, hap_path, legend_path, _ in addresses:
        panel = hap_io.read_hap(hap_path)  # (2n0, m_chr)
        legend = hap_io.read_legend(legend_path)
        r = rmaps[chrom]
        # cumulative cM at each SNP position (linear interp on the map)
        panels.append(panel)
        legends.append(legend)
        cMs.append(np.interp(legend.pos, r.bp, r.cM))
        m_real.append(panel.shape[1])

    chr_len = -(-max(m_real) // PAD_UNIT) * PAD_UNIT
    n0 = panels[0].shape[0] // 2
    m = chr_len * len(chrs)
    planes_a, planes_b, cdf = [], [], []
    total = 0.0
    for panel, cm in zip(panels, cMs):
        planes_a.append(_pad_to(panel[0::2], chr_len, 0))
        planes_b.append(_pad_to(panel[1::2], chr_len, 0))
        # per-column cumulative Morgans; padding adds no mass
        c = total + np.cumsum(np.diff(cm, prepend=cm[0]) / 100.0)
        total = c[-1]
        cdf.append(_pad_to(c, chr_len, total))
    hap = torch.stack([
        pack_bits(torch.from_numpy(np.concatenate(p, axis=1)).to(dev))
        for p in (planes_a, planes_b)
    ], 1)

    n = pop_size or n0
    cfg = PackedConfig(
        n=n, m=m, n_chr=len(chrs), xo_cap=xo_cap, mut_rate=mut_rate,
        mut_cap=max(4, int(np.ceil(mut_rate + 4 * np.sqrt(max(mut_rate, 1)))))
        if mut_rate > 0 else 4,
        ncv=ncv, selection=selection,
    )
    if n != n0:
        # bootstrap the founders up/down to the requested population size
        rows = torch.randint(0, n0, (n,), device=dev,
                             generator=generator(dev, seed, 0,
                                                 Stage.DENSE_STEP, chrom=1))
        hap = hap[rows]

    if cv_info:
        info = tables.read_cv_info(cv_info, chrs)
        cols, effs = [], []
        for ic, chrom in enumerate(chrs):
            idx = np.searchsorted(legends[ic].pos, info[chrom].bp)
            cols.append(idx + ic * chr_len)
            effs.append(info[chrom].a)
        cv_idx = np.concatenate(cols).astype(np.int32)
        eff = torch.from_numpy(np.concatenate(effs).astype(np.float32)).to(dev)
        cfg = replace(cfg, ncv=int(cv_idx.shape[0]))
    else:
        # neutral marker set spread over real columns
        cv_idx = np.linspace(0, m_real[0] - 1, cfg.ncv).astype(np.int32)
        eff = torch.randn(cfg.ncv, device=dev,
                          generator=generator(dev, seed, 0, Stage.DENSE_STEP,
                                              chrom=2))
    cv_idx = torch.from_numpy(cv_idx).to(dev)
    state = {
        "hap": hap,
        "cv": cv_from_planes(hap, cv_idx),
        "cv_idx": cv_idx,
        "eff": eff,
        "clip": torch.zeros((), dtype=torch.int64, device=dev),
    }
    return PanelScenario(
        cfg=cfg, state=state,
        xo_cdf=torch.from_numpy(np.concatenate(cdf).astype(np.float32)).to(
            dev),
        chrs=chrs, m_real=m_real, legends=legends, indv_ids=list(indv_ids),
    )


def evolve(
    sc: PanelScenario, gens: int, seed: int = 2, log=print,
    start_gen: int = 0, checkpoint_every: int = 0, checkpoint_path: str = "",
) -> dict:
    """Run generations [start_gen, gens); returns the final state.

    Generation g draws from a generator seeded from (seed, g) alone, so a
    run resumed from a checkpoint at generation g continues bit-identically
    to the uninterrupted run."""
    step = make_step(sc.cfg, xo_cdf=sc.xo_cdf)
    state = sc.state
    dev = state["hap"].device
    for g in range(start_gen, gens):
        state = step(state, generator(dev, seed, g, Stage.DENSE_STEP))
        if checkpoint_every and (g + 1) % checkpoint_every == 0:
            sc.state = state
            save_checkpoint(sc, g + 1, seed, checkpoint_path)
    clip = int(state["clip"])
    if clip:
        log(
            f"WARNING: {clip} crossover/mutation Poisson draws were "
            f"truncated at cap (raise xo_cap/mut_cap)"
        )
    sc.state = state
    return state


def save_checkpoint(sc: PanelScenario, gen: int, seed: int, path: str) -> None:
    """Atomic npz checkpoint of the packed engine state under the JAX
    package's keys and dtypes (the words as uint32), so either package
    loads the other's file where their padded widths agree. Stores the
    planes, CV columns/effects, the map CDF, and enough config identity to
    refuse a mismatched resume."""
    st = sc.state
    data = {
        "ckpt_version": CKPT_VERSION,
        "gen": gen,
        "seed": seed,
        "n": sc.cfg.n,
        "m": sc.cfg.m,
        "n_chr": sc.cfg.n_chr,
        "mut_rate": sc.cfg.mut_rate,
        "selection": sc.cfg.selection,
        "hap": st["hap"].cpu().numpy().view(np.uint32),
        "cv": st["cv"].cpu().numpy(),
        "cv_idx": st["cv_idx"].cpu().numpy(),
        "eff": st["eff"].cpu().numpy(),
        "clip": np.asarray(int(st["clip"]), dtype=np.int32),
        "xo_cdf": sc.xo_cdf.cpu().numpy(),
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, **data)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_checkpoint(sc: PanelScenario, seed: int, path: str) -> int:
    """Restore a `save_checkpoint` file (of either package) into `sc` on
    its device; returns the generation to resume from."""
    z = np.load(path, allow_pickle=False)
    if int(z["ckpt_version"]) != CKPT_VERSION:
        raise RuntimeError(
            f"checkpoint version {int(z['ckpt_version'])} != {CKPT_VERSION}"
        )
    for k in ("n", "m", "n_chr"):
        if int(z[k]) != getattr(sc.cfg, k):
            raise RuntimeError(
                f"checkpoint {k}={int(z[k])} does not match scenario "
                f"{k}={getattr(sc.cfg, k)}"
            )
    if int(z["seed"]) != seed:
        raise RuntimeError(
            "checkpoint seed differs; a resumed run would not continue the "
            "same trajectory"
        )
    dev = sc.state["hap"].device
    sc.state = {
        "hap": torch.from_numpy(z["hap"].view(np.int32)).to(dev),
        "cv": torch.from_numpy(z["cv"]).to(dev),
        "cv_idx": torch.from_numpy(z["cv_idx"]).to(dev),
        "eff": torch.from_numpy(z["eff"]).to(dev),
        "clip": torch.tensor(int(z["clip"]) if "clip" in z else 0,
                             dtype=torch.int64, device=dev),
    }
    return int(z["gen"])


def write_hap(sc: PanelScenario, prefix: str, gen: int) -> None:
    """Per-chromosome .hap/.indv output of the current state."""
    hap = sc.state["hap"]
    n = hap.shape[0]
    cw = sc.chr_len // 32
    for ic, chrom in enumerate(sc.chrs):
        words = hap[:, :, ic * cw:(ic + 1) * cw]
        planes = unpack_bits(words, sc.chr_len)[..., :sc.m_real[ic]]
        mat = planes.cpu().numpy().reshape(2 * n, sc.m_real[ic])
        base = f"{prefix}.gen{gen}.chr{chrom}"
        hap_io.write_hap(base + ".hap", mat)
        hap_io.write_indv(base + ".indv", np.arange(n) + 1)


def main(argv=None, device=None) -> int:
    """The module CLI. `device` defaults to "cuda", and without a CUDA
    device the run fails; tests pass "cpu" to run the plain versions."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file_hap_name", required=True)
    ap.add_argument("--file_recom_map", required=True)
    ap.add_argument("--file_cv_info", default="")
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--pop_size", type=int, default=0)
    ap.add_argument("--mut_rate", type=float, default=0.0)
    ap.add_argument("--selection", action="store_true")
    ap.add_argument("--out_hap", action="store_true")
    ap.add_argument("--prefix", default="out.dense")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--checkpoint_every", type=int, default=0,
                    help="write <prefix>.ckpt.npz every N generations")
    ap.add_argument("--resume", default="",
                    help="resume from a checkpoint written by this CLI")
    args = ap.parse_args(argv)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "geneevolve_tpu_torch needs a CUDA device; none is available"
            )
        device = "cuda"

    t0 = time.time()
    sc = load_panel(
        args.file_hap_name,
        args.file_recom_map,
        cv_info=args.file_cv_info,
        pop_size=args.pop_size or None,
        mut_rate=args.mut_rate,
        selection=args.selection,
        seed=args.seed,
        device=device,
    )
    print(
        f"panel: n={sc.cfg.n} chrs={sc.chrs} m={sc.cfg.m} "
        f"(packed {sc.cfg.mw * 4} bytes/chromatid), "
        f"total map = {float(sc.xo_cdf[-1]):.2f} Morgans"
    )
    start_gen = 0
    if args.resume:
        start_gen = load_checkpoint(sc, args.seed + 1, args.resume)
        print(f"resumed from {args.resume} at generation {start_gen}")
    evolve(
        sc, args.gens, seed=args.seed + 1, start_gen=start_gen,
        checkpoint_every=args.checkpoint_every,
        checkpoint_path=f"{args.prefix}.ckpt.npz",
    )
    print(f"evolved {args.gens - start_gen} generations in "
          f"{time.time() - t0:.1f} s")
    if args.out_hap:
        write_hap(sc, args.prefix, args.gens)
        print(f"wrote {args.prefix}.gen{args.gens}.chr*.hap")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
