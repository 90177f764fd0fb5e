"""The benchmark's frozen copies equal their originals: the scenario files
byte for byte at a small size (`tools/mkscenario.py`, `chip_smoke.py`'s
`_mutation_map`, `_second_population`, `_cvs_on_panel` and `_popinfo`),
the roofline arithmetic (`chip_smoke.py`'s `_bins_work`, `_gather_work`,
`_count_work`, `_merge_work`, `_packed_need`, `_packed_work`,
`_paint_work`, `_paint_need`, and `dense/packed.py`'s `phase_word_masks`)
and the busy arithmetic (`profile_phase`) on fixed inputs."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gebench import roofline, scenario, trace

REPO = Path(__file__).resolve().parent.parent.parent
SMALL = dict(n0=20, pop_size=50, gens=3, nchr=3, ncv=4)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(REPO / "tools"))
    return _module("chip_smoke_frozen_original", "chip_smoke.py")


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _paths_free(files: dict, *roots) -> dict:
    """File contents with the roots' paths (address files name them)
    replaced, so that two directories' files compare."""
    out = {}
    for k, v in files.items():
        for r in roots:
            v = v.replace(str(r).encode(), b"ROOT")
        out[k] = v
    return out


@pytest.mark.parametrize("snps", [0, 5, 40])
def test_scenario_equals_mkscenario(tmp_path, snps):
    mk = _module("mkscenario_original", "tools/mkscenario.py")
    a, b = tmp_path / "a", tmp_path / "b"
    fa = mk.make_scenario(str(a), **SMALL, snps=snps, seed=9)
    fb = scenario.make_scenario(str(b), **SMALL, snps=snps, seed=9)
    assert _paths_free(_files(a), a) == _paths_free(_files(b), b)
    assert {k: v.replace(str(a), "") for k, v in fa.items()} == \
        {k: v.replace(str(b), "") for k, v in fb.items()}


def test_second_population_equals_smoke(tmp_path, smoke):
    """`_second_population` (the first population's seed 1, then the
    population's own draws from seed 2) against `make_scenario` and
    `extra_population` with those seeds, and the mutation maps."""
    a, b = tmp_path / "a", tmp_path / "b"
    smoke._second_population(a, dict(SMALL), seed=2)
    scenario.make_scenario(str(b), **SMALL, seed=1)
    scenario.extra_population(b, SMALL["nchr"], SMALL["ncv"], SMALL["n0"],
                              np.random.default_rng(2))
    scenario.mutation_map(b / "mut.txt", b / "rmap.txt")
    assert _paths_free(_files(a), a) == _paths_free(_files(b), b)


def test_cvs_on_panel_equals_smoke(tmp_path, smoke):
    """`cvs_on_panel` moves the CVs onto the same panel sites, with the same
    rows, as `chip_smoke.py`'s `_cvs_on_panel`."""
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        scenario.make_scenario(str(d), **SMALL, snps=[30, 12, 50], seed=4)
    assert _paths_free(_files(a), a) == _paths_free(_files(b), b)
    smoke._cvs_on_panel(a, 4)
    scenario.cvs_on_panel(b, 4)
    assert _paths_free(_files(a), a) == _paths_free(_files(b), b)


def test_panel_counts_draw_as_one_count(tmp_path):
    """A list of equal counts writes what the one count writes."""
    a, b = tmp_path / "a", tmp_path / "b"
    fa = scenario.make_scenario(str(a), **SMALL, snps=9, seed=2)
    fb = scenario.make_scenario(str(b), **SMALL, snps=[9] * SMALL["nchr"],
                                seed=2)
    assert _paths_free(_files(a), a) == _paths_free(_files(b), b)
    assert fa.keys() == fb.keys()


def test_schedule_equals_popinfo(tmp_path, smoke):
    mix = dict(mat_cor=0.0, offspring_dist="p", selection="thr 1 1")
    a = smoke._popinfo(tmp_path, dict(pop_size=77), 4)
    b = scenario.schedule(tmp_path / "b.txt", [77] * 4, mix)
    assert a.read_bytes() == b.read_bytes()


def _inputs():
    g = torch.Generator().manual_seed(3)
    nchr, rows, nc, S, K = 3, 40, 40, 7, 5
    seg_st = torch.randint(0, 100, (nchr, rows, 2, S), generator=g,
                           dtype=torch.int32)
    seg_hap = torch.randint(0, 9, (nchr, rows, 2, S), generator=g,
                            dtype=torch.int16)
    parents = torch.randint(0, rows, (2, nc), generator=g,
                            dtype=torch.int32)  # repeats, as mating gives
    xo = [torch.randint(0, 100, (nchr, nc, K), generator=g,
                        dtype=torch.int32) for _ in range(2)]
    sh = torch.randint(0, 2, (nchr, nc, 2), generator=g, dtype=torch.int32)
    return seg_st, seg_hap, parents, xo[0], xo[1], sh


def _bytes_ops(d):
    return d["bytes"], d["ops"]


def test_roofline_equals_smoke(smoke):
    seg_st, seg_hap, parents, xo_f, xo_m, sh = _inputs()
    assert roofline.merge_work(seg_st, seg_hap, parents, xo_f, xo_m, sh,
                               11) == _bytes_ops(smoke._merge_work(
                                   seg_st, seg_hap, parents, xo_f, xo_m, sh,
                                   11))
    assert roofline.count_work(seg_st, parents, xo_f, xo_m, sh) == \
        _bytes_ops(smoke._count_work(seg_st, parents, xo_f, xo_m, sh))
    table, idx = seg_st, parents[0].contiguous()
    assert roofline.gather_work(table, idx, 1) == \
        _bytes_ops(smoke._gather_work(table, idx, 1))
    u, cum = torch.rand(3, 50), torch.cumsum(torch.rand(3, 17), 1)
    assert roofline.bins_work(u, cum) == _bytes_ops(smoke._bins_work(u, cum))
    b, o = roofline.merge_work(seg_st, seg_hap, parents, xo_f, xo_m, sh, 11)
    assert roofline.bound_s(b, o) * 1e3 == pytest.approx(
        smoke._bound(b, o)["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("hap_dtype", [torch.int16, torch.int32])
def test_paint_work_equals_smoke(smoke, hap_dtype):
    """`paint_work` counts the bytes `_paint_need` counts (the live ledger
    slots and mutation rows) and the operations `_paint_work` counts, from
    the tensors or from their live counts."""
    g = torch.Generator().manual_seed(8)
    C, rows, S, M, H, Q = 3, 20, 9, 5, 14, 11
    big = 2**30
    seg_st = torch.sort(torch.randint(0, 1000, (C, rows, 2, S), generator=g,
                                      dtype=torch.int32), -1).values
    seg_st[torch.rand((C, rows, 2, S), generator=g) < 0.4] = big
    seg_st = torch.sort(seg_st, -1).values
    seg_hap = torch.randint(0, H, (C, rows, 2, S), generator=g,
                            dtype=hap_dtype)
    mut = torch.where(torch.rand((C, rows, 2, M), generator=g) < 0.5,
                      torch.randint(0, 1000, (C, rows, 2, M), generator=g,
                                    dtype=torch.int32), big).to(torch.int32)
    founder = torch.randint(0, 2, (C, H, Q), generator=g, dtype=torch.uint8)
    pos = torch.randint(0, 1000, (C, Q), generator=g, dtype=torch.int32)
    args = (seg_st, seg_hap, mut, founder, pos)
    nbytes, ops = roofline.paint_work(*args)
    assert nbytes == smoke._paint_need(*args)["need_bytes"]
    assert ops == smoke._paint_work(*args)["ops"]
    assert nbytes < smoke._paint_work(*args)["bytes"]
    counts = (roofline.live_slots(seg_st), roofline.live_slots(mut))
    assert roofline.paint_work(*args, *counts) == (nbytes, ops)


def _packed_inputs():
    g = torch.Generator().manual_seed(5)
    n_chr, chr_len, K, rows, n = 3, 96, 6, 30, 50
    m = n_chr * chr_len
    xo = [torch.where(torch.rand((n, n_chr, K), generator=g) < 0.5,
                      torch.randint(0, chr_len, (n, n_chr, K), generator=g,
                                    dtype=torch.int32)
                      + torch.arange(n_chr, dtype=torch.int32)[None, :, None]
                      * chr_len, m).to(torch.int32) for _ in range(2)]
    st = [torch.randint(0, 2, (n, n_chr), generator=g, dtype=torch.int32)
          for _ in range(2)]
    par = [torch.randint(0, rows, (n,), generator=g, dtype=torch.int32)
           for _ in range(2)]
    mu = torch.randint(0, m + 1, (n, 2, 4), generator=g, dtype=torch.int32)
    return (par[0], par[1], xo[0], st[0], xo[1], st[1]), mu, rows, n_chr, \
        chr_len


def test_packed_work_equals_smoke(smoke):
    from geneevolve_tpu_torch.dense import packed

    args, mu, rows, n_chr, chr_len = _packed_inputs()
    cfg = packed.PackedConfig(n=0, m=n_chr * chr_len, n_chr=n_chr)
    for xo, st in ((args[2], args[3]), (args[4], args[5])):
        assert torch.equal(roofline.phase_words(xo, st, n_chr, chr_len),
                           packed.phase_word_masks(xo, st, cfg))
    need = roofline.packed_need(rows, args, n_chr, chr_len, chunk=16)
    assert need == smoke._packed_need(rows, args, n_chr, chr_len, chunk=16)
    assert need == roofline.packed_need(rows, args, n_chr, chr_len)
    assert roofline.packed_work(need, args, mu, n_chr, chr_len) == \
        _bytes_ops(smoke._packed_work(need, args, mu, n_chr, chr_len))
    hap = torch.zeros((rows, 2, n_chr * chr_len // 32), dtype=torch.int32)
    launch = roofline.Launch(roofline.packed_launch_work,
                             (hap, *args, mu, n_chr, chr_len),
                             keep=(1, 2, 3, 4, 5, 6))
    assert isinstance(launch.args[0], roofline.Shape)
    assert launch() == roofline.packed_work(need, args, mu, n_chr, chr_len)


def test_launch_keeps_shapes_and_indices():
    """A recorded launch holds the shapes of its planes and its index
    tensor; its bound counts the distinct rows the indices name."""
    table = torch.zeros((2, 10, 4), dtype=torch.int32)
    idx = torch.tensor([1, 1, 1, 2], dtype=torch.int32)
    launch = roofline.Launch(roofline.gather_work, (table, idx, 1), keep=(1,))
    assert isinstance(launch.args[0], roofline.Shape)
    assert launch.args[1] is idx
    assert launch() == (2 * 32 + 16 + 4 * 32, 0)


def test_busy_equals_profile_phase():
    """`trace.reduce`'s busy seconds equal `profile_phase`'s union of the
    device events' intervals when the run's span covers them."""
    rng = np.random.default_rng(1)
    ev = [{"cat": "kernel", "name": f"k{i % 3}", "ts": float(t),
           "dur": float(d)} for i, (t, d) in enumerate(zip(
               rng.uniform(10, 1000, 200), rng.uniform(0.1, 20, 200)))]
    ev.append({"cat": "gpu_memcpy", "name": "copy", "ts": 5.0, "dur": 3.0})
    run = {"cat": "user_annotation", "name": trace.RUN_SPAN, "ts": 0.0,
           "dur": 2000.0}
    red = trace.reduce(ev + [run])
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev)
    busy, end = 0.0, -1e300  # profile_phase's arithmetic
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    assert red["busy_s"] == pytest.approx(busy / 1e6, rel=1e-12)
    assert red["window_s"] == pytest.approx(2000e-6)
