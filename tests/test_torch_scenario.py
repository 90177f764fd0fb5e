"""The standalone dense scenario in the PyTorch port
(`geneevolve_tpu_torch.dense.scenario`) against the JAX package's
(`geneevolve_tpu.dense.scenario`), on the CPU, over `mini_scenario`.

- `load_panel` with the panel's `cv.info` and no bootstrap equals JAX's
  bit for bit: planes (through the uint32 view), the map CDF, CV columns,
  effects and alleles, chromosomes and real widths.
- `write_hap` writes JAX's bytes for the same state; checkpoints cross
  between the packages both ways with the same keys and dtypes.
- The port's own draws: map-aware crossovers follow the CDF, a run stays
  near its founders' allele frequencies, a resumed run is bit-identical to
  the straight run, and the module CLI writes its files (and refuses to
  run without CUDA unless given a device).
"""

import filecmp

import numpy as np
import pytest
import torch

from geneevolve_tpu.dense import scenario as jsc
from geneevolve_tpu_torch.dense import packed as tpk
from geneevolve_tpu_torch.dense import scenario as tsc
from geneevolve_tpu_torch.dense.step import DenseConfig, _sample_gamete_plan
from geneevolve_tpu_torch.io import hap as hap_io

torch.set_num_threads(1)
STATE = ("hap", "cv", "cv_idx", "eff")


def _files(root):
    return str(root / "hap_address.txt"), str(root / "rmap.txt")


def _port(root, **kw):
    return tsc.load_panel(*_files(root), device="cpu", **kw)


def _jax(root, **kw):
    return jsc.load_panel(*_files(root), **kw)


def _words(sc, k):
    """A state array of either package as numpy, words as uint32."""
    x = sc.state[k]
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x.view(np.uint32) if k == "hap" else x
    return np.asarray(x)


def _assert_same_state(a, b):
    for k in STATE:
        x, y = _words(a, k), _words(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _carry(jax_sc, port_sc):
    """The JAX state, put into the port's scenario."""
    port_sc.state = {
        "hap": torch.from_numpy(_words(jax_sc, "hap").view(np.int32).copy()),
        **{k: torch.from_numpy(_words(jax_sc, k).copy()) for k in STATE[1:]},
        "clip": torch.zeros((), dtype=torch.int64),
    }


def test_load_panel_equals_jax(mini_scenario):
    kw = dict(cv_info=str(mini_scenario / "cv.info"), mut_rate=0.7,
              selection=True, seed=3)
    a, b = _jax(mini_scenario, **kw), _port(mini_scenario, **kw)
    _assert_same_state(a, b)
    np.testing.assert_array_equal(b.xo_cdf.numpy(), np.asarray(a.xo_cdf))
    assert b.chrs == a.chrs and b.m_real == a.m_real
    assert b.indv_ids == a.indv_ids
    for k in ("n", "m", "n_chr", "xo_cap", "mut_rate", "mut_cap", "ncv",
              "selection"):
        assert getattr(b.cfg, k) == getattr(a.cfg, k), k
    assert b.cfg.chr_len % 32 == 0 and b.cfg.ncv == 20


def test_map_aware_crossovers_follow_cdf():
    """With all map mass in the first half of each chromosome, crossovers
    land only there, at per-chromosome Poisson intensity (the mirror of
    `tests/test_scenario.py::test_map_aware_crossovers_follow_cdf`)."""
    cfg = DenseConfig(n=4000, m=2048, n_chr=2, xo_cap=8)
    half = cfg.chr_len // 2
    mass = np.zeros(cfg.m)
    mass[1:half] = 0.5 / (half - 1)  # chr 1: 0.5 Morgans, first half
    mass[cfg.chr_len + 1: cfg.chr_len + half] = 2.0 / (half - 1)  # chr 2
    cdf = torch.as_tensor(np.cumsum(mass), dtype=torch.float32)
    xo, _, _ = _sample_gamete_plan(torch.Generator().manual_seed(0), cfg,
                                   cfg.n, cdf)
    xon = xo.numpy()
    real = xon < cfg.m
    pos1 = xon[:, 0][real[:, 0]]
    pos2 = xon[:, 1][real[:, 1]]
    assert pos1.max(initial=0) < half
    assert pos2.min(initial=cfg.m) >= cfg.chr_len
    assert pos2.max(initial=0) < cfg.chr_len + half
    c1 = real[:, 0].sum(axis=-1).mean()
    c2 = real[:, 1].sum(axis=-1).mean()
    assert abs(c1 - 0.5) < 0.05, c1
    assert abs(c2 - 2.0) < 0.12, c2


def test_write_hap_equals_jax(mini_scenario, tmp_path):
    """Two JAX generations carried into the port: `write_hap` writes the
    JAX package's bytes."""
    a = _jax(mini_scenario, mut_rate=1.0, seed=4)
    jsc.evolve(a, gens=2, seed=5)
    b = _port(mini_scenario, mut_rate=1.0, seed=4)
    _carry(a, b)
    jsc.write_hap(a, str(tmp_path / "jax"), 2)
    tsc.write_hap(b, str(tmp_path / "port"), 2)
    for c in a.chrs:
        for ext in ("hap", "indv"):
            assert filecmp.cmp(tmp_path / f"jax.gen2.chr{c}.{ext}",
                               tmp_path / f"port.gen2.chr{c}.{ext}",
                               shallow=False), (c, ext)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(mini_scenario, tmp_path, direction):
    """A checkpoint written by one package loads in the other with the
    writer's state; both packages write the same keys and dtypes."""
    kw = dict(cv_info=str(mini_scenario / "cv.info"), mut_rate=0.5,
              selection=True)
    a, b = _jax(mini_scenario, **kw), _port(mini_scenario, **kw)
    ja, pa = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsc.evolve(a, gens=2, seed=6, checkpoint_every=2, checkpoint_path=ja)
    tsc.evolve(b, gens=2, seed=6, checkpoint_every=2, checkpoint_path=pa)
    zj, zp = np.load(ja), np.load(pa)
    assert sorted(zj.files) == sorted(zp.files)
    for k in zj.files:
        assert zj[k].dtype == zp[k].dtype, k
    if direction == "jax_to_port":
        dst = _port(mini_scenario, **kw)
        assert tsc.load_checkpoint(dst, 6, ja) == 2
        _assert_same_state(a, dst)
    else:
        dst = _jax(mini_scenario, **kw)
        assert jsc.load_checkpoint(dst, 6, pa) == 2
        _assert_same_state(dst, b)


def test_resume_bit_identical(mini_scenario, tmp_path):
    """Evolve 4 generations straight, against 2 + checkpoint + a fresh
    `load_panel` + resume for 2 more: the same planes and CVs; a
    mismatched seed is refused."""
    def fresh():
        return _port(mini_scenario, mut_rate=0.5, selection=True, seed=5,
                     cv_info=str(mini_scenario / "cv.info"))

    ckpt = str(tmp_path / "run.ckpt.npz")
    straight = fresh()
    tsc.evolve(straight, gens=4, seed=6)
    first = fresh()
    tsc.evolve(first, gens=2, seed=6, checkpoint_every=2,
               checkpoint_path=ckpt)
    resumed = fresh()
    start = tsc.load_checkpoint(resumed, 6, ckpt)
    assert start == 2
    tsc.evolve(resumed, gens=4, seed=6, start_gen=start)
    _assert_same_state(straight, resumed)
    assert not torch.equal(first.state["hap"], resumed.state["hap"])
    with pytest.raises(RuntimeError, match="seed"):
        tsc.load_checkpoint(fresh(), 7, ckpt)


def test_panel_scenario_end_to_end(mini_scenario, tmp_path):
    """Bootstrapped to 2,000, with mutations, two neutral generations stay
    close to the founders' allele frequencies (the panel's frequencies
    spread little, so selection on its 20 CVs would move them further: r
    ~0.4 in both packages); the resident CVs equal the planes'; the .hap
    output has the panel's real width."""
    sc = _port(mini_scenario, cv_info=str(mini_scenario / "cv.info"),
               pop_size=2000, mut_rate=0.3, seed=3)
    assert sc.cfg.n == 2000 and len(sc.chrs) == 2
    assert float(sc.xo_cdf[-1]) > 0.5  # real map mass
    af0 = tpk.unpack_bits(sc.state["hap"], sc.cfg.m).double().mean((0, 1))
    tsc.evolve(sc, gens=2, seed=4)
    assert torch.equal(sc.state["cv"], tpk.cv_from_planes(
        sc.state["hap"], sc.state["cv_idx"]))
    prefix = str(tmp_path / "dense.t")
    tsc.write_hap(sc, prefix, 2)
    mat = hap_io.read_hap(f"{prefix}.gen2.chr1.hap")
    assert mat.shape == (2 * sc.cfg.n, sc.m_real[0])
    r = np.corrcoef(af0[: sc.m_real[0]].numpy(), mat.mean(axis=0))[0, 1]
    assert r > 0.9, r


def test_main_writes_files(mini_scenario, tmp_path, capsys):
    """The module CLI on the CPU: its panel line, a checkpoint, and the
    final generation's .hap/.indv per chromosome."""
    hap_name, rmap = _files(mini_scenario)
    prefix = tmp_path / "cli.t"
    rc = tsc.main(["--file_hap_name", hap_name, "--file_recom_map", rmap,
                   "--file_cv_info", str(mini_scenario / "cv.info"),
                   "--gens", "2", "--selection", "--mut_rate", "1.0",
                   "--checkpoint_every", "1", "--out_hap",
                   "--prefix", str(prefix)], device="cpu")
    assert rc == 0
    assert "panel: n=50" in capsys.readouterr().out
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["cli.t.ckpt.npz"] + [
        f"cli.t.gen2.chr{c}.{e}" for c in (1, 2) for e in ("hap", "indv")]


def test_main_refuses_without_cuda(mini_scenario, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hap_name, rmap = _files(mini_scenario)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsc.main(["--file_hap_name", hap_name, "--file_recom_map", rmap,
                  "--prefix", str(tmp_path / "x")])
    assert not list(tmp_path.iterdir())
