"""The port's copies of the JAX package's host modules (`config`,
`core.mating`, `io`, `native`) against their originals, on the CPU.

The copies must behave as the originals: equal configurations from equal
argv (and equal errors from a bad one), equal mating plans from equal
numpy seeds, byte-identical hap / legend / indv / VCF / PLINK files and
equal parsed tables on `mini_scenario`, with the C codec and with its
pure-Python fallback (`GE_NO_NATIVE=1`), and equal info-file bytes from the
C formatter. Every comparison is exact: no tolerance.
"""

import dataclasses
import io
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from geneevolve_tpu import config as jconfig
from geneevolve_tpu import native as jnative
from geneevolve_tpu.core import mating as jmating
from geneevolve_tpu.io import hap as jhap
from geneevolve_tpu.io import plink as jplink
from geneevolve_tpu.io import tables as jtables
from geneevolve_tpu.io import vcf as jvcf
from geneevolve_tpu_torch import config as tconfig
from geneevolve_tpu_torch import native as tnative
from geneevolve_tpu_torch.core import mating as tmating
from geneevolve_tpu_torch.io import hap as thap
from geneevolve_tpu_torch.io import plink as tplink
from geneevolve_tpu_torch.io import tables as ttables
from geneevolve_tpu_torch.io import vcf as tvcf


def _same(a, b, where="value"):
    """Equal structure and values; arrays by dtype and content; the two
    sides' dataclasses (distinct classes of one shape) field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _argv(root: Path, *extra):
    return [
        "--file_gen_info", str(root / "popinfo.txt"),
        "--file_hap_name", str(root / "hap_address.txt"),
        "--file_recom_map", str(root / "rmap.txt"),
        "--file_cv_info", str(root / "cv.info"),
        "--file_cvs", str(root / "cv_address.txt"),
        "--seed", "777", *extra,
    ]


ARGVS = {
    "mini_scenario": [],
    "dense": ["--backend", "dense", "--out_hap", "--out_vcf", "--out_plink",
              "--stage_sync"],
    "options": ["--va", "0.5", "--vd", "0", "--vc", "0.1", "--ve", "0.4",
                "--vf", "0.2", "--omega", "2", "--lambda", "0.5", "--RM",
                "--MM", "0.25", "--vt_type", "2", "--avoid_inbreeding",
                "--gamma", "0.3", "--mesh", "ind=4,loci=2", "--prefix", "x"],
    "two_populations": ["--next_population", "--file_gen_info", "g2",
                        "--file_hap_name", "h2", "--file_recom_map", "r2",
                        "--file_cv_info", "c2", "--file_cvs", "v2",
                        "--file_migration", "mig.txt"],
}
BAD = {
    "unknown_flag": ["--no_such_flag"],
    "bad_backend": ["--backend", "sparse"],
    "bad_va": ["--va", "-3"],
    "bad_mesh": ["--mesh", "loci=2"],
    "missing_value": ["--prefix"],
    "two_populations_no_migration": ["--next_population", "--file_gen_info",
                                     "g2", "--file_hap_name", "h2",
                                     "--file_recom_map", "r2",
                                     "--file_cv_info", "c2",
                                     "--file_cvs", "v2"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parse_args_equal(mini_scenario, case):
    argv = _argv(mini_scenario, *ARGVS[case])
    got, want = tconfig.parse_args(argv), jconfig.parse_args(argv)
    _same(got, want, "cfg")
    assert (got.n_pop, got.n_pheno, got.ref_is_vcf) == (
        want.n_pop, want.n_pheno, want.ref_is_vcf)
    out = [io.StringIO(), io.StringIO()]
    tconfig.print_config(got, out[0])
    jconfig.print_config(want, out[1])
    assert out[0].getvalue() == out[1].getvalue()


@pytest.mark.parametrize("case", sorted(BAD))
def test_parse_args_raises_equal(mini_scenario, case):
    argv = _argv(mini_scenario, *BAD[case])
    with pytest.raises(tconfig.ConfigError) as got:
        tconfig.parse_args(argv)
    with pytest.raises(jconfig.ConfigError) as want:
        jconfig.parse_args(argv)
    assert str(got.value) == str(want.value)


def _population(rng, n):
    ids = np.arange(n, dtype=np.int64)
    ped = {k: rng.integers(0, n // 3, size=n) for k in
           ("father", "mother", "ff", "fm", "mf", "mm")}
    return dict(mv=rng.normal(size=n), svf=rng.uniform(0.2, 1.0, size=n),
                sex=rng.integers(1, 3, size=n).astype(np.int8), ped=ped,
                ids=ids)


@pytest.mark.parametrize("kind, mat_cor, mm, avoid, dist, exact_n", [
    ("random", 0.0, 0.0, False, "p", False),
    ("assort", 0.3, 0.0, False, "p", False),
    ("assort", 0.8, 0.2, True, "p", False),
    ("assort", -0.4, 0.1, True, "f", False),
    ("assort", 0.5, 0.0, False, "p", True),
])
def test_mating_plans_equal(kind, mat_cor, mm, avoid, dist, exact_n):
    pop = _population(np.random.default_rng(5), 900)
    plans = []
    for mod in (tmating, jmating):
        rng = np.random.default_rng(2024)
        if kind == "random":
            plans.append(mod.random_mate(rng, pop["svf"], pop["sex"], 1000))
        else:
            plans.append(mod.assort_mate(
                rng, pop["mv"], pop["svf"], pop["sex"], pop["ped"], mat_cor,
                mm, avoid, dist, 1000, exact_n=exact_n))
    got, want = plans
    _same(got, want, "plan")
    np.testing.assert_array_equal(got.child_father, want.child_father)
    np.testing.assert_array_equal(got.child_mother, want.child_mother)
    assert got.n_couples == want.n_couples > 0
    assert got.couple_cor_mating_value(pop["mv"]) == \
        want.couple_cor_mating_value(pop["mv"])


@pytest.fixture(params=["native", "python"])
def codec(request, monkeypatch):
    """Run with the C codec, or force the pure-Python paths."""
    if request.param == "python":
        monkeypatch.setenv("GE_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("GE_NO_NATIVE", raising=False)
    return request.param


def _files_equal(a: Path, b: Path):
    assert a.read_bytes() == b.read_bytes(), (a, b)


def test_tables_equal(mini_scenario, codec):
    r = mini_scenario
    chrs = [1, 2]
    for name, args in (
        ("read_generation_info", (r / "popinfo.txt",)),
        ("read_hap_address", (r / "hap_address.txt",)),
        ("read_cv_info", (r / "cv.info", chrs)),
        ("read_cvs_address", (r / "cv_address.txt", chrs)),
        ("read_recom_map", (r / "rmap.txt", chrs)),
    ):
        _same(getattr(ttables, name)(*args), getattr(jtables, name)(*args),
              name)
    maps = (ttables.read_recom_map(r / "rmap.txt", chrs),
            jtables.read_recom_map(r / "rmap.txt", chrs))
    for c in chrs:
        _same(maps[0][c].prob, maps[1][c].prob, f"prob {c}")


def test_hap_files_equal(mini_scenario, codec, tmp_path):
    for c in (1, 2):
        hap = [m.read_hap(mini_scenario / f"ref.chr{c}.hap")
               for m in (thap, jhap)]
        _same(hap[0], hap[1], f"hap {c}")
        leg = [m.read_legend(mini_scenario / f"ref.chr{c}.legend")
               for m in (thap, jhap)]
        _same(leg[0], leg[1], f"legend {c}")
        indv = [m.read_indv(mini_scenario / f"ref.chr{c}.indv")
                for m in (thap, jhap)]
        _same(indv[0], indv[1], f"indv {c}")
        for name, m in (("torch", thap), ("jax", jhap)):
            m.write_hap(tmp_path / f"{name}.{c}.hap", hap[0])
            m.write_indv(tmp_path / f"{name}.{c}.indv", indv[0])
        for ext in ("hap", "indv"):
            _files_equal(tmp_path / f"torch.{c}.{ext}",
                         tmp_path / f"jax.{c}.{ext}")
        assert thap.hap_bytes(hap[0]) == jhap.hap_bytes(hap[0])
        # written text reads back to the same matrix
        _same(thap.read_hap(tmp_path / f"torch.{c}.hap"), hap[0], "reread")


def _vcf_data(mod, hap, leg, indv):
    m = leg.nsnp
    s = lambda x: np.asarray(x, dtype=object)
    return mod.VcfData(
        samples=list(indv), chrom=s(["1"] * m), pos=leg.pos, ids=leg.ids,
        ref=leg.al0, alt=leg.al1, qual=s(["."] * m), filt=s(["PASS"] * m),
        info=s(["."] * m), fmt=s(["GT"] * m), hap=hap,
        meta_lines=mod.default_meta_lines(),
    )


def test_vcf_and_plink_files_equal(mini_scenario, codec, tmp_path):
    r = mini_scenario
    hap = thap.read_hap(r / "ref.chr1.hap")
    leg = thap.read_legend(r / "ref.chr1.legend")
    indv = thap.read_indv(r / "ref.chr1.indv")
    n = len(indv)
    for name, m in (("torch", tvcf), ("jax", jvcf)):
        v = _vcf_data(m, hap, leg, indv)
        m.write_vcf(tmp_path / f"{name}.vcf", v)
        with m.VcfStreamWriter(tmp_path / f"{name}.stream.vcf", v) as w:
            for lo in range(0, leg.nsnp, 64):
                w.write_block(lo, hap[0::2, lo:lo + 64], hap[1::2, lo:lo + 64])
    for ext in ("vcf", "stream.vcf"):
        _files_equal(tmp_path / f"torch.{ext}", tmp_path / f"jax.{ext}")
    _files_equal(tmp_path / "torch.vcf", tmp_path / "torch.stream.vcf")
    got = tvcf.read_vcf(tmp_path / "jax.vcf")
    want = jvcf.read_vcf(tmp_path / "jax.vcf")
    _same(got, want, "vcf")
    _same(got.hap, hap, "vcf hap")
    assert tvcf.read_header_samples(tmp_path / "jax.vcf") == \
        jvcf.read_header_samples(tmp_path / "jax.vcf")

    geno = np.stack([hap[0::2], hap[1::2]], axis=2)  # (n, m, 2)
    ids = np.arange(1, n + 1)
    sex = (ids % 2 + 1).astype(np.int8)
    for letters in (True, False):
        for name, m in (("torch", tplink), ("jax", jplink)):
            m.write_ped_map(
                tmp_path / f"{name}.{letters}", geno,
                m.PedIds(fid=ids, iid=ids, pid=ids, mid=ids, sex=sex), 1,
                leg.ids, leg.pos, leg.al0, leg.al1, letters=letters)
        for ext in ("ped", "map"):
            _files_equal(tmp_path / f"torch.{letters}.{ext}",
                         tmp_path / f"jax.{letters}.{ext}")


def _info_rows(ids, vals) -> bytes:
    """The info-file body as the engines' Python row loop writes it when
    no codec is built."""
    return b"".join(
        (" ".join(str(x) for x in i) + " "
         + " ".join(f"{x:g}" for x in v) + "\n").encode()
        for i, v in zip(ids, vals))


def test_format_info_equal():
    """The port's C formatter writes the JAX package's bytes: its codec's
    where that loaded in this process, else its Python row loop's text.
    The JAX loader builds `_codecs.so` in place, so a process that raced
    another's build may hold no codec; the port's own loader builds under
    a temporary name and must load wherever `g++` is present."""
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 10**9, size=(513, 8), dtype=np.int64)
    vals = rng.normal(scale=1e3, size=(513, 10))
    vals[::7, 3] = 0.0
    vals[5, 1] = np.nan
    got = tnative.format_info(ids, vals)
    if shutil.which("g++") and os.environ.get("GE_NO_NATIVE") != "1":
        assert tnative.load() is not None
    if got is None:  # no toolchain here: the pure-Python paths serve
        pytest.skip("no C++ toolchain: the port's codec is not built")
    want = (jnative.format_info(ids, vals) if jnative.load() is not None
            else _info_rows(ids, vals))
    assert got == want
    assert got == _info_rows(ids, vals)


def test_codec_builds_outside_the_source_tree():
    if tnative.load() is None:
        pytest.skip("no C++ toolchain: the pure-Python paths serve")
    path = tnative._lib_path()
    assert path.exists() and path.parent.name == "_build"


def _ckpt_sim(seed=5, rows=6, gen_arrays=None):
    """A stand-in simulation holding what `checkpoint.save` reads and
    `checkpoint.load` restores: two populations, one phenotype, seeded
    host arrays and genome arrays under the segment engine's keys."""
    from types import SimpleNamespace as NS

    rng = np.random.default_rng(seed)
    pops = []
    for i in range(2):
        n = rows - i
        state = NS(
            n=n, sex=rng.integers(1, 3, n).astype(np.int8),
            ids=np.arange(n, dtype=np.int64),
            ped={k: rng.integers(0, 9, n) for k in
                 ("father", "mother", "ff", "fm", "mf", "mm")},
            comp={k: rng.normal(size=(1, n)) for k in "ADGCEFP"},
            mv=rng.normal(size=n), sv=rng.normal(size=n), svf=np.ones(n),
            genome={"seg_st": rng.integers(0, 99, (2, n, 2, 3), np.int32),
                    "seg_hap": rng.integers(0, 99, (2, n, 2, 3), np.int16),
                    "mut": rng.integers(0, 99, (2, n, 2, 2), np.int32)},
        )
        pops.append(NS(
            index=i, state=state, prev_phen=rng.normal(size=(1, n)),
            prev_F=rng.normal(size=(1, n)), var_a_gen0=rng.normal(size=1),
            var_d_gen0=rng.normal(size=1), sv_mean_gen0=0.25,
            sv_var_gen0=1.5, phenos=[NS(beta=0.7)],
            traj={"var_A": rng.normal(size=(1, 4)),
                  "var_mv": rng.normal(size=4)},
        ))
    sim = NS(cfg=NS(seed=seed, backend="segment"), n_pop=2, n_pheno=1,
             s_cap=3, m_cap=2, pops=pops)
    sim._ckpt_genome_arrays = lambda st: st.genome
    sim._ckpt_make_state = lambda z, pre, host: NS(
        genome={k: z[f"{pre}.{k}"] for k in ("seg_st", "seg_hap", "mut")},
        **host)
    return sim


def test_checkpoint_copy_equal(tmp_path):
    """The port's `core/checkpoint` writes the JAX module's arrays (keys,
    dtypes, values) from the same simulation, and each module restores the
    other's file into the same state."""
    from geneevolve_tpu.core import checkpoint as jckpt
    from geneevolve_tpu_torch.core import checkpoint as tckpt

    assert tckpt.FORMAT_VERSION == jckpt.FORMAT_VERSION == 2
    for mod, name in ((jckpt, "jax.npz"), (tckpt, "torch.npz")):
        mod.save(_ckpt_sim(), 3, str(tmp_path / name))
    zj, zt = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "torch.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        _same(zt[k], zj[k], k)
    assert not list(tmp_path.glob("*.tmp"))  # written atomically
    for name in ("jax.npz", "torch.npz"):
        restored = []
        for mod in (jckpt, tckpt):
            sim = _ckpt_sim(rows=2)  # other sizes: load must replace them
            assert mod.load(sim, str(tmp_path / name)) == 3
            restored.append(sim)
        want = _ckpt_sim()
        for got in restored:
            for p, q in zip(got.pops, want.pops):
                _same({k: v for k, v in vars(p.state).items()},
                      {k: v for k, v in vars(q.state).items()}, name)
                for k in ("prev_phen", "prev_F", "var_a_gen0", "var_d_gen0",
                          "traj"):
                    _same(getattr(p, k), getattr(q, k), k)
                assert (p.sv_mean_gen0, p.sv_var_gen0, p.phenos[0].beta) \
                    == (0.25, 1.5, 0.7)
            assert (got.s_cap, got.m_cap) == (3, 2)


@pytest.mark.parametrize("bad, match", [
    ("seed", "seed"), ("n_pop", "scenario"), ("backend", "backend")])
def test_checkpoint_copy_refusals_equal(tmp_path, bad, match):
    """Both modules refuse a checkpoint of another seed, shape or backend
    with the same error."""
    from geneevolve_tpu.core import checkpoint as jckpt
    from geneevolve_tpu_torch.core import checkpoint as tckpt

    tckpt.save(_ckpt_sim(), 1, str(tmp_path / "c.npz"))
    errors = []
    for mod in (jckpt, tckpt):
        sim = _ckpt_sim()
        if bad == "seed":
            sim.cfg.seed = 6
        elif bad == "n_pop":
            sim.n_pop = 3
        else:
            sim.cfg.backend = "dense"
        with pytest.raises(RuntimeError, match=match) as e:
            mod.load(sim, str(tmp_path / "c.npz"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
