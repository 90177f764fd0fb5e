"""Several populations in the PyTorch port against the JAX package, on the
CPU (the kernels' plain versions).

The fixture is `tests/test_multipop.py`'s two-population shape (40 founders
each, 10% symmetric migration every generation, 3 generations of ~50),
on 2 chromosomes, with each population's own founder panel and CV alleles
and its own effects (additive and dominance) at shared CV positions, and a
mutation map: equal tables would hide a wrong root population. Fed the JAX
run's mating and reproduce plans per (generation, population), the port's
ledgers, mutations and host fields equal the JAX run's every generation,
after migration too; `.int` and `.vcf` files are byte-identical; `.info` /
`.summary` agree within `test_torch_engine`'s tolerance (rtol 1e-5 plus an
absolute floor of 1e-5 of each column's largest magnitude: A and D are f32
row sums taken in another order).
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from geneevolve_tpu.core import engine as jax_engine
from geneevolve_tpu.core import segments as jseg
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core.convert import state_from_numpy
from geneevolve_tpu_torch.dense import backend as tbackend
from geneevolve_tpu_torch.ops.paint import paint
from test_torch_dense import JaxDenseRun
from test_torch_engine import (
    PLANES,
    JaxRun,
    _assert_table_close,
    _inject,
    _planes,
)

torch.set_num_threads(1)
NCHR = 2
HOST = ("sex", "ids")
PED = ("father", "mother", "ff", "fm", "mf", "mm")


def make_duo(root: Path, n0=40, nsnp=120, ncv=8, pop_size=50, gens=3,
             seed=7) -> Path:
    """Two populations on 2 chromosomes: shared SNP and CV positions, each
    population its own panel (so its own founder CV alleles) and its own
    `cv.info` effects, a 1 cM/Mb map and a mutation map."""
    rng = np.random.default_rng(seed)
    for c in range(1, NCHR + 1):
        pos = np.sort(rng.choice(np.arange(1_000_000, 40_000_000), nsnp,
                                 replace=False))
        cols = np.sort(rng.choice(nsnp, ncv, replace=False))
        np.save(root / f"pos{c}.npy", pos[cols])
        for p in (1, 2):
            hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
            np.savetxt(root / f"p{p}.ref.chr{c}.hap", hap, fmt="%d")
            with open(root / f"p{p}.ref.chr{c}.legend", "w") as f:
                f.write("id position a0 a1\n")
                f.writelines(f"rs{c}_{i} {q} A G\n"
                             for i, q in enumerate(pos))
            (root / f"p{p}.ref.chr{c}.indv").write_text(
                "".join(f"p{p}i{i + 1}\n" for i in range(n0)))
            np.savetxt(root / f"p{p}.cv.chr{c}.hap", hap[cols], fmt="%d")
    for p in (1, 2):
        with open(root / f"p{p}.hap_address.txt", "w") as f:
            f.write("chr hap legend sample\n")
            f.writelines(
                f"{c} {root}/p{p}.ref.chr{c}.hap {root}/p{p}.ref.chr{c}"
                f".legend {root}/p{p}.ref.chr{c}.indv\n"
                for c in range(1, NCHR + 1))
        (root / f"p{p}.cv_address.txt").write_text("".join(
            f"{c} {root}/p{p}.cv.chr{c}.hap\n" for c in range(1, NCHR + 1)))
        with open(root / f"p{p}.cv.info", "w") as f:
            f.write("chr pos a d\n")
            for c in range(1, NCHR + 1):
                for q in np.load(root / f"pos{c}.npy"):
                    f.write(f"{c} {q} {rng.normal()} {0.3 * rng.normal()}\n")
    (root / "popinfo.txt").write_text(
        "pop_size mat_cor offspring_dist selection_func "
        "selection_func_par1 selection_func_par2\n"
        + f"{pop_size} 0 p thr 1 1\n" * gens)
    bins = [(c, bp) for c in range(1, NCHR + 1)
            for bp in range(0, 50_000_000, 50_000)]
    (root / "rmap.txt").write_text("chr bp cM\n" + "".join(
        f"{c} {bp} {bp / 1_000_000:.6f}\n" for c, bp in bins))
    (root / "mut.txt").write_text("chr bp rate\n" + "".join(
        f"{c} {bp} {2e-4:.8g}\n" for c, bp in bins))
    (root / "migration.txt").write_text("0.9 0.1 0.1 0.9\n" * gens)
    return root


def duo_argv(root: Path, prefix: Path, extra=(), mutations=True):
    pops = []
    for p in (1, 2):
        pops += [
            "--file_gen_info", str(root / "popinfo.txt"),
            "--file_hap_name", str(root / f"p{p}.hap_address.txt"),
            "--file_recom_map", str(root / "rmap.txt"),
            "--file_cv_info", str(root / f"p{p}.cv.info"),
            "--file_cvs", str(root / f"p{p}.cv_address.txt"),
            "--vd", "0.2",
        ]
        if mutations:
            pops += ["--file_mutation_map", str(root / "mut.txt")]
        if p == 1:
            pops.append("--next_population")
    return pops + [
        "--file_migration", str(root / "migration.txt"),
        "--seed", "99",
        "--prefix", str(prefix),
        *extra,
    ]


OUT = ["--out_interval", "--out_vcf", "--gamma", "0.5"]


@pytest.fixture(scope="module")
def duo(tmp_path_factory):
    return make_duo(tmp_path_factory.mktemp("duo"))


@pytest.fixture(scope="module")
def duo_runs(duo, tmp_path_factory):
    """The JAX run, and the port's fed its plans, with every generation's
    states of both populations."""
    out = tmp_path_factory.mktemp("duo_runs")
    (out / "jax").mkdir()
    (out / "torch").mkdir()
    run = JaxRun(duo_argv(duo, out / "jax" / "out", OUT))
    run.sim.save_genotypes(run.sim.tot_gen)
    tsim = torch_engine.Simulation(
        parse_args(duo_argv(duo, out / "torch" / "out", OUT)), device="cpu",
        verbose=False)
    _inject(tsim, run)
    tsim.init_generation0()
    states = [[_planes(q.state) | _host_of(q.state) for q in tsim.pops]]
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
        states.append([_planes(q.state) | _host_of(q.state)
                       for q in tsim.pops])
    tsim._check_capacity_guard()
    tsim.write_summary()
    tsim.save_genotypes(tsim.tot_gen)
    return run, tsim, states, out


def _host_of(st):
    return dict(n=st.n, sex=st.sex, ids=st.ids, ped=st.ped, comp=st.comp,
                mv=st.mv, sv=st.sv, svf=st.svf)


def test_duo_fixture_differs_between_populations(duo_runs):
    """Each population's effects and founder CV alleles are its own, and
    the run takes the gather path with int16 haps (80 founder haps)."""
    _run, tsim, _states, _out = duo_runs
    assert tsim.n_pop == 2 and not tsim.resident_cv
    a = tsim.eff_a[0]
    assert a.shape == (NCHR, 2, tsim.ncv_pad)
    assert not torch.equal(a[:, 0], a[:, 1])
    assert not torch.equal(tsim.eff_d[0][:, 0], tsim.eff_d[0][:, 1])
    fc = tsim.founder_cv[0]
    assert fc.shape[1] == 160 and not np.array_equal(fc[:, :80], fc[:, 80:])
    assert tsim.hap_dtype == torch.int16
    np.testing.assert_array_equal(tsim.pop_starts, [0, 80])


@pytest.mark.parametrize("gen", [0, 1, 2, 3])
def test_duo_planes_bit_exact(duo_runs, gen):
    """Ledgers and mutations of both populations equal the JAX run's after
    every generation (after its migration)."""
    run, _tsim, states, _out = duo_runs
    for pop in range(2):
        got, want = states[gen][pop], run.pop_states[gen][pop]
        for k in PLANES[:3]:
            assert got[k].dtype == want[k].dtype, (gen, pop, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{gen} {pop} {k}")
    if gen == 3:
        muts = sum((s["mut"] < 2**30).sum() for s in states[3])
        assert muts > 20  # mutations were drawn, inherited and migrated


@pytest.mark.parametrize("gen", [0, 1, 2, 3])
def test_duo_host_fields_exact(duo_runs, gen):
    """Sizes, sexes, ids and pedigrees exact; components, MV and SV within
    the stated tolerance."""
    run, _tsim, states, _out = duo_runs
    for pop in range(2):
        got, want = states[gen][pop], run.pop_states[gen][pop]
        assert got["n"] == want["n"]
        for k in HOST:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in PED:
            np.testing.assert_array_equal(got["ped"][k], want["ped"][k])
        for k, v in want["comp"].items():
            np.testing.assert_allclose(
                got["comp"][k], v, rtol=1e-5,
                atol=1e-5 * float(np.max(np.abs(v), initial=0.0)))
        for k in ("mv", "sv", "svf"):
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-5,
                atol=1e-5 * float(np.max(np.abs(want[k]), initial=0.0)))


def test_duo_migration_moved_ancestry(duo_runs):
    """Each population's final ledger holds the other's founder haps."""
    _run, tsim, _states, _out = duo_runs
    for p in tsim.pops:
        st = p.state
        live = st.seg_st[:, : st.n] < 2**30
        haps = st.seg_hap[:, : st.n][live].long()
        other = (haps >= 80) if p.index == 0 else (haps < 80)
        assert bool(other.any()), p.index


def test_duo_info_and_summary_close(duo_runs):
    run, _tsim, _states, out = duo_runs
    for p in (1, 2):
        for gen in range(4):
            name = f"out.info.pop{p}.gen{gen}.txt"
            _assert_table_close(out / "torch" / name, out / "jax" / name)
        _assert_table_close(out / "torch" / f"out.pop{p}.summary",
                            out / "jax" / f"out.pop{p}.summary")


@pytest.mark.parametrize("ext", ["int", "vcf"])
def test_duo_genotype_files_identical(duo_runs, ext):
    """`.int` (root population column) and VCF over both panels, byte for
    byte."""
    _run, _tsim, _states, out = duo_runs
    names = sorted(x.name for x in (out / "jax").iterdir()
                   if x.name.endswith(f".{ext}"))
    assert len(names) == 2 * NCHR
    assert names == sorted(x.name for x in (out / "torch").iterdir()
                           if x.name.endswith(f".{ext}"))
    for name in names:
        assert filecmp.cmp(out / "torch" / name, out / "jax" / name,
                           shallow=False), name
    if ext == "int":
        roots = {l.split()[-1] for l in (out / "torch" / names[0])
                 .read_text().splitlines()[1:]}
        assert roots == {"1", "2"}


# ------------------------------------------------------- A/D against _ad_all
def _ad_case(duo_runs):
    run, tsim, _states, _out = duo_runs
    jsim = run.sim
    return jsim, tsim, [p.state for p in jsim.pops]


@pytest.mark.parametrize("pop", [0, 1])
def test_multipop_ad_matches_jax_ad_all(duo_runs, pop):
    """The port's A/D (alleles painted, roots painted over the root panel,
    per-chromatid effects) against the JAX `_ad_all` on the same final
    state, within the stated tolerance."""
    jsim, tsim, jstates = _ad_case(duo_runs)
    jst = jstates[pop]
    p = tsim.pops[pop]
    p.state = state_from_numpy(_planes(jst) | _host_of(jst) | dict(cv=None),
                               device="cpu")
    A, D = tsim._compute_ad(p)
    jA, jD = jsim._compute_ad(jsim.pops[pop])
    for got, want in ((A, jA), (D, jD)):
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_painted_roots_equal_jax_searchsorted(duo_runs):
    """`paint` over the root panel with an empty mutation plane gives each
    chromatid's root population at each CV: the JAX
    `searchsorted(pop_starts, hap_at(...), 'right') - 1`."""
    jsim, tsim, jstates = _ad_case(duo_runs)
    pos = tsim.cv_bp_all[:, : tsim.ncv_pad].contiguous()
    roots = tsim._root_panel()
    assert roots.shape == (NCHR, 160, tsim.ncv_pad)
    for jst in jstates:
        st = state_from_numpy(_planes(jst) | _host_of(jst) | dict(cv=None),
                              device="cpu")
        empty = st.mut.new_empty(st.mut.shape[:3] + (0,))
        got = paint(st.seg_st, st.seg_hap, empty, roots, pos).numpy()
        for ci in range(NCHR):
            hidx = np.asarray(jseg.hap_at(
                np.asarray(jst.seg_st[ci]), np.asarray(jst.seg_hap[ci]),
                np.asarray(pos[ci].numpy())))
            want = np.searchsorted(np.asarray(jsim.pop_starts), hidx,
                                   side="right") - 1
            np.testing.assert_array_equal(got[ci], want)
        assert set(np.unique(got)) == {0, 1}


def test_multipop_two_pass_ad_chunks(duo_runs, duo, tmp_path, monkeypatch):
    """GE_AD_CHUNK=32 (two passes over row chunks, roots painted a chunk
    at a time): the same A/D as one pass, on both populations' states."""
    run, tsim, _states, _out = duo_runs
    want = [tsim._compute_ad(p) for p in tsim.pops]
    monkeypatch.setenv("GE_AD_CHUNK", "32")
    assert all(p.state.seg_st.shape[1] > 32 for p in tsim.pops)
    for p, (wA, wD) in zip(tsim.pops, want):
        A, D = tsim._compute_ad(p)
        np.testing.assert_array_equal(A, wA)
        np.testing.assert_array_equal(D, wD)


def test_multipop_two_pass_run_matches_jax(duo_runs, duo, tmp_path,
                                          monkeypatch):
    """A whole run under GE_AD_CHUNK=32, fed the JAX plans: the same planes
    and, within tolerance, the same `.info` files as the JAX run."""
    run, _tsim, _states, out = duo_runs
    monkeypatch.setenv("GE_AD_CHUNK", "32")
    tsim = torch_engine.Simulation(
        parse_args(duo_argv(duo, tmp_path / "out", OUT)), device="cpu",
        verbose=False)
    _inject(tsim, run)
    tsim.init_generation0()
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
    tsim.write_summary()
    for q, want in zip(tsim.pops, run.pop_states[-1]):
        np.testing.assert_array_equal(q.state.seg_st.numpy(), want["seg_st"])
    for p in (1, 2):
        name = f"out.info.pop{p}.gen3.txt"
        _assert_table_close(tmp_path / name, out / "jax" / name)


# ------------------------------------------- the port's own samplers (laws)
def test_two_pop_migration_run(duo, tmp_path):
    """`tests/test_multipop.py::test_two_pop_migration_run` on the port's
    own samplers."""
    cfg = parse_args(duo_argv(duo, tmp_path / "out", ["--out_interval"]))
    assert cfg.n_pop == 2
    torch_engine.Simulation(cfg, device="cpu", verbose=False).run()
    for p in (1, 2):
        assert (tmp_path / f"out.pop{p}.summary").exists()
        assert (tmp_path / f"out.info.pop{p}.gen3.txt").exists()
    int1 = (tmp_path / "out.pop1.gen3.chr1.int").read_text().splitlines()[1:]
    assert "2" in {row.split()[-1] for row in int1}, \
        "no pop-2 ancestry found in pop 1 after migration"
    n1 = len((tmp_path / "out.info.pop1.gen3.txt").read_text()
             .splitlines()) - 1
    n2 = len((tmp_path / "out.info.pop2.gen3.txt").read_text()
             .splitlines()) - 1
    assert 55 <= n1 + n2 <= 145, (n1, n2)


def test_gamma_offsets_separate_populations(duo, tmp_path):
    """`tests/test_multipop.py::test_gamma_offsets_separate_populations` on
    the port's own samplers."""
    cfg = parse_args(duo_argv(duo, tmp_path / "out", ["--gamma", "0.5"]))
    torch_engine.Simulation(cfg, device="cpu", verbose=False).run()
    p1 = np.loadtxt(tmp_path / "out.info.pop1.gen3.txt", skiprows=1)
    p2 = np.loadtxt(tmp_path / "out.info.pop2.gen3.txt", skiprows=1)
    m1, m2 = p1[:, 14].mean(), p2[:, 14].mean()  # P of phenotype 1
    assert abs(m1 - m2) > 0.5, (m1, m2)


def test_two_pop_dense_backend_migration(duo, tmp_path):
    """`tests/test_multipop.py::test_two_pop_dense_backend_migration` on
    the port's own samplers: per-population files, sizes and shapes, and
    each population's resident CVs equal its planes'."""
    from geneevolve_tpu_torch.dense import packed as tpk
    from geneevolve_tpu_torch.io import hap as hap_io

    cfg = parse_args(duo_argv(duo, tmp_path / "out",
                              ["--backend", "dense", "--out_hap", "--gamma",
                               "0.4"]))
    sim = tbackend.DenseSimulation(cfg, device="cpu", verbose=False)
    sim.run()
    for p in (1, 2):
        assert (tmp_path / f"out.pop{p}.summary").exists()
        assert (tmp_path / f"out.info.pop{p}.gen3.txt").exists()
        assert (tmp_path / f"out.pop{p}.gen3.chr1.hap").exists()
    n1 = len((tmp_path / "out.info.pop1.gen3.txt").read_text()
             .splitlines()) - 1
    n2 = len((tmp_path / "out.info.pop2.gen3.txt").read_text()
             .splitlines()) - 1
    assert 55 <= n1 + n2 <= 150, (n1, n2)
    a = hap_io.read_hap(tmp_path / "out.pop1.gen3.chr1.hap")
    assert a.shape == (2 * n1, 120)
    for p in sim.pops:
        for j, cols in enumerate(sim.dps[p.index].cv_cols):
            assert torch.equal(p.state.cv[j],
                               tpk.cv_from_planes(p.state.hap, cols))


# ------------------------------------------------------- dense, JAX plans
@pytest.fixture(scope="module")
def dense_duo_runs(duo, tmp_path_factory):
    out = tmp_path_factory.mktemp("dense_duo")
    extra = ["--backend", "dense", "--out_hap", "--out_vcf", "--gamma", "0.4"]
    (out / "jax").mkdir()
    (out / "torch").mkdir()
    run = JaxDenseRun(duo_argv(duo, out / "jax" / "out", extra))
    tsim = tbackend.DenseSimulation(
        parse_args(duo_argv(duo, out / "torch" / "out", extra)),
        device="cpu", verbose=False)
    run.inject(tsim)
    tsim.init_generation0()
    states = [[q.state for q in tsim.pops]]
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
        states.append([q.state for q in tsim.pops])
    tsim.write_summary()
    tsim.save_genotypes(tsim.tot_gen)
    return run, tsim, states, out


def test_dense_duo_planes_bit_exact(dense_duo_runs):
    """Both populations' packed planes and resident CVs equal the JAX
    run's every generation, after migration too."""
    from geneevolve_tpu_torch.core import convert

    run, _tsim, states, _out = dense_duo_runs
    for gen, pops in enumerate(states):
        for pop, st in enumerate(pops):
            got = convert.dense_state_to_numpy(st)
            want = run.pop_states[gen][pop]
            assert got["n"] == want["n"]
            np.testing.assert_array_equal(got["hap"], want["hap"])
            for a, b in zip(got["cv"], want["cv"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(got["ids"], want["ids"])


def test_dense_duo_files_identical(dense_duo_runs):
    """`.hap`, `.indv` and `.vcf` of both populations byte for byte;
    `.info` / `.summary` within the stated tolerance."""
    _run, _tsim, _states, out = dense_duo_runs
    names = sorted(x.name for x in (out / "jax").iterdir()
                   if x.suffix in (".hap", ".indv", ".vcf"))
    assert len(names) == 3 * 2 * NCHR
    for name in names:
        assert filecmp.cmp(out / "torch" / name, out / "jax" / name,
                           shallow=False), name
    for p in (1, 2):
        _assert_table_close(out / "torch" / f"out.info.pop{p}.gen3.txt",
                            out / "jax" / f"out.info.pop{p}.gen3.txt")
        _assert_table_close(out / "torch" / f"out.pop{p}.summary",
                            out / "jax" / f"out.pop{p}.summary")


# ----------------------------------------------------------------- refusals
def test_refuses_more_than_255_populations(duo, tmp_path):
    argv = duo_argv(duo, tmp_path / "out", mutations=False)
    one = argv[: argv.index("--next_population")]
    many = []
    for _ in range(256):
        many += one + ["--next_population"]
    cfg = parse_args(many[:-1] + argv[argv.index("--file_migration"):])
    assert cfg.n_pop == 256
    with pytest.raises(torch_engine.SimulationError, match="at most 255"):
        torch_engine.Simulation(cfg, device="cpu", verbose=False)


def test_refuses_cv_positions_that_differ(duo, tmp_path):
    info = (duo / "p2.cv.info").read_text().splitlines()
    c, q, a, d = info[1].split()
    info[1] = f"{c} {int(q) + 1} {a} {d}"
    moved = tmp_path / "p2.cv.info"
    moved.write_text("\n".join(info) + "\n")
    argv = duo_argv(duo, tmp_path / "out")
    i = len(argv) - 1 - argv[::-1].index(str(duo / "p2.cv.info"))
    argv[i] = str(moved)
    with pytest.raises(torch_engine.SimulationError,
                       match="CV positions must agree across populations"):
        torch_engine.Simulation(parse_args(argv), device="cpu",
                                verbose=False)
