"""Checkpoint/resume in the PyTorch port, on the CPU.

A resumed run's files equal the straight run's byte for byte, on the
resident and the gather A/D path, with several populations and on the
dense backend (the mirrors of `tests/test_engine.py`'s and
`tests/test_multipop.py`'s checkpoint tests). Checkpoints cross between the
packages: a JAX-written checkpoint resumes in the port, which, fed the JAX
resumed run's plans, reaches the JAX run's planes exactly and its files
within `test_torch_engine`'s tolerance (f32 summation order); the JAX
`checkpoint.load` accepts a port-written one, whose keys and dtypes equal
those the JAX package writes for the same scenario.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from geneevolve_tpu.config import parse_args as jax_parse_args
from geneevolve_tpu.core import checkpoint as jax_checkpoint
from geneevolve_tpu.core import engine as jax_engine
from geneevolve_tpu.core import mating
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import checkpoint
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.dense import backend as tbackend
from test_torch_engine import (
    PLANES,
    _argv,
    _assert_table_close,
    _mutation_map,
    _planes,
)
from test_torch_multipop import duo_argv, make_duo

torch.set_num_threads(1)
PATHS = ["resident", "gather"]


@pytest.fixture
def path_env(request, monkeypatch):
    if request.param == "gather":
        monkeypatch.setenv("GE_NO_RESIDENT_CV", "1")
    return request.param


def _same_files(a: Path, b: Path, names):
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


def _resume_case(make_sim, argv, straight: Path, ck: Path, stop: int,
                 names):
    """Run straight; run to `stop`, save, resume in a fresh simulation;
    the resumed run's files equal the straight run's."""
    make_sim(argv(straight)).run()
    sim = make_sim(argv(ck))
    sim.init_generation0()
    for gen in range(1, stop + 1):
        sim.step(gen)
    checkpoint.save(sim, stop, str(ck / "out.ckpt.npz"))
    sim._drain_io()
    resumed = make_sim(argv(ck) + ["--resume", str(ck / "out.ckpt.npz")])
    resumed.run()
    _same_files(straight, ck, names)
    return resumed


@pytest.mark.parametrize("path_env", PATHS, indirect=True)
def test_checkpoint_resume_bit_identical(mini_scenario, tmp_path, path_env):
    """`tests/test_engine.py::test_checkpoint_resume_bit_identical` in the
    port, with a mutation map, on both A/D paths."""
    mmap = _mutation_map(tmp_path / "mut.txt")
    (tmp_path / "straight").mkdir()
    (tmp_path / "ck").mkdir()

    def make(a):
        return torch_engine.Simulation(parse_args(a), device="cpu",
                                       verbose=False)

    sim = _resume_case(
        make, lambda d: _argv(mini_scenario, d / "out", mmap),
        tmp_path / "straight", tmp_path / "ck", 2,
        ["out.pop1.summary", "out.info.pop1.gen3.txt",
         "out.info.pop1.gen4.txt"])
    assert (sim.pops[0].state.cv is None) == (path_env == "gather")


def test_dense_checkpoint_resume_bit_identical(mini_scenario, tmp_path):
    """One population on the dense backend: the checkpoint keeps the
    planes' padding rows, so the resumed plans are drawn at the same row
    count and the files equal the straight run's."""
    (tmp_path / "straight").mkdir()
    (tmp_path / "ck").mkdir()

    def make(a):
        return tbackend.DenseSimulation(parse_args(a), device="cpu",
                                        verbose=False)

    sim = _resume_case(
        make, lambda d: _argv(mini_scenario, d / "out")
        + ["--backend", "dense", "--out_hap"],
        tmp_path / "straight", tmp_path / "ck", 2,
        ["out.pop1.summary", "out.info.pop1.gen3.txt",
         "out.info.pop1.gen4.txt", "out.pop1.gen4.chr1.hap"])
    st = sim.pops[0].state
    assert st.hap.shape[0] > st.n  # padding rows were resumed


@pytest.mark.parametrize("path_env", PATHS, indirect=True)
def test_checkpoint_rejects_wrong_seed(mini_scenario, tmp_path, path_env):
    d = tmp_path
    sim = torch_engine.Simulation(parse_args(_argv(mini_scenario, d / "out")),
                                  device="cpu", verbose=False)
    sim.run()
    checkpoint.save(sim, 4, str(d / "out.ckpt.npz"))
    argv = _argv(mini_scenario, d / "out2")
    argv[argv.index("777")] = "778"
    sim2 = torch_engine.Simulation(parse_args(argv), device="cpu",
                                   verbose=False)
    with pytest.raises(RuntimeError, match="seed"):
        checkpoint.load(sim2, str(d / "out.ckpt.npz"))


@pytest.fixture(scope="module")
def duo(tmp_path_factory):
    return make_duo(tmp_path_factory.mktemp("duo_ck"))


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_two_pop_checkpoint_resume(duo, tmp_path, backend):
    """Two populations with migration and gamma, resumed after generation
    2 (`tests/test_multipop.py::test_dense_backend_checkpoint_resume`, and
    its segment twin)."""
    (tmp_path / "straight").mkdir()
    (tmp_path / "ck").mkdir()
    extra = ["--backend", backend, "--gamma", "0.5"]
    cls = (tbackend.DenseSimulation if backend == "dense"
           else torch_engine.Simulation)

    def make(a):
        return cls(parse_args(a), device="cpu", verbose=False)

    _resume_case(
        make, lambda d: duo_argv(duo, d / "out", extra),
        tmp_path / "straight", tmp_path / "ck", 2,
        [f"out.{f}" for p in (1, 2)
         for f in (f"pop{p}.summary", f"info.pop{p}.gen3.txt")])


def test_checkpoint_every_writes_after_gen0_and_every_n(
        mini_scenario, tmp_path, monkeypatch):
    saved = []
    save = checkpoint.save

    def save_rec(sim, gen, path):
        saved.append((gen, path))
        save(sim, gen, path)

    monkeypatch.setattr(checkpoint, "save", save_rec)
    argv = _argv(mini_scenario, tmp_path / "out") + ["--checkpoint_every", "2"]
    torch_engine.Simulation(parse_args(argv), device="cpu",
                            verbose=False).run()
    path = str(tmp_path / "out") + ".ckpt.npz"
    assert saved == [(0, path), (2, path), (4, path)]
    z = np.load(path)
    assert int(z["gen"]) == 4 and int(z["format_version"]) == 2


# ------------------------------------------------------ across the packages
def _jax_sim(argv):
    return jax_engine.Simulation(jax_parse_args(argv), verbose=False)


def test_jax_checkpoint_resumes_in_port(mini_scenario, tmp_path):
    """A JAX-written checkpoint (after generation 2), resumed by the port
    fed the plans of the JAX package's own resumed run: the same planes
    at the end, and the JAX straight run's files."""
    mmap = _mutation_map(tmp_path / "mut.txt")
    for d in ("straight", "ck", "port"):
        (tmp_path / d).mkdir()
    argv = lambda d: _argv(mini_scenario, tmp_path / d / "out", mmap)
    _jax_sim(argv("straight")).run()
    jsim = _jax_sim(argv("ck"))
    jsim.init_generation0()
    for gen in (1, 2):
        jsim.step(gen)
    ck = str(tmp_path / "ck" / "out.ckpt.npz")
    jax_checkpoint.save(jsim, 2, ck)

    mates, plans = [], []
    probe, assort = jax_engine._capacity_probe, mating.assort_mate

    def probe_rec(*a, **k):
        out = probe(*a, **k)
        plans.append(tuple(np.asarray(x) for x in out[2]))
        return out

    def assort_rec(*a, **k):
        mates.append(assort(*a, **k))
        return mates[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "_capacity_probe", probe_rec)
        mp.setattr(mating, "assort_mate", assort_rec)
        jres = _jax_sim(argv("ck") + ["--resume", ck])
        jres.run()
    assert len(plans) == len(mates) == 2  # generations 3 and 4

    tsim = torch_engine.Simulation(
        parse_args(argv("port") + ["--resume", ck]), device="cpu",
        verbose=False)
    tsim._mate = lambda p, gen, pop_size, g: mates[gen - 3]

    def plan(p, gen, n_pad):
        assert plans[gen - 3][0].shape[1] == n_pad
        return tuple(torch.from_numpy(np.array(x)) for x in plans[gen - 3])

    tsim._plan = plan
    tsim.run()
    got, want = _planes(tsim.pops[0].state), _planes(jres.pops[0].state)
    for k in PLANES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in ("out.info.pop1.gen3.txt", "out.info.pop1.gen4.txt",
                 "out.pop1.summary"):
        _assert_table_close(tmp_path / "port" / name,
                            tmp_path / "straight" / name)


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_port_checkpoint_loads_in_jax(mini_scenario, tmp_path, backend):
    """The JAX package's `checkpoint.load` accepts the port's checkpoint,
    and the keys and dtypes equal a JAX-written one's; the JAX run then
    steps on from it."""
    from geneevolve_tpu.dense.backend import DenseSimulation as JaxDense

    extra = ["--backend", backend]
    argv = _argv(mini_scenario, tmp_path / "out") + extra
    cls = (tbackend.DenseSimulation if backend == "dense"
           else torch_engine.Simulation)
    tsim = cls(parse_args(argv), device="cpu", verbose=False)
    tsim.init_generation0()
    for gen in (1, 2):
        tsim.step(gen)
    checkpoint.save(tsim, 2, str(tmp_path / "port.npz"))
    jcls = JaxDense if backend == "dense" else jax_engine.Simulation
    jsim = jcls(jax_parse_args(argv), verbose=False)
    jsim.init_generation0()
    for gen in (1, 2):
        jsim.step(gen)
    jax_checkpoint.save(jsim, 2, str(tmp_path / "jax.npz"))
    zp, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(zp.files) == sorted(zj.files)
    for k in zj.files:
        assert zp[k].dtype == zj[k].dtype, k
    fresh = jcls(jax_parse_args(argv), verbose=False)
    assert jax_checkpoint.load(fresh, str(tmp_path / "port.npz")) == 2
    assert fresh.pops[0].state.n == tsim.pops[0].state.n
    fresh.step(3)
    p = np.asarray(fresh.pops[0].state.comp["P"])
    assert p.shape[1] == fresh.pops[0].state.n and np.isfinite(p).all()


def test_resident_resume_rebuilds_cv_from_the_ledger(mini_scenario, tmp_path,
                                                     monkeypatch):
    """A checkpoint without CV matrices (a gather-path run's) resumed on the
    resident path: the matrix is painted from the ledger, equals the one a
    straight resident run holds, and the files equal that run's."""
    mmap = _mutation_map(tmp_path / "mut.txt")
    for d in ("straight", "ck"):
        (tmp_path / d).mkdir()
    argv = lambda d: _argv(mini_scenario, tmp_path / d / "out", mmap)

    def make(a):
        return torch_engine.Simulation(parse_args(a), device="cpu",
                                       verbose=False)

    straight = make(argv("straight"))
    straight.init_generation0()
    for gen in (1, 2):
        straight.step(gen)
    want_cv = straight.pops[0].state.cv.clone()
    for gen in (3, 4):
        straight.step(gen)
    straight._check_capacity_guard()
    straight.write_summary()
    monkeypatch.setenv("GE_NO_RESIDENT_CV", "1")
    sim = make(argv("ck"))
    sim.init_generation0()
    for gen in (1, 2):
        sim.step(gen)
    ck = str(tmp_path / "ck" / "out.ckpt.npz")
    checkpoint.save(sim, 2, ck)
    sim._drain_io()
    assert "pop0.cv" not in np.load(ck).files
    monkeypatch.delenv("GE_NO_RESIDENT_CV")
    resumed = make(argv("ck") + ["--resume", ck])
    assert resumed.resident_cv
    assert checkpoint.load(resumed, ck) == 2
    assert torch.equal(resumed.pops[0].state.cv, want_cv)
    make(argv("ck") + ["--resume", ck]).run()
    _same_files(tmp_path / "straight", tmp_path / "ck",
                ["out.pop1.summary", "out.info.pop1.gen3.txt",
                 "out.info.pop1.gen4.txt"])
