"""The port's segment engine under `--mesh` on gloo CPU ranks (mirrors
`tests/test_engine_sharded.py` and `tests/test_multipop.py:188-250`).

Each 'ind' rank holds a block of the genome planes' rows; outputs must be
byte-identical (tolerance 0) to the port's one-device run: `.summary`,
`.info` and `.int` on `mini_scenario` at 2 and 4 ranks (with
`--checkpoint_every` and `--profile` on the 2-rank run), with a mutation
map on the gather path in two-pass A/D chunks (`GE_NO_RESIDENT_CV=1
GE_AD_CHUNK=16`), with `--device_mating`, and two populations with
migration (`tests/test_torch_multipop.py`'s duo); checkpoints resume
across layouts; the CLI's `--mesh ind=2` and `--mesh auto` match the
CLI without `--mesh`. Fed the JAX mesh run's mating and reproduce plans
(JAX `Simulation(mesh=8 devices)`), the 2-rank run's `.int` files equal
JAX's byte for byte and `.info`/`.summary` agree within
`test_torch_engine.py`'s tolerance. Under `--gamma` the mesh takes f32
device moments, as JAX does: within the JAX test's rtol 1e-5 and atol
1e-3 (sum) and 1e-2 (sum of squares) of the host's float64.

The 2-rank runs share one group of ranks (`tests/torch_dist.py`
`engine_runs`). Every launch of ranks runs under a deadline (the fixture's
runs share one budget), so a hang fails these tests and not the run.
"""

import filecmp
import functools
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist
from geneevolve_tpu.config import parse_args as jax_parse_args
from geneevolve_tpu.core import engine as jax_engine
from geneevolve_tpu.core import mating as jax_mating
from geneevolve_tpu_torch import cli
from geneevolve_tpu_torch.config import (
    ConfigError,
    mesh_shape,
    parse_args,
    parse_mesh_spec,
)
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core import mating, phenotype
from geneevolve_tpu_torch.parallel import launch
from geneevolve_tpu_torch.parallel.mesh import Mesh as TorchMesh
from test_torch_engine import _assert_table_close, _mutation_map
from test_torch_multipop import duo_argv, make_duo

torch.set_num_threads(1)
BUDGET_S = 300  # every run of the `runs` fixture, one-device runs included
CLI_DEADLINE_S = 120  # each launch of `cli.main`
MINI_FILES = ["out.pop1.summary", "out.info.pop1.gen0.txt",
              "out.info.pop1.gen4.txt", "out.pop1.gen4.chr1.int",
              "out.pop1.gen4.chr2.int"]
DUO_FILES = ["out.pop1.summary", "out.pop2.summary",
             "out.info.pop1.gen3.txt", "out.info.pop2.gen3.txt",
             "out.pop1.gen3.chr1.int", "out.pop2.gen3.chr1.int",
             "out.pop1.gen3.chr2.int", "out.pop2.gen3.chr2.int"]


def _argv(root: Path, prefix: Path, *extra):
    return [
        "--file_gen_info", str(root / "popinfo.txt"),
        "--file_hap_name", str(root / "hap_address.txt"),
        "--file_recom_map", str(root / "rmap.txt"),
        "--file_cv_info", str(root / "cv.info"),
        "--file_cvs", str(root / "cv_address.txt"),
        "--seed", "777",
        "--prefix", str(prefix),
        *extra,
    ]


def _single(argv, env=None):
    """The port's one-device run (CPU), with `env` set around it."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        torch_engine.Simulation(parse_args(argv), device="cpu",
                                verbose=False).run()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _same(a: Path, b: Path, names):
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), (a, b, name)


def _jax_mesh_run(argv):
    """The JAX engine on 8 virtual devices (`Simulation(mesh=...)`), with
    every mating plan (as the port's `MatingPlan`) and every reproduce
    plan kept in call order."""
    mates, plans = [], []
    probe, assort = jax_engine._capacity_probe, jax_mating.assort_mate

    def probe_rec(*a, **k):
        out = probe(*a, **k)
        plans.append(tuple(np.asarray(x) for x in out[2]))
        return out

    def assort_rec(*a, **k):
        plan = assort(*a, **k)
        mates.append(mating.MatingPlan(
            father_pos=plan.father_pos, mother_pos=plan.mother_pos,
            inbred=plan.inbred, child_couple=plan.child_couple))
        return plan

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "_capacity_probe", probe_rec)
        mp.setattr(jax_mating, "assort_mate", assort_rec)
        mesh = Mesh(np.array(jax.devices()[:8]), ("ind",))
        jax_engine.Simulation(jax_parse_args(argv), verbose=False,
                              mesh=mesh).run()
    return {"mates": mates, "plans": plans}


@pytest.fixture(scope="module")
def runs(mini_scenario, tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return torch_dist.once(tmp_path_factory, "engine_sharded_runs",
                           lambda: _runs(mini_scenario, tmp_path_factory))


def _runs(mini_scenario, tmp_path_factory):
    """Every run: one-device runs in this process, mesh runs on ranks,
    all within BUDGET_S."""
    deadline = time.monotonic() + BUDGET_S
    out = tmp_path_factory.mktemp("sharded")
    duo = make_duo(tmp_path_factory.mktemp("duo"))
    mmap = _mutation_map(out / "mut.txt")
    gather_env = {"GE_NO_RESIDENT_CV": "1", "GE_AD_CHUNK": "16"}
    base = ["--out_interval", "--checkpoint_every", "3"]
    variants = {  # name -> (argv of a prefix, env)
        "mini": (lambda d: _argv(mini_scenario, d / "out", *base), {}),
        "gather": (lambda d: _argv(mini_scenario, d / "out", "--out_interval",
                                   "--file_mutation_map", str(mmap)),
                   gather_env),
        "dm": (lambda d: _argv(mini_scenario, d / "out", "--out_interval",
                               "--device_mating", "--avoid_inbreeding"), {}),
        "duo": (lambda d: duo_argv(duo, d / "out", ["--out_interval"]), {}),
    }
    dirs = {}
    for name, (argv, env) in variants.items():
        for layout in ("single", "mesh2"):
            dirs[name, layout] = out / f"{name}_{layout}"
            dirs[name, layout].mkdir()
        _single(argv(dirs[name, "single"]), env)
    # the JAX mesh run, and the checkpoints to resume across layouts
    dirs["jax"] = out / "jax"
    dirs["jax"].mkdir()
    inject = _jax_mesh_run(_argv(mini_scenario, dirs["jax"] / "out",
                                 "--out_interval"))
    for name in ("fed", "resumed_m", "resumed_s", "mini_mesh4",
                 "nodes"):
        dirs[name] = out / name
        dirs[name].mkdir()
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=n) * 3 + i for i, n in enumerate((57, 64))]
    runs2 = [dict(argv=argv(dirs[name, "mesh2"]) + (
                 ["--profile", str(out / "trace")] if name == "mini" else []),
                  env=env)
             for name, (argv, env) in variants.items()]
    runs2.append(dict(argv=_argv(mini_scenario, dirs["fed"] / "out",
                                 "--out_interval"), inject=inject))
    runs2.append(dict(moments=xs, moments_argv=duo_argv(duo, out / "m")))
    res = {"mesh2": torch_dist.launch_by(deadline, torch_dist.engine_runs, 2,
                                         ((2, 1), runs2))}
    # resume the one-device checkpoint on 2 ranks, the 2-rank one on one
    ck = "out.ckpt.npz"
    resumed = [dict(argv=_argv(mini_scenario, dirs["resumed_m"] / "out",
                               "--out_interval", "--resume",
                               str(dirs["mini", "single"] / ck)))]
    res["resume"] = torch_dist.launch_by(deadline, torch_dist.engine_runs, 2,
                                         ((2, 1), resumed))
    _single(_argv(mini_scenario, dirs["resumed_s"] / "out", "--out_interval",
                  "--resume", str(dirs["mini", "mesh2"] / ck)))
    res["mesh4"] = torch_dist.launch_by(
        deadline, torch_dist.engine_runs, 4,
        ((4, 1), [dict(argv=_argv(mini_scenario, dirs["mini_mesh4"] / "out",
                                  *base))]))
    # two ranks posing as two nodes of one rank each
    res["nodes"] = torch_dist.launch_by(
        deadline, torch_dist.engine_runs, 2,
        ((2, 1), [dict(argv=_argv(mini_scenario, dirs["nodes"] / "out",
                                  "--out_interval"),
                       envs=[{"GROUP_RANK": str(r), "LOCAL_WORLD_SIZE": "1"}
                             for r in range(2)])]))
    return dict(dirs=dirs, res=res, xs=xs, trace=out / "trace")


@pytest.mark.parametrize("name", ["mini", "gather", "dm", "duo"])
def test_two_ranks_byte_identical(runs, name):
    d = runs["dirs"]
    files = DUO_FILES if name == "duo" else MINI_FILES
    if name != "mini":  # every generation's .info
        files = files + sorted(
            f.name for f in d[name, "single"].iterdir()
            if f.name.startswith("out.info"))
    _same(d[name, "single"], d[name, "mesh2"], files)


def test_four_ranks_byte_identical(runs):
    d = runs["dirs"]
    _same(d["mini", "single"], d["mini_mesh4"], MINI_FILES)
    # the planes really were split: 4 blocks of a quarter of the rows
    assert runs["res"]["mesh4"][0][0]["rows"] * 4 >= 60


def test_ranks_exchange_parent_rows(runs):
    t = runs["res"]["mesh2"][0][0]["traffic"]
    assert t["calls"] > 0 and t["bytes"] > 0
    log = runs["res"]["mesh2"][0][0]["log"]
    assert len(log) == 4 and all(c["seg_need"] == c["seg_used"] for c in log)


def test_checkpoints_do_not_depend_on_layout(runs):
    d = runs["dirs"]
    z1 = np.load(d["mini", "single"] / "out.ckpt.npz")
    z2 = np.load(d["mini", "mesh2"] / "out.ckpt.npz")
    assert sorted(z1.files) == sorted(z2.files)
    for k in z1.files:
        np.testing.assert_array_equal(z1[k], z2[k], err_msg=k)


@pytest.mark.parametrize("name", ["resumed_m", "resumed_s"])
def test_resume_across_layouts(runs, name):
    d = runs["dirs"]
    _same(d["mini", "single"], d[name],
          ["out.pop1.summary", "out.info.pop1.gen4.txt",
           "out.pop1.gen4.chr1.int", "out.pop1.gen4.chr2.int"])


def test_profile_writes_a_trace_a_rank(runs):
    for r in range(2):
        d = runs["trace"] / f"rank{r}"
        assert d.is_dir() and any(d.iterdir()), d


def test_fed_jax_plans_matches_jax_mesh_run(runs):
    d = runs["dirs"]
    for c in (1, 2):
        name = f"out.pop1.gen4.chr{c}.int"
        assert filecmp.cmp(d["fed"] / name, d["jax"] / name, shallow=False)
    for gen in range(5):
        name = f"out.info.pop1.gen{gen}.txt"
        _assert_table_close(d["fed"] / name, d["jax"] / name)
    _assert_table_close(d["fed"] / "out.pop1.summary",
                        d["jax"] / "out.pop1.summary")


def test_gamma_device_moments_match_host(runs):
    got = runs["res"]["mesh2"][0][-1]
    for x, dev in zip(runs["xs"], got):
        host = phenotype.pop_moments(x)
        assert dev[0] == host[0]
        np.testing.assert_allclose(dev[1], host[1], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(dev[2], host[2], rtol=1e-5, atol=1e-2)
    for r in runs["res"]["mesh2"]:  # every rank holds the same moments
        assert r[-1] == got


def test_nodes_write_their_rows(runs):
    """Two nodes of one rank each: each writes `.hostK.int` files of its
    rows, whose lines, node after node, are the one-device file's; rank 0
    alone writes `.info` and `.summary`."""
    d = runs["dirs"]
    for c in (1, 2):
        want = (d["mini", "single"] / f"out.pop1.gen4.chr{c}.int") \
            .read_text().splitlines()
        got = []
        for k in range(2):
            lines = (d["nodes"] / f"out.pop1.gen4.chr{c}.host{k}.int") \
                .read_text().splitlines()
            assert lines[0] == want[0]
            got += lines[1:]
        assert got == want[1:]
    assert not list(d["nodes"].glob("*.host*.info*"))
    _same(d["mini", "single"], d["nodes"], ["out.pop1.summary",
                                            "out.info.pop1.gen4.txt"])


@pytest.fixture
def cli_deadline(monkeypatch):
    """`cli.main`'s launches of ranks under CLI_DEADLINE_S, each
    collective within the tests' group timeout."""
    monkeypatch.setattr(launch, "launch", functools.partial(
        launch.launch, timeout_s=CLI_DEADLINE_S,
        pg_timeout_s=torch_dist.PG_TIMEOUT_S))


def test_cli_mesh_byte_identical(mini_scenario, tmp_path, capfd,
                                 cli_deadline):
    """`main(argv, device="cpu")` with `--mesh ind=2` and `--mesh auto`
    (on the CPU one rank, as JAX has one CPU device) against no `--mesh`;
    the parent prints the mesh."""
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "ind=2"]),
                        ("auto", ["--mesh", "auto"])):
        d = tmp_path / name
        d.mkdir()
        assert cli.main(_argv(mini_scenario, d / "out", "--out_interval",
                              *extra), device="cpu") == 0
        outs[name] = d
    text = capfd.readouterr().out
    assert "Device mesh: {'ind': 2, 'loci': 1} on 2 x cpu ranks" in text
    assert "Device mesh: {'ind': 1, 'loci': 1} on 1 x cpu ranks" in text
    for variant in ("mesh", "auto"):
        _same(outs["single"], outs[variant], MINI_FILES)


def test_cli_refuses_mesh_beyond_devices(mini_scenario, tmp_path, capfd,
                                         cli_deadline):
    n = len(os.sched_getaffinity(0)) + 1
    rc = cli.main(_argv(mini_scenario, tmp_path / "out", "--mesh",
                        f"ind={n}"), device="cpu")
    assert rc == 1
    assert f"needs {n} devices" in capfd.readouterr().err
    assert not list(tmp_path.iterdir())


def test_mesh_spec_parsing_and_refusals():
    assert parse_mesh_spec("auto") is None
    assert parse_mesh_spec("ind=4") == (4, 1)
    assert parse_mesh_spec("ind=4,loci=2") == (4, 2)
    for bad in ("", "ind", "ind=0", "foo=2", "ind=x", "loci=2"):
        with pytest.raises(ConfigError):
            parse_mesh_spec(bad)
    assert mesh_shape("auto", 8) == (8, 1)
    assert mesh_shape("ind=2,loci=2", 4) == (2, 2)
    with pytest.raises(ConfigError, match=r"needs 16 devices; only 8"):
        mesh_shape("ind=8,loci=2", 8)


def test_mesh_without_ind_axis_refused(mini_scenario, tmp_path):
    mesh = TorchMesh(("x",), (2,), (0,), {}, torch.device("cpu"))
    cfg = parse_args(_argv(mini_scenario, tmp_path / "out"))
    with pytest.raises(torch_engine.SimulationError, match="ind"):
        torch_engine.Simulation(cfg, device="cpu", verbose=False, mesh=mesh)


def test_segment_backend_accepts_mesh_flag(mini_scenario, tmp_path):
    """Nothing refuses `--mesh`: the segment engine and the dense backend
    both build on a mesh (here a one-rank (1, 1) grid, no group needed to
    build), and hold it."""
    from geneevolve_tpu_torch.dense.backend import DenseSimulation

    mesh = TorchMesh(("ind", "loci"), (1, 1), (0, 0), {},
                     torch.device("cpu"))
    for backend, cls in (("segment", torch_engine.Simulation),
                         ("dense", DenseSimulation)):
        cfg = parse_args(_argv(mini_scenario, tmp_path / "out", "--mesh",
                               "ind=1", "--backend", backend))
        sim = cls(cfg, device="cpu", verbose=False, mesh=mesh)
        assert sim.mesh is mesh and sim._ind == 1
