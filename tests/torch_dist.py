"""Rank functions of the port's mesh tests: each runs in a spawned rank
(`geneevolve_tpu_torch.parallel.launch`), so this module imports neither
JAX nor the JAX package. The tests build their inputs, and the JAX
package's draws and results, in the test process and pass them in."""

import fcntl
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from geneevolve_tpu_torch.core import convert
from geneevolve_tpu_torch.dense import packed as pk
from geneevolve_tpu_torch.dense import step as ds
from geneevolve_tpu_torch.parallel import comm, launch, multihost
from geneevolve_tpu_torch.parallel import mesh as pm

PG_TIMEOUT_S = 60  # a collective's timeout in the tests' process groups


def once(tmp_path_factory, name: str, fn):
    """`fn()`, computed once a test session however many xdist workers
    run the tests that need it: the first worker computes it under an
    exclusive lock in the session's shared temporary root and pickles it,
    and the others load it (a module fixture would otherwise start its
    ranks again in every worker that gets one of the module's tests). A
    failure is pickled too, as its traceback, so the other workers raise
    it at once instead of running `fn` again."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                ok, out = pickle.load(f)
            if not ok:
                raise RuntimeError(f"{name} failed in another worker:\n{out}")
            return out
        try:
            out = fn()
        except Exception:
            with open(path, "wb") as f:
                pickle.dump((False, traceback.format_exc()), f)
            raise
        with open(path, "wb") as f:
            pickle.dump((True, out), f)
        return out


def launch_by(deadline: float, fn, nprocs: int, args=()):
    """`launch.launch` of CPU ranks that must finish by `deadline` (on
    `time.monotonic()`'s clock), each collective within `PG_TIMEOUT_S`:
    a hang fails the test that needs the ranks, not the whole run."""
    left = deadline - time.monotonic()
    if left <= 0:
        raise launch.RankError("no time left before the test's deadline")
    return launch.launch(fn, nprocs, args, device="cpu", timeout_s=left,
                         pg_timeout_s=PG_TIMEOUT_S)


def _words(a) -> torch.Tensor:
    """uint32 words (the JAX package's) as the port's int32 words."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _out(state: dict, mesh) -> dict:
    """The full packed state as numpy (words as uint32), from every
    rank's shard."""
    return convert.packed_state_to_numpy(pm.unshard_state(state, mesh))


def sharded_vs_one_rank(mesh, cfg, seed: int = 4) -> dict:
    """`make_sharded_step` on this rank's shard against the one-rank step
    on the whole state, from identically seeded generators: equal?"""
    packed = isinstance(cfg, pk.PackedConfig)
    init, make = ((pk.init_state, pk.make_step) if packed
                  else (ds.init_state, ds.make_step))
    st = init(torch.Generator().manual_seed(0), cfg)
    one = make(cfg)(st, torch.Generator().manual_seed(seed))
    got = pm.make_sharded_step(cfg, mesh)(pm.shard_state(st, mesh),
                                          torch.Generator().manual_seed(seed))
    full = pm.unshard_state(got, mesh)
    return {k: bool(torch.equal(full[k], one[k])) for k in one}


def _het(hap: np.ndarray, m: int, demes: int) -> float:
    """Within-deme expected heterozygosity H_S averaged over demes (rows
    in deme order), as `tests/test_statistics.py` computes it."""
    a, b = (pk.unpack_bits(_words(hap[:, g]), m).double().numpy()
            for g in (0, 1))
    n = hap.shape[0]
    h = np.concatenate([a, b])
    nd = n // demes
    hs = []
    for d in range(demes):
        rows = np.r_[d * nd:(d + 1) * nd, n + d * nd:n + (d + 1) * nd]
        p = h[rows].mean(axis=0)
        hs.append(np.mean(2 * p * (1 - p)))
    return float(np.mean(hs))


def deme_migration_law(mesh, gens: int = 40, reps: int = 2) -> dict:
    """H_S after `gens` deme-mode generations over H_S at the start, mean
    of `reps` runs, with ring migration 0.125 and without (the law of
    `tests/test_statistics.py::test_deme_migration_matches_panmictic_
    heterozygosity`, on the port's own generators)."""
    cfg = pk.PackedConfig(n=256, m=4096, n_chr=4, morgans_per_chr=1.0,
                          xo_cap=8)
    demes = mesh.size("ind")

    def run(mig_rate, rep):
        st = pm.shard_state(
            pk.init_state(torch.Generator().manual_seed(20 + rep), cfg), mesh)
        step = pm.make_deme_step(cfg, mesh, mig_rate=mig_rate)
        h0 = _het(_out(st, mesh)["hap"], cfg.m, demes)
        for g in range(gens):
            st = step(st, torch.Generator().manual_seed(1000 * (50 + rep) + g))
        return _het(_out(st, mesh)["hap"], cfg.m, demes) / h0

    return {"mig": float(np.mean([run(0.125, r) for r in range(reps)])),
            "iso": float(np.mean([run(0.0, r) for r in range(reps)])),
            "n": cfg.n, "demes": demes, "gens": gens}


def deme_isolation(mesh) -> dict:
    """Deme mode with selection, no mutations: word 0 of every chromatid
    of deme d starts all (d & 1); after 3 generations each child still
    carries its deme's word."""
    ind = mesh.size("ind")
    cfg = pk.PackedConfig(n=8 * ind, m=4096, n_chr=4, selection=True,
                          mut_rate=0.0)
    st = pk.init_state(torch.Generator().manual_seed(0), cfg)
    marker = np.repeat(-(np.arange(ind) & 1).astype(np.int32), cfg.n // ind)
    st["hap"][:, :, 0] = torch.from_numpy(marker)[:, None]
    st = pm.shard_state(st, mesh)
    step = pm.make_deme_step(cfg, mesh)
    for g in range(3):
        st = step(st, torch.Generator().manual_seed(g))
    got = pm.unshard_state(st, mesh)["hap"][:, 0, 0].numpy()
    return {"got": got, "want": marker}


def routed_law(mesh) -> dict:
    """Three routed generations with selection and mutations: allele
    frequencies stay interior, CVs in range, nothing clipped."""
    cfg = pk.PackedConfig(n=256, m=8192 * 2, n_chr=4, morgans_per_chr=1.0,
                          xo_cap=8, mut_rate=0.5, mut_cap=4, ncv=64,
                          selection=True)
    st = pm.shard_state(pk.init_state(torch.Generator().manual_seed(0), cfg),
                        mesh)
    step = pm.make_routed_step(cfg, mesh)
    for g in range(3):
        st = step(st, torch.Generator().manual_seed(100 + g))
    full = pm.unshard_state(st, mesh)
    h = pk.unpack_bits(full["hap"][:, 0], cfg.m).double().mean().item()
    cv = full["cv"]
    return {"mean": h, "clip": int(full["clip"]),
            "cv_min": int(cv.min()), "cv_max": int(cv.max()),
            "cv_planes": bool(torch.equal(
                cv, pk.cv_from_planes(full["hap"], full["cv_idx"])))}


def mesh_checks(rank: int, cases: dict) -> dict:
    """The 8-rank checks: on a (4, 2) mesh `routed_fetch`, the deme and
    routed steps fed the JAX steps' draws, `make_sharded_step` (against
    the one-rank step, and fed the JAX step's draws), deme isolation and
    the routed law; on an (8, 1) mesh the deme-migration law."""
    mesh = pm.make_mesh((4, 2), "cpu")
    i, j = mesh.coords
    out = {"coords": (i, j)}
    g_ind = mesh.group("ind")
    out["fetch"] = []
    for tab, idx, cap in cases["fetch"]:
        nloc = tab.shape[0] // 4
        loc = torch.from_numpy(tab[i * nloc:(i + 1) * nloc])
        got, ov = pm.routed_fetch(loc, torch.from_numpy(idx), nloc, 4, cap,
                                  g_ind)
        out["fetch"].append((got.numpy(), int(ov)))
    for name, c in cases["steps"].items():
        cfg = pk.PackedConfig(**c["cfg"])
        if c["kind"] == "deme":
            step = pm.make_deme_step(cfg, mesh, mig_rate=c["mig_rate"],
                                     mig_matrix=c["mig_matrix"])
        else:
            step = pm.make_routed_step(cfg, mesh)
        st = convert.packed_shard_from_numpy(c["state"], mesh)
        st = step(st, None, draws=c["draws"][(i, j)])
        res = _out(st, mesh)
        if rank == 0:
            out[name] = res
    for name, kw in cases["sharded"].items():
        cfg = (pk.PackedConfig(**kw) if name.startswith("packed")
               else ds.DenseConfig(**kw))
        out[name] = sharded_vs_one_rank(mesh, cfg)
    out["sharded_fed"] = {name: sharded_fed(mesh, c)
                          for name, c in cases["sharded_fed"].items()}
    out["isolation"] = deme_isolation(mesh)
    out["routed_law"] = routed_law(mesh)
    out["traffic"] = mesh.traffic.summary()
    demes = pm.make_mesh((8, 1), "cpu")
    out["migration_law"] = deme_migration_law(demes)
    return out


def pair_checks(rank: int, cases: dict) -> dict:
    """The 2-rank checks: `make_sharded_step` at (2, 1) and (1, 2) (the
    latter also one chromosome split over both loci ranks, and three
    chromosomes cut into unequal pieces), and the refusals of word and
    locus counts that do not split over 'loci'."""
    out = {}
    for shape in ((2, 1), (1, 2)):
        mesh = pm.make_mesh(shape, "cpu")
        for name, kw in cases.items():
            cfg = (pk.PackedConfig(**kw) if name.startswith("packed")
                   else ds.DenseConfig(**kw))
            out[(shape, name)] = sharded_vs_one_rank(mesh, cfg)
    mesh = pm.make_mesh((1, 2), "cpu")
    for name, cfg in (("packed", pk.PackedConfig(n=8, m=3 * 32, n_chr=3)),
                      ("dense", ds.DenseConfig(n=8, m=3 * 33, n_chr=3))):
        try:
            pm.make_sharded_step(cfg, mesh)
            out[("refused", name)] = None
        except ValueError as e:
            out[("refused", name)] = str(e)
    return out


def sharded_fed(mesh, case: dict) -> dict:
    """`make_sharded_step` (packed) on this rank's shard of `case["state"]`
    fed `case["draws"]`, the whole generation's: the full state after
    it."""
    cfg = pk.PackedConfig(**case["cfg"])
    st = convert.packed_shard_from_numpy(case["state"], mesh)
    return _out(pm.make_sharded_step(cfg, mesh)(st, None,
                                                draws=case["draws"]), mesh)


# ----------------------------------------------------------------- engine
def _simulate(mesh, argv, inject=None, s_cap=None) -> dict:
    """The segment `Simulation` on `mesh`; with `inject`, fed mating plans
    (`mates`, per (generation, population) in call order) and reproduce
    plans (`plans`, rows edge-extended or cut to the port's row count)
    drawn elsewhere; with `s_cap`, the ledger capacity cut to it after
    loading (a later generation grows it). Returns the rank's exchange
    record, capacity log, block rows and the address of population 1's
    `seg_st` plane after each generation (the same from one to the next:
    written in place)."""
    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.core.engine import Simulation

    mesh.traffic.reset()
    sim = Simulation(parse_args(argv), mesh=mesh, verbose=False)
    if s_cap is not None:
        sim.s_cap = s_cap
    ptrs, step = [], sim.step

    def step_kept(gen):
        step(gen)
        ptrs.append(sim.pops[0].state.seg_st.data_ptr())

    sim.step = step_kept
    if inject is not None:
        n_pop = len(sim.pops)

        def at(p, gen):
            return (gen - 1) * n_pop + p.index

        sim._mate = lambda p, gen, pop_size, g: inject["mates"][at(p, gen)]

        def plan(p, gen, n_pad):
            drawn = inject["plans"][at(p, gen)]
            edge = np.minimum(np.arange(n_pad), drawn[0].shape[1] - 1)
            return tuple(torch.from_numpy(np.ascontiguousarray(x[:, edge]))
                         for x in drawn)

        sim._plan = plan
    sim.run()
    return {"traffic": mesh.traffic.summary(), "log": sim.capacity_log,
            "rows": sim.pops[0].state.seg_st.shape[1], "ptrs": ptrs}


def engine_runs(rank: int, shape, runs) -> list:
    """Several runs on one (ind, loci) mesh of CPU ranks, in order. Each
    run is a dict: `argv` (a `Simulation` run, with `env` set around it,
    `envs` per rank, `inject` and `s_cap`), or `moments` (the vectors
    whose `_device_moments` to return)."""
    import os

    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.core.engine import Simulation

    mesh = pm.make_mesh(shape, "cpu")
    out = []
    for run in runs:
        env = dict(run.get("env", {}))
        if "envs" in run:
            env.update(run["envs"][rank])
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            if "moments" in run:
                sim = Simulation(parse_args(run["moments_argv"]), mesh=mesh,
                                 verbose=False)
                out.append([sim._device_moments(x) for x in run["moments"]])
            else:
                out.append(_simulate(mesh, run["argv"], run.get("inject"),
                                     run.get("s_cap")))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


# ----------------------------------------------------------- dense backend
def _inject(sim, inject) -> None:
    """Feed `sim` mating plans (`mates`, per (generation, population) in
    call order), device draws (`plans`: (xo_p, st_p, xo_m, st_m, mu)) and
    each generation's plane rows (`rows`) drawn elsewhere."""
    n_pop = len(sim.pops)

    def at(p, gen):
        return (gen - 1) * n_pop + p.index

    sim._mate = lambda p, gen, pop_size, g: inject["mates"][at(p, gen)]
    sim._child_rows = lambda p, gen, n_child, par_rows: \
        inject["rows"][at(p, gen)]
    sim._plan = lambda p, gen, n_pad: tuple(
        None if x is None else torch.from_numpy(np.array(x)).to(sim.device)
        for x in inject["plans"][at(p, gen)])


def dense_runs(rank: int, runs) -> list:
    """`DenseSimulation` runs on meshes of CPU ranks, in order. Each run
    is a dict: `shape` (ind, loci), `argv`, optionally `inject` (see
    `_inject`) and `states` (keep population 1's whole planes, gathered
    from every rank, after each generation). Returns each run's exchange
    record and block shape, and on rank 0 the kept states. A run with
    `roundtrip` (a whole dense state as numpy) instead carries it onto
    the ranks and back (`convert.dense_shard_*`), returning this rank's
    block shape and the state back."""
    from geneevolve_tpu_torch.config import parse_args
    from geneevolve_tpu_torch.dense.backend import DenseSimulation

    out = []
    for run in runs:
        mesh = pm.make_mesh(run["shape"], "cpu")
        if "roundtrip" in run:
            st = convert.dense_shard_from_numpy(run["roundtrip"], mesh)
            out.append({"block": tuple(st.hap.shape),
                        "back": convert.dense_shard_to_numpy(st, mesh)})
            continue
        sim = DenseSimulation(parse_args(run["argv"]), mesh=mesh,
                              verbose=False)
        if run.get("inject") is not None:
            _inject(sim, run["inject"])
        states = []
        if run.get("states"):
            step = sim.step

            def kept(gen, step=step, sim=sim):
                step(gen)
                st = sim.pops[0].state
                states.append(dict(n=st.n, **sim._ckpt_genome_arrays(st)))

            sim.step = kept
        sim.run()
        st = sim.pops[0].state
        out.append({"traffic": mesh.traffic.summary(),
                    "block": tuple(st.hap.shape),
                    "states": states if rank == 0 else None})
    return out


# -------------------------------------------------------------- multihost
def two_nodes(rank: int, n: int) -> dict:
    """Two ranks posing as two nodes of one rank each: the node's suffix,
    its rows of an n-row array on a (2, 1) mesh and a global sum."""
    import os

    os.environ.update(GROUP_RANK=str(rank), LOCAL_WORLD_SIZE="1")
    rows = multihost.host_row_ranges(n, (2, 1))
    lo, hi = rows[0]
    total = comm.all_reduce(torch.arange(lo, hi, dtype=torch.int64).sum()
                            .reshape(1))
    return {"suffix": multihost.host_suffix(), "rows": rows,
            "total": int(total[0]), "info": multihost.process_info(),
            "writer": multihost.is_node_writer()}


def one_node(rank: int) -> dict:
    return {"suffix": multihost.host_suffix(),
            "info": multihost.process_info(),
            "writer": multihost.is_node_writer()}


def fail_on_rank1(rank: int) -> None:
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if rank == 1:
        raise ValueError("injected failure on rank 1")
    dist.all_reduce(torch.zeros(1))
    dist.all_reduce(torch.zeros(1))


def hang(rank: int) -> None:
    """Every rank sleeps past any test's deadline."""
    time.sleep(3600)
