"""The port's mesh (`geneevolve_tpu_torch/parallel/mesh.py`) on gloo CPU
ranks, against the JAX package's `parallel/mesh.py` on 8 virtual devices.

One group of 8 ranks runs every (4, 2) and (8, 1) check and one group of 2
ranks the (2, 1) and (1, 2) checks (`tests/torch_dist.py`); each test reads
its part of their results. Tolerances are 0 (bit identity) unless stated:

- `routed_fetch` equals the JAX `routed_fetch` under `shard_map`, exact
  and skewed with cap 64 and 8 (overflow 0 and 32);
- `make_deme_step` (ring and 4 x 4 matrix migration, mutations) and
  `make_routed_step` fed the JAX steps' draws, recomputed here from the
  JAX key schedule (`mesh.py:189-195`, `:413-417`), equal the JAX steps:
  `hap`, `cv` and `clip`;
- `make_sharded_step` at (4, 2), (2, 1) and (1, 2) equals the one-rank
  step for the byte and packed configurations of `tests/test_dense.py:135`
  and `tests/test_packed.py:81`, with one chromosome split over two loci
  ranks, and with three chromosomes cut into unequal pieces (packed: 6
  words over 2 ranks; byte: 300 loci); fed the JAX step's draws at (4, 2)
  over three chromosomes of 4 words (6 words a loci rank: a chromosome
  cut in half), it equals the JAX `make_sharded_step` on 8 virtual
  devices; word and locus counts that do not split over 'loci' are
  refused in the JAX package's words;
- the deme isolation test (`tests/test_packed.py:98`), the routed law
  (`tests/test_routed_step.py:67`) and the deme-migration law
  (`tests/test_statistics.py:246`) on the port's own generators.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist
from geneevolve_tpu.dense import packed as jpk
from geneevolve_tpu.dense.step import _sample_gamete_plan
from geneevolve_tpu.parallel import mesh as jmesh

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)
# each launch's deadline: a hang fails the tests that need its ranks, not
# the whole run
RANKS8_S, RANKS2_S = 300, 120

# the 4 x 4 migration matrix: unbalanced, so deme sizes hold only by the
# exchange's construction
MIG_MATRIX = np.array([[0.70, 0.10, 0.10, 0.10],
                       [0.05, 0.80, 0.10, 0.05],
                       [0.20, 0.00, 0.80, 0.00],
                       [0.00, 0.25, 0.00, 0.75]])
STEP_CFG = dict(n=64, m=4096, n_chr=4, morgans_per_chr=1.0, xo_cap=8,
                mut_rate=0.5, mut_cap=4, ncv=16)
SHARDED = {
    "dense": dict(n=32, m=512, n_chr=4, selection=True, mut_rate=0.5,
                  ncv=16),
    "packed": dict(n=32, m=2048, n_chr=4, selection=True, mut_rate=0.5,
                   ncv=16),
}
ONE_CHR = {
    "dense_one_chr": dict(n=32, m=512, n_chr=1, selection=True,
                          mut_rate=0.5, ncv=16),
    "packed_one_chr": dict(n=32, m=2048, n_chr=1, selection=True,
                           mut_rate=0.5, ncv=16),
}
# three chromosomes over two loci ranks: each rank holds one whole
# chromosome and half of the middle one (packed: 1.5 of 2 words)
THREE_CHR = {
    "dense_three_chr": dict(n=8, m=3 * 100, n_chr=3, selection=True,
                            mut_rate=0.5, ncv=16),
    "packed_three_chr": dict(n=8, m=3 * 64, n_chr=3, selection=True,
                             mut_rate=0.5, ncv=16),
}
# fed the JAX step's draws at (4, 2): 12 words, 6 a loci rank
SHARDED_FED = {
    "three_chr": dict(n=16, m=3 * 128, n_chr=3, xo_cap=8, selection=True,
                      mut_rate=0.5, mut_cap=4, ncv=16),
    "three_chr_no_mutations": dict(n=16, m=3 * 128, n_chr=3, xo_cap=8,
                                   ncv=16),
}


def _jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.make_mesh(jax.devices()[:8])  # (4, 2)


def _state_np(state) -> dict:
    return {k: np.asarray(v) for k, v in state.items()}


def _local_cfg(cfg, ind, loci, mut_rate):
    return jpk.PackedConfig(**{**cfg.__dict__, "n": cfg.n // ind,
                               "m": cfg.m // loci,
                               "n_chr": cfg.n_chr // loci,
                               "mut_rate": mut_rate})


def _plan(key, cfg_loc, n):
    """The per-shard draws of one gamete pair, in the JAX steps' order."""
    k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(key, 4)
    dl = cfg_loc.as_dense()
    xo_p, st_p, cp = _sample_gamete_plan(k_pat, dl, n)
    xo_m, st_m, cm = _sample_gamete_plan(k_mat, dl, n)
    clip, mu = int(cp) + int(cm), None
    if cfg_loc.mut_rate > 0:
        mu_a, ca = jpk.mutation_positions(k_mu1, n, cfg_loc)
        mu_b, cb = jpk.mutation_positions(k_mu2, n, cfg_loc)
        mu = np.stack([np.asarray(mu_a), np.asarray(mu_b)], 1)
        clip += int(ca) + int(cb)
    return dict(xo_p=np.asarray(xo_p), st_p=np.asarray(st_p),
                xo_m=np.asarray(xo_m), st_m=np.asarray(st_m), mu=mu,
                clip=clip)


def _deme_draws(cfg, key, ind, loci, with_perm):
    """Every rank's draws of `make_deme_step` (uniform mating) from the
    JAX key schedule: k_ind = fold_in(key, i) for mating and migration,
    fold_in(k_ind, 1 + j) for the plan."""
    cfg_loc = _local_cfg(cfg, ind, loci, cfg.mut_rate / loci)
    n = cfg_loc.n
    draws = {}
    for i in range(ind):
        k_ind = jax.random.fold_in(key, i)
        k_mate, k_mig = jax.random.split(k_ind)
        km1, km2 = jax.random.split(k_mate)
        mates = dict(
            fathers=np.asarray(jax.random.randint(km1, (n,), 0, n)),
            mothers=np.asarray(jax.random.randint(km2, (n,), 0, n)),
            perm=(np.asarray(jax.random.permutation(k_mig, n))
                  if with_perm else None))
        for j in range(loci):
            draws[(i, j)] = dict(
                mates, **_plan(jax.random.fold_in(k_ind, 1 + j), cfg_loc, n))
    return draws


def _routed_draws(cfg, key, ind, loci):
    """Every rank's draws of `make_routed_step` (uniform mating): global
    mates from fold_in(key, 0), the plan from fold_in(fold_in(key, 1 + i),
    1 + j)."""
    cfg_loc = _local_cfg(cfg, ind, loci, cfg.mut_rate)
    km1, km2 = jax.random.split(jax.random.fold_in(key, 0))
    mates = dict(fathers=np.asarray(jax.random.randint(km1, (cfg.n,), 0,
                                                       cfg.n)),
                 mothers=np.asarray(jax.random.randint(km2, (cfg.n,), 0,
                                                       cfg.n)))
    return {(i, j): dict(mates, **_plan(
        jax.random.fold_in(jax.random.fold_in(key, 1 + i), 1 + j),
        cfg_loc, cfg_loc.n))
        for i in range(ind) for j in range(loci)}


def _sharded_draws(cfg, state, key) -> dict:
    """The JAX packed step's draws (`dense/packed.py:make_step`) from its
    key schedule, over the whole generation."""
    n = cfg.n
    k_mate, k_pat, k_mat, k_mu1, k_mu2 = jax.random.split(key, 5)
    km1, km2, _ = jax.random.split(k_mate, 3)
    if cfg.selection:
        bv = jpk.phenotype_from_cv(state["cv"], state["eff"])
        z = (bv - jnp.mean(bv)) / (jnp.std(bv) + 1e-9)
        fathers = jax.random.categorical(km1, z, shape=(n,))
        mothers = jax.random.categorical(km2, z, shape=(n,))
    else:
        fathers = jax.random.randint(km1, (n,), 0, n)
        mothers = jax.random.randint(km2, (n,), 0, n)
    dl = cfg.as_dense()
    xo_p, st_p, cp = _sample_gamete_plan(k_pat, dl, n)
    xo_m, st_m, cm = _sample_gamete_plan(k_mat, dl, n)
    clip, mu = int(cp) + int(cm), None
    if cfg.mut_rate > 0:
        mu_a, ca = jpk.mutation_positions(k_mu1, n, cfg)
        mu_b, cb = jpk.mutation_positions(k_mu2, n, cfg)
        mu = np.stack([np.asarray(mu_a), np.asarray(mu_b)], 1)
        clip += int(ca) + int(cb)
    return {k: (v if v is None or isinstance(v, int) else np.asarray(v))
            for k, v in dict(fathers=fathers, mothers=mothers, xo_p=xo_p,
                             st_p=st_p, xo_m=xo_m, st_m=st_m, mu=mu,
                             clip=clip).items()}


def _fetch_cases():
    rng = np.random.default_rng(0)
    tab = rng.integers(0, 1 << 20, size=(256, 3)).astype(np.int32)
    idx = rng.integers(0, 256, size=64).astype(np.int32)
    skew = np.arange(256 * 2, dtype=np.int32).reshape(256, 2)
    seven = np.full(40, 7, np.int32)  # every request on rank 0
    return [(tab, idx, 64), (skew, seven, 64), (skew, seven, 8)]


def _jax_fetch(mesh, tab, idx, cap):
    def f(tab_loc, idx_rep):
        return jmesh.routed_fetch(tab_loc, idx_rep, 256 // 4, 4, cap=cap)

    got, ov = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("ind", None), P()),
                                out_specs=(P(), P()), check_vma=False))(
        jnp.asarray(tab), jnp.asarray(idx))
    return np.asarray(got), int(ov)


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    _jax_mesh()  # skips without 8 virtual devices
    return torch_dist.once(tmp_path_factory, "mesh_jax_cases", _jax_cases)


def _jax_cases():
    """The inputs, the JAX draws and the JAX results of every check."""
    mesh = _jax_mesh()
    cases = {"fetch": _fetch_cases(), "steps": {}, "sharded": SHARDED,
             "sharded_fed": {}}
    cases["jax_fetch"] = [_jax_fetch(mesh, *c) for c in cases["fetch"]]
    cfg = jpk.PackedConfig(**STEP_CFG)
    state = jpk.init_state(jax.random.key(3), cfg)
    key = jax.random.key(9)
    for name, kind, kw in (
            ("deme_ring", "deme", dict(mig_rate=0.25, mig_matrix=None)),
            ("deme_matrix", "deme", dict(mig_rate=0.0,
                                         mig_matrix=MIG_MATRIX)),
            ("routed", "routed", {})):
        if kind == "deme":
            step = jmesh.make_deme_step(cfg, mesh, **kw)
            draws = _deme_draws(cfg, key, 4, 2, with_perm=True)
        else:
            step = jmesh.make_routed_step(cfg, mesh)
            draws = _routed_draws(cfg, key, 4, 2)
        want = _state_np(step(jmesh.shard_state(state, mesh), key))
        cases["steps"][name] = dict(kind=kind, cfg=STEP_CFG, **kw,
                                    state=_state_np(state), draws=draws,
                                    want=want)
    for name, kw in SHARDED_FED.items():
        cfg = jpk.PackedConfig(**kw)
        state = jpk.init_state(jax.random.key(5), cfg)
        key = jax.random.key(13)
        want = jmesh.make_sharded_step(cfg, mesh)(
            jmesh.shard_state(state, mesh), key)
        cases["sharded_fed"][name] = dict(
            cfg=kw, state=_state_np(state),
            draws=_sharded_draws(cfg, state, key), want=_state_np(want))
    return cases


@pytest.fixture(scope="module")
def ranks8(jax_cases, tmp_path_factory):
    run = {k: v for k, v in jax_cases.items()
           if k in ("fetch", "steps", "sharded", "sharded_fed")}
    for part in ("steps", "sharded_fed"):
        run[part] = {k: {kk: vv for kk, vv in v.items() if kk != "want"}
                     for k, v in run[part].items()}
    return torch_dist.once(tmp_path_factory, "mesh_ranks8", lambda: (
        torch_dist.launch_by(time.monotonic() + RANKS8_S,
                             torch_dist.mesh_checks, 8, (run,))))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return torch_dist.once(tmp_path_factory, "mesh_ranks2", lambda: (
        torch_dist.launch_by(time.monotonic() + RANKS2_S,
                             torch_dist.pair_checks, 2,
                             ({**SHARDED, **ONE_CHR, **THREE_CHR},))))


def test_ranks_take_grid_coordinates(ranks8):
    assert [r["coords"] for r in ranks8] == [(i, j) for i in range(4)
                                             for j in range(2)]


@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["exact", "skewed_cap64", "skewed_cap8"])
def test_routed_fetch_matches_jax(ranks8, jax_cases, case):
    tab, idx, cap = jax_cases["fetch"][case]
    want, want_ov = jax_cases["jax_fetch"][case]
    for r in ranks8:
        got, ov = r["fetch"][case]
        np.testing.assert_array_equal(got, want)
        assert ov == want_ov
    assert want_ov == (32 if cap == 8 else 0)
    if cap == 64:
        np.testing.assert_array_equal(want, tab[idx])


@pytest.mark.parametrize("name", ["deme_ring", "deme_matrix", "routed"])
def test_step_fed_jax_draws_matches_jax(ranks8, jax_cases, name):
    want = jax_cases["steps"][name]["want"]
    got = ranks8[0][name]
    np.testing.assert_array_equal(got["hap"], want["hap"])
    np.testing.assert_array_equal(got["cv"], want["cv"])
    assert int(got["clip"]) == int(want["clip"])


def test_migration_moves_rows(jax_cases):
    """The migrations really exchange rows: without them the JAX deme
    step's children differ (so the equalities above cover the
    exchange)."""
    c = jax_cases["steps"]["deme_ring"]
    mesh = _jax_mesh()
    cfg = jpk.PackedConfig(**STEP_CFG)
    alone = jmesh.make_deme_step(cfg, mesh)(
        jmesh.shard_state({k: jnp.asarray(v) for k, v in c["state"].items()},
                          mesh), jax.random.key(9))
    assert not np.array_equal(np.asarray(alone["hap"]), c["want"]["hap"])


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_step_4x2_equals_one_rank(ranks8, name):
    for r in ranks8:
        assert all(r[name].values()), r[name]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("name", sorted({**SHARDED, **ONE_CHR, **THREE_CHR}))
def test_sharded_step_2_ranks_equals_one_rank(ranks2, shape, name):
    for r in ranks2:
        assert all(r[(shape, name)].values()), (shape, name, r[(shape, name)])


@pytest.mark.parametrize("name, size", [("packed", 3), ("dense", 99)])
def test_sharded_step_refuses_splits_jax_refuses(ranks2, name, size):
    """6 words over 2 loci ranks split (`test_sharded_step_2_ranks_...`),
    3 do not; nor do 99 byte-step loci. JAX's words (the jit's sharding
    refusal)."""
    msg = ranks2[0][("refused", name)]
    assert msg is not None
    assert (f"should be divisible by 2, but it is equal to {size}"
            in msg), msg


@pytest.mark.parametrize("name", sorted(SHARDED_FED))
def test_sharded_step_fed_jax_draws_matches_jax(ranks8, jax_cases, name):
    want = jax_cases["sharded_fed"][name]["want"]
    for r in ranks8:
        got = r["sharded_fed"][name]
        np.testing.assert_array_equal(got["hap"], want["hap"])
        np.testing.assert_array_equal(got["cv"], want["cv"])
        assert int(got["clip"]) == int(want["clip"])


def test_deme_step_isolates_shards(ranks8):
    iso = ranks8[0]["isolation"]
    np.testing.assert_array_equal(iso["got"], iso["want"])


def test_routed_step_keeps_law(ranks8):
    law = ranks8[0]["routed_law"]
    assert 0.05 < law["mean"] < 0.95
    assert law["cv_min"] >= 0 and law["cv_max"] <= 1
    assert law["cv_planes"]  # the resident CVs follow the planes
    # no routed request overflows (cap ~ R/D + 6 sqrt(R/D) + 8); mutation
    # draws beyond mut_cap 4 at rate 0.5 (1.7e-4 a gamete, ~0.5 expected
    # over 3 generations of 8 ranks x 64 children x 2 gametes) may count
    assert law["clip"] <= 3


def test_traffic_is_recorded(ranks8):
    t = ranks8[0]["traffic"]
    assert t["calls"] > 0 and t["bytes"] > 0 and t["seconds"] > 0


def test_deme_migration_law(ranks8):
    """`tests/test_statistics.py:246` on the port's generators: 8 demes of
    32, 40 generations, 2 replicates. Isolated demes decay at Ne = n / D
    (tolerance 0.10, as there). With ring migration at m = 0.125, H_S
    decays at the panmictic rate times 1 - F_ST, F_ST = 1 / (1 + 4 N m)
    (Wright's island model, the law the JAX step's docstring cites:
    0.870); the JAX test compares against the panmictic rate alone (0.925)
    within 0.06, which the JAX step's own replicates meet by under 0.001.
    Here: within 0.06 of 0.870, within 0.03 of the JAX step's mean over
    the JAX test's keys, and 0.2 above isolation."""
    law = ranks8[0]["migration_law"]
    n, D, gens = law["n"], law["demes"], law["gens"]
    want_pan = (1 - 1 / (2 * n)) ** gens
    want_iso = (1 - 1 / (2 * n / D)) ** gens
    want_mig = want_pan * (1 - 1 / (1 + 4 * (n / D) * 0.125))
    assert abs(law["iso"] - want_iso) < 0.10, law
    assert abs(law["mig"] - want_mig) < 0.06, law
    assert law["mig"] > law["iso"] + 0.2, law
    assert abs(law["mig"] - _jax_migration_ratio(n, D, gens)) < 0.03, law


def _jax_migration_ratio(n, D, gens, reps=2):
    """The JAX deme step's H_S ratio with ring migration 0.125, mean over
    the JAX statistics test's keys."""
    mesh = jmesh.make_mesh(jax.devices()[:8], shape=(8, 1))
    cfg = jpk.PackedConfig(n=n, m=4096, n_chr=4, morgans_per_chr=1.0,
                           xo_cap=8)
    step = jmesh.make_deme_step(cfg, mesh, mig_rate=0.125)

    def het(state):
        return torch_dist._het(np.asarray(state["hap"]), cfg.m, D)

    out = []
    for rep in range(reps):
        state = jmesh.shard_state(jpk.init_state(jax.random.key(20 + rep),
                                                 cfg), mesh)
        h0, key = het(state), jax.random.key(50 + rep)
        for g in range(gens):
            state = step(state, jax.random.fold_in(key, g))
        out.append(het(state) / h0)
    return float(np.mean(out))
