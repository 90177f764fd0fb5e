"""Device mate pairing in the PyTorch port (`parallel/mating_device.py`,
`--device_mating`) on the CPU.

- The mirrors of `tests/test_mating_device.py` (all but the sharded case,
  which waits for the port's mesh): couple correlation, the selection
  gate, the sib veto, `random_mate_device`'s gate, the "f" law, MM, and
  the engine end to end.
- `pair` fed the JAX function's own draws (rebuilt from the same
  `jax.random.split(key, 7)`; the "p" children as the uniforms that pick
  JAX's child slots) gives the JAX plan exactly, tolerance 0.
- The port's own "p" child draw: uniform over the eligible couple slots
  (chi-square), none off them.
- A `--device_mating` run resumed from its checkpoint is byte-identical to
  the straight run, on both backends.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from geneevolve_tpu.parallel import mating_device as jmd
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.dense import backend as tbackend
from geneevolve_tpu_torch.parallel import mating_device as md
from test_torch_checkpoint import _resume_case
from test_torch_engine import _argv

REPO = Path(__file__).resolve().parent.parent
T = torch.as_tensor
torch.set_num_threads(1)


def _pop(n, rng):
    mv = rng.normal(size=n).astype(np.float32)
    sex = rng.integers(1, 3, size=n)
    ped = {k: np.arange(n) for k in ("father", "ff", "fm", "mf", "mm")}
    return mv, sex, ped


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _mate(seed, mv, svf, sex, ped, mat_cor, avoid, pop_size, **kw):
    return md.assort_mate_device(_gen(seed), T(mv), T(svf), T(sex),
                                 {k: T(v) for k, v in ped.items()}, mat_cor,
                                 avoid, pop_size, **kw)


def _np(plan):
    return {k: getattr(plan, k).numpy() for k in plan._fields}


def test_couple_correlation_matches_target():
    rng = np.random.default_rng(0)
    n = 4000
    mv, sex, ped = _pop(n, rng)
    svf = np.ones(n, dtype=np.float32)
    for r_target in (0.0, 0.5, 0.9):
        plan = _np(_mate(1, mv, svf, sex, ped, r_target, False, n))
        valid = plan["valid"]
        fa = plan["father_pos"][valid]
        mo = plan["mother_pos"][valid]
        got = float(np.corrcoef(mv[fa], mv[mo])[0, 1])
        assert abs(got - r_target) < 0.08, (r_target, got)
        # the two sexes never cross and no one marries twice
        assert set(np.unique(sex[fa])) == {1}
        assert set(np.unique(sex[mo])) == {2}
        assert len(np.unique(fa)) == len(fa)
        assert len(np.unique(mo)) == len(mo)


def test_selection_gate_and_children():
    rng = np.random.default_rng(1)
    n = 2000
    mv, sex, ped = _pop(n, rng)
    svf = (np.arange(n) % 2).astype(np.float32)  # only odd positions marry
    plan = _np(_mate(2, mv, svf, sex, ped, 0.4, False, n))
    valid = plan["valid"]
    assert np.all(plan["father_pos"][valid] % 2 == 1)
    assert np.all(plan["mother_pos"][valid] % 2 == 1)
    # children reference only valid couple slots
    cc = plan["child_couple"]
    assert cc.shape == (n,)
    assert np.all(valid[cc])


def test_inbreeding_veto_blocks_sibs():
    rng = np.random.default_rng(2)
    n = 1000
    mv, sex, ped = _pop(n, rng)
    # everyone shares one father: every couple is a sib pair
    ped["father"] = np.zeros(n, dtype=np.int64)
    svf = np.ones(n, dtype=np.float32)
    plan = _np(_mate(3, mv, svf, sex, ped, 0.0, True, n))
    assert np.all(plan["inbred"][plan["valid"]])


def test_random_mate_device_gate():
    rng = np.random.default_rng(3)
    n = 1000
    _, sex, _ = _pop(n, rng)
    svf = (np.arange(n) < 100).astype(np.float32)
    plan = _np(md.random_mate_device(_gen(4), T(svf), T(sex), n))
    assert np.all(plan["father_pos"] < 100)
    assert np.all(plan["mother_pos"] < 100)
    assert np.all(sex[plan["father_pos"]] == 1)
    assert np.all(sex[plan["mother_pos"]] == 2)


def test_fixed_offspring_law_device():
    """'f' law (`Simulation.cpp:2340-2355`): every eligible couple gets
    floor(pop_size/eligible) children; a random subset gets one extra;
    total exactly pop_size."""
    rng = np.random.default_rng(3)
    n = 800
    mv, sex, ped = _pop(n, rng)
    svf = np.ones(n, dtype=np.float32)
    pop_size = 1311  # not a multiple of the couple count
    plan = _np(_mate(5, mv, svf, sex, ped, 0.0, False, pop_size,
                     offspring_dist="f"))
    nc = int(plan["n_couples"])
    child = plan["child_couple"]
    assert len(child) == pop_size
    sizes = np.bincount(child, minlength=nc)[:nc]
    nf = pop_size // nc
    assert set(np.unique(sizes)) <= {nf, nf + 1}
    assert sizes.sum() == pop_size
    assert (sizes == nf + 1).sum() == pop_size - nf * nc


def test_mm_double_spouse_device():
    """MM (`Simulation.cpp:2199-2213`): with MM=0.5 some individuals marry
    twice; with MM=0 nobody does; the couple count grows accordingly."""
    rng = np.random.default_rng(4)
    n = 2000
    mv, sex, ped = _pop(n, rng)
    svf = np.ones(n, dtype=np.float32)
    res = {}
    for mm in (0.0, 0.5):
        plan = _np(_mate(6, mv, svf, sex, ped, 0.0, False, n,
                         mm_percent=mm))
        nc = int(plan["n_couples"])
        fa = plan["father_pos"][:nc]
        mo = plan["mother_pos"][:nc]
        assert np.all(fa >= 0) and np.all(fa < n)  # original positions
        assert set(np.unique(sex[fa])) == {1}
        assert set(np.unique(sex[mo])) == {2}
        res[mm] = (nc, len(np.unique(fa)), len(np.unique(mo)))
    nc0, uf0, um0 = res[0.0]
    nc5, uf5, um5 = res[0.5]
    assert uf0 == nc0 and um0 == nc0  # no double marriages at MM=0
    assert nc5 > nc0 * 1.3  # ~1.5x couples at MM=0.5
    assert uf5 < nc5 and um5 < nc5  # some marry twice


# ---------------------------------------------------- the JAX draws, exact
def _jax_draws(key, n, mm, law, n_children):
    """The draws of JAX `assort_mate_device(key, ...)`, rebuilt from the
    same split of its key (the "p" children are added from its plan)."""
    k_gate, k_trim_m, k_trim_f, k_mvn, _, k_mm, k_extra = jax.random.split(
        key, 7)
    N = 2 * n if mm > 0 else n
    a = lambda x: T(np.array(x))  # noqa: E731
    return md.MateDraws(
        gate=a(jax.random.uniform(k_gate, (n,))),
        mm=a(jax.random.uniform(k_mm, (n,))) if mm > 0 else None,
        trim_m=a(jax.random.uniform(k_trim_m, (N,))),
        trim_f=a(jax.random.uniform(k_trim_f, (N,))),
        z=a(jax.random.normal(k_mvn, (2, N))),
        extra=a(jax.random.uniform(k_extra, (N,))) if law == "f" else None,
        child=None,
    )


def _child_uniforms(plan):
    """Uniforms that make the port's "p" draw pick the JAX plan's child
    slots: slot s of packed eligible rank k takes u = (k + 0.5) / eligible."""
    elig = np.flatnonzero(np.asarray(plan.valid) & ~np.asarray(plan.inbred))
    cc = np.asarray(plan.child_couple)
    rank = np.searchsorted(elig, cc)
    assert np.array_equal(elig[rank], cc)  # JAX's children are eligible
    return T((rank + 0.5) / len(elig))


@pytest.mark.parametrize("law, mm, avoid, mat_cor", [
    ("p", 0.0, True, 0.3),
    ("f", 0.0, True, 0.5),
    ("p", 0.2, True, 0.7),
    ("f", 0.2, False, 0.9),
])
def test_pair_equals_jax_on_its_draws(law, mm, avoid, mat_cor):
    """Fed JAX's draws, `pair` gives JAX's plan exactly: the positions
    (also under MM), the couple slots, the veto and the children. Sparse
    pedigree ids make the veto bite."""
    rng = np.random.default_rng(11)
    n, pop_size, n_children = 3000, 2900, 3100
    mv = rng.normal(size=n).astype(np.float32)
    svf = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    sex = rng.integers(1, 3, size=n)
    ped = {k: rng.integers(0, n // 3, size=n)
           for k in ("father", "ff", "fm", "mf", "mm")}
    key = jax.random.key(5)
    want = jmd.assort_mate_device(
        key, jnp.asarray(mv), jnp.asarray(svf), jnp.asarray(sex),
        {k: jnp.asarray(v) for k, v in ped.items()}, mat_cor, avoid,
        pop_size, mm_percent=mm, offspring_dist=law, n_children=n_children)
    draws = _jax_draws(key, n, mm, law, n_children)
    if law == "p":
        draws = draws._replace(child=_child_uniforms(want))
    got = md.pair(draws, T(mv), T(svf), T(sex),
                  {k: T(v) for k, v in ped.items()}, mat_cor, avoid,
                  pop_size, mm, law, n_children)
    for k in md.DevicePlan._fields:
        w, g = np.asarray(getattr(want, k)), getattr(got, k).numpy()
        assert w.dtype == g.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    if avoid:
        assert np.asarray(want.inbred).any()


def test_child_draw_uniform_over_eligible():
    """The port's "p" child draw: each child lands on an eligible couple
    slot (never a vetoed or padding slot), uniformly (chi-square p-value
    above 1e-4)."""
    rng = np.random.default_rng(12)
    n, n_children = 600, 120_000
    mv, sex, _ = _pop(n, rng)
    ped = {k: rng.integers(0, 60, size=n)
           for k in ("father", "ff", "fm", "mf", "mm")}
    svf = np.ones(n, dtype=np.float32)
    plan = _np(_mate(13, mv, svf, sex, ped, 0.3, True, n,
                     n_children=n_children))
    elig = plan["valid"] & ~plan["inbred"]
    assert plan["inbred"][plan["valid"]].any()
    counts = np.bincount(plan["child_couple"], minlength=len(elig))
    assert counts[~elig].sum() == 0
    obs = counts[elig]
    assert stats.chisquare(obs).pvalue > 1e-4


# ---------------------------------------------------------- the engine
def test_engine_device_mating_end_to_end(mini_scenario, tmp_path):
    """`--device_mating` runs the port's engine with the pairing on the
    device and the standard outputs."""
    cfg = parse_args(_argv(mini_scenario, tmp_path / "dm")
                     + ["--device_mating"])
    assert cfg.device_mating
    torch_engine.Simulation(cfg, device="cpu", verbose=False).run()
    summary = (tmp_path / "dm.pop1.summary").read_text().splitlines()
    assert len(summary) == 6
    hdr = summary[0].split()
    for line in summary[1:]:
        vals = dict(zip(hdr, line.split()))
        assert abs(float(vals["ph1_var_E"]) - 1.0) < 1e-6


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_engine_device_mating_f_and_mm(tmp_path, backend):
    """'f' schedules and MM > 0 under `--device_mating`: the run completes
    with the exact 'f' sizes, on both backends."""
    sys.path.insert(0, str(REPO / "tools"))
    from mkscenario import make_scenario

    flags = make_scenario(
        str(tmp_path / "sc"), n0=80, pop_size=90, gens=3, nchr=2, ncv=6,
        snps=64, offspring_dist="f",
    )
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", v]
    argv += ["--seed", "21", "--prefix", str(tmp_path / "o"),
             "--device_mating", "--MM", "0.3", "--backend", backend]
    cls = (tbackend.DenseSimulation if backend == "dense"
           else torch_engine.Simulation)
    cls(parse_args(argv), device="cpu", verbose=False).run()
    for g in (1, 2, 3):
        rows = len(
            (tmp_path / f"o.info.pop1.gen{g}.txt").read_text().splitlines()
        ) - 1
        assert rows == 90  # 'f' law is exact


def test_engine_device_mating_poisson_sizes(mini_scenario, tmp_path):
    """Under the 'p' law the realized generation sizes follow the
    reference's Poisson(pop_size) law (drawn on the host, the children
    taken off the device plan's padded count)."""
    cfg = parse_args(_argv(mini_scenario, tmp_path / "o")
                     + ["--seed", "31", "--device_mating"])
    sim = torch_engine.Simulation(cfg, device="cpu", verbose=False)
    sim.run()
    sizes = [
        len((tmp_path / f"o.info.pop1.gen{g}.txt").read_text().splitlines())
        - 1
        for g in range(1, sim.tot_gen + 1)
    ]
    # nominal 60: jitter present (not all equal) and within a sane band
    assert all(25 <= s <= 100 for s in sizes), sizes
    assert len(set(sizes)) > 1, sizes


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_device_mating_resume_bit_identical(mini_scenario, tmp_path,
                                            backend):
    """The device draws are a function of (seed, generation, population):
    a `--device_mating` run resumed from its generation-2 checkpoint writes
    the straight run's files byte for byte."""
    (tmp_path / "straight").mkdir()
    (tmp_path / "ck").mkdir()
    cls = (tbackend.DenseSimulation if backend == "dense"
           else torch_engine.Simulation)

    def make(a):
        return cls(parse_args(a), device="cpu", verbose=False)

    _resume_case(
        make, lambda d: _argv(mini_scenario, d / "out")
        + ["--device_mating", "--avoid_inbreeding", "--backend", backend],
        tmp_path / "straight", tmp_path / "ck", 2,
        ["out.pop1.summary", "out.info.pop1.gen3.txt",
         "out.info.pop1.gen4.txt"])
