"""The PyTorch port's segment engine against the JAX engine on
`mini_scenario`.

The JAX run's mating plans and `_capacity_probe` plans (its only device
draws) are captured by wrapping those functions inside the test and fed to
the port generation by generation. With the same plans the port's child
ledgers, mutations and resident CVs must be bit-exact every generation.
`.info` / `.summary` floats agree within rtol 1e-5 (plus an absolute floor
of 1e-5 of each column's largest magnitude): A and D are f32 row sums over
the CVs, taken in another order by XLA and torch, so their rounding error
scales with the summed terms, not with the (possibly near-zero) result.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from geneevolve_tpu.config import parse_args as jax_parse_args
from geneevolve_tpu.core import engine as jax_engine
from geneevolve_tpu.core import mating
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import engine as torch_engine
from geneevolve_tpu_torch.core.convert import state_from_numpy, state_to_numpy

PLANES = ("seg_st", "seg_hap", "mut", "cv")
MUT_RATE = 1.0 / 1200  # ~1 de novo mutation per gamete per chromosome
# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


def _argv(root: Path, prefix: Path, mutation_map=None):
    argv = [
        "--file_gen_info", str(root / "popinfo.txt"),
        "--file_hap_name", str(root / "hap_address.txt"),
        "--file_recom_map", str(root / "rmap.txt"),
        "--file_cv_info", str(root / "cv.info"),
        "--file_cvs", str(root / "cv_address.txt"),
        "--seed", "777",
        "--prefix", str(prefix),
    ]
    if mutation_map is not None:
        argv += ["--file_mutation_map", str(mutation_map)]
    return argv


def _mutation_map(path: Path) -> Path:
    with open(path, "w") as f:
        f.write("chr bp rate\n")
        for c in (1, 2):
            for bp in range(0, 60_000_000, 50_000):
                f.write(f"{c} {bp} {MUT_RATE:.8g}\n")
    return path


def _planes(st):
    return {k: np.asarray(getattr(st, k)) for k in PLANES}


def _host(st):
    return dict(n=st.n, sex=st.sex, ids=st.ids, ped=st.ped, comp=st.comp,
                mv=st.mv, sv=st.sv, svf=st.svf)


class JaxRun:
    """A JAX engine run with every generation's plans and states kept:
    mating and reproduce plans in call order, population by population
    within a generation; `states` population 1's, `pop_states` every
    population's, after each generation (after its migration)."""

    def __init__(self, argv):
        self.mates, self.plans, self.states, self.runtime = [], [], [], []
        self.pop_states = []
        probe, assort = jax_engine._capacity_probe, mating.assort_mate

        def probe_rec(*a, **k):
            out = probe(*a, **k)
            self.plans.append(tuple(np.asarray(x) for x in out[2]))
            return out

        def assort_rec(*a, **k):
            plan = assort(*a, **k)
            self.mates.append(plan)
            return plan

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_engine, "_capacity_probe", probe_rec)
            mp.setattr(mating, "assort_mate", assort_rec)
            sim = jax_engine.Simulation(jax_parse_args(argv), verbose=False)
            sim.init_generation0()
            self._keep(sim)
            for gen in range(1, sim.tot_gen + 1):
                sim.step(gen)
                self._keep(sim)
            sim._check_capacity_guard()
            sim.write_summary()
        self.sim = sim

    def _keep(self, sim):
        p = sim.pops[0]
        self.n_pop = sim.n_pop
        self.pop_states.append([dict(**_planes(q.state), **_host(q.state))
                                for q in sim.pops])
        self.states.append(self.pop_states[-1][0])
        self.runtime.append(dict(
            prev_phen=p.prev_phen.copy(), prev_F=p.prev_F.copy(),
            var_a_gen0=p.var_a_gen0, var_d_gen0=p.var_d_gen0,
            sv_mean_gen0=p.sv_mean_gen0, sv_var_gen0=p.sv_var_gen0,
            beta=[ph.beta for ph in p.phenos],
            s_cap=sim.s_cap, m_cap=sim.m_cap,
        ))


def _inject(tsim, run: JaxRun):
    """Feed the port the JAX run's mating plans and reproduce plans, those
    of each (generation, population)."""
    def at(p, gen):
        return (gen - 1) * run.n_pop + p.index

    tsim._mate = lambda p, gen, pop_size, g: run.mates[at(p, gen)]

    def plan(p, gen, n_pad):
        drawn = run.plans[at(p, gen)]
        assert drawn[0].shape[1] == n_pad  # same plane-row policy
        return tuple(torch.from_numpy(np.array(x)) for x in drawn)

    tsim._plan = plan


@pytest.fixture(scope="module", params=["no_mutation", "mutation_map"])
def jax_run(request, mini_scenario, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"jax_{request.param}")
    mmap = (_mutation_map(out / "mut.txt")
            if request.param == "mutation_map" else None)
    run = JaxRun(_argv(mini_scenario, out / "out", mmap))
    run.out, run.mmap = out, mmap
    return run


def _read_table(path: Path):
    lines = Path(path).read_text().splitlines()
    return lines[0].split(), np.array([l.split() for l in lines[1:]],
                                      dtype=np.float64)


def _assert_table_close(got: Path, want: Path):
    h1, a = _read_table(got)
    h2, b = _read_table(want)
    assert h1 == h2
    assert a.shape == b.shape
    atol = 1e-5 * np.nanmax(np.abs(b), axis=0, initial=0.0)
    bad = ~((np.abs(a - b) <= atol + 1e-5 * np.abs(b))
            | (np.isnan(a) & np.isnan(b)))
    assert not bad.any(), (got, np.argwhere(bad)[:5], a[bad][:5], b[bad][:5])


def test_plan_injected_run_bit_exact(jax_run, mini_scenario, tmp_path):
    tsim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "out", jax_run.mmap)),
        device="cpu", verbose=False,
    )
    _inject(tsim, jax_run)
    tsim.init_generation0()
    for gen in range(tsim.tot_gen + 1):
        if gen:
            tsim.step(gen)
        got = _planes(tsim.pops[0].state)
        for k in PLANES:
            want = jax_run.states[gen][k]
            assert got[k].dtype == want.dtype, (gen, k)
            np.testing.assert_array_equal(got[k], want, err_msg=f"{gen} {k}")
    if jax_run.mmap is not None:  # mutations were drawn and inherited
        assert (jax_run.states[-1]["mut"] < 2**30).sum() > 100
        assert tsim.has_mut
    tsim._check_capacity_guard()
    tsim.write_summary()
    assert [c["seg_used"] for c in tsim.capacity_log] == [
        c["seg_need"] for c in tsim.capacity_log
    ]
    for gen in range(tsim.tot_gen + 1):
        name = f"out.info.pop1.gen{gen}.txt"
        _assert_table_close(tmp_path / name, jax_run.out / name)
    _assert_table_close(tmp_path / "out.pop1.summary",
                        jax_run.out / "out.pop1.summary")


def test_gathers_in_chromosome_chunks(jax_run, mini_scenario, tmp_path,
                                      monkeypatch):
    """With too little free memory for every chromosome's parent rows at
    once, the real pass gathers them a chromosome at a time: the same
    planes as the JAX run, in one gather per parent, table and chromosome."""
    calls = []
    gather = torch_engine.gather_rows_stacked

    def gather_rec(table, idx):
        calls.append(table.shape[0])
        return gather(table, idx)

    check_fits = torch_engine.Simulation._check_fits

    def one_chromosome(self):  # as `_check_fits` sets it when memory is short
        check_fits(self)
        self.gather_chunk = 1

    monkeypatch.setattr(torch_engine, "gather_rows_stacked", gather_rec)
    monkeypatch.setattr(torch_engine.Simulation, "_check_fits",
                        one_chromosome)
    tsim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "out", jax_run.mmap)),
        device="cpu", verbose=False,
    )
    _inject(tsim, jax_run)
    tsim.init_generation0()
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
        got = _planes(tsim.pops[0].state)
        for k in PLANES:
            np.testing.assert_array_equal(got[k], jax_run.states[gen][k],
                                          err_msg=f"{gen} {k}")
    tables = 2 if tsim.has_mut else 1
    assert calls == [1] * (tsim.tot_gen * 2 * tables * len(tsim.chrs))


def _plan_chromosome_by_chromosome(sim, p, gen, n_pad):
    """The plan as drawn one chromosome at a time (every draw of a
    chromosome before the next chromosome's), one bins call per draw."""
    from geneevolve_tpu_torch.core import segments
    from geneevolve_tpu_torch.core.rng import Stage, generator

    sm, BIG, outs = p.smaps, segments.BIG, []
    for ci in range(len(sim.chrs)):
        g = generator(sim.device, sim.cfg.seed, gen, Stage.CROSSOVER,
                      p.index, ci)
        aff = {} if sm.bp0 is None else dict(bp0=int(sm.bp0[ci]),
                                             bp_step=int(sm.bp_step[ci]))
        xo = [segments.sample_point_process(
            g, n_pad, sim.xo_cap, sm.xo_cum[ci], float(sm.xo_lambda[ci]),
            sm.bp[ci], float(sm.bin_width[ci]), False, **aff)
            for _ in range(2)]
        sh = torch.randint(0, 2, (n_pad, 2), generator=g, dtype=torch.int32)
        if sim.has_mut:
            aff = {} if sm.mut_bp0 is None else dict(
                bp0=int(sm.mut_bp0[ci]), bp_step=int(sm.mut_bp_step[ci]))
            new = segments.sample_point_process(
                g, n_pad, sim.mn_cap, sm.mut_cum[ci],
                float(sm.mut_lambda[ci]), sm.mut_bp[ci], 0.0, True, **aff)
            which = torch.randint(0, 2, (n_pad, sim.mn_cap), generator=g)
            nf, nm = (torch.where(which == w, new, BIG) for w in (0, 1))
        else:
            nf = nm = torch.full((n_pad, 1), BIG, dtype=torch.int32)
        outs.append((xo[0], xo[1], sh, nf, nm))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(5))


@pytest.mark.parametrize("mutations", [False, True])
def test_plan_keeps_draw_order(mini_scenario, tmp_path, mutations):
    """`_plan` draws every chromosome's crossovers, then starts, then
    mutations, to map all chromosomes' bins in one launch per kind: each
    chromosome's generator still makes the same draws in the same order,
    so the plan equals the chromosome-by-chromosome one exactly."""
    mmap = _mutation_map(tmp_path / "mut.txt") if mutations else None
    sim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "out", mmap)),
        device="cpu", verbose=False)
    p = sim.pops[0]
    for gen in (1, 2):
        got = sim._plan(p, gen, 77)
        want = _plan_chromosome_by_chromosome(sim, p, gen, 77)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert bool((got[0] < 2**30).any())
    assert bool((got[3] < 2**30).any()) == mutations


def test_state_handover(jax_run, mini_scenario, tmp_path):
    """A JAX generation-2 state, handed over through `state_from_numpy`
    and stepped once with the JAX run's plan, equals the JAX step."""
    tsim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "out", jax_run.mmap)),
        device="cpu", verbose=False,
    )
    _inject(tsim, jax_run)
    tsim.init_generation0()
    p = tsim.pops[0]
    rt = jax_run.runtime[2]
    p.state = state_from_numpy(jax_run.states[2], device="cpu")
    for k in ("prev_phen", "prev_F", "var_a_gen0", "var_d_gen0",
              "sv_mean_gen0", "sv_var_gen0"):
        setattr(p, k, rt[k])
    for ph, beta in zip(p.phenos, rt["beta"]):
        ph.beta = beta
    tsim.s_cap, tsim.m_cap = rt["s_cap"], rt["m_cap"]
    tsim.step(3)
    got, want = state_to_numpy(p.state), jax_run.states[3]
    for k in PLANES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n"] == want["n"]
    for k in ("father", "mother", "ff", "fm", "mf", "mm"):
        np.testing.assert_array_equal(got["ped"][k], want["ped"][k])
    np.testing.assert_array_equal(got["sex"], want["sex"])
    for k, v in want["comp"].items():
        np.testing.assert_allclose(
            got["comp"][k], v, rtol=1e-5,
            atol=1e-5 * float(np.max(np.abs(v), initial=0.0)),
        )


def test_exact_n_matches_jax(mini_scenario, tmp_path, monkeypatch):
    """GE_EXACT_N=1 conditions every generation on exactly pop_size, in the
    port as in the JAX engine: the port's own run draws sizes of exactly
    60, and, fed the JAX run's plans, takes the same plane rows (no
    headroom) and reproduces its planes bit for bit."""
    monkeypatch.setenv("GE_EXACT_N", "1")
    run = JaxRun(_argv(mini_scenario, tmp_path / "jax"))
    own = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "own")), device="cpu",
        verbose=False,
    )
    own.run()
    tsim = torch_engine.Simulation(
        parse_args(_argv(mini_scenario, tmp_path / "torch")), device="cpu",
        verbose=False,
    )
    _inject(tsim, run)
    tsim.init_generation0()
    for gen in range(tsim.tot_gen + 1):
        if gen:
            tsim.step(gen)
            assert tsim.pops[0].state.n == run.states[gen]["n"] == 60
        got = _planes(tsim.pops[0].state)
        for k in PLANES:
            np.testing.assert_array_equal(got[k], run.states[gen][k],
                                          err_msg=f"{gen} {k}")
    assert got["seg_st"].shape[1] == 60  # rows without Poisson headroom
    for gen in range(1, own.tot_gen + 1):
        info = tmp_path / f"own.info.pop1.gen{gen}.txt"
        assert len(info.read_text().splitlines()) - 1 == 60


def test_state_roundtrip(jax_run):
    st = state_from_numpy(jax_run.states[1], device="cpu")
    back = state_to_numpy(st)
    for k in PLANES:
        np.testing.assert_array_equal(back[k], jax_run.states[1][k])
    assert back["n"] == jax_run.states[1]["n"]


def test_cli_file_set(mini_scenario, tmp_path, monkeypatch):
    """`main(argv, device="cpu")` writes the same files as the JAX CLI."""
    from geneevolve_tpu import cli as jax_cli
    from geneevolve_tpu_torch import cli as torch_cli

    monkeypatch.setenv("GE_NO_COMPILE_CACHE", "1")
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    assert jax_cli.main(_argv(mini_scenario, tmp_path / "jax" / "out")) == 0
    assert torch_cli.main(_argv(mini_scenario, tmp_path / "torch" / "out"),
                          device="cpu") == 0
    names = lambda d: sorted(x.name for x in d.iterdir())
    assert names(tmp_path / "torch") == names(tmp_path / "jax")
    assert len(names(tmp_path / "torch")) == 6  # 5 .info + .summary


def test_cli_refuses_without_cuda(mini_scenario, tmp_path, monkeypatch):
    from geneevolve_tpu_torch import cli as torch_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli.main(_argv(mini_scenario, tmp_path / "out"))
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize(
    "extra, item",
    [
        (["--mesh", "auto"], "1.14"),
    ],
)
def test_refuses_flags_outside_slice(mini_scenario, tmp_path, extra, item):
    cfg = parse_args(_argv(mini_scenario, tmp_path / "out") + extra)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        torch_engine.Simulation(cfg, device="cpu", verbose=False)

