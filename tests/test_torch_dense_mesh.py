"""The port's dense backend under `--mesh` on gloo CPU ranks (mirrors
`tests/test_dense_backend.py:108` `test_dense_cli_mesh_bit_identical` and
`:136` `test_put_plane_shards_only_packed_word_axis`).

Each 'ind' rank holds a block of the planes' rows, each 'loci' rank a
window of the packed words (the CV matrices whole). Tolerance 0 (byte
identity) against the port's one-device dense run, for every file the
run writes (`.summary`, `.info`, `.hap`/`.indv`, `.vcf`, `.ped`/`.map`):

- the CLI's `--backend dense --mesh ind=2` and `--mesh ind=1,loci=2` on
  `mini_scenario` (2 chromosomes of 7 words: whole chromosomes a loci
  rank), with `--checkpoint_every 3`, and 4 ranks at (2, 2) for each
  scenario below and this one;
- three chromosomes of 256 SNPs (8 words each, 12 a loci rank: the middle
  chromosome cut in half) with ~1 de novo mutation a gamete and
  chromosome, at (1, 2) and (2, 1);
- two populations with migration (`tests/test_torch_multipop.py`'s duo,
  without `--gamma`: under a mesh its moments are f32 device sums) at
  (2, 1);
- checkpoints: the files of every layout hold the same arrays; the
  2-rank checkpoint resumed on one device and at (1, 2), and the
  one-device checkpoint at (2, 1), write the straight run's files.

Fed the JAX `DenseSimulation(mesh=8 devices)` run's mating plans, draws
and plane rows (a multiple of 8, JAX's mesh padding), the 2-rank run's
planes (their first n rows) and CV matrices equal JAX's every
generation, its `.hap` files byte for byte; `.info`/`.summary` agree
within `test_torch_engine.py`'s tolerance. `plane_block`, the layout rule,
is held to JAX's `_put_plane` without ranks. Every launch of ranks runs
under a deadline (the fixture's runs share one budget).

Without ranks: a loci window's pieces (`parallel.mesh.loci_pieces`) cover
it in at most three, and the window entries of kernels 4 and 5 (plain
versions) run once a piece over every window equal the JAX package's
whole-plane meioses, bit for bit.
"""

import filecmp
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist
from geneevolve_tpu.dense import packed as jpk
from geneevolve_tpu.dense import step as jstep
from geneevolve_tpu_torch import cli
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import mating
from geneevolve_tpu_torch.dense import backend as tbackend
from geneevolve_tpu_torch.ops import meiose_planes as tplanes
from geneevolve_tpu_torch.parallel import launch
from geneevolve_tpu_torch.parallel import mesh as pm
from geneevolve_tpu_torch.parallel.mesh import Mesh as TorchMesh
from test_torch_dense import JaxDenseRun
from test_torch_engine import _argv, _assert_table_close
from test_torch_multipop import duo_argv, make_duo
from torch_cases import dense_plan, foreign_slots, mutation_loci

torch.set_num_threads(1)
BUDGET_S = 300  # every run of the `runs` fixture, one-device runs included
DENSE = ["--backend", "dense"]
MINI_OUT = ["--out_hap", "--out_vcf", "--out_plink", "--checkpoint_every",
            "3"]


def make_tri(root: Path) -> Path:
    """40 founders, 3 chromosomes x 256 SNPs (8 packed words each), 8 CVs
    a chromosome, 4 generations of ~50, on 4,000-bp chromosomes with a
    20-bp map (1 Morgan each) and a mutation map of rate 0.1 a bin (~1 de
    novo mutation a gamete and chromosome). Returns the scenario's root."""
    rng = np.random.default_rng(11)
    n0, nsnp, ncv, L, w, chrs = 40, 256, 8, 4000, 20, (1, 2, 3)
    cv_rows = []
    with open(root / "hap_address.txt", "w") as fa, \
            open(root / "cv_address.txt", "w") as fc:
        fa.write("chr hap legend sample\n")
        for c in chrs:
            hap = rng.integers(0, 2, size=(nsnp, 2 * n0))
            np.savetxt(root / f"ref.chr{c}.hap", hap, fmt="%d")
            pos = np.sort(rng.choice(np.arange(1, L), nsnp, replace=False))
            with open(root / f"ref.chr{c}.legend", "w") as f:
                f.write("id position a0 a1\n")
                f.writelines(f"rs{c}_{i} {p} A G\n" for i, p in enumerate(pos))
            (root / f"ref.chr{c}.indv").write_text(
                "".join(f"{i + 1}\n" for i in range(n0)))
            cols = np.sort(rng.choice(nsnp, ncv, replace=False))
            np.savetxt(root / f"cv.chr{c}.hap", hap[cols], fmt="%d")
            cv_rows += [(c, pos[i], rng.normal(), 0.1 * rng.normal())
                        for i in cols]
            fa.write(f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                     f"{root}/ref.chr{c}.indv\n")
            fc.write(f"{c} {root}/cv.chr{c}.hap\n")
    (root / "cv.info").write_text("chr pos a d\n" + "".join(
        f"{c} {p} {a} {d}\n" for c, p, a, d in cv_rows))
    (root / "popinfo.txt").write_text(
        "pop_size mat_cor offspring_dist selection_func "
        "selection_func_par1 selection_func_par2\n" + "50 0.2 p thr 1 1\n" * 4)
    bins = [(c, bp) for c in chrs for bp in range(0, L + w, w)]
    (root / "rmap.txt").write_text("chr bp cM\n" + "".join(
        f"{c} {bp} {bp / 40:.6f}\n" for c, bp in bins))
    (root / "mut.txt").write_text("chr bp rate\n" + "".join(
        f"{c} {bp} 0.1\n" for c, bp in bins))
    return root


def _single(argv):
    """The port's one-device dense run (CPU)."""
    tbackend.DenseSimulation(parse_args(argv), device="cpu",
                             verbose=False).run()


def _files(d: Path):
    return sorted(x.name for x in d.iterdir() if not x.name.endswith(".npz"))


def _same_dirs(a: Path, b: Path, names):
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), (a, b, name)


def _port_plan(plan) -> mating.MatingPlan:
    return mating.MatingPlan(father_pos=plan.father_pos,
                             mother_pos=plan.mother_pos, inbred=plan.inbred,
                             child_couple=plan.child_couple)


def _jax_mesh_run(argv):
    """The JAX dense backend on 8 virtual devices, its draws kept, and
    what the port's run needs to be fed them."""
    run = JaxDenseRun(argv, mesh=Mesh(np.array(jax.devices()[:8]), ("ind",)))
    per = len(run.muts) // len(run.mates)
    plans = []
    for i in range(len(run.mates)):
        (xo_p, st_p), (xo_m, st_m) = run.plans[2 * i:2 * i + 2]
        mu = np.stack(run.muts[per * i:per * (i + 1)], 1) if per else None
        plans.append((xo_p, st_p, xo_m, st_m, mu))
    inject = dict(mates=[_port_plan(m) for m in run.mates], plans=plans,
                  rows=[p[0].shape[0] for p in plans])
    return run, inject


@pytest.fixture(scope="module")
def runs(mini_scenario, tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return torch_dist.once(tmp_path_factory, "dense_mesh_runs",
                           lambda: _runs(mini_scenario, tmp_path_factory))


def _runs(mini_scenario, tmp_path_factory):
    """Every run: one-device runs and the JAX run in this process, the
    CLI's mesh runs and one group of ranks for the rest, all within
    BUDGET_S."""
    deadline = time.monotonic() + BUDGET_S
    out = tmp_path_factory.mktemp("dense_mesh")
    tri = make_tri(tmp_path_factory.mktemp("tri"))
    duo = make_duo(tmp_path_factory.mktemp("duo"))
    variants = {  # name -> argv of a prefix
        "mini": lambda d: _argv(mini_scenario, d / "out") + DENSE + MINI_OUT,
        "tri": lambda d: _argv(tri, d / "out", tri / "mut.txt") + DENSE
        + ["--out_hap", "--out_plink01", "--checkpoint_every", "3"],
        "duo": lambda d: duo_argv(duo, d / "out", DENSE + ["--out_hap"]),
    }

    def mk(name):
        d = out / name
        d.mkdir()
        return d

    dirs = {}
    for name, argv in variants.items():
        dirs[name] = mk(name)
        _single(argv(dirs[name]))
    dirs["jax"] = mk("jax")
    run, inject = _jax_mesh_run(_argv(mini_scenario, dirs["jax"] / "out")
                                + DENSE + ["--out_hap"])
    # the CLI starts its own ranks
    for name, spec in (("mini_ind2", "ind=2"), ("mini_loci2", "ind=1,loci=2")):
        dirs[name] = mk(name)
        left = deadline - time.monotonic()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(launch, "launch", _deadline_launch(left))
            assert cli.main(variants["mini"](dirs[name])
                            + ["--mesh", spec], device="cpu") == 0
    ranked = []  # (name, shape, argv, inject, keep states)
    for name, shape in (("tri_loci2", (1, 2)), ("tri_ind2", (2, 1)),
                        ("duo_ind2", (2, 1))):
        dirs[name] = mk(name)
        ranked.append((name, shape, variants[name.split("_")[0]](dirs[name]),
                       None, False))
    dirs["fed"] = mk("fed")
    ranked.append(("fed", (2, 1), _argv(mini_scenario, dirs["fed"] / "out")
                   + DENSE + ["--out_hap"], inject, True))
    ck = "out.ckpt.npz"
    for name, src, shape in (("resumed_loci2", "mini_ind2", (1, 2)),
                             ("resumed_ind2", "mini", (2, 1))):
        dirs[name] = mk(name)
        ranked.append((name, shape, variants["mini"](dirs[name])
                       + ["--resume", str(dirs[src] / ck)], None, False))
    jax_state = {k: v for k, v in run.states[2].items()
                 if k in ("n", "hap", "cv")}
    carried = [dict(shape=s, roundtrip=jax_state) for s in ((2, 1), (1, 2))]
    res = torch_dist.launch_by(deadline, torch_dist.dense_runs, 2, (
        [dict(shape=s, argv=a, inject=i, states=k)
         for _, s, a, i, k in ranked] + carried,))
    # both axes at once: 4 ranks at (2, 2)
    grid = []
    for name in ("mini", "tri", "duo"):
        dirs[f"{name}_grid"] = mk(f"{name}_grid")
        grid.append(dict(shape=(2, 2), argv=variants[name](
            dirs[f"{name}_grid"])))
    res4 = torch_dist.launch_by(deadline, torch_dist.dense_runs, 4, (grid,))
    dirs["resumed_single"] = mk("resumed_single")
    _single(variants["mini"](dirs["resumed_single"])
            + ["--resume", str(dirs["mini_ind2"] / ck)])
    return dict(dirs=dirs, res=res, res4=res4, jax_states=run.states,
                names=[r[0] for r in ranked] + ["carried_ind2",
                                                "carried_loci2"])


def _deadline_launch(left: float):
    real = launch.launch

    def fn(*a, **k):
        return real(*a, **k, timeout_s=left,
                    pg_timeout_s=torch_dist.PG_TIMEOUT_S)

    return fn


@pytest.mark.parametrize("name, ref", [
    ("mini_ind2", "mini"), ("mini_loci2", "mini"), ("tri_loci2", "tri"),
    ("tri_ind2", "tri"), ("duo_ind2", "duo"), ("mini_grid", "mini"),
    ("tri_grid", "tri"), ("duo_grid", "duo")])
def test_dense_mesh_byte_identical(runs, name, ref):
    d = runs["dirs"]
    names = _files(d[ref])
    assert names == _files(d[name])
    geno = [x for x in names if x.rsplit(".", 1)[-1] in
            ("hap", "indv", "vcf", "ped", "map")]
    assert geno and any(x.startswith("out.info.") for x in names)
    _same_dirs(d[ref], d[name], names)


def test_dense_mesh_splits_planes(runs):
    """The planes really were split: rows over 'ind', words over 'loci'
    (3 chromosomes of 8 words: 12 a loci rank)."""
    got = dict(zip(runs["names"], runs["res"][0]))
    assert got["tri_loci2"]["block"][2] == 12
    assert got["tri_ind2"]["block"][2] == 24
    assert got["tri_ind2"]["block"][0] * 2 >= 50
    for name in ("tri_ind2", "duo_ind2", "fed"):
        t = got[name]["traffic"]
        assert t["calls"] > 0 and t["bytes"] > 0
    for r, ranks in enumerate(runs["res4"]):  # (2, 2): rank r at (r // 2, r % 2)
        rows, _, words = ranks[1]["block"]  # tri
        assert words == 12 and rows * 2 >= 50, (r, ranks[1]["block"])


@pytest.mark.parametrize("name", ["mini_ind2", "mini_loci2", "mini_grid"])
def test_dense_checkpoints_do_not_depend_on_layout(runs, name):
    d = runs["dirs"]
    z1 = np.load(d["mini"] / "out.ckpt.npz")
    z2 = np.load(d[name] / "out.ckpt.npz")
    assert sorted(z1.files) == sorted(z2.files)
    assert int(z1["gen"]) == 3
    for k in z1.files:
        np.testing.assert_array_equal(z1[k], z2[k], err_msg=k)


@pytest.mark.parametrize("name", ["resumed_single", "resumed_loci2",
                                  "resumed_ind2"])
def test_dense_resume_across_layouts(runs, name):
    d = runs["dirs"]
    _same_dirs(d["mini"], d[name], [
        "out.pop1.summary", "out.info.pop1.gen4.txt",
        "out.pop1.gen4.chr1.hap", "out.pop1.gen4.chr2.hap",
        "out.pop1.gen4.chr1.vcf", "out.pop1.gen4.chr2.ped"])


def test_fed_jax_draws_matches_jax_mesh_run(runs):
    """Planes (first n rows) and CV matrices exact every generation,
    `.hap` files byte for byte, `.info`/`.summary` within tolerance."""
    states = runs["res"][0][runs["names"].index("fed")]["states"]
    want = runs["jax_states"][1:]
    assert len(states) == len(want) == 4
    for gen, (got, w) in enumerate(zip(states, want), start=1):
        n = w["n"]
        assert got["n"] == n
        assert got["hap"].shape[0] == w["hap"].shape[0]  # JAX's rows
        np.testing.assert_array_equal(got["hap"][:n], w["hap"][:n],
                                      err_msg=f"gen {gen} hap")
        for j, c in enumerate(w["cv"]):
            np.testing.assert_array_equal(got[f"dcv{j}"][:n], c[:n],
                                          err_msg=f"gen {gen} cv {j}")
    d = runs["dirs"]
    for c in (1, 2):
        for ext in ("hap", "indv"):
            name = f"out.pop1.gen4.chr{c}.{ext}"
            assert filecmp.cmp(d["fed"] / name, d["jax"] / name,
                               shallow=False), name
    for gen in range(5):
        name = f"out.info.pop1.gen{gen}.txt"
        _assert_table_close(d["fed"] / name, d["jax"] / name)
    _assert_table_close(d["fed"] / "out.pop1.summary",
                        d["jax"] / "out.pop1.summary")


@pytest.mark.parametrize("name", ["carried_ind2", "carried_loci2"])
def test_jax_planes_carried_onto_ranks_and_back(runs, name):
    """A JAX mesh run's generation-2 state (uint32 words, rows padded to
    8) onto two ranks (`convert.dense_shard_from_numpy`) and back
    (`dense_shard_to_numpy`), unchanged; each rank holds its part."""
    want = runs["jax_states"][2]
    rows, mw = want["hap"].shape[0], want["hap"].shape[2]
    i = runs["names"].index(name)
    for r, res in enumerate(runs["res"]):
        got = res[i]
        assert got["block"] == ((rows // 2, 2, mw) if name == "carried_ind2"
                                else (rows, 2, mw // 2))
        back = got["back"]
        assert back["n"] == want["n"] and back["hap"].dtype == np.uint32
        np.testing.assert_array_equal(back["hap"], want["hap"])
        for a, b in zip(back["cv"], want["cv"]):
            np.testing.assert_array_equal(a, b)


def _coords(i, j):
    return {"ind": i, "loci": j}


def test_plane_block_shards_only_packed_word_axis():
    """At (4, 2): the packed words split over 'loci' (4 of 8 a rank), rows
    over 'ind' (3 of 12); a (12, 2, 7) CV matrix (ncv 7, which 2 does not
    divide) stays whole on 'loci'; ragged rows are edge-padded."""
    dims = {"ind": 4, "loci": 2}
    for i in range(4):
        for j in range(2):
            rows, last = tbackend.plane_block((12, 2, 8), torch.int32, dims,
                                              _coords(i, j))
            np.testing.assert_array_equal(rows, np.arange(3 * i, 3 * i + 3))
            assert (last.start, last.stop) == (4 * j, 4 * j + 4)
            rows_cv, last = tbackend.plane_block((12, 2, 7), torch.uint8,
                                                 dims, _coords(i, j))
            np.testing.assert_array_equal(rows_cv, rows)
            assert last == slice(None)
    words = np.arange(12 * 2 * 8, dtype=np.uint32).reshape(12, 2, 8)
    parts = [[words[tbackend.plane_block(words.shape, words.dtype, dims,
                                         _coords(i, j))[0]][
        ..., tbackend.plane_block(words.shape, words.dtype, dims,
                                  _coords(i, j))[1]]
        for j in range(2)] for i in range(4)]
    np.testing.assert_array_equal(
        np.concatenate([np.concatenate(p, 2) for p in parts]), words)
    rows, _ = tbackend.plane_block((10, 2, 8), torch.int32, dims,
                                   _coords(3, 0))
    np.testing.assert_array_equal(rows, [9, 9, 9])


@pytest.mark.parametrize("dtype", [torch.int32, np.uint32])
def test_plane_block_refuses_words_that_do_not_split(dtype):
    with pytest.raises(ValueError, match=r"dimension 2 should be divisible "
                       r"by 2, but it is equal to 7 \(full shape: "
                       r"\(12, 2, 7\)\)"):
        tbackend.plane_block((12, 2, 7), dtype, {"ind": 4, "loci": 2},
                             _coords(0, 0))


def test_dense_mesh_refuses_word_count(mini_scenario, tmp_path):
    """mini_scenario's 14 words do not split over 4 loci ranks: refused
    at construction, before any collective, naming the word count."""
    mesh = TorchMesh(("ind", "loci"), (1, 4), (0, 0), {},
                     torch.device("cpu"))
    cfg = parse_args(_argv(mini_scenario, tmp_path / "out") + DENSE)
    with pytest.raises(ValueError, match="divisible by 4, but it is equal "
                       "to 14"):
        tbackend.DenseSimulation(cfg, device="cpu", verbose=False,
                                 mesh=mesh)


# ---------------------------------------------- the pieces of a loci window
# (n_chr, chr_len, loci): every window cuts chromosomes somewhere
PIECE_CASES = [(3, 64, 2), (3, 128, 4), (5, 96, 3), (1, 2048, 4),
               (2, 224, 2)]


def _windows(n_chr, chr_len, loci):
    m_loc = n_chr * chr_len // loci
    return [(j * m_loc, m_loc, pm.loci_pieces(n_chr, chr_len, j * m_loc,
                                              m_loc)) for j in range(loci)]


@pytest.mark.parametrize("n_chr, chr_len, loci", PIECE_CASES)
def test_loci_pieces_cover_each_window(n_chr, chr_len, loci):
    """Each window is its pieces end to end: at most three, whole
    chromosomes in one, partial ones alone, each inside its chromosome."""
    for lo, m_loc, pieces in _windows(n_chr, chr_len, loci):
        assert 1 <= len(pieces) <= 3
        at = 0
        for pc in pieces:
            assert pc.lo == at
            at += pc.m
            assert 0 <= pc.c0 and pc.c0 + pc.n_chr <= n_chr
            if pc.n_chr > 1 or pc.length == chr_len:
                assert (pc.off, pc.length) == (0, chr_len)
            else:
                assert 0 < pc.length < chr_len
                assert pc.off + pc.length <= chr_len
            assert pc.c0 * chr_len + pc.off == lo + pc.lo  # global locus
        assert at == m_loc
        assert sum(p.n_chr > 1 or p.length == chr_len for p in pieces) <= 1


@pytest.mark.parametrize("n_chr, chr_len, loci", PIECE_CASES)
def test_meiose_window_equals_jax_planes(n_chr, chr_len, loci):
    """`meiose_window` (one window entry launch a piece, plain versions
    here) over every loci rank's window, the windows side by side, equals
    the JAX package's whole-plane packed meiosis with mutations: unsorted
    slots, several crossovers in a word, foreign slots (a chromosome's
    slot at the last column of the one before, which flips all of it)."""
    rng = np.random.default_rng(n_chr * chr_len + loci)
    N, n, K, Km, m = 24, 17, 5, 4, n_chr * chr_len
    hap = rng.integers(0, 2**32, size=(N, 2, m // 32), dtype=np.uint64) \
        .astype(np.uint32)
    f = rng.integers(0, N, n).astype(np.int32)
    mo = rng.integers(0, N, n).astype(np.int32)
    xo_p, st_p = dense_plan(rng, n, n_chr, chr_len, K)
    xo_m, st_m = dense_plan(rng, n, n_chr, chr_len, K)
    if n_chr > 1:
        xo_p, xo_m = (foreign_slots(x, chr_len) for x in (xo_p, xo_m))
    mu = mutation_loci(rng, n, m, Km)
    cfg = jpk.PackedConfig(n=n, m=m, n_chr=n_chr)
    want = np.stack([
        np.asarray(jpk.apply_mutations_packed(
            jpk.meiose_packed_xla(jnp.asarray(hap), jnp.asarray(p),
                                  jnp.asarray(x), jnp.asarray(s), cfg),
            jnp.asarray(mu[:, g])))
        for g, (p, x, s) in enumerate(((f, xo_p, st_p), (mo, xo_m, st_m)))],
        1)
    words = torch.from_numpy(hap.view(np.int32))
    plan = [torch.from_numpy(x) for x in (xo_p, st_p, xo_m, st_m)]
    got = [pm.meiose_window(words[:, :, lo // 32:(lo + m_loc) // 32],
                            torch.from_numpy(f), torch.from_numpy(mo), plan,
                            torch.from_numpy(mu), pieces, chr_len, lo, m_loc)
           for lo, m_loc, pieces in _windows(n_chr, chr_len, loci)]
    np.testing.assert_array_equal(torch.cat(got, 2).numpy().view(np.uint32),
                                  want)


@pytest.mark.parametrize("n_chr, chr_len, loci", [(3, 100, 2), (3, 100, 4),
                                                   (5, 96, 3), (1, 99, 3)])
def test_meiose_planes_windows_equal_jax_planes(n_chr, chr_len, loci):
    """The byte kernel's window entry (plain version), one launch a piece
    of each window, the windows side by side, equals the JAX byte meiosis
    on the whole planes (the byte step's uniform draws: every slot in its
    own chromosome)."""
    rng = np.random.default_rng(n_chr * chr_len + loci)
    N, n, K, m = 24, 17, 5, n_chr * chr_len
    hapA, hapB = (rng.integers(0, 2, (N, m)).astype(np.uint8)
                  for _ in range(2))
    f = rng.integers(0, N, n).astype(np.int32)
    mo = rng.integers(0, N, n).astype(np.int32)
    plans = [dense_plan(rng, n, n_chr, chr_len, K) for _ in range(2)]
    cfg = jstep.DenseConfig(n=n, m=m, n_chr=n_chr)
    want = [np.asarray(jstep._meiose_xla(jnp.asarray(hapA),
                                         jnp.asarray(hapB), jnp.asarray(p),
                                         jnp.asarray(x), jnp.asarray(s),
                                         cfg))
            for p, (x, s) in zip((f, mo), plans)]
    T = torch.from_numpy
    got = [[], []]
    for lo, m_loc, pieces in _windows(n_chr, chr_len, loci):
        outs = [torch.zeros((n, m_loc), dtype=torch.uint8) for _ in range(2)]
        for pc in pieces:
            tplanes.meiose_planes_window(
                T(hapA[:, lo:lo + m_loc].copy()),
                T(hapB[:, lo:lo + m_loc].copy()), *outs, pc.lo, T(f), T(mo),
                *pm.piece_plan(T(plans[0][0]), T(plans[0][1]), pc, chr_len),
                *pm.piece_plan(T(plans[1][0]), T(plans[1][1]), pc, chr_len),
                n_chr=pc.n_chr, chr_len=pc.length)
        for g in range(2):
            got[g].append(outs[g].numpy())
    for g in range(2):
        np.testing.assert_array_equal(np.concatenate(got[g], 1), want[g])
