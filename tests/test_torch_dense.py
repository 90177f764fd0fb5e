"""The PyTorch port's dense engines against the JAX package's, on the CPU.

- Deterministic functions (`pack_bits`, `phase_word_masks`, the packed and
  byte meioses and their split / no-mutation entries, `cv_child`,
  `popcount_dosage`) are held bit-exact (tolerance 0) against the JAX XLA
  functions and, where one exists, the JAX Pallas kernel run in interpret
  mode, on inputs made with numpy from a seed: unsorted crossover slots,
  several crossovers in one word, duplicated loci, pad = m.
- `DenseSimulation` on `mini_scenario` is fed the JAX run's draws (its
  `_sample_gamete_plan` / `_mutation_cols` outputs and mating plans,
  captured by wrapping those functions): planes and CV matrices are
  bit-exact every generation, genotype files byte-identical, `.info` /
  `.summary` within rtol 1e-5 plus a floor of 1e-5 of each column's
  largest magnitude (A and D are f32 row sums taken in another order).
- The port's own sampler is held to its law statistically (within 4
  standard errors).
"""

import filecmp
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geneevolve_tpu.config import parse_args as jax_parse_args
from geneevolve_tpu.core import mating
from geneevolve_tpu.dense import backend as jbackend
from geneevolve_tpu.dense import packed as jpk
from geneevolve_tpu.dense import step as jstep
from geneevolve_tpu_torch.config import parse_args
from geneevolve_tpu_torch.core import convert
from geneevolve_tpu_torch.dense import backend as tbackend
from geneevolve_tpu_torch.dense import packed as tpk
from geneevolve_tpu_torch.dense import step as tstep
from geneevolve_tpu_torch.ops import meiose_packed as tmp
from geneevolve_tpu_torch.ops import meiose_planes as tmpl
from test_torch_engine import _argv, _assert_table_close
from torch_cases import dense_plan as _plan
from torch_cases import foreign_slots
from torch_cases import mutation_loci as _mutations

REPO = Path(__file__).resolve().parent.parent
T = torch.as_tensor
# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def packed_case():
    """n 24 children of N 40 parents, 2 chromosomes x 4,096 loci (the
    Pallas kernel's 4,096-locus unit), K 5, Km 4; every word's bit 31 is
    live."""
    rng = np.random.default_rng(7)
    N, n, n_chr, chr_len, K, Km = 40, 24, 2, 4096, 5, 4
    m = n_chr * chr_len
    hap = rng.integers(0, 2**32, size=(N, 2, m // 32), dtype=np.uint64)
    hap = hap.astype(np.uint32)
    fathers = rng.integers(0, N, size=n).astype(np.int32)
    mothers = rng.integers(0, N, size=n).astype(np.int32)
    xo_p, st_p = _plan(rng, n, n_chr, chr_len, K)
    xo_m, st_m = _plan(rng, n, n_chr, chr_len, K)
    mu = _mutations(rng, n, m, Km)
    return dict(hap=hap, fathers=fathers, mothers=mothers, xo_p=xo_p,
                st_p=st_p, xo_m=xo_m, st_m=st_m, mu=mu, n_chr=n_chr,
                chr_len=chr_len, m=m)


def _torch_args(c):
    return [T(c["hap"].view(np.int32))] + [
        T(c[k]) for k in ("fathers", "mothers", "xo_p", "st_p", "xo_m",
                          "st_m")]


def _jax_args(c):
    return [jnp.asarray(c[k]) for k in ("hap", "fathers", "mothers", "xo_p",
                                        "st_p", "xo_m", "st_m")]


def _jcfg(c):
    return jpk.PackedConfig(n=len(c["fathers"]), m=c["m"], n_chr=c["n_chr"])


def _tcfg(c):
    return tpk.PackedConfig(n=len(c["fathers"]), m=c["m"], n_chr=c["n_chr"])


# ------------------------------------------------------------ bit packing
@pytest.mark.parametrize("shape", [(5, 64), (3, 4, 256), (1, 32)])
def test_pack_roundtrip_bit31(shape):
    """pack/unpack round trip, equal to the JAX words, with bit 31 of every
    word set (no int64 -> int32 overflow cast)."""
    rng = np.random.default_rng(len(shape))
    bits = rng.integers(0, 2, size=shape, dtype=np.uint8)
    bits[..., 31::32] = 1
    got = tpk.pack_bits(T(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got),
                                  np.asarray(jpk.pack_bits(jnp.asarray(bits))))
    assert (got < 0).all()  # bit 31 is the sign bit of every int32 word
    np.testing.assert_array_equal(
        tpk.unpack_bits(got, shape[-1]).numpy(), bits)


# ------------------------------------------------------- kernel plain versions
def test_phase_word_masks_exact(packed_case):
    c = packed_case
    got = tpk.phase_word_masks(T(c["xo_p"]), T(c["st_p"]), _tcfg(c))
    want = jpk.phase_word_masks(jnp.asarray(c["xo_p"]),
                                jnp.asarray(c["st_p"]), _jcfg(c))
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("with_mu", [True, False])
def test_meiose_packed_plain_exact(packed_case, with_mu):
    """Combined layout, with mutations (`meiose_packed_pallas`) and without
    (`tools/kexp.py` v3): the plain version equals the JAX XLA word-mask
    path and the Pallas kernel in interpret mode, bit for bit."""
    from geneevolve_tpu.ops import meiosis_packed_pallas as mpp

    c = packed_case
    mu = c["mu"] if with_mu else None
    got = tmp.meiose_packed(*_torch_args(c), None if mu is None else T(mu),
                            n_chr=c["n_chr"], chr_len=c["chr_len"])
    assert got.dtype == torch.int32 and got.shape == (24, 2, c["m"] // 32)
    hap, f, mo, xo_p, st_p, xo_m, st_m = _jax_args(c)
    cfg = _jcfg(c)
    ref = [jpk.meiose_packed_xla(hap, f, xo_p, st_p, cfg),
           jpk.meiose_packed_xla(hap, mo, xo_m, st_m, cfg)]
    if mu is not None:
        ref = [jpk.apply_mutations_packed(r, jnp.asarray(mu[:, g]))
               for g, r in enumerate(ref)]
    want = np.stack([np.asarray(r) for r in ref], 1)
    np.testing.assert_array_equal(_u32(got), want)
    with pltpu.force_tpu_interpret_mode():
        pal = mpp.meiose_packed_pallas(
            hap, f, mo, xo_p, st_p, xo_m, st_m,
            None if mu is None else jnp.asarray(mu),
            n_chr=c["n_chr"], chr_len=c["chr_len"])
    np.testing.assert_array_equal(_u32(got), np.asarray(pal))


@pytest.mark.parametrize("n_chr, chr_len", [(3, 224), (2, 2016)])
def test_meiose_packed_plain_exact_odd_words(n_chr, chr_len):
    """Chromosomes of a word count that is not a multiple of 4 (7 and 63
    words, as a panel padded to 32 loci gives them; mw % 4 = 1 and 2): the
    plain version, with and without mutations, equals the JAX XLA
    word-mask path bit for bit."""
    rng = np.random.default_rng(chr_len)
    N, n, K, Km = 30, 17, 5, 6
    m = n_chr * chr_len
    hap = rng.integers(0, 2**32, size=(N, 2, m // 32),
                       dtype=np.uint64).astype(np.uint32)
    par = [rng.integers(0, N, size=n).astype(np.int32) for _ in range(2)]
    plans = [_plan(rng, n, n_chr, chr_len, K) for _ in range(2)]
    mu = _mutations(rng, n, m, Km)
    cfg = jpk.PackedConfig(n=n, m=m, n_chr=n_chr)
    for m_ in (mu, None):
        got = tmp.meiose_packed(
            T(hap.view(np.int32)), *(T(x) for x in par),
            *(T(x) for pl in plans for x in pl),
            None if m_ is None else T(m_), n_chr=n_chr, chr_len=chr_len)
        ref = [jpk.meiose_packed_xla(jnp.asarray(hap), jnp.asarray(p),
                                     jnp.asarray(xo), jnp.asarray(st), cfg)
               for p, (xo, st) in zip(par, plans)]
        if m_ is not None:
            ref = [jpk.apply_mutations_packed(r, jnp.asarray(m_[:, g]))
                   for g, r in enumerate(ref)]
        np.testing.assert_array_equal(
            _u32(got), np.stack([np.asarray(r) for r in ref], 1))


def _kexp():
    spec = importlib.util.spec_from_file_location("kexp",
                                                  REPO / "tools" / "kexp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["v2_split", "v3_combined"])
def test_meiose_packed_kexp_layouts_exact(packed_case, variant):
    """The split entry equals `tools/kexp.py`'s `meiose_v2`, the combined
    no-mutation entry its `meiose_v3`, both run in interpret mode."""
    kexp = _kexp()
    c = packed_case
    hap, f, mo, xo_p, st_p, xo_m, st_m = _jax_args(c)
    kw = dict(n_chr=c["n_chr"], chr_len=c["chr_len"])
    R = c["m"] // 32 // 128
    th = _torch_args(c)
    with pltpu.force_tpu_interpret_mode():
        if variant == "v2_split":
            wa, wb = kexp.meiose_v2(hap[:, 0], hap[:, 1], f, mo, xo_p, st_p,
                                    xo_m, st_m, blk_rows=R, **kw)
            want = np.stack([np.asarray(wa), np.asarray(wb)], 1)
        else:
            want = np.asarray(kexp.meiose_v3(
                hap.reshape(-1, 2, R, 128), f, mo, xo_p, st_p, xo_m, st_m,
                blk_rows=1, **kw)).reshape(-1, 2, R * 128)
    if variant == "v2_split":
        ga, gb = tmp.meiose_packed_split(th[0][:, 0], th[0][:, 1], *th[1:],
                                         **kw)
        got = torch.stack([ga, gb], 1)
    else:
        got = tmp.meiose_packed(*th, None, **kw)
    np.testing.assert_array_equal(_u32(got), want)


def test_meiose_planes_plain_exact():
    """The byte meiosis's plain version equals the JAX `_meiose_xla` and
    the Pallas `meiose_planes_pallas` in interpret mode (whose 8,192-locus
    block sets m = 2 x 8,192 here)."""
    from geneevolve_tpu.ops import meiosis_pallas as mp

    rng = np.random.default_rng(11)
    N, n, n_chr, K = 12, 6, 2, 4
    m = 2 * mp.BLOCK_M
    hapA = rng.integers(0, 2, size=(N, m), dtype=np.uint8)
    hapB = rng.integers(0, 2, size=(N, m), dtype=np.uint8)
    f = rng.integers(0, N, size=n).astype(np.int32)
    mo = rng.integers(0, N, size=n).astype(np.int32)
    xo_p, st_p = _plan(rng, n, n_chr, m // n_chr, K)
    xo_m, st_m = _plan(rng, n, n_chr, m // n_chr, K)
    args = (hapA, hapB, f, mo, xo_p, st_p, xo_m, st_m)
    ga, gb = tmpl.meiose_planes(*map(T, args), n_chr=n_chr)
    jargs = [jnp.asarray(a) for a in args]
    cfg = jstep.DenseConfig(n=n, m=m, n_chr=n_chr, xo_cap=K)
    np.testing.assert_array_equal(
        ga.numpy(), np.asarray(jstep._meiose_xla(*jargs[:3], *jargs[4:6],
                                                 cfg)))
    np.testing.assert_array_equal(
        gb.numpy(), np.asarray(jstep._meiose_xla(jargs[0], jargs[1],
                                                 jargs[3], *jargs[6:], cfg)))
    with pltpu.force_tpu_interpret_mode():
        pa, pb = mp.meiose_planes_pallas(*jargs, n_chr=n_chr)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(pb))


def test_phase_batch_and_mutation_flips_exact():
    """`_phase_batch` equals the JAX function; the byte engine's mutation
    XOR (per occurrence) equals the JAX `.at[].add & 1` law."""
    rng = np.random.default_rng(3)
    n, n_chr, chr_len, K = 16, 3, 96, 6
    xo, st = _plan(rng, n, n_chr, chr_len, K)
    m = n_chr * chr_len
    np.testing.assert_array_equal(
        tstep._phase_batch(T(xo), T(st), m, n_chr).numpy(),
        np.asarray(jstep._phase_batch(jnp.asarray(xo), jnp.asarray(st), m,
                                      n_chr)))
    plane = rng.integers(0, 2, size=(n, m), dtype=np.uint8)
    mu = _mutations(rng, n, m, 5)[:, 0]
    want = plane.copy()
    for i, row in enumerate(mu):
        for p in row[row < m]:
            want[i, p] ^= 1
    got = tpk.unpack_bits(tpk.apply_mutations_packed(
        tpk.pack_bits(T(plane)), T(mu)), m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_foreign_slot_phase_exact():
    """A slot of chromosome c at chromosome c-1's last column (the `cdf`
    sampler's rounding case): `_phase_batch` counts it in chromosome c-1
    and `phase_word_masks` flips all of chromosome c, each bit-exact
    (tolerance 0) to the JAX function."""
    rng = np.random.default_rng(13)
    n, n_chr, chr_len, K = 16, 3, 96, 4
    m = n_chr * chr_len
    xo, st = _plan(rng, n, n_chr, chr_len, K)
    xo = foreign_slots(xo, chr_len)
    jxo, jst = jnp.asarray(xo), jnp.asarray(st)
    np.testing.assert_array_equal(
        tstep._phase_batch(T(xo), T(st), m, n_chr).numpy(),
        np.asarray(jstep._phase_batch(jxo, jst, m, n_chr)))
    np.testing.assert_array_equal(
        _u32(tpk.phase_word_masks(T(xo), T(st), tpk.PackedConfig(
            n=n, m=m, n_chr=n_chr))),
        np.asarray(jpk.phase_word_masks(jxo, jst, jpk.PackedConfig(
            n=n, m=m, n_chr=n_chr))))


def test_cv_child_and_popcount_exact(packed_case):
    c = packed_case
    rng = np.random.default_rng(5)
    cv_idx = np.sort(rng.choice(c["m"], 37, replace=False)).astype(np.int32)
    cv_idx[:3] = [0, 31, c["chr_len"]]  # word and chromosome edges
    cv_idx.sort()
    cv_par = jpk.cv_from_planes(jnp.asarray(c["hap"]), jnp.asarray(cv_idx))
    got_par = tpk.cv_from_planes(T(c["hap"].view(np.int32)), T(cv_idx))
    np.testing.assert_array_equal(got_par.numpy(), np.asarray(cv_par))
    for g, (par, xo, st) in enumerate((("fathers", "xo_p", "st_p"),
                                       ("mothers", "xo_m", "st_m"))):
        for mu in (None, c["mu"][:, g]):
            want = jpk.cv_child(cv_par, jnp.asarray(c[par]),
                                jnp.asarray(c[xo]), jnp.asarray(c[st]),
                                None if mu is None else jnp.asarray(mu),
                                jnp.asarray(cv_idx), c["chr_len"])
            got = tpk.cv_child(got_par, T(c[par]), T(c[xo]), T(c[st]),
                               None if mu is None else T(mu), T(cv_idx),
                               c["chr_len"])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resident_cv_matches_children_planes(packed_case):
    """`cv_child` of the parents' CVs equals the CVs read from the child
    planes the meiosis kernel's plain version writes."""
    c = packed_case
    cv_idx = T(np.linspace(0, c["m"] - 1, 50).astype(np.int32))
    args = _torch_args(c)
    mu = T(c["mu"])
    child = tmp.meiose_packed(*args, mu, n_chr=c["n_chr"],
                              chr_len=c["chr_len"])
    cv_par = tpk.cv_from_planes(args[0], cv_idx)
    for g in range(2):
        got = tpk.cv_child(cv_par, args[1 + g], args[3 + 2 * g],
                           args[4 + 2 * g], mu[:, g], cv_idx, c["chr_len"])
        assert torch.equal(got, tpk.popcount_dosage(child[:, g], cv_idx))


# ------------------------------------------------------------------- steps
@pytest.mark.parametrize("cdf_map", [False, True])
def test_byte_step_equals_packed_step(cdf_map):
    """The port's byte step and packed step, driven from identically seeded
    generators (selection and mutations on), agree after unpacking, and
    the packed step's resident CV matrix tracks its planes."""
    pcfg = tpk.PackedConfig(n=40, m=3 * 1024, n_chr=3, xo_cap=6,
                            mut_rate=1.5, mut_cap=5, ncv=24, selection=True)
    dcfg = pcfg.as_dense()
    cdf = None
    if cdf_map:
        mass = np.random.default_rng(0).exponential(size=pcfg.m) * 1.5e-3
        cdf = T(np.cumsum(mass).astype(np.float32))
    g1, g2 = (torch.Generator().manual_seed(9) for _ in range(2))
    d = tstep.init_state(g1, dcfg)
    p = tpk.init_state(g2, pcfg)
    sd, sp = tstep.make_step(dcfg, cdf), tpk.make_step(pcfg, cdf)
    for gen in range(3):
        d, p = sd(d, g1), sp(p, g2)
        for plane, k in ((0, "hapA"), (1, "hapB")):
            assert torch.equal(tpk.unpack_bits(p["hap"][:, plane], pcfg.m),
                               d[k]), (gen, k)
        assert torch.equal(p["cv"], tpk.cv_from_planes(p["hap"],
                                                       p["cv_idx"]))
    assert int(p["clip"]) == int(d["clip"])


def test_packed_step_from_jax_state():
    """A JAX packed state handed over through `packed_state_from_numpy`
    round-trips, and the port's step (couples on) keeps its resident CV
    matrix equal to the planes' CVs."""
    jcfg = jpk.PackedConfig(n=32, m=2048, n_chr=2, xo_cap=6, mut_rate=2.0,
                            mut_cap=6, ncv=16, selection=True, couples=True)
    js = jpk.init_state(jax.random.key(3), jcfg)
    jnp_state = {k: np.asarray(v) for k, v in js.items()}
    st = convert.packed_state_from_numpy(jnp_state, device="cpu")
    back = convert.packed_state_to_numpy(st)
    for k in ("hap", "cv", "cv_idx", "eff"):
        np.testing.assert_array_equal(back[k], jnp_state[k])
        assert back[k].dtype == jnp_state[k].dtype, k
    assert torch.equal(st["cv"], tpk.cv_from_planes(st["hap"], st["cv_idx"]))
    tcfg = tpk.PackedConfig(**{k: getattr(jcfg, k) for k in (
        "n", "m", "n_chr", "xo_cap", "mut_rate", "mut_cap", "ncv",
        "selection", "couples")})
    step = tpk.make_step(tcfg)
    g = torch.Generator().manual_seed(4)
    for _ in range(4):
        st = step(st, g)
        assert torch.equal(st["cv"],
                           tpk.cv_from_planes(st["hap"], st["cv_idx"]))


# ------------------------------------------------------------------ sampler
def test_sampler_crossover_law():
    """Counts per chromosome have mean = the chromosome's map mass (within
    4 standard errors), positions follow the map, slots stay inside their
    chromosome with pad = m after the real ones."""
    n_chr, L, n, K = 3, 512, 6000, 16
    masses = np.array([0.5, 1.2, 2.0])
    dens = np.ones((n_chr, L))
    dens[:, : L // 4] = 3.0  # the first quarter holds half the mass
    mass = dens / dens.sum(1, keepdims=True) * masses[:, None]
    cdf = T(np.cumsum(mass.ravel()).astype(np.float32))
    cfg = tstep.DenseConfig(n=n, m=n_chr * L, n_chr=n_chr, xo_cap=K)
    xo, start, clip = tstep._sample_gamete_plan(
        torch.Generator().manual_seed(1), cfg, n, cdf)
    xo = xo.numpy()
    real = xo < cfg.m
    counts = real.sum(2)
    for c in range(n_chr):
        se = np.sqrt(masses[c] / n)
        assert abs(counts[:, c].mean() - masses[c]) < 4 * se, c
        vals = xo[:, c][real[:, c]]
        assert ((vals >= c * L) & (vals < (c + 1) * L)).all()
        q = (vals < c * L + L // 4).mean()  # expected 0.5
        assert abs(q - 0.5) < 4 * np.sqrt(0.25 / len(vals))
    # real slots are a prefix: no real slot after a pad slot
    assert not (np.diff(real.astype(np.int8), axis=2) > 0).any()
    assert (xo[~real] == cfg.m).all()
    assert set(np.unique(start.numpy())) == {0, 1}
    assert int(clip) == 0


def test_sampler_uniform_law_and_mutations():
    cfg = tstep.DenseConfig(n=5000, m=4 * 256, n_chr=4, morgans_per_chr=1.5,
                            xo_cap=12, mut_rate=0.8, mut_cap=8)
    g = torch.Generator().manual_seed(2)
    xo, _, _ = tstep._sample_gamete_plan(g, cfg, cfg.n)
    counts = (xo < cfg.m).sum(2).double()
    se = np.sqrt(1.5 / cfg.n)
    assert (abs(counts.mean(0) - 1.5) < 4 * se).all()
    for c in range(4):
        vals = xo[:, c][xo[:, c] < cfg.m]
        assert ((vals >= c * 256) & (vals < (c + 1) * 256)).all()
        assert abs(vals.double().mean() - (c * 256 + 127.5)) < 4 * 74 / np.sqrt(len(vals))
    pcfg = tpk.PackedConfig(n=cfg.n, m=cfg.m, n_chr=4, mut_rate=0.8,
                            mut_cap=8)
    pos, clip = tpk.mutation_positions(g, cfg.n, pcfg)
    nm = (pos < cfg.m).sum(1).double()
    assert abs(nm.mean() - 0.8) < 4 * np.sqrt(0.8 / cfg.n)
    assert int(clip) == 0


def test_parent_draw_follows_weights():
    """The selection parent draw (`draw_parents` with logits): each row is
    drawn with its softmax weight (chi-square p-value above 1e-4); a row
    of weight 0 is never drawn."""
    from scipy import stats

    rng = np.random.default_rng(8)
    logits = torch.as_tensor(rng.normal(size=40) * 1.5, dtype=torch.float32)
    logits[7] = -float("inf")
    n = 200_000
    f, m = tstep.draw_parents(torch.Generator().manual_seed(9), n, 40, logits)
    assert f.dtype == m.dtype == torch.int32
    w = torch.softmax(logits, 0).double().numpy()
    for draw in (f, m):
        counts = np.bincount(draw.numpy(), minlength=40)
        assert counts[7] == 0
        keep = w > 0
        assert stats.chisquare(counts[keep], w[keep] / w[keep].sum() * n
                               ).pvalue > 1e-4
    assert not torch.equal(f, m)


def test_clip_counts_only_truncated_draws():
    """The clip count equals the number of Poisson draws above the cap
    (replayed from the same generator), and the real slots number
    min(draw, cap)."""
    cfg = tstep.DenseConfig(n=500, m=2 * 64, n_chr=2, morgans_per_chr=3.0,
                            xo_cap=2)
    xo, _, clip = tstep._sample_gamete_plan(
        torch.Generator().manual_seed(6), cfg, cfg.n)
    raw = torch.poisson(torch.full((cfg.n, 2), 3.0),
                        generator=torch.Generator().manual_seed(6))
    assert int(clip) == int((raw > 2).sum()) > 0
    assert torch.equal((xo < cfg.m).sum(2), raw.clamp(max=2).long())
    # generous caps: nothing clipped; starved caps accumulate over steps
    loose = tpk.PackedConfig(n=64, m=2 * 512, n_chr=2, xo_cap=16,
                             mut_rate=0.5, mut_cap=8, ncv=8)
    g = torch.Generator().manual_seed(0)
    st = tpk.make_step(loose)(tpk.init_state(g, loose), g)
    assert int(st["clip"]) == 0
    tight = tpk.PackedConfig(n=64, m=2 * 512, n_chr=2, morgans_per_chr=4.0,
                             xo_cap=1, mut_rate=4.0, mut_cap=1, ncv=8)
    step = tpk.make_step(tight)
    st = step(tpk.init_state(g, tight), g)
    clips = int(st["clip"])
    assert clips > 0
    assert int(step(st, g)["clip"]) > clips


# ----------------------------------------------------------- dense backend
class JaxDenseRun:
    """A JAX `DenseSimulation` run (on `mesh` when given) with every
    generation's draws, mating plans and states kept (`states` population
    1's, `pop_states` every population's)."""

    def __init__(self, argv, mesh=None):
        self.mates, self.plans, self.muts, self.states = [], [], [], []
        self.pop_states = []
        sample, mcols = jbackend._sample_gamete_plan, jbackend._mutation_cols
        assort = mating.assort_mate

        def sample_rec(*a, **k):
            out = sample(*a, **k)
            self.plans.append(tuple(np.asarray(x) for x in out[:2]))
            return out

        def mcols_rec(*a, **k):
            out = mcols(*a, **k)
            self.muts.append(np.asarray(out))
            return out

        def assort_rec(*a, **k):
            plan = assort(*a, **k)
            self.mates.append(plan)
            return plan

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jbackend, "_sample_gamete_plan", sample_rec)
            mp.setattr(jbackend, "_mutation_cols", mcols_rec)
            mp.setattr(mating, "assort_mate", assort_rec)
            sim = jbackend.DenseSimulation(jax_parse_args(argv),
                                           verbose=False, mesh=mesh)
            sim.init_generation0()
            self._keep(sim)
            for gen in range(1, sim.tot_gen + 1):
                sim.step(gen)
                self._keep(sim)
            sim.write_summary()
            sim.save_genotypes(sim.tot_gen)
        self.sim = sim

    def _keep(self, sim):
        self.n_pop = sim.n_pop
        self.pop_states.append([dict(
            n=st.n, hap=np.asarray(st.hap), cv=[np.asarray(c) for c in st.cv],
            sex=st.sex, ids=st.ids, ped=st.ped, comp=st.comp, mv=st.mv,
            sv=st.sv, svf=st.svf,
        ) for st in (q.state for q in sim.pops)])
        self.states.append(self.pop_states[-1][0])

    def inject(self, tsim):
        """Feed the port this run's mating plans and device draws, those of
        each (generation, population)."""
        def at(p, gen):
            return (gen - 1) * self.n_pop + p.index

        tsim._mate = lambda p, gen, pop_size, g: self.mates[at(p, gen)]
        per = len(self.muts) // len(self.mates)

        def plan(p, gen, n_pad):
            i = at(p, gen)
            (xo_p, st_p), (xo_m, st_m) = self.plans[2 * i:2 * i + 2]
            assert xo_p.shape[0] == n_pad  # same plane-row policy
            mu = (np.stack(self.muts[per * i:per * (i + 1)], 1)
                  if per else None)
            out = (xo_p, st_p, xo_m, st_m, mu)
            return tuple(None if x is None else T(np.array(x)) for x in out)

        tsim._plan = plan


def short_scenario(root: Path) -> Path:
    """`mini_scenario`'s shape (50 founders, 2 chromosomes x 200 SNPs, 10
    CVs each, 4 generations of ~60) on 4,000-bp chromosomes with a 20-bp
    map (1 Morgan each) and a mutation map of rate 0.1 per bin: the dense
    law flips a panel column with the per-bp intensity at its position, so
    these short chromosomes carry ~1 de novo mutation per gamete each."""
    rng = np.random.default_rng(43)
    n0, nsnp, ncv, L, w = 50, 200, 10, 4000, 20
    cv_rows = []
    with open(root / "hap_address.txt", "w") as fa, \
            open(root / "cv_address.txt", "w") as fc:
        fa.write("chr hap legend sample\n")
        for c in (1, 2):
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
            cv_rows += [(c, pos[i], rng.normal()) for i in cols]
            fa.write(f"{c} {root}/ref.chr{c}.hap {root}/ref.chr{c}.legend "
                     f"{root}/ref.chr{c}.indv\n")
            fc.write(f"{c} {root}/cv.chr{c}.hap\n")
    (root / "cv.info").write_text("chr pos a d\n" + "".join(
        f"{c} {p} {a} 0.0\n" for c, p, a in cv_rows))
    (root / "popinfo.txt").write_text(
        "pop_size mat_cor offspring_dist selection_func "
        "selection_func_par1 selection_func_par2\n" + "60 0.2 p thr 1 1\n" * 4)
    bins = [(c, bp) for c in (1, 2) for bp in range(0, L + w, w)]
    (root / "rmap.txt").write_text("chr bp cM\n" + "".join(
        f"{c} {bp} {bp / 40:.6f}\n" for c, bp in bins))
    (root / "mut.txt").write_text("chr bp rate\n" + "".join(
        f"{c} {bp} 0.1\n" for c, bp in bins))
    return root / "mut.txt"


OUT_FLAGS = {"no_mutation": ["--out_hap", "--out_vcf", "--out_plink"],
             "mutation_map": ["--out_hap", "--out_vcf", "--out_plink01"]}


@pytest.fixture(scope="module", params=sorted(OUT_FLAGS))
def dense_runs(request, mini_scenario, tmp_path_factory):
    """The JAX dense run and the port's, fed the JAX draws, on CPU:
    `mini_scenario` without mutations, `short_scenario` with them."""
    out = tmp_path_factory.mktemp(f"dense_{request.param}")
    mmap = None
    if request.param == "mutation_map":
        mini_scenario = out
        mmap = short_scenario(out)
    extra = ["--backend", "dense", *OUT_FLAGS[request.param]]
    (out / "jax").mkdir()
    (out / "torch").mkdir()
    run = JaxDenseRun(_argv(mini_scenario, out / "jax" / "out", mmap) + extra)
    tsim = tbackend.DenseSimulation(
        parse_args(_argv(mini_scenario, out / "torch" / "out", mmap) + extra),
        device="cpu", verbose=False,
    )
    run.inject(tsim)
    tsim.init_generation0()
    states = [convert.dense_state_to_numpy(tsim.pops[0].state)]
    for gen in range(1, tsim.tot_gen + 1):
        tsim.step(gen)
        states.append(convert.dense_state_to_numpy(tsim.pops[0].state))
    tsim.write_summary()
    tsim.save_genotypes(tsim.tot_gen)
    tsim._io_pool.shutdown(wait=True)
    return dict(run=run, tsim=tsim, states=states, out=out,
                mutations=mmap is not None)


def test_dense_backend_planes_bit_exact(dense_runs):
    run, states = dense_runs["run"], dense_runs["states"]
    assert len(states) == len(run.states) == 5
    for gen, (got, want) in enumerate(zip(states, run.states)):
        assert got["n"] == want["n"]
        assert got["hap"].dtype == want["hap"].dtype == np.uint32
        np.testing.assert_array_equal(got["hap"], want["hap"],
                                      err_msg=f"gen {gen} hap")
        for j, (a, b) in enumerate(zip(got["cv"], want["cv"])):
            np.testing.assert_array_equal(a, b, err_msg=f"gen {gen} cv {j}")
    if dense_runs["mutations"]:
        m = run.sim._dp[0].dense_cfg.m
        assert sum((x < m).sum() for x in run.muts) > 100


def test_dense_backend_files(dense_runs):
    """Genotype files byte-identical; `.info` / `.summary` within the
    stated tolerance."""
    jdir, tdir = dense_runs["out"] / "jax", dense_runs["out"] / "torch"
    names = sorted(x.name for x in jdir.iterdir())
    assert names == sorted(x.name for x in tdir.iterdir())
    geno = [x for x in names if x.rsplit(".", 1)[-1] in
            ("hap", "indv", "vcf", "ped", "map")]
    assert len(geno) == 2 * 5  # 2 chromosomes x hap, indv, vcf, ped, map
    for x in geno:
        assert filecmp.cmp(jdir / x, tdir / x, shallow=False), x
    for x in names:
        if x.startswith("out.info.") or x.endswith(".summary"):
            _assert_table_close(tdir / x, jdir / x)


def test_dense_state_roundtrip(dense_runs):
    want = dense_runs["run"].states[2]
    st = convert.dense_state_from_numpy(want, device="cpu")
    assert st.hap.dtype == torch.int32
    back = convert.dense_state_to_numpy(st)
    np.testing.assert_array_equal(back["hap"], want["hap"])
    for a, b in zip(back["cv"], want["cv"]):
        np.testing.assert_array_equal(a, b)
    assert back["n"] == want["n"]


def test_dense_realized_sizes_follow_poisson_law(mini_scenario, tmp_path):
    """The port's own draws: realized sizes ~ Poisson(60), not all equal,
    plane rows reused with headroom (rows >= n)."""
    cfg = parse_args(_argv(mini_scenario, tmp_path / "out")
                     + ["--backend", "dense"])
    sim = tbackend.DenseSimulation(cfg, device="cpu", verbose=False)
    sim.run()
    sizes = [len((tmp_path / f"out.info.pop1.gen{g}.txt").read_text()
                 .splitlines()) - 1 for g in range(1, 5)]
    assert len(set(sizes)) > 1, sizes
    assert all(30 <= s <= 100 for s in sizes), sizes
    st = sim.pops[0].state
    assert st.hap.shape[0] >= st.n
    assert torch.equal(st.cv[0],
                       tpk.cv_from_planes(st.hap, sim.dps[0].cv_cols[0]))


def test_dense_cli_file_set(mini_scenario, tmp_path, monkeypatch):
    """`main(argv, device="cpu")` with `--backend dense` writes the same
    files as the JAX CLI, genotype files of `--file_output_generations`
    included."""
    from geneevolve_tpu import cli as jax_cli
    from geneevolve_tpu_torch import cli as torch_cli

    monkeypatch.setenv("GE_NO_COMPILE_CACHE", "1")
    gens = tmp_path / "gens.txt"
    gens.write_text("2\n4\n")
    extra = ["--backend", "dense", "--out_hap", "--file_output_generations",
             str(gens)]
    for name, main in (("jax", jax_cli.main),
                       ("torch", lambda a: torch_cli.main(a, device="cpu"))):
        (tmp_path / name).mkdir()
        assert main(_argv(mini_scenario, tmp_path / name / "out") + extra) == 0
    names = lambda d: sorted(x.name for x in d.iterdir())
    assert names(tmp_path / "torch") == names(tmp_path / "jax")
    assert "out.pop1.gen2.chr1.hap" in names(tmp_path / "torch")
