"""The port's kernel modules (`geneevolve_tpu_torch/ops`) against the JAX
package's functions.

On the CPU each wrapper runs its plain version; those are held bit-exact
(all outputs are integers) to the Pallas kernels in interpret mode and to
the JAX segment functions on the same numpy inputs. The CUDA kernels
themselves are held to the plain versions in `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneevolve_tpu.core import segments as jseg
from geneevolve_tpu.ops import cdf_bins_pallas as cbp
from geneevolve_tpu.ops import materialize as jmat
from geneevolve_tpu.ops import merge_count_pallas as mcp
from geneevolve_tpu_torch.core import memory as tmemory
from geneevolve_tpu_torch.core import segments as tseg
from geneevolve_tpu_torch.ops import cdf_bins as tbins
from geneevolve_tpu_torch.ops import gamete_inherit as tinherit
from geneevolve_tpu_torch.ops import materialize as tmat
from geneevolve_tpu_torch.ops import meiose_merge as tmerge
from geneevolve_tpu_torch.ops import merge_count as tcount
from geneevolve_tpu_torch.ops import point_draws as tdraws
from torch_cases import CASES, STACKED_CASES, cdf as _cdf, probes as _probes
from torch_cases import (INHERIT_CASES, INHERIT_PARTS, inherit_case,
                         inherit_planes)
from torch_cases import stacked as _stacked_case

T = torch.as_tensor
# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


def _bins_oracles(cum, u):
    K = len(cum)
    L, c2 = cbp.build_tables(cum)
    pallas = np.asarray(cbp.searchsorted_right(
        jnp.asarray(u), jnp.asarray(L), jnp.asarray(c2), interpret=True,
    ))
    return (np.minimum(pallas, K - 1),
            np.minimum(np.searchsorted(cum, u, side="right"), K - 1))


@pytest.mark.parametrize("K", [7, 128, 1000, 4096, 5120])
def test_bins_match_pallas_and_searchsorted(K):
    rng = np.random.default_rng(K)
    cum = _cdf(rng, K)
    u = _probes(rng, cum)
    got = tbins.cdf_bins(T(u[None]), T(cum[None]))[0].numpy()
    assert got.dtype == np.int32
    for want in _bins_oracles(cum, u):
        np.testing.assert_array_equal(got, want)


def test_bins_padded_tail_and_single_bin():
    # padding repeats the last value: counts like searchsorted-right
    cum = np.concatenate([np.cumsum(np.ones(100, np.float32)),
                          np.full(28, 100.0, np.float32)])
    u = np.array([0.0, 0.5, 1.0, 99.0, 99.5, 100.0, 101.0], np.float32)
    for c, q in ((cum, u), (np.float32([2.5]), np.float32([0, 2.4, 2.5, 3]))):
        got = tbins.cdf_bins(T(q[None]), T(c[None]))[0].numpy()
        for want in _bins_oracles(c, q):
            np.testing.assert_array_equal(got, want)


def test_bins_keep_shape():
    rng = np.random.default_rng(1)
    cum = _cdf(rng, 300, flat=0.0)
    u = rng.uniform(0, cum[-1], size=(37, 11)).astype(np.float32)
    got = tbins.cdf_bins(T(u[None]), T(cum[None]))
    assert got.shape == (1, 37, 11)
    np.testing.assert_array_equal(
        got[0].numpy(), np.minimum(np.searchsorted(cum, u, side="right"), 299)
    )


@pytest.mark.parametrize("C, K", [(3, 7), (4, 1000), (22, 130), (2, 1)])
def test_bins_stacked_match_rows_and_jax(C, K):
    """Stacked CDFs (C, K), padded as `StackedMaps` pads them (repeating
    the last value): row c's bins equal the C = 1 call on row c and the JAX
    oracles on row c."""
    rng = np.random.default_rng(C * K)
    cum = np.stack([_cdf(rng, K) for _ in range(C)])
    cum[0, K // 2:] = cum[0, K // 2]  # a short map padded to K
    u = np.stack([_probes(rng, c) for c in cum])  # (C, P)
    u3 = u.reshape(C, -1, 1)  # any trailing shape
    got = tbins.cdf_bins(T(u3), T(cum)).numpy().reshape(C, -1)
    assert got.dtype == np.int32
    for c in range(C):
        one = tbins.cdf_bins(T(u[c:c + 1]), T(cum[c:c + 1]))[0]
        np.testing.assert_array_equal(got[c], one.numpy())
        for want in _bins_oracles(cum[c], u[c]):
            np.testing.assert_array_equal(got[c], want)


def _stacked(seed, nchr, n, S, K, live, hap_dtype=np.int16):
    return _stacked_case(np.random.default_rng(seed), nchr, n, S, K, live,
                         hap_dtype)


def _gametes(st, parents, xo_f, xo_m, sh):
    """Each chromosome's and parent's JAX operands: (c, g, parent rows of
    chromosome c, crossovers, starts)."""
    for c in range(st.shape[0]):
        for g, xo in enumerate((xo_f, xo_m)):
            yield c, g, st[c][parents[g]], xo[c], sh[c, :, g]


def _check_count(st, parents, xo_f, xo_m, sh):
    """The stacked count equals the JAX count and the Pallas kernel in
    interpret mode for every chromosome and parent."""
    got = tcount.merge_count(T(st), T(parents), T(xo_f), T(xo_m),
                             T(sh)).numpy()
    assert got.shape == xo_f.shape[:2] + (2,) and got.dtype == np.int32
    for c, g, rows, xo, start in _gametes(st, parents, xo_f, xo_m, sh):
        n, _, S = rows.shape
        xla = np.asarray(jseg.count_merge_valid(
            jnp.asarray(rows), jnp.asarray(xo), jnp.asarray(start)))
        pallas = np.asarray(mcp.count_merge_valid_pallas(
            jnp.asarray(rows.reshape(n, 2 * S)), jnp.asarray(xo),
            jnp.asarray(start), interpret=True))
        np.testing.assert_array_equal(got[c, :, g], xla)
        np.testing.assert_array_equal(got[c, :, g], pallas)


def _check_merge(st, hap, parents, xo_f, xo_m, sh, cap, merge_ibd):
    """The stacked merge equals the JAX `meiose` (`merge3_T`) for every
    chromosome and parent; returns the JAX uncapped counts."""
    got = tmerge.meiose_merge(T(st), T(hap), T(parents), T(xo_f), T(xo_m),
                              T(sh), cap, merge_ibd)
    nchr, n = xo_f.shape[:2]
    assert [tuple(x.shape) for x in got] == [(nchr, n, 2, cap)] * 2 + [
        (nchr, n, 2)]
    assert got[1].dtype == torch.from_numpy(hap).dtype
    counts = []
    for c, g, rows, xo, start in _gametes(st, parents, xo_f, xo_m, sh):
        want = jseg.meiose(jnp.asarray(rows), jnp.asarray(hap[c][parents[g]]),
                           jnp.asarray(xo), jnp.asarray(start), cap,
                           merge_ibd)
        for x, w in zip(got, want):
            np.testing.assert_array_equal(x[c, :, g].numpy(), np.asarray(w))
        counts.append(np.asarray(want[2]))
    return np.concatenate(counts)


@pytest.mark.parametrize("n, S, K, live", CASES)
def test_count_matches_pallas_and_xla(n, S, K, live):
    st, _, *rest = _stacked(n + S, 1, n, S, K, live)
    _check_count(st, *rest)


@pytest.mark.parametrize("nchr, n, S, K, live", STACKED_CASES)
def test_stacked_count_matches_pallas_and_xla(nchr, n, S, K, live):
    """Several chromosomes and both parents in one call; K past 32 and S
    past 64 (the warp kernel's second crossover a lane and several
    32-slot words)."""
    st, _, *rest = _stacked(nchr * n + S, nchr, n, S, K, live)
    _check_count(st, *rest)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.uint8])
def test_gather_matches_jax(dtype):
    rng = np.random.default_rng(7)
    table = rng.integers(0, 100, size=(90, 2, 13)).astype(dtype)
    idx = rng.integers(0, 90, size=200).astype(np.int32)
    got = tmat.gather_rows(T(table), T(idx)).numpy()
    want = np.asarray(jmat.gather_rows(jnp.asarray(table), jnp.asarray(idx)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype, R", [(np.int16, (2, 13)), (np.int32, (2, 27)),
                                      (np.uint8, (2, 100)), (np.uint8, (3,))])
def test_gather_stacked_matches_jax(dtype, R):
    """The stacked gather equals `table[:, idx]` and the JAX gather on each
    table."""
    rng = np.random.default_rng(len(R) + R[-1])
    B, n, nc = 5, 90, 200
    table = rng.integers(0, 100, size=(B, n) + R).astype(dtype)
    idx = rng.integers(0, n, size=nc).astype(np.int32)
    got = tmat.gather_rows_stacked(T(table), T(idx)).numpy()
    np.testing.assert_array_equal(got, table[:, idx])
    for b in range(B):
        want = np.asarray(jmat.gather_rows(jnp.asarray(table[b]),
                                           jnp.asarray(idx)))
        assert got[b].dtype == want.dtype
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("merge_ibd", [True, False])
@pytest.mark.parametrize("n, S, K, live", CASES)
def test_merge_matches_meiose(n, S, K, live, merge_ibd):
    args = _stacked(3 * n + K, 1, n, S, K, live)
    _check_merge(*args, S + K, merge_ibd)  # room for every boundary


def test_merge_truncates_like_meiose():
    """A cap below the boundary count: both keep the first `cap` slots and
    report the uncapped count (the kept count without `merge_ibd`)."""
    args = _stacked(11, 1, 200, 16, 9, 16, hap_dtype=np.int32)
    for merge_ibd in (True, False):
        counts = _check_merge(*args, 6, merge_ibd)
        if merge_ibd:
            assert (counts > 6).any()


@pytest.mark.parametrize("merge_ibd", [True, False])
@pytest.mark.parametrize("nchr, n, S, K, live", STACKED_CASES)
def test_stacked_merge_matches_meiose(nchr, n, S, K, live, merge_ibd):
    args = _stacked(nchr * n + K, nchr, n, S, K, live)
    _check_merge(*args, S + K, merge_ibd)


@pytest.mark.parametrize("merge_ibd", [True, False])
@pytest.mark.parametrize("S, K, cap", [(49, 23, 12), (130, 64, 40)])
def test_stacked_merge_truncates_like_meiose(S, K, cap, merge_ibd):
    """Caps below many gametes' counts, over several 32-slot words of the
    output row; without `merge_ibd` the kept entries of the cut row."""
    args = _stacked(S + cap, 3, 40, S, K, S - 8)
    counts = _check_merge(*args, cap, merge_ibd)
    if merge_ibd:
        assert (counts > cap).any()


@pytest.mark.parametrize("fn, args", [
    ("cdf_bins", lambda: (torch.zeros(3, dtype=torch.float64),
                          torch.zeros(3))),
    ("merge_count", lambda: (torch.zeros(2, 2, 3, dtype=torch.int32,
                                         device="meta"),) * 5),
    ("meiose_merge", lambda: (torch.zeros(1, 2, 2, 3, dtype=torch.int32,
                                          device="meta"),) * 6 + (3,)),
    ("point_draws", lambda: (torch.zeros(2, 3, dtype=torch.float64),
                             torch.zeros(2, 3, 5), torch.zeros(2, 3, 4),
                             torch.zeros(2, 7),
                             torch.zeros(2, 7, dtype=torch.int32),
                             [1.0, 1.0], [True, True], False)),
    ("point_draws", lambda: (torch.zeros(2, 3), torch.zeros(2, 3, 4),
                             torch.zeros(2, 3, 4), torch.zeros(2, 7),
                             torch.zeros(2, 7, dtype=torch.int32),
                             [1.0, 1.0], [True, True], False)),
    ("gamete_inherit", lambda: (
        torch.zeros(1, 2, 2, 3, dtype=torch.int32, device="meta"), None,
        *(torch.zeros(1, 2, 3, dtype=torch.int32, device="meta"),) * 1,
        torch.zeros(1, 2, dtype=torch.int32, device="meta"),
        torch.zeros(1, 2, 3, dtype=torch.int32, device="meta"),
        torch.zeros(1, 3, dtype=torch.int32, device="meta"),
        torch.zeros(1, 2, 3, dtype=torch.int32, device="meta"), None)),
])
def test_wrappers_reject_bad_inputs(fn, args):
    mod = {"cdf_bins": tbins, "merge_count": tcount,
           "meiose_merge": tmerge, "gamete_inherit": tinherit,
           "point_draws": tdraws}[fn]
    with pytest.raises((TypeError, ValueError)):
        getattr(mod, fn)(*args())


# ----------------------------------------------- gamete inheritance (CPU)
def _inherit_reference(pm, cv, xo, start, new, q, Mo, part):
    """The real pass's composition before `ops/gamete_inherit`:
    `segments.inherit_mutations` and `segments.gamete_cv` a chromosome at
    a time, in one pass."""
    mut, counts, cvs = [], [], []
    for j in range(xo.shape[0]):
        pmj = None if part == "cv" else pm[j]
        if part != "cv":
            m, nv = tseg.inherit_mutations(pm[j], xo[j], start[j], new[j], Mo)
            mut.append(m)
            counts.append(nv)
        if part != "mutations":
            cvs.append(tseg.gamete_cv(cv[j], xo[j], start[j], pmj, new[j],
                                      q[j]))
    stack = (lambda x: torch.stack(x) if x else None)
    return stack(mut), stack(counts), stack(cvs)


def _coincidences(args):
    """Which equalities the drawn operands hold: de novo slots equal to
    each other, to a parent mutation and to a CV; crossovers equal to
    each other, to a CV and to a parent mutation."""
    pm, _, xo, _, new, q = args
    nk, n = xo.shape[:2]

    def meet(a, b):  # some valid a[j, i, :] equal to some b[j, i, :]
        hit = (a[..., :, None] == b[..., None, :]) & (a < BIG)[..., None]
        return bool(hit.any())

    def twice(a):
        s = torch.sort(a, -1).values
        return bool(((s[..., 1:] == s[..., :-1]) & (s[..., 1:] < BIG)).any())

    qs = q[:, None, :].expand(nk, n, -1)
    par = pm.flatten(2)
    return dict(new_new=twice(new), new_parent=meet(new, par),
                new_cv=meet(new, qs), xo_xo=twice(xo), xo_cv=meet(xo, qs),
                xo_parent=meet(xo, par))


BIG = tseg.BIG


@pytest.mark.parametrize("part", INHERIT_PARTS)
@pytest.mark.parametrize("nk, n, K, Mp, mn, C, Mo, span", INHERIT_CASES)
def test_gamete_inherit_plain_equals_composition(nk, n, K, Mp, mn, C, Mo,
                                                 span, part):
    """The op's plain version (the CPU path), written through strided
    [:, :, g] views of child planes, equals `inherit_mutations` and
    `gamete_cv` composed as the engine composed them, for each parent, with
    and without mutation or CV rows; the other parent's slots stay as they
    were."""
    args = inherit_case(torch.Generator().manual_seed(n + K + Mo), nk, n, K,
                        Mp, mn, C, span)
    pm, cv, xo, sh, new, q = args
    for g in range(2):
        out_m, out_c, counts = inherit_planes(tinherit.gamete_inherit, args,
                                              Mo, part, g)
        m, nv, c = _inherit_reference(pm, cv, xo, sh[:, :, g], new, q, Mo,
                                      part)
        if part != "cv":
            assert torch.equal(out_m[:, :, g], m)
            assert torch.equal(counts, nv)
        else:
            assert counts is None
        if part != "mutations":
            assert torch.equal(out_c[:, :, g], c)
        assert (out_m[:, :, 1 - g] == -7).all()
        assert (out_c[:, :, 1 - g] == 9).all()
        if part == "both" and Mo < Mp:
            assert (nv > Mo).any()  # rows cut, counts not
    if span <= 60 and min(K, mn) > 1:  # crowded rows: every equality
        assert all(_coincidences(args).values())


def test_gamete_inherit_plain_row_chunks(monkeypatch):
    """Past `memory.CHUNKED_PAST` gametes (16 here) the plain version runs
    each chromosome over chunks of `GE_REPRO_CHUNK` rows (7 here): the same
    rows and counts as one pass."""
    args = inherit_case(torch.Generator().manual_seed(3), 2, 50, 7, 6, 4, 9,
                        30)
    pm, cv, xo, sh, new, q = args
    monkeypatch.setattr(tmemory, "CHUNKED_PAST", 16)
    monkeypatch.setenv("GE_REPRO_CHUNK", "7")
    calls = []
    chunks = tseg.in_row_chunks

    def rec(fn, chunk, rows, *fixed):
        calls.append(chunk)
        return chunks(fn, chunk, rows, *fixed)

    monkeypatch.setattr(tseg, "in_row_chunks", rec)
    out_m, out_c, counts = inherit_planes(tinherit.gamete_inherit, args, 8,
                                          "both", 1)
    m, nv, c = _inherit_reference(pm, cv, xo, sh[:, :, 1], new, q, 8, "both")
    assert torch.equal(out_m[:, :, 1], m) and torch.equal(counts, nv)
    assert torch.equal(out_c[:, :, 1], c)
    assert calls and set(calls) == {7}
