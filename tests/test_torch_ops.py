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
from geneevolve_tpu_torch.ops import cdf_bins as tbins
from geneevolve_tpu_torch.ops import materialize as tmat
from geneevolve_tpu_torch.ops import meiose_merge as tmerge
from geneevolve_tpu_torch.ops import merge_count as tcount
from torch_cases import BIG, CASES, cdf as _cdf, crossovers as _crossovers
from torch_cases import ledger as _ledger, probes as _probes

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


@pytest.mark.parametrize("n, S, K, live", CASES)
def test_count_matches_pallas_and_xla(n, S, K, live):
    rng = np.random.default_rng(n + S)
    st, _ = _ledger(rng, n, S, live)
    xo = _crossovers(rng, n, K, st)
    sh = rng.integers(0, 2, size=n).astype(np.int32)
    idx = rng.permutation(n).astype(np.int32)
    got = tcount.merge_count(T(st), T(idx), T(xo), T(sh)).numpy()
    rows = st[idx]
    xla = np.asarray(jseg.count_merge_valid(
        jnp.asarray(rows), jnp.asarray(xo), jnp.asarray(sh)))
    pallas = np.asarray(mcp.count_merge_valid_pallas(
        jnp.asarray(rows.reshape(n, 2 * S)), jnp.asarray(xo),
        jnp.asarray(sh), interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


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
    rng = np.random.default_rng(3 * n + K)
    st, hap = _ledger(rng, n, S, live, hap_dtype=np.int16)
    xo = _crossovers(rng, n, K, st)
    sh = rng.integers(0, 2, size=n).astype(np.int32)
    idx = rng.integers(0, n, size=n).astype(np.int32)
    cap = S + K  # room for every boundary: nothing truncated
    got = tmerge.meiose_merge(T(st), T(hap), T(idx), T(xo), T(sh), cap,
                              merge_ibd)
    want = jseg.meiose(jnp.asarray(st[idx]), jnp.asarray(hap[idx]),
                       jnp.asarray(xo), jnp.asarray(sh), cap, merge_ibd)
    assert got[1].dtype == torch.int16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_merge_truncates_like_meiose():
    """A cap below the boundary count: both keep the first `cap` slots and
    report the uncapped count."""
    rng = np.random.default_rng(11)
    st, hap = _ledger(rng, 200, 16, 16)
    xo = _crossovers(rng, 200, 9, st)
    sh = rng.integers(0, 2, size=200).astype(np.int32)
    idx = np.arange(200, dtype=np.int32)
    for merge_ibd in (True, False):
        got = tmerge.meiose_merge(T(st), T(hap), T(idx), T(xo), T(sh), 6,
                                  merge_ibd)
        want = jseg.meiose(jnp.asarray(st), jnp.asarray(hap),
                           jnp.asarray(xo), jnp.asarray(sh), 6, merge_ibd)
        if merge_ibd:
            assert (np.asarray(want[2]) > 6).any()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn, args", [
    ("cdf_bins", lambda: (torch.zeros(3, dtype=torch.float64),
                          torch.zeros(3))),
    ("merge_count", lambda: (torch.zeros(2, 2, 3, dtype=torch.int32,
                                         device="meta"),) * 4),
])
def test_wrappers_reject_bad_inputs(fn, args):
    mod = {"cdf_bins": tbins, "merge_count": tcount}[fn]
    with pytest.raises((TypeError, ValueError)):
        getattr(mod, fn)(*args())
