"""The port's ledger helpers and sampler (`geneevolve_tpu_torch/core/
segments.py`) against the JAX package.

Deterministic functions are held bit-exact to their JAX counterparts on
the same numpy inputs. The sampler draws from torch generators, which give
other numbers than `jax.random`; its bins are held exact on the uniforms it
drew, and its law is held statistically, each test at a stated p-value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from geneevolve_tpu.core import segments as jseg
from geneevolve_tpu_torch.core import segments as tseg

BIG = tseg.BIG
P_MIN = 1e-4  # each statistical test fails a correct sampler w.p. <= 1e-4
# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


def _mut_rows(rng, n, M, span=5000):
    m = np.full((n, 2, M), BIG, dtype=np.int32)
    for i in range(n):
        for c in range(2):
            k = rng.integers(0, M + 1)
            m[i, c, :k] = np.sort(rng.choice(span, size=k, replace=False))
    return m


@pytest.mark.parametrize("n, M, Mn, K, cap", [
    (400, 9, 4, 6, 12), (300, 5, 3, 3, 5), (200, 12, 6, 8, 30),
])
def test_inherit_mutations_exact(n, M, Mn, K, cap):
    rng = np.random.default_rng(n + M)
    par = _mut_rows(rng, n, M)
    # crossovers unsorted, some at mutation positions
    xo = np.full((n, K), BIG, dtype=np.int32)
    for i in range(n):
        c = rng.integers(0, K + 1)
        pts = rng.integers(0, 5000, size=c)
        if c and par[i, 0, 0] < BIG:
            pts[0] = par[i, 0, 0]
        xo[i, :c] = pts
    # de novo points, some repeating a parent mutation or each other
    new = np.full((n, Mn), BIG, dtype=np.int32)
    for i in range(n):
        c = rng.integers(0, Mn + 1)
        pts = rng.integers(0, 5000, size=c)
        if c >= 2:
            pts[1] = pts[0]
        if c >= 3 and par[i, 1, 0] < BIG:
            pts[2] = par[i, 1, 0]
        new[i, :c] = pts
    sh = rng.integers(0, 2, size=n).astype(np.int32)
    got = tseg.inherit_mutations(torch.as_tensor(par), torch.as_tensor(xo),
                                 torch.as_tensor(sh), torch.as_tensor(new),
                                 cap)
    want = jseg.inherit_mutations(jnp.asarray(par), jnp.asarray(xo),
                                  jnp.asarray(sh), jnp.asarray(new), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hap_dtype", [torch.int16, torch.int32])
def test_init_gen0_ledger_exact(hap_dtype):
    starts = np.array([0, 1000, 50_000])
    st, hap = tseg.init_gen0_ledger_stacked(
        7, starts, 20, 9, hap_dtype=hap_dtype, rows=11, device="cpu"
    )
    jst, jhap = jseg.init_gen0_ledger_stacked(
        7, starts, 20, 9, hap_dtype={torch.int16: jnp.int16,
                                     torch.int32: jnp.int32}[hap_dtype],
        rows=11,
    )
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(hap.numpy(), np.asarray(jhap))
    assert hap.dtype == hap_dtype
    np.testing.assert_array_equal(
        tseg.empty_mutations_stacked(3, 11, 4, device="cpu").numpy(),
        np.asarray(jseg.empty_mutations_stacked(3, 11, 4)),
    )


def _map(K=1200, width=50_000, seed=0):
    rng = np.random.default_rng(seed)
    mass = rng.exponential(size=K) * 1e-3
    mass[rng.random(K) < 0.3] = 0.0
    mass[0] = 0.0
    cum = np.cumsum(mass).astype(np.float32)
    bp = (np.arange(K) * width).astype(np.int32)
    return cum, bp, width


def test_sampler_bins_exact_on_shared_u(monkeypatch):
    """The bins the sampler used equal JAX's searchsorted on the very
    uniforms it drew, and every position lies in its bin."""
    cum, bp, width = _map()
    seen = {}
    real = tseg.cdf_bins

    def spy(u, c):  # the stacked call, C = 1
        bins = real(u, c)
        seen["u"], seen["bins"] = u[0].clone(), bins[0].clone()
        return bins

    monkeypatch.setattr(tseg, "cdf_bins", spy)
    g = torch.Generator().manual_seed(5)
    pos = tseg.sample_point_process(
        g, 3000, 12, torch.as_tensor(cum), float(cum[-1]),
        torch.as_tensor(bp), float(width), False,
    ).numpy()
    u = seen["u"].numpy()
    want = np.minimum(
        np.asarray(jnp.searchsorted(jnp.asarray(cum), jnp.asarray(u),
                                    side="right")), len(cum) - 1)
    bins = seen["bins"].numpy()
    np.testing.assert_array_equal(bins, want)
    live = pos < BIG
    assert live.any()
    assert np.all(pos[live] >= bp[bins[live]])
    assert np.all(pos[live] < bp[bins[live]] + width)


@pytest.mark.parametrize("affine", [False, True])
def test_sampler_law(affine):
    """Poisson(lambda) counts, bin hits proportional to bin mass, offsets
    uniform within the bin (affine anchors give the same positions law)."""
    cum, bp, width = _map(seed=1)
    lam = float(cum[-1])
    n = 20_000
    g = torch.Generator().manual_seed(11)
    kw = dict(bp0=int(bp[0]), bp_step=width) if affine else {}
    pos = tseg.sample_point_process(
        g, n, 40, torch.as_tensor(cum), lam, torch.as_tensor(bp),
        float(width), False, **kw,
    ).numpy()
    live = pos < BIG
    counts = live.sum(1)
    # mean count: normal approximation, two-sided p
    z = (counts.mean() - lam) / np.sqrt(lam / n)
    assert 2 * stats.norm.sf(abs(z)) > P_MIN, z
    # points are a left-aligned prefix of each row
    assert np.all(live[:, :-1] >= live[:, 1:])
    # bin hits vs mass, pooled into 20 equal-mass groups
    bins = pos[live] // width
    edges = np.searchsorted(cum, np.linspace(0, lam, 21)[1:-1], side="right")
    obs = np.bincount(np.searchsorted(edges, bins, side="right"),
                      minlength=20)
    mass = np.diff(np.concatenate([[0.0], cum[edges - 1], [lam]]))
    exp = mass / mass.sum() * obs.sum()
    assert stats.chisquare(obs, exp).pvalue > P_MIN
    # offsets uniform in [0, width)
    off = pos[live] % width
    assert stats.kstest(off / width, "uniform").pvalue > P_MIN


@pytest.mark.parametrize("inclusive, affine", [(False, False), (False, True),
                                               (True, False)])
def test_stacked_sampler_equals_per_chromosome(inclusive, affine):
    """C chromosomes sampled at once (one stacked bins call) equal C
    one-chromosome calls on identically seeded generators, a zero-rate
    chromosome included (it draws nothing)."""
    maps = [_map(K=900, seed=1), _map(K=1200, seed=2), _map(K=600, seed=3)]
    K = max(len(c) for c, _, _ in maps)
    pad = lambda a: np.concatenate([a, np.full(K - len(a), a[-1])])
    cum = torch.as_tensor(np.stack([pad(c) for c, _, _ in maps]))
    bp = torch.as_tensor(np.stack([pad(b) for _, b, _ in maps]))
    lam = np.array([float(c[-1]) for c, _, _ in maps] + [0.0], np.float32)
    cum = torch.cat([cum, cum[:1]])
    bp = torch.cat([bp, bp[:1]])
    width = np.full(4, 50_000.0 if not inclusive else 0.0, np.float32)
    kw = dict(bp0=np.zeros(4, np.int32),
              bp_step=np.full(4, 50_000, np.int32)) if affine else {}
    seeds = [11, 12, 13, 14]
    got = tseg.sample_point_process_stacked(
        [torch.Generator().manual_seed(x) for x in seeds], 700, 9, cum, lam,
        bp, width, inclusive, **kw)
    assert got.shape == (4, 700, 9)
    for c, x in enumerate(seeds):
        one = tseg.sample_point_process(
            torch.Generator().manual_seed(x), 700, 9, cum[c], float(lam[c]),
            bp[c], float(width[c]), inclusive,
            **({k: int(v[c]) for k, v in kw.items()}))
        assert torch.equal(got[c], one), c
    assert bool((got[3] == BIG).all()) and bool((got[:3] < BIG).any())


def _torch_chain(gen, n, cap, cum, lam, bp, width, inclusive, bp0=None,
                 bp_step=None):
    """One chromosome's points as a chain of torch ops: the draws, then
    the scan, the inverse-CDF bins and the placement, each op as the
    benchmark's check draws the plan again."""
    if lam <= 0.0:
        return torch.full((n, cap), BIG, dtype=torch.int32)
    rate = torch.full((n,), float(lam), dtype=torch.float32)
    counts = torch.poisson(rate, generator=gen).clamp_max(cap).long()
    unif = torch.rand((n, cap + 1), generator=gen)
    s = torch.cumsum(-torch.log1p(-unif), dim=1)
    denom = s.gather(1, counts[:, None])
    u = s[:, :cap] / torch.clamp(denom, min=1e-30) * cum[-1]
    bins = torch.searchsorted(cum, u, right=True).clamp_max(
        cum.shape[0] - 1).to(torch.int32)
    v = torch.clamp(torch.rand((n, cap), generator=gen), max=1.0 - 1e-7)
    if bp0 is not None:
        hi = bp0 + bins * bp_step
        lo = hi - bp_step
    else:
        hi = bp[bins.long()]
        lo = bp[torch.clamp(bins - 1, min=0).long()]
    if inclusive:
        pos = lo + torch.floor(v * (hi - lo + 1).to(torch.float32)).to(
            torch.int32)
    else:
        pos = hi + torch.floor(v * float(width)).to(torch.int32)
    live = torch.arange(cap)[None, :] < counts[:, None]
    return torch.where(live, pos.to(torch.int32), BIG)


@pytest.mark.parametrize("num_rows, row_size, threads", [
    (302_204, 24, 512), (30_708, 12, 512), (20_000, 40, 16), (100, 24, 16),
    (501_500, 24, 512), (100, 1000, 64),
])
def test_torch_scan_threads_mirror(num_rows, row_size, threads):
    """The threads torch's CUDA cumsum puts on a row, as
    `ScanUtils.cuh`'s `get_log_num_threads_x_inner_scan<uint32_t>` gives
    them: the unsigned difference of the logs wraps past ~2^10 rows a
    slot, and the clamp then gives 512."""
    from geneevolve_tpu_torch.ops.point_draws import torch_scan_threads

    assert torch_scan_threads(num_rows, row_size) == threads


@pytest.mark.parametrize("n, cap, inclusive, affine", [
    (3000, 23, False, False), (3000, 23, False, True), (2000, 11, True, False),
    (2000, 11, True, True), (500, 40, False, False),
])
def test_sampler_equals_the_torch_chain(n, cap, inclusive, affine):
    """The one-chromosome and the stacked sampler return, for fixed
    generators, exactly what the chain of torch ops gives (on the CPU
    `point_draws` runs its plain version), a zero-rate chromosome
    included."""
    maps = [_map(K=900, seed=1), _map(K=1200, seed=2), _map(K=600, seed=3)]
    K = max(len(c) for c, _, _ in maps)
    pad = lambda a: np.concatenate([a, np.full(K - len(a), a[-1])])
    cum = torch.as_tensor(np.stack([pad(c) for c, _, _ in maps] + [
        pad(maps[0][0])]))
    bp = torch.as_tensor(np.stack([pad(b) for _, b, _ in maps] + [
        pad(maps[0][1])]))
    lam = np.array([2.0 * float(c[-1]) for c, _, _ in maps] + [0.0],
                   np.float32)
    width = np.full(4, 0.0 if inclusive else 50_000.0, np.float32)
    kw = dict(bp0=np.zeros(4, np.int32),
              bp_step=np.full(4, 50_000, np.int32)) if affine else {}
    seeds = [21, 22, 23, 24]
    got = tseg.sample_point_process_stacked(
        [torch.Generator().manual_seed(x) for x in seeds], n, cap, cum, lam,
        bp, width, inclusive, **kw)
    for c, x in enumerate(seeds):
        one = {k: int(v[c]) for k, v in kw.items()}
        want = _torch_chain(
            torch.Generator().manual_seed(x), n, cap, cum[c], float(lam[c]),
            bp[c], float(width[c]), inclusive, **one)
        assert torch.equal(got[c], want), c
        assert torch.equal(tseg.sample_point_process(
            torch.Generator().manual_seed(x), n, cap, cum[c], float(lam[c]),
            bp[c], float(width[c]), inclusive, **one), want), c
    assert bool((got[:3] < BIG).any()) and bool((got[3] == BIG).all())


def test_mutation_sampler_inclusive_bins():
    """Mutation convention: uniform over [bp[j-1], bp[j]] inclusive."""
    K, step = 400, 1000
    rate = np.full(K, 2.0 / K)
    rate[0] = 0.0
    cum = np.cumsum(rate).astype(np.float32)
    bp = (np.arange(K) * step).astype(np.int32)
    g = torch.Generator().manual_seed(3)
    pos = tseg.sample_point_process(
        g, 5000, 12, torch.as_tensor(cum), float(cum[-1]),
        torch.as_tensor(bp), 0.0, True,
    ).numpy()
    live = pos[pos < BIG]
    assert live.min() >= 0 and live.max() <= bp[-1]
    # endpoints of a bin are reachable: some positions land on an anchor
    assert np.isin(live, bp).any()


def test_zero_rate_gives_padding():
    g = torch.Generator().manual_seed(0)
    out = tseg.sample_point_process(
        g, 10, 4, torch.zeros(3), 0.0, torch.zeros(3, dtype=torch.int32),
        1.0, False,
    )
    assert out.dtype == torch.int32 and bool((out == BIG).all())


def test_generators_are_per_chromosome():
    from geneevolve_tpu_torch.core.rng import Stage, generator

    a = torch.rand(4, generator=generator("cpu", 7, 1, Stage.CROSSOVER, 0, 0))
    b = torch.rand(4, generator=generator("cpu", 7, 1, Stage.CROSSOVER, 0, 0))
    c = torch.rand(4, generator=generator("cpu", 7, 1, Stage.CROSSOVER, 0, 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
