"""The streamed packed engine in the PyTorch port
(`geneevolve_tpu_torch.dense.streamed`) on the CPU: the mirrors of
`tests/test_streamed.py`, and one generation from the JAX engine's founder
slabs, fed its parents and per-slab plans, equal to the JAX engine's host
slabs bit for bit."""

import jax
import numpy as np
import torch

from geneevolve_tpu.dense import packed as jpk
from geneevolve_tpu.dense.step import _sample_gamete_plan as jplan
from geneevolve_tpu.dense.streamed import StreamedPacked as JaxStreamed
from geneevolve_tpu_torch.dense.packed import PackedConfig
from geneevolve_tpu_torch.dense.streamed import StreamedPacked

torch.set_num_threads(1)
SHAPE = dict(m=2048 * 4, n_chr=4, morgans_per_chr=1.0, xo_cap=8,
             mut_rate=0.0, mut_cap=2, ncv=0, selection=False)


def _mk(n=64, slab_chrs=2):
    cfg = PackedConfig(n=n, **SHAPE)
    return StreamedPacked.build(3, cfg, slab_chrs, device="cpu")


def test_streamed_matches_inmemory_slabs():
    """A streamed generation is bit-identical to running the same slab
    kernel on in-memory copies under the same draws (streaming moves
    bytes, not math)."""
    eng = _mk()
    before = [h.clone() for h in eng.host]
    fathers, mothers, plans = eng.draw(torch.Generator().manual_seed(11))
    eng.apply(fathers, mothers, plans)
    from geneevolve_tpu_torch.ops.meiose_packed import meiose_packed

    for s, par in enumerate(before):
        want = meiose_packed(par, fathers, mothers, *plans[s], None,
                             n_chr=eng.cfg_slab.n_chr,
                             chr_len=eng.cfg_slab.chr_len)
        assert torch.equal(eng.host[s], want), s
    assert not torch.equal(eng.host[0], before[0])


def test_streamed_drift_sanity():
    """Allele frequencies stay interior and move only by drift over a few
    generations."""
    eng = _mk(n=128)
    f0 = eng.allele_mean(0)
    for g in range(3):
        eng.step(torch.Generator().manual_seed(5 + g))
    f1 = eng.allele_mean(0)
    assert 0.05 < f1 < 0.95
    assert abs(f1 - f0) < 0.1


def test_state_bytes_accounting():
    eng = _mk()
    assert eng.state_bytes == sum(h.nbytes for h in eng.host)
    assert eng.state_bytes == 64 * 2 * (2048 * 4 // 32) * 4
    assert len(eng.host) == 2 and eng.cfg_slab.m == 2048 * 2


def test_step_equals_jax_on_its_draws():
    """The JAX engine's founder slabs carried over, one port generation
    fed the JAX step's parents and per-slab plans (its own key splits)
    equals the JAX engine's host slabs after its step."""
    jcfg = jpk.PackedConfig(n=64, **SHAPE)
    jeng = JaxStreamed.build(jax.random.key(3), jcfg, 2)
    eng = StreamedPacked(
        cfg=PackedConfig(n=64, **SHAPE), slab_chrs=2,
        host=[torch.from_numpy(h.view(np.int32).copy()) for h in jeng.host],
        cfg_slab=StreamedPacked.slab_config(PackedConfig(n=64, **SHAPE), 2),
        device=torch.device("cpu"))
    key = jax.random.key(11)
    jeng.step(key)
    k_mate, k_slab = jax.random.split(key)
    km1, km2 = jax.random.split(k_mate)
    T = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    fathers = T(jax.random.randint(km1, (64,), 0, 64))
    mothers = T(jax.random.randint(km2, (64,), 0, 64))
    dense_slab = jeng.cfg_slab.as_dense()
    plans = []
    for s in range(len(jeng.host)):
        k_pat, k_mat = jax.random.split(jax.random.fold_in(k_slab, s))
        xo_p, st_p, _ = jplan(k_pat, dense_slab, 64)
        xo_m, st_m, _ = jplan(k_mat, dense_slab, 64)
        plans.append(tuple(T(x) for x in (xo_p, st_p, xo_m, st_m)))
    eng.apply(fathers, mothers, plans)
    for s, h in enumerate(jeng.host):
        np.testing.assert_array_equal(eng.host[s].numpy().view(np.uint32), h)
