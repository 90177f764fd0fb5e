"""The port's painting functions against the JAX package: `segments.hap_at`,
`segments.mutation_flip_mask` and `ops.paint.paint_plain` (the CUDA
kernel's oracle) equal the JAX `hap_at`, `mutation_flip_mask` and
`output._paint_chunk` exactly on the same numpy-seeded ledgers.

Cases: queries before the first start (hap 0, not slot 0), full ledgers
(every slot live), BIG queries, mutation rows with duplicates and empty
rows, int16 and int32 haps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geneevolve_tpu.core import output as joutput
from geneevolve_tpu.core import segments as jseg
from geneevolve_tpu_torch.core import segments as tseg
from geneevolve_tpu_torch.ops import paint as tpaint
from torch_cases import paint_ledger as _ledger
from torch_cases import paint_mutations as _mutations
from torch_cases import paint_positions as _positions

BIG = tseg.BIG
H = 64  # founder haplotypes of the panels below (`paint_ledger`'s haps)
# one intra-op thread: under xdist these tests share the CPU with the JAX
# tests' XLA device threads
torch.set_num_threads(1)


CASES = [  # (n, S, live, M, Q)
    (40, 9, 5, 6, 77),  # sparse ledgers
    (30, 12, 12, 4, 64),  # full ledgers: every slot live
    (25, 49, 16, 27, 160),  # the slice's S and M
]


@pytest.mark.parametrize("hap_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("n, S, live, M, Q", CASES)
def test_hap_at_matches_jax(n, S, live, M, Q, hap_dtype):
    rng = np.random.default_rng(n * S + Q)
    st, hap = _ledger(rng, n, S, live, hap_dtype)
    q = _positions(rng, Q)
    got = tseg.hap_at(torch.as_tensor(st), torch.as_tensor(hap),
                      torch.as_tensor(q))
    want = np.asarray(jseg.hap_at(jnp.asarray(st), jnp.asarray(hap),
                                  jnp.asarray(q)))
    assert got.dtype == torch.as_tensor(hap).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., :3] == 0).all()  # before the first start: hap 0
    # per-row queries (the leading dims matched, not broadcast)
    qr = np.broadcast_to(q, (n, 2, Q)).copy()
    qr[::2] = qr[::2] + 1
    got = tseg.hap_at(torch.as_tensor(st), torch.as_tensor(hap),
                      torch.as_tensor(qr))
    want = np.asarray(jseg.hap_at(jnp.asarray(st), jnp.asarray(hap),
                                  jnp.asarray(qr)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n, S, live, M, Q", CASES)
def test_mutation_flip_mask_matches_jax(n, S, live, M, Q):
    rng = np.random.default_rng(7 * n + M)
    q = _positions(rng, Q)
    mut = _mutations(rng, n, M, q)
    mut[0, 0, :2] = [q[-2], BIG]  # a mutation AT the BIG query: no flip
    mut[0, 0] = np.sort(mut[0, 0])
    got = tseg.mutation_flip_mask(torch.as_tensor(mut), torch.as_tensor(q))
    want = np.asarray(jseg.mutation_flip_mask(jnp.asarray(mut),
                                              jnp.asarray(q)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any() and not got[..., -2:].any()


def _panel(rng, Q):
    return rng.integers(0, 2, size=(H, Q)).astype(np.uint8)


@pytest.mark.parametrize("hap_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("n, S, live, M, Q", CASES)
def test_paint_plain_matches_paint_chunk(n, S, live, M, Q, hap_dtype):
    """Two stacked chromosomes, each against the JAX `_paint_chunk`."""
    rng = np.random.default_rng(n + S + M + Q)
    lead = [_ledger(rng, n, S, live, hap_dtype) for _ in range(2)]
    pos = np.stack([_positions(rng, Q) for _ in range(2)])
    mut = np.stack([_mutations(rng, n, M, pos[c]) for c in range(2)])
    founder = np.stack([_panel(rng, Q) for _ in range(2)])
    st = np.stack([x[0] for x in lead])
    hap = np.stack([x[1] for x in lead])
    T = torch.as_tensor
    got = tpaint.paint_plain(T(st), T(hap), T(mut), T(founder), T(pos))
    assert got.dtype == torch.uint8 and got.shape == (2, n, 2, Q)
    for c in range(2):
        want = np.asarray(joutput._paint_chunk(
            jnp.asarray(st[c]), jnp.asarray(hap[c]), jnp.asarray(mut[c]),
            jnp.asarray(founder[c]), jnp.asarray(pos[c])))
        np.testing.assert_array_equal(got[c].numpy(), want)
    # the CPU wrapper is the plain version
    assert torch.equal(tpaint.paint(T(st), T(hap), T(mut), T(founder),
                                    T(pos)), got)


def test_paint_plain_row_chunks(monkeypatch):
    """The plain version's row chunks (a few rows each here) give the
    unchunked result."""
    rng = np.random.default_rng(3)
    n, S, M, Q = 37, 10, 5, 50
    st, hap = _ledger(rng, n, S, 6, np.int16)
    pos = _positions(rng, Q)
    mut = _mutations(rng, n, M, pos)
    args = [torch.as_tensor(x)[None] for x in (st, hap, mut, _panel(rng, Q),
                                               pos)]
    whole = tpaint.paint_plain(*args)
    monkeypatch.setattr(tpaint, "PLAIN_CHUNK_BYTES", 2 * Q * S * 4)
    assert torch.equal(tpaint.paint_plain(*args), whole)


def test_paint_flips_panel_values_as_uint8():
    """`1 - f` in uint8, as the JAX `where(flip, 1 - bits, bits)`: a panel
    value of 2 flips to 255."""
    st = torch.tensor([[[[0, BIG], [0, BIG]]]], dtype=torch.int32)
    hap = torch.tensor([[[[1, 0], [0, 0]]]], dtype=torch.int16)
    mut = torch.tensor([[[[5, BIG], [BIG, BIG]]]], dtype=torch.int32)
    founder = torch.tensor([[[0, 0], [2, 2]]], dtype=torch.uint8)
    pos = torch.tensor([[5, 6]], dtype=torch.int32)
    got = tpaint.paint(st, hap, mut, founder, pos)
    assert got[0, 0].tolist() == [[255, 2], [0, 0]]


def test_paint_refuses_tensors_off_cpu_and_cuda():
    """A tensor not on the CPU goes to the kernel or the wrapper raises:
    there is no fallback to the plain version."""
    meta = dict(device="meta")
    args = (torch.empty((1, 2, 2, 3), dtype=torch.int32, **meta),
            torch.empty((1, 2, 2, 3), dtype=torch.int16, **meta),
            torch.empty((1, 2, 2, 2), dtype=torch.int32, **meta),
            torch.empty((1, 4, 5), dtype=torch.uint8, **meta),
            torch.empty((1, 5), dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        tpaint.paint(*args)
