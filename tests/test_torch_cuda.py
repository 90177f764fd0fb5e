"""The port's CUDA kernels against their plain PyTorch versions, on the
card, bit-exact (integer outputs). Every case is marked `cuda` and skips
where no CUDA device is present. This file imports no JAX, so it runs on a
GPU machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from geneevolve_tpu_torch.ops import cdf_bins as tbins
from geneevolve_tpu_torch.ops import materialize as tmat
from geneevolve_tpu_torch.ops import meiose_merge as tmerge
from geneevolve_tpu_torch.ops import merge_count as tcount
from torch_cases import CASES, cdf, crossovers, ledger, probes

T = torch.as_tensor


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [7, 1000, 5120, 20000])
def test_cuda_bins_kernel(cuda, K):
    rng = np.random.default_rng(K)
    cum = T(cdf(rng, K), device=cuda)
    u = T(probes(rng, cum.cpu().numpy()), device=cuda)
    got = tbins.cdf_bins(u, cum)
    torch.cuda.synchronize()
    assert torch.equal(got, tbins.cdf_bins_plain(u, cum))


@pytest.mark.cuda
@pytest.mark.parametrize("n, S, K, live", CASES)
def test_cuda_count_and_merge_kernels(cuda, n, S, K, live):
    rng = np.random.default_rng(n)
    st, hap = ledger(rng, n, S, live, hap_dtype=np.int16)
    xo = crossovers(rng, n, K, st)
    sh = rng.integers(0, 2, size=n).astype(np.int32)
    idx = rng.integers(0, n, size=n).astype(np.int32)
    a = [T(x, device=cuda) for x in (st, hap, idx, xo, sh)]
    got = tcount.merge_count(a[0], a[2], a[3], a[4])
    assert torch.equal(got, tcount.merge_count_plain(a[0], a[2], a[3], a[4]))
    for merge_ibd in (True, False):
        for cap in (S + K, 4):
            got = tmerge.meiose_merge(*a, cap, merge_ibd)
            want = tmerge.meiose_merge_plain(*a, cap, merge_ibd)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((90, 2, 13), torch.int16), ((90, 2, 8), torch.int32),
    ((90, 2, 100), torch.uint8), ((90, 3), torch.uint8),
])
def test_cuda_gather_kernel(cuda, shape, dtype):
    table = torch.randint(0, 100, shape, dtype=dtype, device=cuda)
    idx = torch.randint(0, shape[0], (500,), dtype=torch.int32, device=cuda)
    assert torch.equal(tmat.gather_rows(table, idx),
                       tmat.gather_rows_plain(table, idx))
