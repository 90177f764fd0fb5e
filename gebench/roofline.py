"""The yardstick of a kernel's roofline share: the least time one H100
could take for a launch, from its arguments' shapes and dtypes alone.

The arithmetic is `chip_smoke.py`'s (`_bound`, `_bins_work`,
`_count_work`, `_merge_work`, `_gather_work`), frozen here: each input byte
read once, each output byte written once, against NVIDIA's published
3.35 TB/s of HBM3 and 67 T scalar operations a second (the H100 SXM data
sheet, at its 700 W limit). The bytes are computed, not measured.

The traced run records each launch's shapes and keeps its index tensor
(`Launch`); the distinct rows the indices name (`torch.unique`, as the
original counts them) are counted after the traced window has closed, so
reckoning a bound adds no device op or sync to the traced run."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12


def bound_s(nbytes: int, ops: int) -> float:
    """The larger of the bytes over HBM's rate and the operations over the
    scalar lanes' rate, in seconds."""
    return max(nbytes / HBM_BYTES_S, ops / SCALAR_OPS_S)


class Shape:
    """A tensor's shape, element count and element size, without the
    tensor."""

    def __init__(self, t):
        self.shape = tuple(t.shape)
        self._numel = t.numel()
        self._size = t.element_size()

    def numel(self) -> int:
        return self._numel

    def element_size(self) -> int:
        return self._size


class Launch:
    """A launch as the traced run records it: `work` applied later to the
    shapes of `args` and to the tensors named in `keep` (the indices whose
    distinct rows count)."""

    def __init__(self, work, args, keep=()):
        self.work = work
        self.args = [a if i in keep or not hasattr(a, "element_size")
                     else Shape(a) for i, a in enumerate(args)]

    def __call__(self):
        return self.work(*self.args)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def rows_read(table, *idx, axis: int = 0) -> int:
    """Bytes of the distinct rows of `table` along `axis` the indices name,
    each read once."""
    import torch

    rows = torch.unique(torch.cat([i.reshape(-1) for i in idx])).numel()
    return rows * nbytes(table) // table.shape[axis]


def log2(x: int) -> int:
    return max(int(x - 1).bit_length(), 1)


def bins_work(u, cum):
    """(bytes, ops) of `cdf_bins`: probes in and bins out once, the CDFs
    once; a binary search a probe."""
    return nbytes(u, cum) + 4 * u.numel(), 2 * u.numel() * log2(cum.shape[-1])


def gather_work(table, idx, axis: int = 1):
    """(bytes, ops) of a stacked row gather: the rows named read once,
    every gathered row written once."""
    out = idx.numel() * nbytes(table) // table.shape[axis]
    return rows_read(table, idx, axis=axis) + nbytes(idx) + out, 0


def count_work(seg_st, parents, xo_f, xo_m, sh):
    """(bytes, ops) of `merge_count`: the parent rows read once, crossover
    rows and starts once, a count a gamete written; a binary search over
    the sorted crossovers a slot and a crossover."""
    gametes = 2 * xo_f.shape[0] * xo_f.shape[1]
    S, K = seg_st.shape[-1], xo_f.shape[-1]
    return (rows_read(seg_st, parents, axis=1)
            + nbytes(parents, xo_f, xo_m, sh) + 4 * gametes,
            gametes * (2 * S + K) * log2(K + 1))


def merge_work(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap):
    """(bytes, ops) of `meiose_merge`: as the count, plus the parents' hap
    rows and the child rows written; a binary search over the merged
    candidates a candidate."""
    gametes = 2 * xo_f.shape[0] * xo_f.shape[1]
    S, K = seg_st.shape[-1], xo_f.shape[-1]
    return (rows_read(seg_st, parents, axis=1)
            + rows_read(seg_hap, parents, axis=1)
            + nbytes(parents, xo_f, xo_m, sh)
            + gametes * (cap * (4 + seg_hap.element_size()) + 4),
            gametes * (K + 2 * S) * log2(K + 2 * S))


def share(launches: list, events: list, kernel: str):
    """Percent of its roofline a kernel reached over a traced run: the sum
    of its launches' bounds over the sum of its device time (events whose
    name holds `kernel`). None when the trace holds none of its launches,
    or holds another number of them than were recorded."""
    got = [e for e in events if kernel in e["name"]]
    if not got or len(got) != len(launches):
        return None
    device_s = sum(e["dur"] for e in got) / 1e6
    return 100.0 * sum(bound_s(*w) for w in launches) / device_s
