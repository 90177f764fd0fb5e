"""The yardstick of a kernel's roofline share: the least time one H100
could take for a launch, from its arguments' shapes and dtypes alone.

The arithmetic is `chip_smoke.py`'s (`_bound`, `_bins_work`,
`_count_work`, `_merge_work`, `_gather_work`, `_packed_need`,
`_packed_work`, `_paint_work`, `_paint_need`), frozen here: each input byte
read once, each output byte written once, against NVIDIA's published
3.35 TB/s of HBM3 and 67 T scalar operations a second (the H100 SXM data
sheet, at its 700 W limit). The bytes are computed, not measured.

The traced run records each launch's shapes and keeps its index tensor
(`Launch`); the distinct rows the indices name (`torch.unique`, as the
original counts them) are counted after the traced window has closed, so
reckoning a bound adds no device op or sync to the traced run. The packed
meiosis keeps its parents and plan too: the parent words its gametes take
are reckoned from them after the window (`packed_need`). A paint launch
keeps its shapes alone: the live slots of its ledgers and mutation rows
are counted in the check's untraced run of the same seed
(`metrics/paint_roofline.py`)."""

from __future__ import annotations

from gebench.reference.law import BIG

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


def phase_words(xo, start, n_chr: int, chr_len: int):
    """(n, words) int32 phase of each gamete's words, a bit set where the
    gamete takes its parent's second chromatid: the start chromatid's mask,
    XORed with each crossover's mask of the loci at and after it on its
    chromosome (`dense/packed.py`'s `phase_word_masks`, frozen)."""
    import torch

    n, K = xo.shape[0], xo.shape[2]
    cw = chr_len // 32
    dev = xo.device
    cols = torch.arange(cw, dtype=torch.int32, device=dev)[None, None, :]
    base = (torch.arange(n_chr, dtype=torch.int32, device=dev)
            * chr_len)[None, :, None]
    mask = -(start[:, :, None] & 1).to(torch.int32)
    mask = mask.expand(n, n_chr, cw).contiguous()
    for k in range(K):
        x = xo[:, :, k:k + 1] - base
        xw = x >> 5
        partial = torch.full_like(x, -1) << (x & 31)
        mask ^= -(cols > xw).to(torch.int32) | (
            partial & -(cols == xw).to(torch.int32))
    return mask.reshape(n, n_chr * cw)


def packed_need(rows: int, args, n_chr: int, chr_len: int,
                chunk: int = 2048) -> int:
    """Bytes of parent words the packed meiosis must read for these inputs
    (`args`: fathers, mothers, xo_p, st_p, xo_m, st_m): each (parent row,
    plane, word) that some gamete takes a bit from, read once. A word whose
    phase is all zeros takes plane A only, all ones plane B only."""
    import torch

    fathers, mothers, xo_p, st_p, xo_m, st_m = args[:6]
    need = torch.zeros((2, rows, n_chr * chr_len // 32), dtype=torch.int32,
                       device=fathers.device)
    for par, xo, st in ((fathers, xo_p, st_p), (mothers, xo_m, st_m)):
        for i in range(0, par.shape[0], chunk):
            mask = phase_words(xo[i:i + chunk], st[i:i + chunk], n_chr,
                               chr_len)
            idx = par[i:i + chunk].long()
            need[0].index_add_(0, idx, (mask != -1).int())
            need[1].index_add_(0, idx, (mask != 0).int())
    return 4 * int((need > 0).sum())


def packed_work(need: int, args, mu, n_chr: int, chr_len: int):
    """(bytes, ops) of the packed meiosis: the parent words it must read
    (`need`, `packed_need`'s bytes), the plan and the mutation columns
    once, the child words written once; one select (and, andnot, or) a
    child word."""
    n, mw = args[0].shape[0], n_chr * chr_len // 32
    out_b = 2 * n * mw * 4
    return need + nbytes(*args[:6], mu) + out_b, 3 * out_b


def packed_launch_work(hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu,
                       n_chr: int, chr_len: int):
    """(bytes, ops) of one launch of the packed meiosis on parent planes
    `hap` (a `Shape` will do)."""
    args = (fathers, mothers, xo_p, st_p, xo_m, st_m)
    return packed_work(packed_need(hap.shape[0], args, n_chr, chr_len), args,
                       mu, n_chr, chr_len)


def live_slots(x):
    """The slots of a BIG-padded ledger or mutation plane that hold an
    entry: a count on the plane's device."""
    return (x < BIG).sum()


def paint_work(seg_st, seg_hap, mut, founder, pos, live=None, muts=None):
    """(bytes, ops) of `paint` over what it must read: the painted columns
    written once; of the ledgers and mutation rows only the slots that hold
    a segment or a mutation (`live` and `muts`, their counts, counted here
    when not given), the founder panel and the positions read once; a
    locus's slot and mutation-pointer checks, four compares an output
    byte."""
    out = seg_st.shape[0] * seg_st.shape[1] * 2 * pos.shape[1]
    live = int(live_slots(seg_st) if live is None else live)
    muts = int(live_slots(mut) if muts is None else muts)
    return (out + live * (4 + seg_hap.element_size()) + 4 * muts
            + nbytes(founder, pos), 4 * out)


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
