"""`paint_roofline`: the paint kernel's share of its roofline over the
traced run: the sum of its launches' bounds (`gebench/roofline.py`'s
`paint_work`: the painted CV columns written, and the ledger slots and
mutation rows that hold an entry, the founder CV panel and the positions
read) over the sum of its device time (events named `paint_kernel`). The
launch recorded is `ops/paint.paint` as the engine calls it: the gather A/D
path's alleles and, with several populations, root populations.

The traced run records each launch's shapes alone. The slots that hold an
entry are counted on the device in the check's untraced run of the same
seed (`replay`), whose launches are the traced run's one for one; nothing
when their number or shapes differ."""

from gebench import roofline

WRAP = ("geneevolve_tpu_torch.core.engine", "paint")
KERNEL = "paint_kernel"


def work(seg_st, seg_hap, mut, founder, pos, *_, **__):
    return roofline.Launch(lambda *shapes: shapes,
                           (seg_st, seg_hap, mut, founder, pos))


def replay(seg_st, seg_hap, mut, *_, **__):
    return (seg_st.shape, mut.shape, int(roofline.live_slots(seg_st)),
            int(roofline.live_slots(mut)))


def read(ctx):
    shapes = ctx["launches"][ctx["metric"]]
    counts = ctx.get("replays", {}).get(ctx["metric"], [])
    if len(counts) != len(shapes) or any(
            (s[0].shape, s[2].shape) != tuple(c[:2])
            for s, c in zip(shapes, counts)):
        return None
    return roofline.share([roofline.paint_work(*s, *c[2:])
                           for s, c in zip(shapes, counts)],
                          ctx["trace"]["device_events"], KERNEL)
