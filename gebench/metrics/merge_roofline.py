"""`merge_roofline`: the ledger merge kernel's share of its roofline over
the traced run: the sum of its launches' bounds (`gebench/roofline.py`,
reckoned from each launch's shapes and
distinct indices after the run) over the sum of its device time
(events named `meiose_merge_kernel`)."""

from gebench import roofline

WRAP = ("geneevolve_tpu_torch.core.engine", "meiose_merge")
KERNEL = "meiose_merge_kernel"


def work(seg_st, seg_hap, parents, xo_f, xo_m, sh, cap, *_, **__):
    return roofline.Launch(roofline.merge_work,
                           (seg_st, seg_hap, parents, xo_f, xo_m, sh, cap),
                           keep=(2,))


def read(ctx):
    return roofline.share(ctx["launches"][ctx["metric"]],
                          ctx["trace"]["device_events"], KERNEL)
