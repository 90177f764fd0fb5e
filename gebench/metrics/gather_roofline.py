"""`gather_roofline`: the row gather kernel's share of its roofline over
the traced run: the sum of its launches' bounds (`gebench/roofline.py`,
reckoned from each launch's shapes and
distinct indices after the run) over the sum of its device time
(events named `gather_rows_kernel`)."""

from gebench import roofline

WRAP = ("geneevolve_tpu_torch.ops.materialize", "_launch")
KERNEL = "gather_rows_kernel"


def work(table, idx, *_, **__):
    return roofline.Launch(roofline.gather_work, (table, idx, 1), keep=(1,))


def read(ctx):
    return roofline.share(ctx["launches"][ctx["metric"]],
                          ctx["trace"]["device_events"], KERNEL)
