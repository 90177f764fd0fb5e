"""`packed_roofline`: the packed meiosis kernel's share of its roofline over
the traced run: the sum of its launches' bounds (`gebench/roofline.py`'s
`packed_work`: the parent words the gametes take, the plan, the mutation
columns and the child words written, reckoned after the run from each
launch's parents and plan) over the sum of its device time (events named
`meiose_packed_kernel`). The launch recorded is the window entry that the
dense backend's `parallel.mesh.meiose_window` reaches."""

from gebench import roofline

WRAP = ("geneevolve_tpu_torch.parallel.mesh", "meiose_packed_window")
KERNEL = "meiose_packed_kernel"


def work(hap, out, w0, fathers, mothers, xo_p, st_p, xo_m, st_m, mu=None,
         *, n_chr, chr_len, **__):
    return roofline.Launch(
        roofline.packed_launch_work,
        (hap, fathers, mothers, xo_p, st_p, xo_m, st_m, mu, n_chr, chr_len),
        keep=(1, 2, 3, 4, 5, 6))


def read(ctx):
    return roofline.share(ctx["launches"][ctx["metric"]],
                          ctx["trace"]["device_events"], KERNEL)
