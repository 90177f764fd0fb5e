"""`ad_ms`: milliseconds a generation in A/D: `_compute_ad` (`core/phenotype.py`; `ops/paint` on the gather path); the
StageTimer stage `compute_ad` of the traced run over its generations. Nothing
when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("compute_ad")
    return None if t is None else 1e3 * t / ctx["gens"]
