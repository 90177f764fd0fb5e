"""`probe_ms`: milliseconds a generation in the reproduce probe: `_plan` and `_probe_counts` (`ops/cdf_bins`, `ops/merge_count`); the
StageTimer stage `reproduce/probe` of the traced run over its generations. Nothing
when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("reproduce/probe")
    return None if t is None else 1e3 * t / ctx["gens"]
