"""`real_ms`: milliseconds a generation in the reproduce real pass: `_real_pass_in_place` / `_reproduce_group` (`ops/meiose_merge`, `ops/materialize`), fenced under `--stage_sync`; the
StageTimer stage `reproduce/real` of the traced run over its generations. Nothing
when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("reproduce/real")
    return None if t is None else 1e3 * t / ctx["gens"]
