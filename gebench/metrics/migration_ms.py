"""`migration_ms`: milliseconds a generation in migration: `_migrate` and `_gather_state`, fenced under `--stage_sync`; the
StageTimer stage `migration` of the traced run over its generations. Nothing
when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("migration")
    return None if t is None else 1e3 * t / ctx["gens"]
