"""`mate_ms`: milliseconds a generation in mating: `Simulation._mate` (host, `core/mating.py`); the
StageTimer stage `mate` of the traced run over its generations. Nothing
when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("mate")
    return None if t is None else 1e3 * t / ctx["gens"]
