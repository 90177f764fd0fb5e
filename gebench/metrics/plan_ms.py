"""`plan_ms`: milliseconds a generation in the dense backend's plan: `DenseSimulation._plan` (the crossover and mutation columns of every gamete, `dense/step.py`'s `_sample_gamete_plan` and `_mutation_cols`), fenced under `--stage_sync`; the
StageTimer stage `reproduce/plan` of the traced run over its generations.
Nothing when the run has no such stage."""


def read(ctx):
    t = ctx["stages"].get("reproduce/plan")
    return None if t is None else 1e3 * t / ctx["gens"]
