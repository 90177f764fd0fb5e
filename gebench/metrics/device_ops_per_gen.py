"""`device_ops_per_gen`: device events (kernels, copies, sets) of the traced
run over its generations; the engine step's launch count, which host
enqueue pays for."""


def read(ctx):
    n = len(ctx["trace"]["device_events"])
    return n / ctx["gens"] if n else None
