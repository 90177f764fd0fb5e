"""`generation0_ms`: milliseconds of the traced run's `generation0` span:
the founders' planes, A/D and phenotypes and generation 0's `.info` file
(`Simulation.init_generation0`), once a run. Nothing when the program
records no such span."""


def read(ctx):
    t = ctx["stages"].get("generation0")
    return None if t is None else 1e3 * t
