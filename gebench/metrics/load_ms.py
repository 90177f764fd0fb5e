"""`load_ms`: milliseconds of the traced run's `load` span: the program's
parse and load of the scenario files and its memory reckoning
(`Simulation._load`, `_check_fits`), once a run. Nothing when the program
records no such span."""


def read(ctx):
    t = ctx["stages"].get("load")
    return None if t is None else 1e3 * t
