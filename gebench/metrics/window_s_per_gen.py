"""`window_s_per_gen`: the measured window's `s_per_gen` (its wall time over
the generations it simulated, all of its runs), as a per-layer metric in
the cells whose windows the host's drift spreads too widely for a bound on
the end-to-end `s_per_gen`. Nothing when the run passes no such number."""


def read(ctx):
    return ctx.get("s_per_gen")
