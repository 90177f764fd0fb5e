"""`host_wait_ms`: milliseconds a generation the host waited for the card:
the StageTimer total `host_wait` of the traced run (the program's calls of
its sync door, `telemetry.host_wait`, and its `--stage_sync` fences, inside
`step` spans) over its generations. Nothing when the program records no
such total."""


def read(ctx):
    t = ctx["stages"].get("host_wait")
    return None if t is None else 1e3 * t / ctx["gens"]
