"""`host_busy_ms`: milliseconds a generation the host worked on its own
(Python, numpy, enqueueing device work): the StageTimer total `step` of the
traced run less its total `host_wait`, over its generations. With
`host_wait_ms` it adds up to the `step` spans a generation. Nothing when
the program records no `step` or no `host_wait` total."""


def read(ctx):
    step, wait = (ctx["stages"].get(k) for k in ("step", "host_wait"))
    if step is None or wait is None:
        return None
    return 1e3 * (step - wait) / ctx["gens"]
