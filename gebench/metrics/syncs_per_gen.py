"""`syncs_per_gen`: calls of the program's sync door
(`telemetry.host_wait`) inside `step` spans in the traced run, over its
generations: each is one place a generation makes the host wait for the
card. The `--stage_sync` fences are not door calls and are not counted.
Nothing when the program has no such door."""


def _wrap():
    from geneevolve_tpu_torch.utils import telemetry

    if not hasattr(telemetry, "host_wait"):
        return None
    return (telemetry.__name__, "host_wait")


WRAP = _wrap()


def work(timer, site, *_, **__):
    """A call, recorded as 1 when a `step` span was open at it, else 0."""
    inside = int("step" in getattr(timer, "open", ()))
    return lambda: inside


def read(ctx):
    calls = ctx["launches"].get(ctx["metric"])
    return None if calls is None else sum(calls) / ctx["gens"]
