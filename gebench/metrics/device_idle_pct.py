"""`device_idle_pct`: percent of the traced run's host-clock span in which no
kernel, copy or set ran on the device."""


def read(ctx):
    t = ctx["trace"]
    if t["window_s"] <= 0 or not t["device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
