"""Device: share of the traced window in which no operation ran on the
device (profiler timeline, the window alone)."""


def read(ctx):
    if not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
