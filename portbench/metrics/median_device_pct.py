"""Noise: share of device busy time spent in the exact median's
``kthvalue`` kernels (ops/noise.median_lastaxis)."""


def read(ctx):
    if not ctx["busy_s"]:
        return None
    t = sum(e - s for n, s, e in ctx["device"] if "kthvalue" in n.lower())
    return 100.0 * t / ctx["busy_s"]
