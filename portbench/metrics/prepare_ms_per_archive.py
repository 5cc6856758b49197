"""Stream executor: mean milliseconds the lane's ``prepare`` took per
archive admitted in the window (``archive_prepare`` events, prep_s)."""


def read(ctx):
    v = [e["prep_s"] for e in ctx["events"]
         if e.get("type") == "archive_prepare"]
    return 1e3 * sum(v) / len(v) if v else None
