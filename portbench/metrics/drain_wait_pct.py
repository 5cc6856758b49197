"""Stream executor: share of the window the host spent blocked on a
dispatch's completion (``drain`` events, wait_s)."""


def read(ctx):
    v = [e["wait_s"] for e in ctx["events"] if e.get("type") == "drain"]
    if not v or not ctx["window_s"]:
        return None
    return 100.0 * sum(v) / ctx["window_s"]
