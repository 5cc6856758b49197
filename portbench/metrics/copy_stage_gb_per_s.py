"""Copy pipeline: bytes the copy stage shipped over the seconds it took
(``h2d_done`` events): row stacking, pinning and the link together, a
stage rate and not the link's bandwidth."""


def read(ctx):
    ev = [e for e in ctx["events"] if e.get("type") == "h2d_done"]
    s = sum(e["h2d_s"] for e in ev)
    if not ev or s <= 0:
        return None
    return sum(e["bytes"] for e in ev) / s / 1e9
