"""Fit: mean chi^2 evaluations of the Newton loop per TOA (``quality``
events, nfev)."""


def read(ctx):
    v = [n for e in ctx["events"] if e.get("type") == "quality"
         for n in e["nfev"]]
    return sum(v) / len(v) if v else None
