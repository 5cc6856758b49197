"""What a ``--trace 1`` run reads from ``torch.profiler`` and from the
program's own trace (``telemetry.Tracer``).

The traced window runs from the first of the harness's spans to the end
of the last.  On the card the profiler records device activity alone
(its host-side op records would cost more than the window); the spans,
kept on the host's clock, are placed on the device timeline through one
marker copy made at a known host time.  Device busy time is the union of the device operations'
intervals inside it; an idle gap is a stretch of it in which no device
operation ran, named after the harness's spans that were open on the host
at its middle: the main thread's innermost (admit, prepare, launch,
drain, scatter, assemble), the copy stage's and the fit stage's.
"""

import re

from .window import SPAN

MAIN = ("admit", "prepare", "launch", "drain", "scatter", "assemble", "b1")


def _merge(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clean(name, n=96):
    return re.sub(r"[^A-Za-z0-9_.:<>]+", "_", name)[:n]


def profile_events(prof):
    """Device ops [(name, start_s, end_s)] of a finished
    torch.profiler.profile (the harness's own ranges left out)."""
    from torch.autograd import DeviceType

    dev = []
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.name.startswith(SPAN):
            continue
        if e.device_type != DeviceType.CPU and t > s and not getattr(
                e, "is_user_annotation", False):
            dev.append((e.name, s, t))
    return dev


MARKER = ("HtoD", "Pageable")


def mark(device):
    """Host time of a pageable host-to-device copy made now: the device
    timeline's anchor (the program's copies are all pinned)."""
    import torch

    torch.cuda.synchronize(device)
    src = torch.ones(1)
    t = __import__("time").perf_counter()
    torch.empty(1, device=device).copy_(src)
    torch.cuda.synchronize(device)
    return t


def align_marker(dev, t_mark, host_spans):
    """The harness's host spans on the device timeline, through the
    marker copy: its device start is the host time ``t_mark``."""
    starts = [s for n, s, _ in dev if all(m in n for m in MARKER)]
    if not starts:
        return []
    off = min(starts) - t_mark
    return [(n, s + off, e + off) for n, s, e in host_spans]


def reduce(dev, spans):
    """busy_s, window_s, the window's device ops, and the breakdown's
    device_ops and idle_gaps (10 each, longest first); ``spans`` on the
    profiler's timeline."""
    if not spans:
        return None
    w0 = min(s for _, s, _ in spans)
    w1 = max(e for _, _, e in spans)
    inwin = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
             if e > w0 and s < w1]
    busy = _merge([(s, e) for _, s, e in inwin])
    busy_s = sum(e - s for s, e in busy)
    by_name = {}
    for n, s, e in inwin:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_host_phase(spans, 0.5 * (a + b)), b - a] for a, b in gaps[:10]]
    return {"busy_s": busy_s, "window_s": w1 - w0, "device": inwin,
            "breakdown": {"device_ops": [[_clean(n), v] for n, v in ops],
                          "idle_gaps": named}}


def _host_phase(spans, t):
    """host:<main thread's innermost span>[+copy...][+fit] at time t."""
    open_ = [(s, n) for n, s, e in spans if s <= t <= e]
    main = [x for x in open_ if x[1] in MAIN]
    parts = [max(main)[1]] if main else []
    copy = [x for x in open_ if x[1].startswith("copy")]
    if copy:
        parts.append(max(copy)[1])
    if any(n == "fit" for _, n in open_):
        parts.append("fit")
    return "host:" + ("+".join(parts) if parts else "no_span")
