"""Cross-host trace stitching: ``pptrace merge`` (counterpart of
pulseportraiture_tpu/obs/merge.py; the traces share the JAX package's
schema, so either package's traces merge here).

Takes one router trace plus N host traces (any order — roles are
detected from the event stream) and reconstructs, per ``trace_id``,
the request's life across processes: router placement -> host queue
wait -> fit dispatch(es) -> serve -> wire + collect, with hedges and
failovers called out and the critical-path stage named.

Cross-trace clock alignment uses each manifest's ``t0_unix`` wall
anchor plus the per-event monotonic offset ``t``; on one machine (the
test/bench lane) that is exact, across real hosts it is as good as the
hosts' NTP discipline — sub-span ordering within one trace is always
exact regardless.
"""

import json
import os


def _wall(manifest, event):
    return manifest["t0_unix"] + event["t"]


def _load_all(paths):
    # local import: telemetry.main imports this module for the merge
    # subcommand, so the reverse import must stay off module scope
    from ..telemetry import load_trace

    traces = []
    for p in paths:
        manifest, events = load_trace(p)
        kinds = {e.get("type") for e in events}
        role = ("router" if any(k and k.startswith("route_")
                                for k in kinds)
                or manifest.get("run") == "pproute" else "host")
        traces.append({"path": str(p),
                       "label": os.path.basename(str(p)),
                       "manifest": manifest, "events": events,
                       "role": role})
    return traces


def merge_traces(paths):
    """Stitch traces into per-request timelines keyed by trace_id.

    Returns a dict with ``requests`` (trace_id -> timeline), a
    ``trace_ids`` -> request-name map, and coverage bookkeeping; raises
    ValueError when no trace carries trace-ids at all (traces written
    before distributed tracing have nothing to join on)."""
    traces = _load_all(paths)
    reqs = {}

    def entry(tid):
        r = reqs.get(tid)
        if r is None:
            r = reqs[tid] = {
                "trace_id": tid, "req": None, "tenant": None,
                "t0_wall": None, "router_wall_s": None,
                "spans": [], "hedges": [], "failovers": [],
                "coalesces": [], "cache_hit": False, "error": None}
        return r

    saw_any_tid = False
    for tr in traces:
        man, label = tr["manifest"], tr["label"]
        for e in tr["events"]:
            et = e.get("type")
            if et == "batch_coalesce":
                for tid in (e.get("trace_ids") or ()):
                    saw_any_tid = True
                    entry(tid)["coalesces"].append(
                        {"t_wall": _wall(man, e), "where": label,
                         "seq": e.get("seq"), "rows": e.get("rows")})
                continue
            tid = e.get("trace_id")
            if not tid:
                continue
            saw_any_tid = True
            r = entry(tid)
            if et == "route_submit":
                name = e.get("req") or ""
                if r["req"] is None or not name.endswith(":refit"):
                    r["req"] = name.split(":refit")[0] or r["req"]
                r["tenant"] = e.get("tenant") or r["tenant"]
                t = _wall(man, e)
                if r["t0_wall"] is None or t < r["t0_wall"]:
                    r["t0_wall"] = t
                r["spans"].append(
                    {"stage": "route", "where": label,
                     "t_wall": t, "dur_s": None,
                     "host": e.get("host"),
                     "attempt": e.get("attempt")})
                if e.get("host") is None:
                    r["cache_hit"] = True
            elif et == "route_done":
                r["router_wall_s"] = e.get("wall_s")
                r["error"] = e.get("error") or r["error"]
                for s in reversed(r["spans"]):
                    if s["stage"] == "route" and s["dur_s"] is None:
                        s["dur_s"] = e.get("wall_s")
                        break
            elif et == "route_hedge":
                r["hedges"].append(
                    {"t_wall": _wall(man, e),
                     "primary": e.get("primary"),
                     "host": e.get("host")})
            elif et == "route_failover":
                r["failovers"].append(
                    {"t_wall": _wall(man, e),
                     "dead_host": e.get("dead_host"),
                     "action": e.get("action")})
            elif et == "request_submit":
                t = _wall(man, e)
                if r["t0_wall"] is None or t < r["t0_wall"]:
                    r["t0_wall"] = t
                r["spans"].append(
                    {"stage": "serve", "where": label, "t_wall": t,
                     "dur_s": None, "queue_s": None})
            elif et == "request_done":
                r["tenant"] = e.get("tenant") or r["tenant"]
                for s in reversed(r["spans"]):
                    if (s["stage"] == "serve" and s["where"] == label
                            and s["dur_s"] is None):
                        s["dur_s"] = e.get("wall_s")
                        s["queue_s"] = e.get("queue_s")
                        s["error"] = e.get("error")
                        break
            elif et == "cache_hit":
                r["cache_hit"] = True

    if not saw_any_tid:
        raise ValueError(
            "no trace_id fields in any input trace — these traces "
            "predate distributed tracing (re-run with telemetry on a "
            "current build)")

    for r in reqs.values():
        r["spans"].sort(key=lambda s: s["t_wall"])
        # critical path: the dominant stage of the completed lifecycle
        serve_spans = [s for s in r["spans"]
                       if s["stage"] == "serve" and s["dur_s"]
                       is not None]
        segs = {}
        if serve_spans:
            last = serve_spans[-1]
            q = last.get("queue_s") or 0.0
            segs["queue"] = q
            segs["serve"] = max((last["dur_s"] or 0.0) - q, 0.0)
            if r["router_wall_s"] is not None:
                segs["wire+collect"] = max(
                    r["router_wall_s"] - (last["dur_s"] or 0.0), 0.0)
        elif r["cache_hit"]:
            segs["cache"] = r["router_wall_s"] or 0.0
        r["segments"] = {k: round(v, 6) for k, v in segs.items()}
        r["critical"] = (max(segs, key=segs.get) if segs else None)
        r["n_host_spans"] = len(
            [s for s in r["spans"] if s["stage"] == "serve"])
        r["hedged"] = bool(r["hedges"])

    return {
        "n_traces": len(traces),
        "traces": [{"label": t["label"], "role": t["role"],
                    "run": t["manifest"].get("run")} for t in traces],
        "n_requests": len(reqs),
        "requests": reqs,
    }


def format_merge(merged, file=None):
    """Render a merged timeline as text (the pptrace merge default)."""
    import sys

    out = file or sys.stdout
    p = lambda s="": print(s, file=out)  # noqa: E731
    roles = ", ".join(f"{t['label']}({t['role']})"
                      for t in merged["traces"])
    p(f"merged {merged['n_traces']} traces: {roles}")
    p(f"requests: {merged['n_requests']}")
    order = sorted(merged["requests"].values(),
                   key=lambda r: r["t0_wall"] or 0.0)
    for r in order:
        wall = (f"{r['router_wall_s']:.3f} s"
                if r["router_wall_s"] is not None else "?")
        flags = []
        if r["cache_hit"]:
            flags.append("cache-hit")
        if r["hedged"]:
            flags.append("hedged")
        if r["failovers"]:
            flags.append(f"failover x{len(r['failovers'])}")
        if r["error"]:
            flags.append(f"ERROR {r['error']}")
        tag = f"  [{', '.join(flags)}]" if flags else ""
        p(f"req {r['req'] or '?'} trace={r['trace_id']} "
          f"tenant={r['tenant'] or '?'} total {wall} "
          f"critical={r['critical'] or '?'}{tag}")
        t0 = r["t0_wall"] or 0.0
        for s in r["spans"]:
            rel = s["t_wall"] - t0
            dur = (f"+{s['dur_s']:.3f}s" if s.get("dur_s") is not None
                   else "+?")
            if s["stage"] == "route":
                host = s.get("host") or "cache"
                p(f"    {rel:8.3f} {dur:>10}  route -> {host} "
                  f"(attempt {s.get('attempt')}) [{s['where']}]")
            else:
                q = s.get("queue_s")
                qs = f" queue {q:.3f}s" if q is not None else ""
                p(f"    {rel:8.3f} {dur:>10}  serve{qs} "
                  f"[{s['where']}]")
        for c in r["coalesces"]:
            p(f"    {c['t_wall'] - t0:8.3f}             coalesce "
              f"seq={c['seq']} rows={c['rows']} [{c['where']}]")
        for h in r["hedges"]:
            p(f"    {h['t_wall'] - t0:8.3f}             hedge "
              f"{h['primary']} -> {h['host']}")
        for f in r["failovers"]:
            p(f"    {f['t_wall'] - t0:8.3f}             failover "
              f"dead={f['dead_host']} action={f['action']}")


def main_merge(paths, as_json=False, file=None):
    """Entry point for ``pptrace merge``; returns the merged dict."""
    merged = merge_traces(paths)
    if as_json:
        import sys
        print(json.dumps(merged, sort_keys=True),
              file=file or sys.stdout)
    else:
        format_merge(merged, file=file)
    return merged
