"""ppmon: live fleet dashboard over the ``metrics`` transport op
(counterpart of pulseportraiture_tpu/cli/ppmon.py).

    python -m pulseportraiture_tpu_torch.cli.ppmon HOST:PORT \\
        [--interval MS] [--once] [--json] [--timeout S]

Polls one endpoint, a ``pproute --monitor`` port (the fleet view:
per-host health, queue, p99 and throughput plus the router's own latency
and SLO burn) or a single ``ppserve --listen`` host (that host's
registry alone), and renders a terminal dashboard every ``--interval``
ms (default config.mon_interval_ms / PPT_MON_INTERVAL_MS).  ``--once``
polls a single time (exit 1 when the endpoint is unreachable); with
``--json`` the raw reply is printed as one JSON object for scripting.

The endpoint never blocks the serving or routing hot path: the reply is
a lock-held snapshot of counters and fixed log-bucket histograms
(quantiles come from bucket counts, obs.metrics.quantile_from_export; no
device sync is taken).
"""

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppmon", description=__doc__.splitlines()[0])
    p.add_argument("endpoint", metavar="HOST:PORT",
                   help="A 'pproute --monitor' port (fleet view) or a "
                        "'ppserve --listen' host (single-host view).")
    p.add_argument("--interval", type=float, default=None,
                   metavar="MS",
                   help="Poll interval in milliseconds. [default: "
                        "config.mon_interval_ms / PPT_MON_INTERVAL_MS "
                        "— 1000]")
    p.add_argument("--once", action="store_true", default=False,
                   help="Poll once, render, exit 0 (exit 1 if the "
                        "endpoint is unreachable).")
    p.add_argument("--json", dest="as_json", action="store_true",
                   default=False,
                   help="Emit the raw metrics reply as one JSON "
                        "object per poll instead of the dashboard.")
    p.add_argument("--timeout", type=float, default=5.0, metavar="S",
                   help="Socket timeout per poll. [default: 5]")
    return p


def _fmt_s(v):
    """Latency cell: seconds -> human unit, '-' for absent."""
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def _fmt(v, spec="{:.1f}", none="-"):
    return none if v is None else spec.format(v)


def _render_slo(slo, p):
    if not slo:
        return
    p("  tenant            target   attain%   burn5m   burn1h  state")
    for tenant in sorted(slo):
        s = slo[tenant]
        att = (f"{100 * s['attainment']:.2f}"
               if s.get("attainment") is not None else "-")
        burn = s.get("burn", {})
        state = "ALERT" if s.get("alerting") else "ok"
        p(f"  {tenant:<16} {_fmt_s(s.get('target_s')):>7} {att:>9} "
          f"{_fmt(burn.get('300'), '{:.1f}x'):>8} "
          f"{_fmt(burn.get('3600'), '{:.1f}x'):>8}  {state}")


def render(reply, file=None):
    """Render one metrics reply (fleet-shaped or host-shaped) as the
    text dashboard."""
    out = file or sys.stdout
    p = lambda s="": print(s, file=out)  # noqa: E731
    if "hosts" in reply and "fleet" in reply:
        f = reply["fleet"]
        r = reply["router"]
        p(f"== ppmon: fleet ({f['n_hosts']} host(s)) ==")
        p(f"  routed latency: p50 {_fmt_s(r['p50_s'])}  "
          f"p90 {_fmt_s(r['p90_s'])}  p99 {_fmt_s(r['p99_s'])}   "
          f"cache hit rate "
          f"{_fmt(r['cache_hit_rate'], '{:.1%}', 'n/a')}")
        p(f"  fleet serve latency: p50 {_fmt_s(f['p50_s'])}  "
          f"p99 {_fmt_s(f['p99_s'])}   queue depth "
          f"{_fmt(f['queue_depth'], '{:d}', '?')}  in-flight "
          f"{f['in_flight']}  TOAs/s "
          f"{_fmt(f['toas_per_s'], '{:.1f}')}  link stall "
          f"{_fmt(f['link_stall_frac'], '{:.1%}', 'n/a')}")
        p("  host                      state    queue  inflt  "
          "p50      p99      TOA/s")
        hosts = reply["hosts"]
        for label in sorted(hosts):
            h = hosts[label]
            row = (f"  {label:<25} {h['state']:<8} "
                   f"{_fmt(h['queue_len'], '{:d}', '?'):>6} "
                   f"{h['outstanding']:>6} "
                   f"{_fmt_s(h['p50_s']):>8} {_fmt_s(h['p99_s']):>8} "
                   f"{_fmt(h['toas_per_s'], '{:.1f}'):>8}")
            if h.get("error"):
                row += f"  [{h['error']}]"
            p(row)
        slo = r.get("slo") or {}
        # host-level SLO snapshots fold under the same table, keyed by
        # the tenant the host reported them for
        for label in sorted(hosts):
            for tenant, s in (hosts[label].get("slo") or {}).items():
                slo.setdefault(tenant, s)
        if slo:
            p("  -- slo --")
            _render_slo(slo, p)
        return
    # single-host (ToaServer.metrics) shape
    p("== ppmon: host ==")
    p(f"  queue {reply.get('queue_len')}  pending archives "
      f"{reply.get('pending_archives')}  live requests "
      f"{reply.get('n_live')}  TOAs/s "
      f"{_fmt(reply.get('toas_per_s'), '{:.1f}')}  link stall "
      f"{_fmt(reply.get('link_stall_frac'), '{:.1%}', 'n/a')}")
    m = reply.get("metrics")
    if m:
        from ..obs.metrics import quantile_from_export

        h = m.get("histograms", {}).get("request_latency_s")
        if h:
            p(f"  request latency: p50 "
              f"{_fmt_s(quantile_from_export(h, 0.50))}  p90 "
              f"{_fmt_s(quantile_from_export(h, 0.90))}  p99 "
              f"{_fmt_s(quantile_from_export(h, 0.99))}  "
              f"(n={h['count']})")
        c = m.get("counters", {})
        p(f"  requests {c.get('requests_total', 0)} "
          f"({c.get('requests_failed', 0)} failed)  TOAs "
          f"{c.get('toas_total', 0)}  cache hits "
          f"{reply.get('cache_hits', 0)}")
    elif not reply.get("metrics_enabled", True):
        p("  (metrics registry disabled on this host — start it with "
          "--metrics on / PPT_METRICS=on)")
    if reply.get("slo"):
        p("  -- slo --")
        _render_slo(reply["slo"], p)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from .. import config

    interval_ms = args.interval
    if interval_ms is None:
        interval_ms = config.mon_interval_ms
    if not interval_ms > 0:
        raise SystemExit(f"ppmon: --interval: must be > 0, got "
                         f"{interval_ms}")
    try:
        config.parse_hostport(args.endpoint)
    except ValueError as e:
        raise SystemExit(f"ppmon: endpoint: {e}")

    from ..serve.transport import SocketTransport, TransportError

    try:
        transport = SocketTransport(args.endpoint,
                                    timeout=args.timeout)
    except TransportError as e:
        raise SystemExit(f"ppmon: {e}")
    try:
        while True:
            try:
                reply = transport.metrics()
            except TransportError as e:
                if args.once:
                    print(f"ppmon: {e}", file=sys.stderr)
                    return 1
                print(f"ppmon: poll failed: {e} (retrying)",
                      file=sys.stderr)
                time.sleep(interval_ms / 1000.0)
                continue
            if args.as_json:
                print(json.dumps(reply, sort_keys=True), flush=True)
            else:
                if not args.once and sys.stdout.isatty():
                    # home + clear-to-end keeps a live terminal stable
                    # without erasing scrollback
                    print("\x1b[H\x1b[J", end="")
                render(reply)
                print(f"-- {time.strftime('%H:%M:%S')}  "
                      f"poll every {interval_ms:.0f} ms  "
                      "(Ctrl-C to exit) --" if not args.once else "",
                      flush=True)
            if args.once:
                return 0
            time.sleep(interval_ms / 1000.0)
    except KeyboardInterrupt:
        return 0
    finally:
        transport.close()


if __name__ == "__main__":
    sys.exit(main())
