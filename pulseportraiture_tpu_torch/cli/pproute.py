"""pproute: route a campaign's TOA requests across a fleet of warm
``ppserve --listen`` hosts (counterpart of
pulseportraiture_tpu/cli/pproute.py).

    python -m pulseportraiture_tpu_torch.cli.pproute -r requests.jsonl \\
        (-H host:port[,host:port...] | --fleet-file FILE) [-O outdir] \\
        [--probe-ms MS] [--hedge-ms MS] [--no-shared-fs] \\
        [--quality-refit [--device cuda|cpu]] [--retry-max N] \\
        [--timeout S] [--transport-compress off|auto|on] \\
        [--telemetry trace.jsonl] [--monitor PORT] \\
        [--result-cache off|auto|on] [--cache-dir DIR] [--cache-max-mb MB] \\
        [--metrics off|on] [--slo-targets t:SEC,...] [--quiet]

Reads ``ppserve -r``'s JSONL request file (one JSON object per line:
name, datafiles, modelfile, options, tenant) and routes every request
through a :class:`~..serve.router.ToaRouter` over the hosts
(``--hosts`` or PPT_ROUTER_HOSTS): least-loaded placement with sticky
per-template affinity, retryable-backpressure retries with capped
exponential backoff, exactly-once failover when a host dies, and one
``<name>.tim`` per request, byte-identical to the one-shot
``stream_wideband_TOAs``'s whichever host served it.

Archive paths must be readable on every host.  With the default
shared-filesystem lane ``--outdir`` must be too (the serving host writes
each ``.tim``); with ``--no-shared-fs`` the TOA payload returns over the
wire and THIS process writes each ``.tim``.  ``--fleet-file`` watches a
host list for joins and leaves; ``--probe-ms`` bounds the liveness
probes; ``--hedge-ms`` launches one duplicate of a slow request on
another host; ``--quality-refit`` routes one zap-and-refit of
gate-tripping archives to the least-loaded HEALTHY host (its zap
proposal runs on ``--device``).  ``--telemetry`` records the route and
fleet ledger (``python -m pulseportraiture_tpu_torch.cli.pptrace report``:
the "router" and "fleet" sections); ``--monitor PORT`` serves the
router's fleet-wide ``metrics`` op on 127.0.0.1:PORT while the batch
routes.  Exit code 0, or 1 when any request failed.  ``--tune-db``
applies the stored winners of ``--device``'s fingerprint to this
process's config, as ppserve does.
"""

import argparse
import os
import sys
import time


def build_parser():
    from .ppserve import add_cache_flags, add_obs_flags, add_tune_flags

    p = argparse.ArgumentParser(
        prog="pproute", description=__doc__.splitlines()[0])
    p.add_argument("-r", "--requests", metavar="requests.jsonl",
                   required=True,
                   help="JSONL request file (ppserve's format: name, "
                        "datafiles, modelfile, options per line).")
    p.add_argument("-H", "--hosts", metavar="host:port[,host:port...]",
                   default=None,
                   help="Fleet endpoints, each a running 'ppserve "
                        "--listen'. [default: config.router_hosts / "
                        "PPT_ROUTER_HOSTS]")
    p.add_argument("--fleet-file", dest="fleet_file", metavar="FILE",
                   default=None,
                   help="WATCHED membership file (one host:port per line, "
                        "# comments): the router joins and leaves hosts to "
                        "match whenever it changes. Mutually exclusive "
                        "with --hosts. Also via PPT_ROUTER_FLEET_FILE. "
                        "[default: config.router_fleet_file]")
    p.add_argument("--probe-ms", dest="probe_ms", type=float, default=None,
                   metavar="MS",
                   help="Deadline of the per-host stat probes; a probe past "
                        "it feeds the host's SUSPECT transition and "
                        "placement uses the cached load. [default: "
                        "config.router_probe_ms / PPT_ROUTER_PROBE_MS]")
    p.add_argument("--hedge-ms", dest="hedge_ms", type=float, default=None,
                   metavar="MS",
                   help="Hedged requests: a request unresolved after this "
                        "long launches one duplicate on the least-loaded "
                        "other host; the first completion wins. [default: "
                        "config.router_hedge_ms / PPT_ROUTER_HEDGE_MS, "
                        "off]")
    p.add_argument("--no-shared-fs", dest="no_shared_fs",
                   action="store_true", default=False,
                   help="Codec lane: hosts return the full TOA payload over "
                        "the wire and THIS process writes each .tim "
                        "(byte-identical to the shared-fs lane). [default: "
                        "hosts write]")
    p.add_argument("--quality-refit", dest="quality_refit",
                   action="store_true", default=False,
                   help="Routed quality loop: a collected request whose "
                        "TOAs trip config.quality_max_gof gets ONE "
                        "zap-and-refit on the least-loaded HEALTHY host "
                        "(here OR server-side PPT_QUALITY_REFIT, not "
                        "both). [default: off]")
    p.add_argument("-O", "--outdir", metavar="DIR", default=".",
                   help="Directory for per-request <name>.tim outputs "
                        "(readable by every host). [default: .]")
    p.add_argument("--retry-max", dest="retry_max", type=int, default=None,
                   metavar="N",
                   help="Total placement attempts per request before the "
                        "last retryable rejection is raised. [default: "
                        "config.router_retry_max / PPT_ROUTER_RETRY_MAX]")
    p.add_argument("--timeout", type=float, default=None, metavar="S",
                   help="Per-request result timeout in seconds. "
                        "[default: none]")
    p.add_argument("--transport-compress", dest="transport_compress",
                   default=None, metavar="off|auto|on",
                   help="zlib-compress large socket frames: 'off', 'auto' "
                        "(size/saving rule), 'on'; peers decode "
                        "transparently. Also via PPT_TRANSPORT_COMPRESS. "
                        "[default: config.transport_compress]")
    p.add_argument("--telemetry", metavar="trace.jsonl", default=None,
                   help="Write the routing trace (route_submit/route_retry/"
                        "route_done, fleet_transition, route_failover, "
                        "route_hedge) here. Also via PPT_TELEMETRY. "
                        "[default: off]")
    p.add_argument("--monitor", dest="monitor", type=int, default=None,
                   metavar="PORT",
                   help="Serve the router's fleet-wide 'metrics' op on "
                        "127.0.0.1:PORT while the batch routes (port 0 = "
                        "ephemeral, printed). [default: off]")
    add_cache_flags(p)
    add_tune_flags(p)
    add_obs_flags(p)
    p.add_argument("--device", default=None, metavar="cuda|cpu",
                   help="torch device of the --quality-refit zap proposal. "
                        "[default: cuda]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.retry_max is not None and args.retry_max < 1:
        raise SystemExit(f"--retry-max: must be >= 1, got {args.retry_max}")
    if args.probe_ms is not None and not args.probe_ms > 0:
        raise SystemExit(f"--probe-ms: must be > 0, got {args.probe_ms}")
    if args.hedge_ms is not None and args.hedge_ms < 0:
        raise SystemExit(f"--hedge-ms: must be >= 0, got {args.hedge_ms}")
    from .. import config

    if args.transport_compress is not None:
        table = {"off": False, "auto": "auto", "on": True}
        v = str(args.transport_compress).lower()
        if v not in table:
            raise SystemExit("pproute: --transport-compress expected one "
                             f"of off/auto/on, got "
                             f"{args.transport_compress!r}")
        config.transport_compress = table[v]
    from .ppserve import apply_cache_flags, apply_obs_flags, apply_tune_flags

    apply_cache_flags(args, "pproute")
    apply_tune_flags(args, "pproute", device=args.device)
    apply_obs_flags(args, "pproute")
    if args.monitor is not None and not 0 <= args.monitor <= 65535:
        raise SystemExit(f"--monitor: port out of range, got {args.monitor}")
    if args.hosts is not None and args.fleet_file is not None:
        raise SystemExit("pproute: --hosts and --fleet-file are mutually "
                         "exclusive (static list vs watched membership)")
    fleet_file = args.fleet_file
    if fleet_file is None and args.hosts is None:
        fleet_file = config.router_fleet_file
    hosts = args.hosts
    if hosts is not None:
        hosts = [h.strip() for h in str(hosts).split(",") if h.strip()]
    elif fleet_file is None:
        hosts = list(config.router_hosts)
    else:
        hosts = []
        if not os.path.exists(fleet_file):
            raise SystemExit(f"pproute: --fleet-file not found: {fleet_file}")
    if not hosts and not fleet_file:
        raise SystemExit("pproute: no fleet endpoints — pass --hosts "
                         "host:port[,host:port...], --fleet-file, or set "
                         "PPT_ROUTER_HOSTS")
    for h in hosts:
        try:
            config.parse_hostport(h)
        except ValueError as e:
            raise SystemExit(f"pproute: --hosts: {e}")

    from .ppserve import parse_requests

    reqs = parse_requests(args.requests)
    # .tim paths cross the wire and are resolved by the SERVING host: a
    # relative outdir would land in the remote ppserve's cwd
    args.outdir = os.path.abspath(args.outdir)
    os.makedirs(args.outdir, exist_ok=True)

    from ..serve import ToaRouter, TransportError

    try:
        router = ToaRouter(hosts, retry_max=args.retry_max,
                           telemetry=args.telemetry, quiet=args.quiet,
                           probe_ms=args.probe_ms, hedge_ms=args.hedge_ms,
                           write_tim=("router" if args.no_shared_fs
                                      else "host"),
                           quality_refit=args.quality_refit,
                           fleet_file=fleet_file, device=args.device)
    except (TransportError, RuntimeError) as e:
        # unreachable hosts; --quality-refit without a card
        raise SystemExit(f"pproute: {e}")
    monitor = None
    if args.monitor is not None:
        # the TransportServer speaks the same ops over the router as over
        # a ToaServer: 'metrics' returns the fleet-wide aggregation
        from ..serve import TransportServer

        monitor = TransportServer(router, host="127.0.0.1",
                                  port=args.monitor,
                                  quiet=args.quiet).start()
        print(f"pproute: monitor endpoint on {monitor.label} (its "
              "'metrics' op)", flush=True)
    failures = 0
    t0 = time.time()
    with router:
        handles = []
        for rec in reqs:
            tim = os.path.join(args.outdir, f"{rec['name']}.tim")
            try:
                handles.append(router.submit(
                    rec["datafiles"], rec["modelfile"], tim_out=tim,
                    name=rec["name"], tenant=rec.get("tenant"),
                    **rec["options"]))
            except Exception as e:
                # a saturated or terminal fleet fails THIS request, not
                # the batch: the placed ones are still collected
                handles.append(None)
                failures += 1
                print(f"pproute: request {rec['name']!r} FAILED to place: "
                      f"{e}", file=sys.stderr)
        for rec, h in zip(reqs, handles):
            if h is None:
                continue
            try:
                res = h.result(args.timeout)
            except Exception as e:
                failures += 1
                print(f"pproute: request {rec['name']!r} FAILED on "
                      f"{h.host.label}: {e}", file=sys.stderr)
                continue
            if not args.quiet:
                # a router-side cache hit was placed on no host
                where = h.host.label if h.host is not None else "the cache"
                print(f"pproute: {rec['name']}: {len(res.TOA_list)} TOAs "
                      f"from {len(res.order)} archive(s) on {where} -> "
                      f"{res.tim_out}")
        placed = router.stats()
    if monitor is not None:
        monitor.close()
    if not args.quiet:
        share = ", ".join(f"{lbl}: {st['n_archives']} archive(s)/"
                          f"{st['n_requests']} request(s)"
                          for lbl, st in placed.items())
        print(f"pproute: {len(reqs) - failures}/{len(reqs)} requests "
              f"across {len(placed)} host(s) in {time.time() - t0:.2f} s "
              f"[{share}]")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
