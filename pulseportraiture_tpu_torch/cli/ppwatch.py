"""ppwatch: the online observatory pipeline: watch a folder (and/or a
socket), time every arriving archive on the card, and alert on anomalies
(counterpart of pulseportraiture_tpu/cli/ppwatch.py).

    python -m pulseportraiture_tpu_torch.cli.ppwatch -w DIR -m model.gmodel \\
        [-t out.tim] [-p pulsar.par] [--listen HOST:PORT] [--drain] \\
        [--stable-ms MS] [--poll-ms MS] [--resolve-every N] \\
        [--cusum-k K] [--cusum-h H] [--nsub-batch N] [--max-wait-ms MS] \\
        [--telemetry trace.jsonl] [--device cuda|cpu] [--quiet]

It keeps one warm ToaServer (serve/server.py) on the card and pumps three
layers around it (ingest/):

  1. INGEST: a watch-folder source admits archives once complete (a
     ``<name>.done`` sentinel, or (size, mtime) unchanged for
     --stable-ms), probes each for truncation (half-written PSRFITS
     defer and retry; they never reach the loaders), and submits
     single-archive requests into the serving loop; results append to
     the streaming ``--tim`` file IN ADMISSION ORDER with durable
     sentinels, byte-identical to the one-shot stream_wideband_TOAs over
     the finished corpus at the same --nsub-batch.  ``--listen``
     additionally accepts push-style path announcements over the serve
     wire framing (``ingest.announce`` is the client helper).
  2. TIMING: with ``--par``, every completed archive's TOAs fold into an
     incremental GLS solution on the host (timing/incremental.py), with
     periodic full resolves (--resolve-every / PPT_GLS_RESOLVE_EVERY)
     that cross-check the running solution against the batch solver and
     raise on drift.
  3. ALERTING: CUSUM detectors on the residual stream (ingest/alerts.py)
     emit ``alert`` telemetry events for glitches, DM steps and profile
     changes; ``python -m pulseportraiture_tpu_torch.cli.pptrace
     report`` aggregates them in its alerts section.

By default ppwatch runs until SIGINT/SIGTERM, then drains in-flight
work.  ``--drain`` instead exits once the folder has gone idle (every
seen archive timed, nothing in flight).  ``--device`` picks the torch
device the server fits on (default: the card; ``cpu`` for tests).  Exit
1 when any archive errored.
"""

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppwatch", description=__doc__.splitlines()[0])
    p.add_argument("-w", "--watch", metavar="DIR", default=None,
                   help="Directory to watch for complete archives. "
                        "At least one of -w / --listen.")
    p.add_argument("--listen", metavar="HOST:PORT", default=None,
                   help="Also accept archive-path announcements over "
                        "the serve wire framing on this endpoint "
                        "(port 0 = ephemeral, printed). [default: off]")
    p.add_argument("-m", "--model", metavar="MODEL", required=True,
                   help="Portrait template every archive fits against "
                        "(.gmodel/.spl).")
    p.add_argument("-t", "--tim", metavar="FILE", default=None,
                   help="Streaming .tim output (append-only, admission "
                        "order, durable sentinels). [default: "
                        "<watch-dir>/ppwatch.tim]")
    p.add_argument("-p", "--par", metavar="PARFILE", default=None,
                   help="Timing model: enables the incremental GLS "
                        "lane + anomaly alerting. Without it ppwatch "
                        "only streams TOAs. [default: off]")
    p.add_argument("--patterns", metavar="GLOB[,GLOB...]",
                   default="*.fits",
                   help="Candidate-file patterns in the watch folder. "
                        "[default: *.fits]")
    p.add_argument("--poll-ms", dest="poll_ms", type=float,
                   default=None, metavar="MS",
                   help="Folder poll cadence. [default: "
                        "config.ingest_poll_ms / PPT_INGEST_POLL_MS]")
    p.add_argument("--stable-ms", dest="stable_ms", type=float,
                   default=None, metavar="MS",
                   help="Size-stability window before an un-senti"
                        "neled file admits. [default: "
                        "config.ingest_stable_ms / "
                        "PPT_INGEST_STABLE_MS]")
    p.add_argument("--drain", action="store_true", default=False,
                   help="Exit once the corpus is idle (batch mode) "
                        "instead of serving until SIGINT.")
    p.add_argument("--idle-polls", dest="idle_polls", type=int,
                   default=5, metavar="N",
                   help="With --drain: consecutive empty polls that "
                        "count as idle. [default: 5]")
    p.add_argument("--resolve-every", dest="resolve_every", type=int,
                   default=None, metavar="N",
                   help="Full batch resolve + drift cross-check every "
                        "N incremental updates (0 = never). [default: "
                        "config.gls_resolve_every / "
                        "PPT_GLS_RESOLVE_EVERY]")
    p.add_argument("--cusum-k", dest="cusum_k", type=float,
                   default=None, metavar="K",
                   help="CUSUM drift allowance per sample (sigmas). "
                        "[default: config.alert_cusum_k / "
                        "PPT_ALERT_CUSUM_K]")
    p.add_argument("--cusum-h", dest="cusum_h", type=float,
                   default=None, metavar="H",
                   help="CUSUM alert threshold (accumulated sigmas). "
                        "[default: config.alert_cusum_h / "
                        "PPT_ALERT_CUSUM_H]")
    p.add_argument("--nsub-batch", dest="nsub_batch", type=int,
                   default=64, metavar="N",
                   help="Fused-bucket row count of the warm serving "
                        "loop. [default: 64]")
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                   default=None, metavar="MS",
                   help="Serving-loop deadline for partially-filled "
                        "buckets — the knob that bounds a lone "
                        "arrival's latency. [default: "
                        "config.serve_max_wait_ms]")
    p.add_argument("--telemetry", metavar="trace.jsonl", default=None,
                   help="Write the ingest/alert trace here; analyze "
                        "with python -m pulseportraiture_tpu_torch.cli."
                        "pptrace. Also via PPT_TELEMETRY. [default: off]")
    p.add_argument("--device", default=None, metavar="cuda|cpu",
                   help="The torch device the warm server fits on. "
                        "[default: every CUDA device]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.watch is None and args.listen is None:
        raise SystemExit("ppwatch: need -w/--watch DIR and/or "
                         "--listen HOST:PORT (an ingest pipeline "
                         "with no source has nothing to do)")
    if args.watch is not None and not os.path.isdir(args.watch):
        raise SystemExit(f"ppwatch: --watch: {args.watch!r} is not a "
                         "directory")
    if not os.path.exists(args.model):
        raise SystemExit(f"ppwatch: --model: {args.model} not found")
    if args.par is not None and not os.path.exists(args.par):
        raise SystemExit(f"ppwatch: --par: {args.par} not found")
    if args.poll_ms is not None and args.poll_ms <= 0:
        raise SystemExit("--poll-ms: must be > 0, got "
                         f"{args.poll_ms}")
    if args.stable_ms is not None and args.stable_ms < 0:
        raise SystemExit("--stable-ms: must be >= 0, got "
                         f"{args.stable_ms}")
    if args.idle_polls < 1:
        raise SystemExit("--idle-polls: must be >= 1, got "
                         f"{args.idle_polls}")
    if args.resolve_every is not None and args.resolve_every < 0:
        raise SystemExit("--resolve-every: must be >= 0, got "
                         f"{args.resolve_every}")
    if args.nsub_batch < 1:
        raise SystemExit("--nsub-batch: must be >= 1, got "
                         f"{args.nsub_batch}")
    if args.listen is not None:
        from .. import config

        try:
            config.parse_hostport(args.listen)
        except ValueError as e:
            raise SystemExit(f"ppwatch: --listen: {e}")
    patterns = tuple(s.strip() for s in args.patterns.split(",")
                     if s.strip())
    if not patterns:
        raise SystemExit("--patterns: no patterns given")
    tim_out = args.tim
    if tim_out is None:
        tim_out = os.path.join(args.watch or ".", "ppwatch.tim")

    import signal
    import threading

    from ..ingest import (AlertMonitor, IngestDriver, SocketSource,
                          WatchFolderSource)
    from ..serve import ToaServer
    from ..timing import IncrementalGLS

    sources = []
    if args.watch is not None:
        sources.append(WatchFolderSource(
            args.watch, patterns=patterns, poll_ms=args.poll_ms,
            stable_ms=args.stable_ms))
    socket_source = None
    if args.listen is not None:
        socket_source = SocketSource(listen=args.listen).start()
        sources.append(socket_source)
        print(f"ppwatch: announcements on "
              f"{socket_source.endpoint[0]}:"
              f"{socket_source.endpoint[1]}", flush=True)

    try:
        server = ToaServer(nsub_batch=args.nsub_batch,
                           max_wait_ms=args.max_wait_ms,
                           telemetry=args.telemetry, quiet=args.quiet,
                           device=args.device)
    except BaseException:
        # no card (or a bad device): the listener must not outlive main
        if socket_source is not None:
            socket_source.stop()
        raise
    t0 = time.time()
    inc = monitor = None
    if args.par is not None:
        from ..io import parse_parfile

        par = parse_parfile(args.par)
        inc = IncrementalGLS(par, resolve_every=args.resolve_every,
                             tracer=server.tracer)
        monitor = AlertMonitor(par.get("PSR", "?"),
                               tracer=server.tracer, k=args.cusum_k,
                               h=args.cusum_h)

    def on_toas(datafile, toas):
        if inc is None:
            return
        for toa in toas:
            result = inc.update(toa)
            for alert in monitor.observe(result, toa):
                print(f"ppwatch: ALERT {alert['kind']} "
                      f"{alert['pulsar']} at MJD "
                      f"{alert['mjd']:.4f} (score "
                      f"{alert['score']:.1f})", flush=True)

    stop = threading.Event()
    try:
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
    except ValueError:
        pass  # not the main thread (tests drive main() directly)

    with server:
        driver = IngestDriver(server, args.model, sources,
                              tim_out=tim_out, tracer=server.tracer,
                              quiet=args.quiet)
        driver.on_toas = on_toas
        if not args.quiet:
            where = " + ".join(s.name for s in sources)
            print(f"ppwatch: watching {where} -> {tim_out}"
                  + ("" if args.drain else "; Ctrl-C to drain and "
                     "exit"), flush=True)
        try:
            driver.run(stop=stop,
                       idle_polls=(args.idle_polls if args.drain
                                   else None),
                       poll_ms=args.poll_ms)
        except KeyboardInterrupt:
            driver.drain()
    if socket_source is not None:
        socket_source.stop()
    if monitor is not None:
        monitor.finish()
    stats = driver.stats()
    if not args.quiet:
        n_alerts = len(monitor.alerts) if monitor is not None else 0
        print(f"ppwatch: {stats['completed']}/{stats['admitted']} "
              f"archives timed, {stats['deferred']} deferred, "
              f"{stats['errors']} errors, {n_alerts} alert(s) in "
              f"{time.time() - t0:.2f} s", flush=True)
    return 1 if stats["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
