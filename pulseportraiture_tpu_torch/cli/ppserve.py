"""ppserve: run the continuous-batching TOA server over a request set,
or serve remote clients as a fleet member (counterpart of
pulseportraiture_tpu/cli/ppserve.py).

The serving loop (serve/server.ToaServer) keeps ONE warm stream
executor alive and coalesces compatible subints across requests into
shared dispatches on the card.  In its batch mode (``-r``) this CLI is
its client: it reads a JSONL request file, submits every request at once
through the bounded admission queue (retrying on backpressure), waits
for all results, and writes one ``<name>.tim`` per request, each
byte-identical to the one-shot ``pptoas --stream`` with the same
``--nsub-batch``.

    python -m pulseportraiture_tpu_torch.cli.ppserve -r requests.jsonl \\
        [-O outdir] [--nsub-batch N] [--max-wait-ms MS] \\
        [--queue-depth N] [--stream-devices auto|N] [--max-inflight N] \\
        [--pipeline-depth N] [--warmup-manifest trace.jsonl \\
        [--warmup-model model]] [--telemetry trace.jsonl] [--timeout S] \\
        [--metrics off|on] [--slo-targets t:SEC,...] \\
        [--result-cache off|auto|on] [--cache-dir DIR] [--cache-max-mb MB] \\
        [--device cuda|cpu] [--quiet]
    python -m pulseportraiture_tpu_torch.cli.ppserve --listen HOST:PORT \\
        [the same server options]

Request file: one JSON object per line,
    {"name": "J0030+0451", "datafiles": ["a.fits", ...] | "meta.txt",
     "modelfile": "J0030.gmodel", "options": {"fit_scat": true, ...},
     "tenant": "interactive"}
``options`` are stream_wideband_TOAs fit options (lane options);
requests sharing (modelfile, options) coalesce.  ``tenant`` (optional)
labels the request's weighted-fair lane.

``--listen HOST:PORT`` (or PPT_SERVE_LISTEN, the listen mode's default)
runs the other mode: no request file; the warm server is exposed to
remote clients over the length-prefixed JSON transport
(serve/transport.TransportServer), and ``pproute`` routes a campaign's
requests across a fleet of such listeners.  Archive paths in remote
requests must be readable here (a shared filesystem); each request's
``.tim`` is written here unless the router writes it.  Port 0 binds an
ephemeral port; the bound address is printed on its own flushed line
(``ppserve: listening on HOST:PORT ...``) so a parent process can read
it.  The process serves until SIGINT or SIGTERM, then drains.

``--warmup-manifest trace.jsonl`` dispatches every bucket shape a prior
run's trace recorded once before serving starts
(utils/device.warmup_from_manifest), so the first requests pay no first
launch; compare the traces' cold-start sections with ``python -m
pulseportraiture_tpu_torch.cli.pptrace report``.

``--tune-db PATH`` applies the winners a prior ``pptoas --autotune``
stored for this card and torch build (tune/store.py) before the server
and its warm-up start; a DB of another fingerprint is refused with a
warning.  With ``--telemetry`` the hit is witnessed in the server's
trace by a ``tune_apply`` event (the JAX CLI applies it untraced).

``--compile-cache DIR`` builds the hand kernels into (and loads them
from) a shared directory (utils/device.enable_compile_cache), so a
restarted replica runs no nvcc.
"""

import argparse
import json
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppserve", description=__doc__.splitlines()[0])
    p.add_argument("-r", "--requests", metavar="requests.jsonl",
                   default=None,
                   help="JSONL request file (one JSON object per line: "
                        "name, datafiles, modelfile, options).")
    p.add_argument("--listen", metavar="HOST:PORT", default=None,
                   help="Serve REMOTE clients instead of a request file: "
                        "expose the warm server on this endpoint (port 0 "
                        "= ephemeral, printed) for pproute/SocketTransport "
                        "clients; runs until SIGINT or SIGTERM, then "
                        "drains. Exactly one of -r / --listen. Also via "
                        "PPT_SERVE_LISTEN. [default: off]")
    p.add_argument("-O", "--outdir", metavar="DIR", default=".",
                   help="Directory for per-request <name>.tim outputs "
                        "(created). [default: .]")
    p.add_argument("--nsub-batch", dest="nsub_batch", type=int,
                   default=64, metavar="N",
                   help="Bucket row count; every dispatch pads to it. "
                        "[default: 64]")
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                   default=None, metavar="MS",
                   help="Deadline for partially filled buckets: a bucket "
                        "launches when full OR when its oldest subint "
                        "has waited this long. [default: "
                        "config.serve_max_wait_ms / PPT_SERVE_MAX_WAIT_MS]")
    p.add_argument("--queue-depth", dest="queue_depth", type=int,
                   default=None, metavar="N",
                   help="Admission-queue capacity in archives; a submit "
                        "beyond it is rejected (backpressure). [default: "
                        "config.serve_queue_depth / PPT_SERVE_QUEUE_DEPTH]")
    p.add_argument("--stream-devices", dest="stream_devices",
                   default=None, metavar="auto|N",
                   help="CUDA devices to deal buckets across ('auto' = "
                        "all, or a count). [default: "
                        "config.stream_devices]")
    p.add_argument("--max-inflight", dest="max_inflight", type=int,
                   default=None, metavar="N",
                   help="Pending dispatches per device before the loop "
                        "blocks on the oldest. [default: "
                        "config.stream_max_inflight]")
    p.add_argument("--pipeline-depth", dest="pipeline_depth",
                   default=None, type=int, metavar="N",
                   help="Per-device copy->fit pipeline depth. [default: "
                        "config.stream_pipeline_depth]")
    p.add_argument("--warmup-manifest", dest="warmup_manifest",
                   default=None, metavar="trace.jsonl",
                   help="Dispatch every bucket shape this prior trace "
                        "records once before serving starts.")
    p.add_argument("--warmup-model", dest="warmup_model", default=None,
                   metavar="model",
                   help="Template the warm-up builds its portraits from "
                        "(with --warmup-manifest). [default: synthetic "
                        "profile]")
    p.add_argument("--telemetry", metavar="trace.jsonl", default=None,
                   help="Write the serve trace (request lifecycle, "
                        "batch_coalesce occupancy, cold starts) here. "
                        "Also via PPT_TELEMETRY. [default: off]")
    p.add_argument("--compile-cache", dest="compile_cache",
                   default=None, metavar="DIR",
                   help="Shared build directory of the hand kernels "
                        "(restarts load the built library, no nvcc). "
                        "Also via PPT_COMPILE_CACHE. [default: off]")
    p.add_argument("--timeout", type=float, default=None, metavar="S",
                   help="Per-request result timeout in seconds. "
                        "[default: none]")
    add_cache_flags(p)
    add_tune_flags(p)
    add_obs_flags(p)
    p.add_argument("--device", default=None, metavar="cuda|cpu",
                   help="The one torch device to serve on when "
                        "--stream-devices is not given. [default: every "
                        "CUDA device]")
    p.add_argument("--quiet", action="store_true", default=False)
    return p


def add_obs_flags(p):
    """The observability flags shared by ppserve and pproute: the
    streaming metrics registry and the per-tenant SLO targets."""
    p.add_argument("--metrics", dest="metrics", default=None,
                   metavar="off|on",
                   help="Streaming metrics registry (counters and "
                        "latency histograms, exported over the 'metrics' "
                        "transport op); the .tim is byte-identical either "
                        "way. Also via PPT_METRICS. [default: on]")
    p.add_argument("--slo-targets", dest="slo_targets", default=None,
                   metavar="t:SEC,...|SEC|off",
                   help="Per-tenant request-latency SLO targets in "
                        "seconds ('*' = default tenant; a bare number "
                        "applies to every tenant); breaches emit "
                        "slo_breach telemetry. Also via PPT_SLO_TARGETS. "
                        "[default: off]")


def add_tune_flags(p):
    """The tuning-database flag, shared by ppserve and pproute
    (tune/store.TuningStore)."""
    p.add_argument("--tune-db", dest="tune_db", default=None,
                   metavar="PATH",
                   help="Persisted per-backend tuning DB (JSON): the "
                        "stored knob winners for this card's fingerprint "
                        "are applied at startup; a DB from a different "
                        "backend is refused with a warning. Also via "
                        "PPT_TUNE_DB. [default: off]")


def apply_tune_flags(args, prog, tracer=None, device=None):
    """Apply --tune-db to config and load any stored winners of
    ``device``'s fingerprint (the store warns on a stale or corrupt
    DB)."""
    from .. import config
    from ..telemetry import NULL_TRACER
    from ..tune import apply_from_db

    if getattr(args, "tune_db", None) is not None:
        config.tune_db = args.tune_db
    if not config.tune_db:
        return
    try:
        apply_from_db(tracer=tracer if tracer is not None else NULL_TRACER,
                      device=device)
    except RuntimeError as e:   # no card to take the fingerprint of
        raise SystemExit(f"{prog}: --tune-db: {e}")


def add_cache_flags(p):
    """The content-addressed result-cache flags (ppserve, ppfactory)."""
    p.add_argument("--result-cache", dest="result_cache", default=None,
                   metavar="off|auto|on",
                   help="Content-addressed result cache: 'off', 'auto' "
                        "(on iff a cache dir is set — the default), or "
                        "'on' (requires --cache-dir). Hits are "
                        "byte-identical to fresh fits. Also via "
                        "PPT_RESULT_CACHE. [default: auto]")
    p.add_argument("--cache-dir", dest="cache_dir", default=None,
                   metavar="DIR",
                   help="On-disk store directory (created on demand). "
                        "Also via PPT_CACHE_DIR. [default: off]")
    p.add_argument("--cache-max-mb", dest="cache_max_mb", type=float,
                   default=None, metavar="MB",
                   help="Store size bound; least-recently-used entries "
                        "evict beyond it. Also via PPT_CACHE_MAX_MB. "
                        "[default: config.cache_max_mb]")


def apply_cache_flags(args, prog):
    """Validate the cache flags and apply them to config before the
    server is built (the tri-state resolves at construction)."""
    from .. import config

    if args.result_cache is not None:
        table = {"off": False, "auto": "auto", "on": True}
        v = str(args.result_cache).lower()
        if v not in table:
            raise SystemExit(
                f"{prog}: --result-cache: expected 'off', 'auto' or "
                f"'on', got {args.result_cache!r}")
        config.result_cache = table[v]
    if args.cache_max_mb is not None:
        if args.cache_max_mb <= 0:
            raise SystemExit(
                f"{prog}: --cache-max-mb: must be > 0, got "
                f"{args.cache_max_mb}")
        config.cache_max_mb = args.cache_max_mb
    if args.cache_dir is not None:
        config.cache_dir = args.cache_dir
    if config.result_cache is True and not config.cache_dir:
        raise SystemExit(
            f"{prog}: --result-cache on requires --cache-dir (or "
            "PPT_CACHE_DIR): an explicitly-on cache with nowhere to "
            "store entries would silently serve nothing")


def apply_obs_flags(args, prog):
    """Validate --metrics / --slo-targets and apply them to config
    before the server is built."""
    from .. import config

    if args.metrics is not None:
        table = {"off": False, "on": True}
        v = str(args.metrics).lower()
        if v not in table:
            raise SystemExit(
                f"{prog}: --metrics: expected 'off' or 'on', got "
                f"{args.metrics!r}")
        config.metrics = table[v]
    if args.slo_targets is not None:
        s = str(args.slo_targets).strip()
        if s.lower() in ("off", "none"):
            config.slo_targets = None
        else:
            try:
                config.slo_targets = config.parse_tenant_spec(
                    s, "--slo-targets", cast=float, allow_bare=True)
            except ValueError as e:
                raise SystemExit(f"{prog}: {e}")


def parse_requests(path):
    """Read and validate the JSONL request file -> list of dicts with
    name/datafiles/modelfile/options/tenant.  SystemExit on anything
    malformed (a dropped request line would be a lost pulsar)."""
    if not os.path.exists(path):
        raise SystemExit(f"ppserve: request file not found: {path}")
    reqs, names = [], set()
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: bad JSON: {e}")
            if not isinstance(rec, dict):
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: expected an object")
            missing = {"datafiles", "modelfile"} - set(rec)
            if missing:
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: missing "
                    f"{sorted(missing)}")
            name = str(rec.get("name", f"req{lineno}"))
            if name in names:
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: duplicate request "
                    f"name {name!r} (each writes <name>.tim)")
            names.add(name)
            options = rec.get("options", {})
            if not isinstance(options, dict):
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: options must be an "
                    "object")
            tenant = rec.get("tenant")
            if tenant is not None and not isinstance(tenant, str):
                raise SystemExit(
                    f"ppserve: {path}:{lineno}: tenant must be a "
                    "string (the QoS lane label)")
            reqs.append(dict(name=name, datafiles=rec["datafiles"],
                             modelfile=str(rec["modelfile"]),
                             options=options, tenant=tenant))
    if not reqs:
        raise SystemExit(f"ppserve: no requests in {path}")
    return reqs


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.nsub_batch < 1:
        raise SystemExit("--nsub-batch: must be >= 1, got "
                         f"{args.nsub_batch}")
    if args.max_wait_ms is not None and args.max_wait_ms < 0:
        raise SystemExit("--max-wait-ms: must be >= 0, got "
                         f"{args.max_wait_ms}")
    if args.queue_depth is not None and args.queue_depth < 1:
        raise SystemExit("--queue-depth: must be >= 1, got "
                         f"{args.queue_depth}")
    if args.max_inflight is not None and args.max_inflight < 1:
        raise SystemExit("--max-inflight: must be >= 1, got "
                         f"{args.max_inflight}")
    if args.pipeline_depth is not None and args.pipeline_depth < 1:
        raise SystemExit("--pipeline-depth: depth must be >= 1, got "
                         f"{args.pipeline_depth}")
    stream_devices = args.stream_devices
    if stream_devices is not None:
        s = str(stream_devices).strip().lower()
        if s == "auto":
            stream_devices = "auto"
        else:
            try:
                stream_devices = int(s)
            except ValueError:
                raise SystemExit("--stream-devices: expected 'auto' "
                                 f"or a positive count, got "
                                 f"{args.stream_devices!r}")
            if stream_devices < 1:
                raise SystemExit("--stream-devices: count must be "
                                 f">= 1, got {stream_devices}")
    if args.warmup_model and not args.warmup_manifest:
        raise SystemExit("--warmup-model requires --warmup-manifest")
    from .. import config

    if args.listen is not None and args.requests is not None:
        raise SystemExit("ppserve: -r/--requests and --listen are "
                         "mutually exclusive (batch client vs fleet "
                         "member)")
    # PPT_SERVE_LISTEN is only the listen mode's default: an explicit -r
    # is a batch request
    listen = args.listen
    if listen is None and args.requests is None:
        listen = config.serve_listen
    if listen is None and args.requests is None:
        raise SystemExit("ppserve: need -r/--requests (batch mode) or "
                         "--listen HOST:PORT (fleet member)")
    if listen is not None:
        try:
            config.parse_hostport(listen)
        except ValueError as e:
            raise SystemExit(f"ppserve: --listen: {e}")
        reqs = None
    else:
        reqs = parse_requests(args.requests)
    if args.compile_cache:
        from ..utils.device import enable_compile_cache

        config.compile_cache_dir = args.compile_cache
        enable_compile_cache(args.compile_cache)
    apply_cache_flags(args, "ppserve")
    apply_obs_flags(args, "ppserve")
    os.makedirs(args.outdir, exist_ok=True)

    from ..serve import ServeRejected, ToaServer
    from ..telemetry import resolve_tracer

    # the tuned winners are set before the server thread and its warm-up
    # start; with a trace, ONE tracer carries the tune_apply witness and
    # the server's events (a second Tracer on the path would rotate the
    # first away)
    telemetry, tracer, owned = args.telemetry, None, False
    if args.tune_db is not None or config.tune_db:
        tracer, owned = resolve_tracer(args.telemetry, run="ppserve")
        if owned:
            telemetry = tracer
    try:
        apply_tune_flags(args, "ppserve", tracer=tracer, device=args.device)
        return _serve(args, reqs, listen, stream_devices, telemetry,
                      ToaServer, ServeRejected)
    finally:
        if owned:
            tracer.close()


def _serve(args, reqs, listen, stream_devices, telemetry, ToaServer,
           ServeRejected):
    """Run the server over the request file, or in the listen mode."""
    server = ToaServer(
        nsub_batch=args.nsub_batch, max_wait_ms=args.max_wait_ms,
        queue_depth=args.queue_depth, stream_devices=stream_devices,
        max_inflight=args.max_inflight,
        pipeline_depth=args.pipeline_depth, telemetry=telemetry,
        warmup_manifest=args.warmup_manifest,
        warmup_model=args.warmup_model, quiet=args.quiet,
        device=args.device)

    if listen is not None:
        return serve_listen(server, listen, args.quiet)

    failures = 0
    t0 = time.time()
    with server:
        handles = []
        for rec in reqs:
            tim = os.path.join(args.outdir, f"{rec['name']}.tim")
            while True:
                try:
                    handles.append(server.submit(
                        rec["datafiles"], rec["modelfile"],
                        tim_out=tim, name=rec["name"],
                        tenant=rec.get("tenant"), **rec["options"]))
                    break
                except ServeRejected as e:
                    if not e.retryable:
                        raise
                    # a patient batch client: honour the backpressure
                    if not args.quiet:
                        print(f"ppserve: {e}; retrying", file=sys.stderr)
                    time.sleep(0.05)
        for rec, h in zip(reqs, handles):
            try:
                res = h.result(args.timeout)
            except Exception as e:
                failures += 1
                print(f"ppserve: request {rec['name']!r} FAILED: {e}",
                      file=sys.stderr)
                continue
            if not args.quiet:
                print(f"ppserve: {rec['name']}: "
                      f"{len(res.TOA_list)} TOAs from "
                      f"{len(res.order)} archive(s) -> {res.tim_out}")
    if not args.quiet:
        print(f"ppserve: {len(reqs) - failures}/{len(reqs)} requests "
              f"in {time.time() - t0:.2f} s")
    return 1 if failures else 0


def serve_listen(server, listen, quiet=False, stop=None):
    """The fleet-member mode: start ``server`` (its warm-up included),
    expose it on ``listen`` through a TransportServer, print the bound
    address on its own flushed line, and serve until SIGINT or SIGTERM
    (or until ``stop``, a threading.Event, is set); then close the
    listener and drain the server.  Returns 0."""
    import signal
    import threading

    from .. import config
    from ..serve import TransportServer

    host, port = config.parse_hostport(listen)
    stop = threading.Event() if stop is None else stop
    server.start()
    try:
        transport = TransportServer(server, host=host, port=port,
                                    quiet=quiet).start()
    except BaseException:
        server.stop(drain=False)
        raise
    try:
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
    except ValueError:
        pass  # not the main thread (a test drives main() directly)
    print(f"ppserve: listening on {transport.label} "
          f"({len(server._ex.devices)} device(s)); Ctrl-C to drain and "
          "exit", flush=True)
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    transport.close()
    server.stop(drain=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
