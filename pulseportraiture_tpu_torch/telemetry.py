"""Campaign telemetry: structured event tracing, run manifests, and
the ``pptrace`` report (counterpart of pulseportraiture_tpu/telemetry.py).

When a campaign streams across devices, the operator needs to see
which device got which bucket, where the in-flight queues saturated,
which archives stalled the in-order checkpoint writer, what the cold
dispatches cost, what the host -> device link and the transport codec
did, and how fit quality (reduced chi^2, nfev, S/N) drifted, without
re-running anything under a profiler.

Three layers, with the JAX package's event vocabulary and schema
(``EVENT_FIELDS``, ``TRACE_SCHEMA_VERSION``) unchanged, so a trace of
either package reads through either package's report:

- **Tracer**: a thread-safe, append-only JSONL event writer plus a
  counters/gauges registry.  One file per run; the FIRST record is a
  versioned *manifest* (schema version, the torch backend -- "cuda" or
  "cpu" -- and the CUDA devices' names, a snapshot of the config
  knobs) so traces are self-describing; the LAST record dumps the
  counters.  Disabled mode (the default: ``config.telemetry_path`` is
  None) is a module singleton whose methods are no-ops and whose
  ``enabled`` flag lets hot paths skip even building the event dict.
  Timestamps are taken only around calls that already block (dispatch
  drains, the copy stage's own stream wait, file IO): tracing adds no
  host sync to the device hot path.
- **Instrumentation** lives in the campaign drivers
  (pipeline/stream.py, pipeline/toas.py, pipeline/ipta.py,
  pipeline/zap.py, pipeline/factory.py, timing/fleet.py), which emit
  the event vocabulary validated by :func:`validate_trace`.
- **Report**: :func:`report` (CLI: ``python -m
  pulseportraiture_tpu_torch.cli.pptrace report trace.jsonl``) turns a
  trace into a device-utilization timeline, per-device busy/idle
  fractions, queue-depth statistics vs ``stream_max_inflight``, link
  and codec accounting, checkpoint straggler/stall analysis, cold
  dispatch accounting, and quality histograms.

The leveled :func:`log` helper also lives here: one status-line
function that honors ``quiet`` consistently across every driver and
mirrors its lines into the active trace.
"""

import json
import math
import os
import sys
import threading
import time

import numpy as np

__all__ = ["TRACE_SCHEMA_VERSION", "Tracer", "NULL_TRACER",
           "resolve_tracer", "log", "finite", "load_trace",
           "validate_trace", "report", "main"]

TRACE_SCHEMA_VERSION = 1

# Config knobs snapshotted into every manifest: the full set
# config.env_overrides() can touch, plus the dispatch-routing knobs a
# trace reader needs to interpret device/queue numbers.
CONFIG_SNAPSHOT_KEYS = (
    "cross_spectrum_dtype", "dft_precision", "dft_fold", "align_device",
    "gauss_device", "gls_device", "zap_device", "zap_nstd",
    "quality_refit", "quality_max_gof", "quality_min_snr",
    "stream_devices", "stream_max_inflight", "stream_pipeline_depth",
    "compile_cache_dir", "telemetry_path",
    "serve_max_wait_ms", "serve_queue_depth", "bucket_pad",
    "router_hosts", "router_retry_max", "serve_listen",
    "router_probe_ms", "router_hedge_ms", "router_fleet_file",
    "serve_tenant_quota", "serve_tenant_weight",
    "use_fast_fit", "use_matmul_dft", "fit_harmonic_window",
    "scatter_compensated", "lm_jacobian", "fit_fused",
    "raw_subbyte", "transport_compress",
    "result_cache", "cache_dir", "cache_max_mb",
    "ingest_poll_ms", "ingest_stable_ms",
    "alert_cusum_k", "alert_cusum_h", "gls_resolve_every",
    "tune_db", "autotune", "tune_numerics", "lm_compact_every",
    "slo_targets", "metrics", "mon_interval_ms",
)

# The event vocabulary: type -> fields REQUIRED beyond (type, t).
# Extra fields are allowed (forward-compatible); unknown types are NOT
# (validate_trace exists to catch event-shape drift when the executor
# changes — see tests/test_bench_smoke.py).
EVENT_FIELDS = {
    "manifest": {"schema", "run", "t0_unix", "backend", "devices",
                 "config"},
    "log": {"level", "msg"},
    "resume_skip": {"n_skipped"},
    "archive_skip": {"datafile", "reason"},
    "archive_prepare": {"iarch", "datafile", "n_ok", "n_subints",
                        "prep_s"},
    "archive_load": {"datafile", "load_s"},
    "archive_fit": {"datafile", "n_ok", "fit_s"},
    "dispatch": {"seq", "device", "shape", "n", "queue_depth", "cold"},
    "dispatched": {"seq", "device"},
    # the transfer pipeline's copy stage: h2d_start fires on the copy
    # worker as the bucket's host->device move begins (overlap = a fit
    # was in flight on that device, i.e. the link is hidden behind
    # compute); h2d_done carries the byte count and duration pptrace's
    # link-utilization section aggregates, plus the compression
    # accounting (): bytes_logical = what the copy would have
    # shipped without the transport codec (== bytes when it never
    # engaged), codec_s = the probe/encode wall, and an optional
    # 'codec' decision tag ('engaged' | 'cost' | 'ratio') forming the
    # cost-model decision ledger
    "h2d_start": {"seq", "device", "overlap"},
    "h2d_done": {"seq", "device", "bytes", "h2d_s", "overlap",
                 "bytes_logical", "codec_s"},
    "drain": {"seq", "device", "wait_s", "scatter_s"},
    "quality": {"snr", "gof", "nfev"},
    "archive_done": {"iarch", "datafile"},
    "ckpt_flush": {"iarch", "datafile", "n_toas", "lag"},
    "force_flush": {"datafile", "lag"},
    "run_end": {"driver", "n_toas", "nfit"},
    "campaign_start": {"n_jobs", "pid", "nproc"},
    "pulsar_done": {"pulsar", "n_toas", "nfit"},
    "campaign_end": {"n_toas", "nfit", "wall_s"},
    # the serving loop (serve/server.py): request lifecycle, the
    # cross-request coalescing proof, and the warm-up ledger the
    # "serve" report section aggregates
    "serve_start": {"n_devices", "nsub_batch", "max_wait_ms",
                    "queue_depth"},
    "serve_stop": {"drained"},
    "request_submit": {"req", "n_archives"},
    "request_done": {"req", "n_toas", "n_archives", "wall_s",
                     "queue_s"},
    # one per fused dispatch the server launches: rows = real subints,
    # pad = padded rows, n_requests = distinct requests sharing the
    # bucket (> 1 is continuous batching doing its job)
    "batch_coalesce": {"seq", "n_requests", "rows", "pad"},
    # the warm-up (utils/device.warmup_from_manifest): one per
    # (manifest shape x device) dispatched before serving started; the
    # wall rides the schema's compile_s
    "warmup_compile": {"shape", "device", "compile_s"},
    # the cross-host router (serve/router.ToaRouter): router_start
    # once per router; route_submit per PLACED request (host = the
    # endpoint that accepted it, attempt counts placements tried,
    # affinity marks a sticky-template win); route_retry per rejected
    # placement (backpressure or unreachable host) with the backoff
    # then applied; route_done when the client collected the result
    # (error non-null on a failed request).  The "router" report
    # section aggregates per-host shares, retry rate, and the
    # placement-imbalance metric from exactly these.
    "router_start": {"n_hosts", "hosts", "retry_max"},
    "route_submit": {"req", "host", "n_archives", "attempt",
                     "affinity"},
    "route_retry": {"req", "host", "attempt", "backoff_s", "error"},
    "route_done": {"req", "host", "wall_s", "n_toas", "error"},
    # the elastic fleet (serve/fleet.py + the router's failover/hedge
    # layer): fleet_transition per health-state edge
    # (JOINING/HEALTHY/SUSPECT/DEAD/REJOINED + LEFT on removal);
    # route_failover per dead-host re-placement (action 'collected' =
    # served from the durable .tim with no re-fit, 'redispatch' =
    # placed on a surviving host with the dead one excluded, 'failed'
    # = nowhere to go); route_hedge per hedge launch (primary = the
    # host the request was first placed on).  route_submit/route_done
    # and request_submit/request_done additionally carry a 'tenant'
    # label for the fleet section's per-tenant latency split.
    "fleet_transition": {"host", "from_state", "to_state", "reason"},
    "route_failover": {"req", "dead_host", "action"},
    "route_hedge": {"req", "primary", "host"},
    # the template factory (pipeline/factory.build_templates): one
    # template_fit per bucket dispatch — stage 'profile'|'portrait',
    # the bucket's shape key, rows (real problems), pad (padded rows:
    # B rounded to its power-of-two class + frozen pad components),
    # worst per-problem nfev, wall seconds, whether the batched
    # lane ran (False = host-serial oracle), and the Jacobian source
    # the dispatch resolved ('analytic' | 'ad' — the A/B axis)
    "template_fit": {"stage", "bucket", "rows", "pad", "nfev_max",
                     "wall_s", "batched", "jac"},
    # one per finished template job (pulsar)
    "template_job": {"datafile", "kind", "ngauss", "converged",
                     "iters"},
    "factory_end": {"n_jobs", "n_dispatches", "wall_s"},
    # the fleet timing stage (timing/fleet.fleet_gls_fit): one
    # timing_fit per GLS solve dispatch — bucket is the padded
    # (rows x params) shape class ('host:...' on the NumPy oracle
    # lane), rows = real systems in the dispatch, pad = zero-padded
    # batch rows, batched marks the one-dispatch-per-bucket lane
    # (False = per-pulsar serial, the bench A/B arm / host lane) —
    # and one fleet_end rollup per fleet_gls_fit call.  The "timing"
    # report section aggregates exactly these.
    "timing_fit": {"bucket", "rows", "pad", "wall_s", "batched"},
    "fleet_end": {"n_pulsars", "n_dispatches", "wall_s"},
    # the quality subsystem (quality/ + pipeline/zap.py + the serving
    # refit loop): zap_propose = one median-algorithm proposal pass
    # (n_iter = worst per-subint iteration count; device marks the
    # one-dispatch batched lane; wall_s is the zap wall the report
    # aggregates); zap_apply = a zap actually applied to weights/masks
    # (offline apply, the streaming inline lane per archive, or a
    # refit); refit = one serve-loop zap-and-refit resolution with the
    # before/after goodness-of-fit the quality section reports
    "zap_propose": {"datafile", "n_channels", "n_iter", "device",
                    "wall_s"},
    "zap_apply": {"datafile", "n_channels"},
    "refit": {"req", "datafile", "n_channels", "gof_before",
              "gof_after", "improved"},
    # the content-addressed result cache (serve/cache.py):
    # cache_hit per lookup served from the store (bytes = stored .tim
    # payload size, source = 'router' | 'server' — a router hit never
    # touched a host); cache_miss per lookup that fell through to the
    # fit path; cache_store per fresh fit persisted into the store;
    # cache_evict per LRU eviction under the cache_max_mb bound.
    # hit/miss additionally carry a 'tenant' label for the cache
    # section's per-tenant hit split.
    "cache_hit": {"req", "bytes", "source"},
    "cache_miss": {"req", "source"},
    "cache_store": {"key", "bytes"},
    "cache_evict": {"key", "bytes"},
    # the online observatory pipeline (ingest/):
    # ingest_admit = one archive admitted from a source into the warm
    # serve loop (wait_s = discovery->admission wall, the
    # size-stability + backpressure wait); ingest_skip = a discovered
    # file NOT admitted this pass with the reason ('unstable' = still
    # being written, 'truncated' = typed torn-file retry,
    # 'backpressure' = ServeRejected(retryable), 'error' = poisoned);
    # alert = one anomaly detection on the residual stream — kind is
    # 'glitch' | 'dm_step' | 'profile_change', pulsar/mjd locate it,
    # score is the CUSUM sum (or red-chi2) that crossed, threshold is
    # the h it crossed.  The "alerts" report section and the
    # n_alert/ingest_p99_s summary keys aggregate exactly these.
    "ingest_admit": {"datafile", "source", "wait_s"},
    "ingest_skip": {"datafile", "source", "reason"},
    "alert": {"kind", "pulsar", "mjd", "score", "threshold"},
    # the per-backend autotune subsystem (tune/): tune_probe
    # = one capability-record derivation (the backend fingerprint plus
    # the measured dispatch-floor/throughput probes); tune_sweep = one
    # knob swept (n_rejected counts candidates the byte-identity gate
    # refused before timing; winner == default means no candidate
    # beat it); tune_apply = one knob-set application with the DB-hit
    # witness — db_hit=true is the zero-re-sweep proof the "tuning"
    # report section and bench_autotune.py gate on.
    "tune_probe": {"backend", "device_kind", "fingerprint",
                   "dispatch_floor_s", "matmul_gflops", "dft_gflops"},
    "tune_sweep": {"shape_class", "knob", "default", "winner",
                   "n_candidates", "n_rejected", "default_s",
                   "best_s"},
    "tune_apply": {"shape_class", "db_hit", "db_path", "knobs",
                   "default_s", "tuned_s"},
    # the SLO engine (obs/slo.py): one slo_breach per EDGE
    # into fast-burn — both the short and long burn-rate windows
    # crossed the threshold for the tenant's latency objective.  The
    # event also carries 'source' ('router' = end-to-end routed
    # latency, 'server' = per-host serve latency) and 'window_s'
    # extras; re-armed only after the short window recovers, so a
    # sustained breach emits once, not once per request.
    "slo_breach": {"tenant", "target_s", "burn_short", "burn_long"},
    "counters": {"counters", "gauges"},
}


def finite(value, ndigits=None):
    """Round a float for an event payload, mapping NaN/Inf to None
    (JSON null) — json.dumps would otherwise write bare ``NaN`` tokens
    that strict JSON consumers (jq, log pipelines) reject.  Degenerate
    fits DO produce NaN chi2/snr, so quality emits route through
    here."""
    value = float(value)
    if not math.isfinite(value):
        return None
    return round(value, ndigits) if ndigits is not None else value


def _jsonable(obj):
    """json.dumps default= hook: numpy scalars/arrays -> plain Python.
    Device objects and anything else fall back to str."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def _torch_backend():
    """The manifest's (backend, devices): "cuda" and each visible CUDA
    device's name when torch sees a card, else "cpu" and []."""
    import torch

    if torch.cuda.is_available():
        return "cuda", [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
    return "cpu", []


class Tracer:
    """Append-only JSONL event trace for one campaign run.

    Thread-safe: the streaming executor has one dispatch worker per
    device plus prefetch threads, and all of them emit (worker-side
    ``dispatched`` completions arrive via Future callbacks).  A single
    lock serializes writes; events carry their own monotonic ``t``
    (seconds since the manifest), so near-simultaneous events from
    different threads may appear a few microseconds out of ``t`` order
    in the file — readers sort on ``t`` when they care.

    The manifest (first record) makes the trace self-describing:
    schema version, the run label, wall-clock anchor, the torch
    backend and device list (:func:`_torch_backend`), and a snapshot of
    the config knobs (``None`` for a knob the port does not have).  ``close()`` appends the counters/gauges registry as the
    final record.
    """

    enabled = True

    def __init__(self, path, run="run"):
        from . import config

        self.path = str(path)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._counters = {}
        self._gauges = {}
        self._seq = 0
        self._closed = False
        # one-level rotation: a killed run's trace is crash forensics
        # (events flush per emit exactly so they survive), and resume
        # re-resolves the same telemetry path — truncating here would
        # destroy the record of what was in flight when the run died
        try:
            if os.path.getsize(self.path) > 0:
                os.replace(self.path, self.path + ".prev")
        except OSError:
            pass  # no previous trace
        self._fh = open(self.path, "w")
        backend, devices = _torch_backend()
        manifest = {
            "schema": TRACE_SCHEMA_VERSION,
            "run": str(run),
            "t0_unix": time.time(),
            "backend": backend,
            "devices": devices,
            "config": {k: getattr(config, k, None)
                       for k in CONFIG_SNAPSHOT_KEYS},
        }
        self.emit("manifest", **manifest)

    # -- event + registry API -----------------------------------------
    def emit(self, type, **fields):
        """Append one event record.  ``t`` is seconds since the
        manifest (monotonic clock)."""
        fields["type"] = type
        fields["t"] = round(time.perf_counter() - self._t0, 6)
        line = json.dumps(fields, separators=(",", ":"),
                          default=_jsonable) + "\n"
        with self._lock:
            if self._closed:
                return
            self._fh.write(line)
            self._fh.flush()  # crash-visible: a killed run keeps its
            # events on disk (the same stance as the .tim checkpoints)

    def next_seq(self):
        """Trace-global dispatch sequence number.  The TRACER owns the
        counter (not the executor): several executors can share one
        trace — stream_ipta_campaign runs one per pulsar — and the
        report pairs dispatch/dispatched/drain events by seq, so seqs
        must be unique across the whole file."""
        with self._lock:
            seq = self._seq
            self._seq += 1
            return seq

    def counter(self, name, inc=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + inc

    def gauge_max(self, name, value):
        """High-water-mark gauge (e.g. peak queue depth)."""
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    def close(self):
        """Write the counters record and close the file (idempotent).
        The counters write and the closed flag flip under ONE lock
        acquisition: a straggling worker-thread emit (e.g. a
        ``dispatched`` Future callback on an aborted run) either lands
        before the counters record or is dropped — it can never
        interleave after it, so the counters record is always last."""
        with self._lock:
            if self._closed:
                return
            rec = {"type": "counters",
                   "t": round(time.perf_counter() - self._t0, 6),
                   "counters": dict(self._counters),
                   "gauges": dict(self._gauges)}
            self._fh.write(json.dumps(rec, separators=(",", ":"),
                                      default=_jsonable) + "\n")
            self._closed = True
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # events flush per emit, so a tracer dropped on an exception
        # path loses nothing on disk; this just releases the fd (and
        # appends the counters record when the interpreter still can)
        try:
            self.close()
        except Exception:
            pass


class _NullTracer:
    """The disabled tracer: every method is a no-op and ``enabled`` is
    False so instrumentation sites can skip building event payloads
    entirely — the telemetry-off cost of the streaming hot path is one
    attribute read per dispatch."""

    enabled = False
    path = None
    _seq = 0

    def emit(self, type, **fields):
        pass

    def next_seq(self):
        # never emitted, but still monotonic: the transfer pipeline's
        # overlap accounting (res.h2d_overlap_s) orders dispatches by
        # seq, and that stat is surfaced with telemetry off too.  A GIL
        # race between executors can at worst produce a tie, which the
        # strict < comparison reads as "not earlier" — an undercount,
        # never an overcount.
        _NullTracer._seq += 1
        return _NullTracer._seq

    def counter(self, name, inc=1):
        pass

    def gauge_max(self, name, value):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


NULL_TRACER = _NullTracer()


def resolve_tracer(arg=None, run="run"):
    """Resolve a driver's ``telemetry=`` argument to ``(tracer,
    owned)``.

    ``arg`` may be an existing Tracer (shared — e.g.
    stream_ipta_campaign threads ONE tracer through every per-pulsar
    stream call so the whole campaign lands in one trace; not owned,
    the caller closes it), a path (a new trace is opened; owned), or
    None (``config.telemetry_path`` decides; the NULL tracer when that
    is unset — the default).  Owned tracers must be closed by the
    caller that resolved them."""
    if isinstance(arg, (Tracer, _NullTracer)):
        return arg, False
    if arg is None:
        from . import config
        arg = getattr(config, "telemetry_path", None)
    if not arg:
        return NULL_TRACER, False
    return Tracer(arg, run=run), True


# ---------------------------------------------------------------------------
# Leveled status logging: the drivers' bare
# print() lines applied `quiet` inconsistently (load_for_toas defaults
# quiet=True, the driver classes quiet=False, and skip/fail messages
# ignored it entirely).  One helper, one rule.
# ---------------------------------------------------------------------------

def log(msg, quiet=False, level="info", tracer=None):
    """Driver status line.

    ``info`` honors ``quiet`` and goes to stdout (progress/summary
    lines).  ``warn`` goes to stderr and is NEVER suppressed —
    skip/fail reasons must not vanish just because a campaign runs
    quiet (and they are mirrored into the trace regardless, so a quiet
    campaign still records why an archive was dropped).  When a tracer
    is given the line is also recorded as a ``log`` event."""
    if level not in ("info", "warn"):
        raise ValueError(f"log level must be 'info' or 'warn', "
                         f"got {level!r}")
    if tracer is not None and tracer.enabled:
        tracer.emit("log", level=level, msg=str(msg))
    if level == "warn":
        print(msg, file=sys.stderr)
    elif not quiet:
        print(msg)


# ---------------------------------------------------------------------------
# Trace reading / validation
# ---------------------------------------------------------------------------

def load_trace(path):
    """Read a trace -> (manifest, events).  Raises ValueError on a
    malformed file (no manifest, bad JSON).  Events keep file order
    (writes are lock-serialized; ``t`` is per-event)."""
    records = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: bad JSON: {e}")
            records.append(rec)
    if not records or records[0].get("type") != "manifest":
        raise ValueError(f"{path}: first record is not a manifest")
    return records[0], records[1:]


def validate_trace(path):
    """Validate a trace against the schema: manifest first, known
    schema version, every event of a known type with its required
    fields.  Returns (manifest, events); raises ValueError naming the
    first offending record.  This is the drift guard the bench smoke
    test runs whenever the executor changes."""
    manifest, events = load_trace(path)
    if manifest.get("schema") != TRACE_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: schema {manifest.get('schema')!r} != supported "
            f"{TRACE_SCHEMA_VERSION}")
    missing = EVENT_FIELDS["manifest"] - set(manifest)
    if missing:
        raise ValueError(f"{path}: manifest missing {sorted(missing)}")
    for i, ev in enumerate(events, 2):
        etype = ev.get("type")
        if etype not in EVENT_FIELDS:
            raise ValueError(f"{path}: record {i}: unknown event type "
                             f"{etype!r}")
        if "t" not in ev:
            raise ValueError(f"{path}: record {i}: no timestamp")
        missing = EVENT_FIELDS[etype] - set(ev)
        if missing:
            raise ValueError(f"{path}: record {i} ({etype}): missing "
                             f"{sorted(missing)}")
    return manifest, events


# ---------------------------------------------------------------------------
# pptrace report
# ---------------------------------------------------------------------------

def _merge_intervals(spans):
    """Union length-preserving merge of (start, end) intervals."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _hist_lines(values, nbins=8, width=32, fmt="{:.3g}"):
    """Text histogram rows for the quality section."""
    values = np.asarray(values, float)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return ["  (no samples)"]
    lo, hi = float(values.min()), float(values.max())
    if lo == hi:
        return [f"  {fmt.format(lo)} x{values.size}"]
    counts, edges = np.histogram(values, bins=nbins, range=(lo, hi))
    peak = max(int(counts.max()), 1)
    rows = []
    for c, e0, e1 in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * max(1 if c else 0, round(width * c / peak))
        rows.append(f"  {fmt.format(e0):>10} .. {fmt.format(e1):<10} "
                    f"|{bar:<{width}}| {int(c)}")
    return rows


def _timeline(busy_by_dev, t_end, width=60):
    """ASCII device-utilization timeline: one row per device, '#'
    where the device had at least one dispatch in flight."""
    rows = []
    t_end = max(t_end, 1e-9)
    for dev in sorted(busy_by_dev):
        cells = [" "] * width
        for s, e in busy_by_dev[dev]:
            i0 = min(int(s / t_end * width), width - 1)
            i1 = min(int(e / t_end * width), width - 1)
            for i in range(i0, i1 + 1):
                cells[i] = "#"
        rows.append(f"  dev{dev} |{''.join(cells)}|")
    return rows


def report(path, file=None):
    """Analyze a trace and print the pptrace report.  Returns the
    summary dict (what the tests — and scripts — consume); the printed
    text is the same numbers, human-shaped."""
    out = file or sys.stdout
    manifest, events = validate_trace(path)
    by_type = {}
    for ev in events:
        by_type.setdefault(ev["type"], []).append(ev)

    p = lambda s="": print(s, file=out)  # noqa: E731
    p(f"== pptrace report: {path} ==")
    p(f"run {manifest['run']!r}  schema {manifest['schema']}  "
      f"backend {manifest['backend']}  "
      f"{len(manifest['devices'])} local device(s)")
    cfg = manifest.get("config", {})
    p("config: " + ", ".join(f"{k}={cfg[k]!r}" for k in sorted(cfg)))

    # ---- dispatch/drain bookkeeping ---------------------------------
    dispatches = by_type.get("dispatch", [])
    drains = {ev["seq"]: ev for ev in by_type.get("drain", [])}
    done = {ev["seq"]: ev for ev in by_type.get("dispatched", [])}
    per_dev = {}
    busy_by_dev = {}
    t_end = max((ev["t"] for ev in events), default=0.0)
    cold_s = warm_s = 0.0
    n_cold = n_warm = 0
    for ev in dispatches:
        dev = ev["device"]
        d = per_dev.setdefault(dev, {"dispatches": 0, "subints": 0,
                                     "shapes": set()})
        d["dispatches"] += 1
        d["subints"] += ev["n"]
        d["shapes"].add(ev["shape"])
        drain = drains.get(ev["seq"])
        end_t = drain["t"] if drain else ev["t"]
        busy_by_dev.setdefault(dev, []).append((ev["t"], end_t))
        w = done.get(ev["seq"])
        if w is None:
            # no worker completion recorded (non-Future handle, or the
            # run died before the callback) — counting it as 0 s warm
            # would dilute avg_warm and inflate the first-launch estimate
            continue
        worker_s = w["t"] - ev["t"]
        if ev.get("cold"):
            n_cold += 1
            cold_s += worker_s
        else:
            n_warm += 1
            warm_s += worker_s
    for dev in busy_by_dev:
        busy_by_dev[dev] = _merge_intervals(busy_by_dev[dev])

    nfit_run = None
    peak_run = None
    run_ends = by_type.get("run_end", [])
    if run_ends:
        nfit_run = sum(ev["nfit"] for ev in run_ends)
        peak_run = max(ev.get("peak_inflight", 0) for ev in run_ends)

    p("")
    p("-- devices --")
    p(f"  {'dev':>4} {'dispatches':>10} {'subints':>8} {'shapes':>7} "
      f"{'busy_s':>8} {'busy%':>6}")
    device_counts = {}
    for dev in sorted(per_dev):
        d = per_dev[dev]
        busy = sum(e - s for s, e in busy_by_dev.get(dev, []))
        frac = busy / t_end if t_end > 0 else 0.0
        device_counts[dev] = d["dispatches"]
        p(f"  {dev:>4} {d['dispatches']:>10} {d['subints']:>8} "
          f"{len(d['shapes']):>7} {busy:>8.3f} {100 * frac:>5.1f}%")
    total_disp = sum(device_counts.values())
    tail = f" (run_end nfit {nfit_run})" if nfit_run is not None else ""
    p(f"  total dispatches {total_disp}{tail}")
    if busy_by_dev:
        p(f"  timeline over {t_end:.3f} s ('#' = >=1 dispatch in "
          "flight):")
        for row in _timeline(busy_by_dev, t_end):
            p(row)

    # ---- queue depth ------------------------------------------------
    depths = [ev["queue_depth"] for ev in dispatches]
    # effective limit: the executor records its resolved per-call
    # max_inflight in run_end; the manifest's config snapshot is only
    # the process default and is wrong when a driver was called with
    # max_inflight= explicitly
    limits = [ev["max_inflight"] for ev in run_ends
              if ev.get("max_inflight")]
    limit = max(limits) if limits else cfg.get("stream_max_inflight")
    max_depth = max(depths) if depths else 0
    p("")
    p("-- queue depth (at dispatch) --")
    if depths:
        sat = sum(1 for d in depths if limit and d >= limit)
        src = "run" if limits else "config default"
        p(f"  max {max_depth}  mean {np.mean(depths):.2f}  "
          f"limit max_inflight={limit} ({src})  "
          f"saturated dispatches {sat}/{len(depths)}")
    else:
        p("  (no dispatches)")

    # ---- h2d link utilization ---------------------------------------
    h2d = by_type.get("h2d_done", [])
    h2d_bytes = sum(int(ev["bytes"]) for ev in h2d)
    # pre-compression traces (schema < this release) lack the logical
    # fields; shipped == logical there
    h2d_bytes_logical = sum(int(ev.get("bytes_logical", ev["bytes"]))
                            for ev in h2d)
    codec_s_total = sum(float(ev.get("codec_s", 0.0)) for ev in h2d)
    codec_decisions = {}
    for ev in h2d:
        dec = ev.get("codec")
        if dec is not None:
            codec_decisions[dec] = codec_decisions.get(dec, 0) + 1
    h2d_s = sum(float(ev["h2d_s"]) for ev in h2d)
    h2d_overlap_s = sum(float(ev["h2d_s"]) for ev in h2d
                        if ev.get("overlap"))
    h2d_stall_frac = (1.0 - h2d_overlap_s / h2d_s) if h2d_s > 0 else None
    h2d_compression = (h2d_bytes_logical / h2d_bytes
                       if h2d_bytes else None)
    p("")
    p("-- h2d link (copy stage) --")
    if h2d:
        mbps = h2d_bytes / max(h2d_s, 1e-9) / 1e6
        link_frac = h2d_s / max(t_end, 1e-9)
        p(f"  {len(h2d)} copies, {h2d_bytes / 1e6:.2f} MB in "
          f"{h2d_s:.3f} s ({mbps:.1f} MB/s effective); link busy "
          f"{100 * link_frac:.1f}% of wall")
        # h2d_s can sum to 0.0 (sub-microsecond copies round to 0 at
        # emit time), leaving h2d_stall_frac None
        ov_pct = 100 * h2d_overlap_s / h2d_s if h2d_s > 0 else 0.0
        stall = (f"{100 * h2d_stall_frac:.1f}%"
                 if h2d_stall_frac is not None else "n/a")
        p(f"  overlapped with in-flight fit: {h2d_overlap_s:.3f} s "
          f"({ov_pct:.1f}%)  ->  link stall "
          f"fraction {stall} (copy time the fit "
          "stage could not hide; lower pipeline stalls = raise "
          "stream_pipeline_depth only if this is high AND devices "
          "idle)")
        # transport-compression accounting (): shipped vs
        # logical bytes, codec wall, and the cost-model decision
        # ledger — a trace with no decisions recorded compressed
        # nothing (transport_compress off, or no eligible payloads)
        if h2d_bytes_logical != h2d_bytes or codec_decisions:
            saved = h2d_bytes_logical - h2d_bytes
            ratio = h2d_compression or 1.0
            p(f"  compression: shipped {h2d_bytes / 1e6:.2f} MB of "
              f"{h2d_bytes_logical / 1e6:.2f} MB logical "
              f"({ratio:.2f}x, {saved / 1e6:.2f} MB saved), codec "
              f"wall {codec_s_total:.3f} s")
            if codec_decisions:
                parts = ", ".join(
                    f"{n} {k}" for k, n in sorted(
                        codec_decisions.items()))
                p(f"  cost-model decisions: {parts} ('engaged' = "
                  "packed; 'cost' = model predicted a loss; 'ratio' "
                  "= payload incompressible)")
        per_dev_h2d = {}
        for ev in h2d:
            d = per_dev_h2d.setdefault(ev["device"], [0, 0.0, 0.0, 0])
            d[0] += int(ev["bytes"])
            d[1] += float(ev["h2d_s"])
            d[2] += float(ev["h2d_s"]) if ev.get("overlap") else 0.0
            d[3] += int(ev.get("bytes_logical", ev["bytes"]))
        for dev in sorted(per_dev_h2d):
            b, s, o, lg = per_dev_h2d[dev]
            comp = (f", {lg / b:.2f}x compression" if lg != b else "")
            p(f"  dev{dev}: {b / 1e6:.2f} MB, {s:.3f} s, "
              f"{100 * (o / s if s else 0.0):.1f}% overlapped{comp}")
    else:
        p("  (no h2d events — pre-pipeline trace, or no dispatches)")

    # ---- checkpoint stalls / stragglers -----------------------------
    flushes = by_type.get("ckpt_flush", [])
    forces = by_type.get("force_flush", [])
    p("")
    p("-- checkpoint stalls --")
    if flushes:
        lags = sorted(flushes, key=lambda ev: -ev["lag"])
        p(f"  {len(flushes)} in-order flushes; "
          f"{len(forces)} staleness-horizon force-flushes")
        for ev in lags[:3]:
            if ev["lag"] > 0:
                p(f"  straggler: {ev['datafile']} flushed "
                  f"{ev['lag']} prepared archive(s) late "
                  f"({ev['n_toas']} TOAs)")
        if all(ev["lag"] == 0 for ev in flushes):
            p("  no archive deferred a checkpoint write")
    else:
        p("  (no checkpointing in this run)")

    # ---- cold start: what a shape's first dispatch on a device pays --
    p("")
    p("-- cold start (first dispatch per shape x device: the kernels' "
      "load or build, FFT plans, allocator growth on the worker) --")
    if n_cold:
        avg_warm = warm_s / n_warm if n_warm else 0.0
        p(f"  {n_cold} cold dispatch(es), {cold_s:.3f} s on workers "
          f"(warm avg {avg_warm:.4f} s x {n_warm}); est. first-launch "
          f"cost ~{max(cold_s - avg_warm * n_cold, 0.0):.3f} s")
    else:
        p("  (no dispatch events)")

    # ---- serve (request lifecycle + continuous batching) ------------
    req_done = by_type.get("request_done", [])
    coalesce = by_type.get("batch_coalesce", [])
    warmups = by_type.get("warmup_compile", [])
    occupancy = None
    req_p50 = req_p99 = None
    # every section below prints its header unconditionally with an
    # explicit "(no ... events)" line when the trace has none: a
    # vanished section reads as a broken report, and an
    # operator diffing two traces needs the absence stated, not implied
    p("")
    p("-- serve (continuous batching) --")
    if not (req_done or coalesce or warmups):
        p("  (no serve events)")
    else:
        n_sub = len(by_type.get("request_submit", []))
        if req_done:
            walls = np.asarray([ev["wall_s"] for ev in req_done], float)
            queues = np.asarray([ev["queue_s"] for ev in req_done],
                                float)
            req_p50 = float(np.percentile(walls, 50))
            req_p99 = float(np.percentile(walls, 99))
            ntoa = sum(int(ev["n_toas"]) for ev in req_done)
            p(f"  {len(req_done)}/{n_sub or len(req_done)} requests "
              f"done, {ntoa} TOAs")
            p(f"  request latency (submit->done): p50 {req_p50:.3f} s  "
              f"p90 {np.percentile(walls, 90):.3f} s  "
              f"p99 {req_p99:.3f} s")
            serve_s = walls - queues
            p(f"  queue-wait vs serve split: mean wait "
              f"{queues.mean():.3f} s, mean serve {serve_s.mean():.3f} "
              f"s (of which fused-fit wall rides the device sections "
              "above)")
        if coalesce:
            rows = sum(int(ev["rows"]) for ev in coalesce)
            pad = sum(int(ev["pad"]) for ev in coalesce)
            occupancy = rows / max(rows + pad, 1)
            shared = sum(1 for ev in coalesce if ev["n_requests"] > 1)
            p(f"  batch occupancy: {rows} rows used / {pad} padded "
              f"({100 * occupancy:.1f}% full) across {len(coalesce)} "
              f"dispatches; {shared} dispatch(es) coalesced >1 "
              "request")
        if warmups:
            w_s = sum(float(ev["compile_s"]) for ev in warmups)
            p(f"  warm-up: {len(warmups)} (shape x device) "
              f"dispatch(es) in {w_s:.3f} s before serving")

    # ---- result cache (content-addressed .tim store) ----------------
    c_hit = by_type.get("cache_hit", [])
    c_miss = by_type.get("cache_miss", [])
    c_store = by_type.get("cache_store", [])
    c_evict = by_type.get("cache_evict", [])
    cache_hit_rate = None
    cache_bytes_served = None
    cache_bytes_stored = None
    cache_tenant_hits = {}
    p("")
    p("-- result cache (content-addressed) --")
    if not (c_hit or c_miss or c_store or c_evict):
        p("  (no cache events)")
    else:
        n_lookup = len(c_hit) + len(c_miss)
        cache_hit_rate = len(c_hit) / max(n_lookup, 1)
        cache_bytes_served = sum(int(ev["bytes"]) for ev in c_hit)
        cache_bytes_stored = sum(int(ev["bytes"]) for ev in c_store)
        p(f"  {len(c_hit)}/{n_lookup} lookup(s) hit "
          f"({100 * cache_hit_rate:.1f}%): {cache_bytes_served} bytes "
          f"served from the store vs {cache_bytes_stored} bytes "
          f"fitted-and-stored ({len(c_store)} fresh fit(s) cached)")
        by_source = {}
        for ev in c_hit:
            by_source[ev["source"]] = by_source.get(ev["source"], 0) + 1
        if by_source:
            p("  hit split by layer: " + ", ".join(
                f"{src}={n}" for src, n in sorted(by_source.items()))
              + " (router hits never touched a host)")
        for ev in c_hit:
            t = ev.get("tenant")
            if t is not None:
                cache_tenant_hits[t] = cache_tenant_hits.get(t, 0) + 1
        if cache_tenant_hits:
            miss_by_tenant = {}
            for ev in c_miss:
                t = ev.get("tenant")
                if t is not None:
                    miss_by_tenant[t] = miss_by_tenant.get(t, 0) + 1
            for t in sorted(cache_tenant_hits):
                n_h = cache_tenant_hits[t]
                n_m = miss_by_tenant.get(t, 0)
                p(f"  tenant {t!r}: {n_h} hit(s) / {n_m} fit(s) — hits "
                  "are not billed against the tenant quota")
        if c_evict:
            ev_bytes = sum(int(ev["bytes"]) for ev in c_evict)
            p(f"  eviction pressure: {len(c_evict)} entrie(s) evicted, "
              f"{ev_bytes} bytes released (store bounded by "
              "cache_max_mb; least-recently-used first)")

    # ---- router (cross-host request sharding) -----------------------
    r_starts = by_type.get("router_start", [])
    r_sub = by_type.get("route_submit", [])
    r_retry = by_type.get("route_retry", [])
    r_done = by_type.get("route_done", [])
    router_imbalance = None
    router_host_counts = {}
    p("")
    p("-- router (cross-host request sharding) --")
    if not (r_starts or r_sub or r_retry or r_done):
        p("  (no router events)")
    else:
        n_hosts = max((ev["n_hosts"] for ev in r_starts), default=0)
        per_host = {}
        for ev in r_sub:
            if ev["host"] is None:
                continue  # router-side cache hit: no host touched
            d = per_host.setdefault(ev["host"],
                                    {"requests": 0, "archives": 0,
                                     "affinity": 0})
            d["requests"] += 1
            d["archives"] += int(ev["n_archives"])
            d["affinity"] += bool(ev.get("affinity"))
        done_by_host = {}
        err_by_host = {}
        for ev in r_done:
            if ev["host"] is None:
                continue  # cache hit: counted in the cache section
            done_by_host[ev["host"]] = \
                done_by_host.get(ev["host"], 0) + 1
            if ev.get("error"):
                err_by_host[ev["host"]] = \
                    err_by_host.get(ev["host"], 0) + 1
        tot_req = sum(d["requests"] for d in per_host.values())
        tot_arch = sum(d["archives"] for d in per_host.values())
        if r_starts:
            p(f"  fleet: {n_hosts} host(s), retry_max "
              f"{max(ev['retry_max'] for ev in r_starts)}")
        if per_host:
            p(f"  {'host':>24} {'requests':>9} {'archives':>9} "
              f"{'arch%':>6} {'affinity':>9} {'done':>5} {'errors':>7}")
            for host in sorted(per_host):
                d = per_host[host]
                share = d["archives"] / max(tot_arch, 1)
                p(f"  {host:>24} {d['requests']:>9} "
                  f"{d['archives']:>9} {100 * share:>5.1f}% "
                  f"{d['affinity']:>9} {done_by_host.get(host, 0):>5} "
                  f"{err_by_host.get(host, 0):>7}")
                router_host_counts[host] = d["archives"]
            # placement imbalance: max per-host archive share over the
            # ideal even share (1.0 = perfectly balanced; H = all work
            # on one of H hosts).  Computed over hosts that RECEIVED
            # work against the router_start fleet size, so an idle
            # host drags the metric up — that is the point.
            denom = max(n_hosts, len(per_host))
            even = tot_arch / max(denom, 1)
            router_imbalance = (max(d["archives"]
                                    for d in per_host.values())
                                / max(even, 1e-9))
            p(f"  placement imbalance (max host share / even share): "
              f"{router_imbalance:.2f} (1.0 = balanced over "
              f"{denom} host(s))")
        if r_sub or r_retry:
            rate = len(r_retry) / max(len(r_sub) + len(r_retry), 1)
            p(f"  {len(r_sub)} placement(s), {len(r_retry)} "
              f"retried rejection(s) ({100 * rate:.1f}% of "
              "placement attempts); backpressure retries land on the "
              "next-least-loaded host")
        if r_done:
            walls = np.asarray([ev["wall_s"] for ev in r_done], float)
            n_err = sum(1 for ev in r_done if ev.get("error"))
            p(f"  {len(r_done)}/{tot_req or len(r_done)} request(s) "
              f"collected ({n_err} failed); routed latency p50 "
              f"{float(np.percentile(walls, 50)):.3f} s  p99 "
              f"{float(np.percentile(walls, 99)):.3f} s")

    # ---- fleet (membership / failover / hedging / tenant QoS) -------
    ftrans = by_type.get("fleet_transition", [])
    fover = by_type.get("route_failover", [])
    hedges = by_type.get("route_hedge", [])
    tenant_evs = [ev for ev in (r_done or req_done)
                  if ev.get("tenant") is not None]
    fleet_states = {}
    n_failover_collected = None
    tenant_latency = {}
    p("")
    p("-- fleet (membership / failover / QoS) --")
    if not (ftrans or fover or hedges or tenant_evs):
        p("  (no fleet events)")
    else:
        if ftrans:
            per_host_edges = {}
            for ev in ftrans:
                per_host_edges.setdefault(ev["host"], []).append(ev)
                fleet_states[ev["host"]] = ev["to_state"]
            p(f"  {len(ftrans)} health transition(s); state timeline:")
            for host in sorted(per_host_edges):
                edges = per_host_edges[host]
                path = " -> ".join(
                    f"{ev['to_state']}@{ev['t']:.2f}s"
                    for ev in edges[-6:])
                lead = "... -> " if len(edges) > 6 else ""
                p(f"    {host}: {lead}{path}")
            degraded = [h for h, s in fleet_states.items()
                        if s in ("SUSPECT", "DEAD")]
            if degraded:
                p(f"    degraded at end of trace: "
                  f"{', '.join(sorted(degraded))}")
        if fover:
            by_action = {}
            for ev in fover:
                by_action[ev["action"]] = \
                    by_action.get(ev["action"], 0) + 1
            n_failover_collected = by_action.get("collected", 0)
            parts = ", ".join(f"{n} {a}"
                              for a, n in sorted(by_action.items()))
            p(f"  {len(fover)} in-flight failover(s) ({parts}); "
              "'collected' requests were served from their durable "
              ".tim with no re-fit")
        if hedges:
            wins = sum(1 for ev in r_done if ev.get("hedged")
                       and not ev.get("error"))
            p(f"  {len(hedges)} hedged request(s) "
              f"({wins} resolved with a hedge outstanding); first "
              "completion wins, the loser is cancelled at collection")
        if tenant_evs:
            by_tenant = {}
            for ev in tenant_evs:
                by_tenant.setdefault(ev["tenant"], []).append(ev)
            p(f"  per-tenant latency split "
              f"({len(by_tenant)} tenant(s)):")
            p(f"  {'tenant':>16} {'requests':>9} {'errors':>7} "
              f"{'p50_s':>8} {'p99_s':>8}")
            for tenant in sorted(by_tenant):
                evs = by_tenant[tenant]
                walls = np.asarray([ev["wall_s"] for ev in evs], float)
                n_err = sum(1 for ev in evs if ev.get("error"))
                tenant_latency[tenant] = {
                    "n": len(evs),
                    "p50_s": float(np.percentile(walls, 50)),
                    "p99_s": float(np.percentile(walls, 99)),
                }
                p(f"  {tenant:>16} {len(evs):>9} {n_err:>7} "
                  f"{tenant_latency[tenant]['p50_s']:>8.3f} "
                  f"{tenant_latency[tenant]['p99_s']:>8.3f}")

    # ---- template factory (batched Gaussian/spline model building) --
    tfit = by_type.get("template_fit", [])
    tjobs = by_type.get("template_job", [])
    template_pad_frac = None
    template_wall_s = None
    p("")
    p("-- template factory (batched LM buckets) --")
    if not (tfit or tjobs):
        p("  (no template events)")
    else:
        by_stage = {}
        for ev in tfit:
            s = by_stage.setdefault(ev["stage"],
                                    [0, 0, 0, 0.0, 0, set()])
            s[0] += 1
            s[1] += int(ev["rows"])
            s[2] += int(ev["pad"])
            s[3] += float(ev["wall_s"])
            s[4] = max(s[4], int(ev["nfev_max"]))
            s[5].add(ev["bucket"])
        template_wall_s = sum(s[3] for s in by_stage.values())
        rows_all = sum(s[1] for s in by_stage.values())
        pad_all = sum(s[2] for s in by_stage.values())
        template_pad_frac = pad_all / max(rows_all + pad_all, 1)
        n_batched = sum(1 for ev in tfit if ev.get("batched"))
        for stage in sorted(by_stage):
            nd, rows, pad, wall, nfev, shapes = by_stage[stage]
            occ = rows / max(rows + pad, 1)
            p(f"  {stage}: {nd} dispatch(es) over {len(shapes)} "
              f"bucket shape(s), {rows} problems + {pad} padded "
              f"({100 * occ:.1f}% full), wall {wall:.3f} s, "
              f"worst nfev {nfev}")
        p(f"  {n_batched}/{len(tfit)} dispatches on the batched lane; "
          f"aggregate pad fraction "
          f"{100 * template_pad_frac:.1f}%")
        if tjobs:
            ngs = [int(ev["ngauss"]) for ev in tjobs
                   if ev.get("ngauss") is not None]
            conv = sum(1 for ev in tjobs if ev.get("converged"))
            p(f"  {len(tjobs)} template job(s) done "
              f"({conv} converged); ngauss "
              f"min/median/max {min(ngs)}/{int(np.median(ngs))}/"
              f"{max(ngs)}" if ngs else
              f"  {len(tjobs)} template job(s) done")

    # ---- timing (fleet-batched wideband GLS) ------------------------
    tim_fit = by_type.get("timing_fit", [])
    fleet_ends = by_type.get("fleet_end", [])
    timing_pad_frac = None
    timing_wall_s = None
    n_timing_pulsars = None
    timing_dispatches = None
    p("")
    p("-- timing (fleet-batched wideband GLS) --")
    if not (tim_fit or fleet_ends):
        p("  (no timing events)")
    else:
        if fleet_ends:
            n_timing_pulsars = sum(int(ev["n_pulsars"])
                                   for ev in fleet_ends)
            timing_dispatches = sum(int(ev["n_dispatches"])
                                    for ev in fleet_ends)
            fleet_wall = sum(float(ev["wall_s"]) for ev in fleet_ends)
            p(f"  {n_timing_pulsars} pulsar(s) solved in "
              f"{timing_dispatches} dispatch(es) across "
              f"{len(fleet_ends)} fleet call(s), wall {fleet_wall:.3f}"
              " s (serial would pay one dispatch per pulsar — the "
              "reduction is the batched lane's win)")
        if tim_fit:
            rows = sum(int(ev["rows"]) for ev in tim_fit)
            pad = sum(int(ev["pad"]) for ev in tim_fit)
            timing_pad_frac = pad / max(rows + pad, 1)
            timing_wall_s = sum(float(ev["wall_s"]) for ev in tim_fit)
            n_batched = sum(1 for ev in tim_fit if ev.get("batched"))
            shapes = {}
            for ev in tim_fit:
                s = shapes.setdefault(ev["bucket"], [0, 0, 0])
                s[0] += 1
                s[1] += int(ev["rows"])
                s[2] += int(ev["pad"])
            p(f"  {len(tim_fit)} solve dispatch(es) "
              f"({n_batched} batched), {rows} system(s) + {pad} "
              f"zero-padded ({100 * (1 - timing_pad_frac):.1f}% "
              f"full), solve wall {timing_wall_s:.3f} s")
            for key in sorted(shapes):
                nd, rw, pd = shapes[key]
                p(f"    bucket {key}: {nd} dispatch(es), {rw} "
                  f"system(s) + {pd} pad")
    # ---- data quality (zap + refit) ---------------------------------
    zprop = by_type.get("zap_propose", [])
    zapp = by_type.get("zap_apply", [])
    refits = by_type.get("refit", [])
    zap_channels_cut = None
    zap_wall_s = None
    refit_rate = None
    n_refit_improved = None
    p("")
    p("-- data quality (zap + refit) --")
    if not (zprop or zapp or refits):
        p("  (no quality events)")
    else:
        if zprop:
            zap_wall_s = sum(float(ev["wall_s"]) for ev in zprop)
            n_dev = sum(1 for ev in zprop if ev.get("device"))
            worst_iter = max(int(ev["n_iter"]) for ev in zprop)
            p(f"  {len(zprop)} zap proposal pass(es) "
              f"({n_dev} on the one-dispatch device lane), zap wall "
              f"{zap_wall_s:.3f} s, worst iteration count {worst_iter} "
              "(device lane: every subint's cut iterates together on "
              "the device)")
        if zapp:
            zap_channels_cut = sum(int(ev["n_channels"]) for ev in zapp)
            p(f"  {len(zapp)} zap application(s), {zap_channels_cut} "
              "channel entr(ies) cut; per archive:")
            per_arch = {}
            for ev in zapp:
                per_arch[ev["datafile"]] = \
                    per_arch.get(ev["datafile"], 0) + int(ev["n_channels"])
            for df in sorted(per_arch, key=per_arch.get,
                             reverse=True)[:8]:
                p(f"    {df}: {per_arch[df]} channel entr(ies)")
        if refits:
            n_req = len(by_type.get("request_done", []))
            n_refit_improved = sum(1 for ev in refits
                                   if ev.get("improved"))
            refit_rate = len(refits) / max(n_req, 1) if n_req else None
            gb = [ev["gof_before"] for ev in refits
                  if ev.get("gof_before") is not None]
            ga = [ev["gof_after"] for ev in refits
                  if ev.get("gof_after") is not None]
            rate = (f"{100 * refit_rate:.1f}% of requests"
                    if refit_rate is not None else "n/a")
            p(f"  {len(refits)} refit(s) ({rate}), "
              f"{n_refit_improved} improved; red-chi^2 "
              f"before/after mean "
              f"{np.mean(gb) if gb else float('nan'):.3f} -> "
              f"{np.mean(ga) if ga else float('nan'):.3f}")
            for ev in refits:
                if not ev.get("improved"):
                    p(f"    NOT improved: {ev['datafile']} "
                      f"({ev['n_channels']} channel(s) cut, gof "
                      f"{ev.get('gof_before')} -> "
                      f"{ev.get('gof_after')})")

    # ---- quality ----------------------------------------------------
    qual = by_type.get("quality", [])
    snr = [v for ev in qual for v in ev["snr"]]
    gof = [v for ev in qual for v in ev["gof"]]
    nfev = [v for ev in qual for v in ev["nfev"]]
    p("")
    p(f"-- fit quality ({len(snr)} TOA records) --")
    for name, vals in (("snr", snr), ("gof (chi2/dof)", gof),
                       ("nfev", nfev)):
        p(f"  {name}:")
        for row in _hist_lines(vals):
            p(row)

    # ---- online ingest + alerts (ingest/) -----------------
    admits = by_type.get("ingest_admit", [])
    iskips = by_type.get("ingest_skip", [])
    alerts = by_type.get("alert", [])
    ingest_p50_s = ingest_p99_s = None
    alert_fp_rate = None
    incremental_resolves = None
    if by_type.get("counters"):
        incremental_resolves = (by_type["counters"][-1]["counters"]
                                .get("incremental_resolves"))
    p("")
    p("-- online ingest + alerts --")
    if not (admits or iskips or alerts):
        p("  (no ingest events)")
    else:
        if admits:
            waits = [float(ev["wait_s"]) for ev in admits
                     if ev.get("wait_s") is not None]
            if waits:
                ingest_p50_s = float(np.percentile(waits, 50))
                ingest_p99_s = float(np.percentile(waits, 99))
                p(f"  {len(admits)} archive(s) admitted; "
                  f"discovery->admission wait p50 {ingest_p50_s:.3f} s  "
                  f"p99 {ingest_p99_s:.3f} s")
            else:
                p(f"  {len(admits)} archive(s) admitted")
        if iskips:
            reasons = {}
            for ev in iskips:
                reasons[ev["reason"]] = reasons.get(ev["reason"], 0) + 1
            detail = ", ".join(f"{k}: {v}"
                               for k, v in sorted(reasons.items()))
            p(f"  {len(iskips)} admission deferral(s)/skip(s) "
              f"({detail})")
        if alerts:
            # a false positive is an alert the emitter flagged as not
            # matching any known injected/true event ('fp': true) —
            # synthetic corpora set it, live traces leave it absent
            n_fp = sum(1 for ev in alerts if ev.get("fp"))
            alert_fp_rate = n_fp / len(alerts)
            p(f"  {len(alerts)} alert(s) "
              f"({n_fp} flagged false-positive):")
            for ev in alerts[:10]:
                p(f"    {ev['kind']}: {ev['pulsar']} @ MJD "
                  f"{ev['mjd']:.4f}  score {ev['score']:.2f} "
                  f"(threshold {ev['threshold']:.2f})")
        elif admits:
            alert_fp_rate = 0.0
        if incremental_resolves is not None:
            p(f"  incremental GLS: {incremental_resolves} full "
              "resolve(s) against the batch oracle")

    # ---- tuning (tune/) -----------------------------------
    t_probe = by_type.get("tune_probe", [])
    t_sweep = by_type.get("tune_sweep", [])
    t_apply = by_type.get("tune_apply", [])
    tune_db_hits = sum(1 for ev in t_apply if ev.get("db_hit"))
    tune_db_misses = len(t_apply) - tune_db_hits
    p("")
    p("-- tuning --")
    if not (t_probe or t_sweep or t_apply):
        p("  (no tuning events)")
    else:
        if t_probe:
            ev = t_probe[-1]
            gf = ev.get("matmul_gflops")
            floor = ev.get("dispatch_floor_s")
            p(f"  backend {ev['fingerprint']}"
              + (f"  dispatch floor {floor * 1e6:.1f} us"
                 if floor else "")
              + (f"  matmul {gf:.1f} GFLOP/s" if gf else ""))
        for ev in t_sweep:
            margin = None
            if ev.get("default_s") and ev.get("best_s") is not None:
                margin = (float(ev["default_s"]) - float(ev["best_s"])) \
                    / float(ev["default_s"])
            p(f"  sweep [{ev['shape_class']}] {ev['knob']}: "
              f"{ev['n_candidates']} candidate(s), "
              f"{ev['n_rejected']} identity-rejected; winner "
              f"{ev['winner']} (default {ev['default']})"
              + (f"  margin {margin * 100:.1f}%"
                 if margin is not None else ""))
        for ev in t_apply:
            knobs = ev.get("knobs") or {}
            detail = ", ".join(f"{k}={v}"
                               for k, v in sorted(knobs.items())) \
                or "defaults"
            p(f"  apply [{ev['shape_class']}] "
              f"{'DB HIT' if ev.get('db_hit') else 'swept'}: {detail}")
        if t_apply:
            p(f"  tuning DB: {tune_db_hits} hit(s), "
              f"{tune_db_misses} miss(es) "
              f"({'zero re-sweeps' if t_apply and not t_sweep else f'{len(t_sweep)} knob sweep(s) paid'})")

    # ---- slo (latency objectives / burn-rate breaches) --------------
    breaches = by_type.get("slo_breach", [])
    slo_breach_tenants = {}
    p("")
    p("-- slo (latency objectives) --")
    if not breaches:
        p("  (no slo_breach events — objectives held, or no "
          "slo_targets configured)")
    else:
        for ev in breaches:
            slo_breach_tenants[ev["tenant"]] = \
                slo_breach_tenants.get(ev["tenant"], 0) + 1
        p(f"  {len(breaches)} fast-burn breach(es) across "
          f"{len(slo_breach_tenants)} tenant(s); each is an EDGE — a "
          "sustained breach emits once until the short window "
          "recovers:")
        for ev in breaches[:10]:
            p(f"    t={ev['t']:.2f}s tenant {ev['tenant']!r} "
              f"({ev.get('source', '?')}): target "
              f"{ev['target_s']:.3f}s, burn short "
              f"{ev['burn_short']:.1f}x / long {ev['burn_long']:.1f}x "
              "of error budget")

    skips = by_type.get("archive_skip", [])
    p("")
    p(f"-- skipped archives ({len(skips)}) --")
    if not skips:
        p("  (no archive_skip events)")
    else:
        for ev in skips[:10]:
            p(f"  {ev['datafile']}: {ev['reason']}")

    counters = {}
    gauges = {}
    if by_type.get("counters"):
        counters = by_type["counters"][-1]["counters"]
        gauges = by_type["counters"][-1]["gauges"]

    return {
        "manifest": manifest,
        "device_counts": device_counts,
        "total_dispatches": total_disp,
        "nfit": nfit_run,
        "max_queue_depth": max_depth,
        "peak_inflight": (gauges.get("peak_inflight")
                          if gauges else peak_run),
        "n_cold": n_cold,
        "cold_s": cold_s,
        "n_h2d": len(h2d),
        "h2d_bytes": h2d_bytes,
        "h2d_bytes_logical": h2d_bytes_logical,
        "h2d_compression": h2d_compression,
        "codec_s": codec_s_total,
        "codec_decisions": codec_decisions,
        "h2d_s": h2d_s,
        "h2d_stall_frac": h2d_stall_frac,
        "n_quality": len(snr),
        "n_force_flush": len(forces),
        "n_skipped": len(skips),
        "n_requests": len(req_done),
        "req_p50_s": req_p50,
        "req_p99_s": req_p99,
        "n_coalesce": len(coalesce),
        "batch_occupancy": occupancy,
        "n_warmup": len(warmups),
        "n_cache_hit": len(c_hit),
        "n_cache_miss": len(c_miss),
        "n_cache_store": len(c_store),
        "n_cache_evict": len(c_evict),
        "cache_hit_rate": cache_hit_rate,
        "cache_bytes_served": cache_bytes_served,
        "cache_bytes_stored": cache_bytes_stored,
        "cache_tenant_hits": cache_tenant_hits,
        "n_route_submit": len(r_sub),
        "n_route_retry": len(r_retry),
        "n_route_done": len(r_done),
        "router_imbalance": router_imbalance,
        "router_host_counts": router_host_counts,
        "n_fleet_transition": len(ftrans),
        "fleet_states": fleet_states,
        "n_failover": len(fover),
        "n_failover_collected": n_failover_collected,
        "n_hedge": len(hedges),
        "tenant_latency": tenant_latency,
        "n_template_fit": len(tfit),
        "n_template_jobs": len(tjobs),
        "template_pad_frac": template_pad_frac,
        "template_wall_s": template_wall_s,
        "n_zap_propose": len(zprop),
        "n_zap_apply": len(zapp),
        "n_refit": len(refits),
        "n_refit_improved": n_refit_improved,
        "refit_rate": refit_rate,
        "zap_channels_cut": zap_channels_cut,
        "zap_wall_s": zap_wall_s,
        "n_timing_fit": len(tim_fit),
        "n_timing_pulsars": n_timing_pulsars,
        "timing_dispatches": timing_dispatches,
        "timing_pad_frac": timing_pad_frac,
        "timing_wall_s": timing_wall_s,
        "n_ingest_admit": len(admits),
        "n_ingest_skip": len(iskips),
        "ingest_p50_s": ingest_p50_s,
        "ingest_p99_s": ingest_p99_s,
        "n_alert": len(alerts),
        "alert_fp_rate": alert_fp_rate,
        "incremental_resolves": incremental_resolves,
        "n_slo_breach": len(breaches),
        "slo_breach_tenants": slo_breach_tenants,
        "n_tune_probe": len(t_probe),
        "n_tune_sweep": len(t_sweep),
        "n_tune_apply": len(t_apply),
        "tune_db_hits": tune_db_hits,
        "tune_db_misses": tune_db_misses,
        "counters": counters,
        "gauges": gauges,
    }


def main(argv=None):
    """``python -m pulseportraiture_tpu_torch.telemetry
    {report,validate} trace.jsonl`` and ``merge router.jsonl
    host.jsonl ... [--json]`` (obs/merge.py), the entry cli/pptrace.py
    wraps."""
    import argparse

    p = argparse.ArgumentParser(
        prog="pptrace",
        description="Analyze a pulseportraiture_tpu_torch campaign trace "
                    "(JSONL, written via config.telemetry_path / "
                    "PPT_TELEMETRY / pptoas --telemetry).")
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="print the full trace report")
    rp.add_argument("trace", help="trace .jsonl path")
    vp = sub.add_parser("validate",
                        help="schema-check a trace and exit")
    vp.add_argument("trace", help="trace .jsonl path")
    mp = sub.add_parser(
        "merge",
        help="stitch a router trace + N host traces into per-request "
             "cross-host span timelines (joined on trace_id)")
    mp.add_argument("traces", nargs="+",
                    help="trace .jsonl paths (router + hosts, any "
                         "order — roles are auto-detected)")
    mp.add_argument("--json", action="store_true",
                    help="emit the merged structure as JSON instead "
                         "of the text timeline")
    args = p.parse_args(argv)
    if args.cmd == "validate":
        manifest, events = validate_trace(args.trace)
        print(f"{args.trace}: ok (schema {manifest['schema']}, "
              f"{len(events)} events)")
        return 0
    if args.cmd == "merge":
        from .obs.merge import main_merge
        main_merge(args.traces, as_json=args.json)
        return 0
    report(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
