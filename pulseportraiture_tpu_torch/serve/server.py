"""The continuous-batching TOA server: a long-lived serving loop over
the stream executor (counterpart of pulseportraiture_tpu/serve/server.py).

- ONE executor (``pipeline/stream._StreamExecutor(service=True)``) lives
  for the server's lifetime: its per-device copy and fit workers, their
  CUDA streams, the caching allocator's blocks and the FFT plans serve
  every request, so a steady-state request pays no first launch;
- concurrent clients :meth:`~ToaServer.submit` archives through a
  bounded :class:`~.queue.AdmissionQueue` (backpressure raises
  ``ServeRejected``, never an unbounded host-memory queue);
- the serving thread builds ONE lane per (template, options) pair
  (``make_wideband_lane``; the TemplateModel load amortizes across
  requests) and admits every request's subints into SHARED buckets:
  compatible subints of different requests coalesce into one dispatch
  (``batch_coalesce`` telemetry), B2 on 2-bit buckets and B1 on int16
  ones, as in ``pptoas --stream``;
- a bucket launches when full or when its oldest subint has waited
  ``serve_max_wait_ms``; a partial bucket pads to ``nsub_batch`` rows;
- completed TOAs demultiplex back per request in the request's archive
  order with the one-shot stream's checkpoint format, so each request's
  ``.tim`` is byte-identical to ``stream_wideband_TOAs`` on the same
  archives with the same ``nsub_batch`` (no row's fit depends on its
  bucket-mates, and every dispatch has the same padded shape);
- :meth:`~ToaServer.stop` drains: the queue closes (new submissions
  reject), pending buckets flush, in-flight dispatches drain, every
  outstanding request resolves, and the executor's workers shut down.

Scope: the wideband options ``stream_wideband_TOAs`` streams, on the
executor's devices (``stream_devices``, default every CUDA device; a
host without a card raises unless the caller asks for the CPU).
Remote clients reach a server through serve/transport.TransportServer
(``ppserve --listen``), and serve/router.ToaRouter (``pproute``) routes
a campaign across a fleet of them.
"""

import os
import threading
import time

import numpy as np

from ..io.tim import write_TOAs
from ..pipeline.stream import (_DONE_PREFIX, _StreamExecutor,
                               _collect_wideband, make_wideband_lane)
from ..telemetry import log, resolve_tracer
# the stat wire's capability record (tune/capability.py holds the one
# definition of the backend fingerprint)
from ..tune.capability import capability_summary
from ..utils.bunch import DataBunch
from . import codec
# canonical option freezing is shared with the result cache, so the lane
# key and the cache key agree on what an option change is
from .cache import _freeze, content_key, resolve_result_cache
from .queue import AdmissionQueue, ServeRejected, ServeRequest

__all__ = ["ToaServer", "capability_summary"]

# Most-recently-used (template, options) lanes a long-lived server keeps.
# Each pins a TemplateModel and its response cache; eviction is safe:
# buckets and in-flight records hold their own lane references, and a
# re-request rebuilds the lane with the same key prefix (so the same
# bucket keys).
LANE_CACHE_MAX = 32


class ToaServer:
    """A long-lived wideband-TOA serving loop over one warm executor.

    Thread model: ``submit`` is safe from any thread (it touches only
    the admission queue, the result cache and the tracer); everything
    executor-facing (archive loads, bucket fills, launches, drains,
    request completion) happens on the single server thread, so the
    executor needs no locking.  Client threads block in
    ``ServeRequest.result()``.

    nsub_batch: the bucket row count (every dispatch pads to it).
    max_wait_ms / queue_depth default to ``config.serve_max_wait_ms`` /
    ``config.serve_queue_depth``.  stream_devices / max_inflight /
    pipeline_depth / telemetry follow stream_wideband_TOAs; ``device``
    alone (e.g. 'cpu') names the one device when stream_devices is
    None.  warmup_manifest: a prior run's trace; every wideband
    dispatch shape it records is dispatched once at :meth:`start`
    (``utils/device.warmup_from_manifest``, through the executor's own
    pipelines) and marked warm, so the serve trace shows no cold
    dispatch of those shapes; warmup_model: the template the warm-up
    builds its portraits from (default a synthetic profile);
    warmup_options: fit-option overrides for the warm-up.

    quality_refit (default config.quality_refit): an archive whose TOAs
    trip quality_max_gof / quality_min_snr gets exactly ONE
    zap-and-refit (the ppzap median proposal, an in-memory weight zap,
    a re-fit through the same lane) before its .tim line demuxes;
    zap_nstd overrides the proposal threshold (config.zap_nstd).
    tenant_quota / tenant_weight: the admission queue's QoS
    (config.serve_tenant_quota / serve_tenant_weight).  result_cache /
    cache_dir: the content-addressed result cache (serve/cache.py).
    metrics / slo_targets: the streaming metrics registry and the
    per-tenant SLO tracker (config.metrics / config.slo_targets).
    """

    def __init__(self, nsub_batch=64, max_wait_ms=None, queue_depth=None,
                 stream_devices=None, max_inflight=None,
                 pipeline_depth=None, telemetry=None,
                 warmup_manifest=None, warmup_model=None,
                 warmup_options=None, quiet=True, quality_refit=None,
                 quality_max_gof=None, quality_min_snr=None,
                 zap_nstd=None, tenant_quota=None, tenant_weight=None,
                 result_cache=None, cache_dir=None, metrics=None,
                 slo_targets=None, device=None):
        from .. import config
        from ..obs.metrics import MetricsRegistry
        from ..obs.slo import SloTracker
        from ..pipeline.zap import resolve_zap_nstd

        if max_wait_ms is None:
            max_wait_ms = config.serve_max_wait_ms
        if queue_depth is None:
            queue_depth = config.serve_queue_depth
        self.quality_refit = bool(
            config.quality_refit if quality_refit is None
            else quality_refit)
        self.quality_max_gof = float(
            config.quality_max_gof if quality_max_gof is None
            else quality_max_gof)
        self.quality_min_snr = float(
            config.quality_min_snr if quality_min_snr is None
            else quality_min_snr)
        self.zap_nstd = resolve_zap_nstd(zap_nstd)
        self.nsub_batch = int(nsub_batch)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.quiet = quiet
        if stream_devices is None and device is not None:
            stream_devices = [device]
        self.tracer, self._own_tracer = resolve_tracer(telemetry,
                                                       run="ppserve")
        try:
            # a submit-time hit bypasses the admission queue and is never
            # billed as a fit
            self.cache = resolve_result_cache(tracer=self.tracer,
                                              cache_dir=cache_dir,
                                              mode=result_cache)
            want_metrics = (config.metrics if metrics is None
                            else bool(metrics))
            self._metrics = MetricsRegistry() if want_metrics else None
            targets = (config.slo_targets if slo_targets is None
                       else slo_targets)
            self._slo = SloTracker(targets) if targets else None
            self.queue = AdmissionQueue(queue_depth,
                                        tenant_quota=tenant_quota,
                                        tenant_weight=tenant_weight)
            # raises without a card unless the CPU is asked for
            self._ex = _StreamExecutor(
                None, [], None, self.nsub_batch, max_inflight=max_inflight,
                prefetch=False, tim_out=None, quiet=quiet,
                stream_devices=stream_devices, tracer=self.tracer,
                pipeline_depth=pipeline_depth, service=True)
        except BaseException:
            if self._own_tracer:
                self.tracer.close()
            raise
        self._cache_hits = 0
        self._cache_bytes = 0
        # smoothed measured fit throughput (TOAs/s) over completed
        # requests; None until the first real fit (hits never count)
        self._toa_rate = None
        self._ex.on_archive_done = self._archive_done
        self._ex.on_launch = self._launched
        self._lanes = {}      # (modelfile, frozen options) -> lane pair
        self._by_iarch = {}   # executor iarch -> (request, position)
        self._iarch = 0
        # id(request) -> request (admitted, unresolved): keyed by object
        # identity, since names are client labels that may collide
        self._live = {}
        self._thread = None
        self._started = False
        self._stopping = threading.Event()
        self._drain = True
        self._fatal = None
        # the quality loop (server thread only): gated archives queued
        # for zap-and-refit, processed from the serving loop, never from
        # inside an executor drain callback (a re-entrant admit would
        # interleave with a mid-fill bucket); and the executor iarchs
        # that ARE refits
        self._refits_pending = []
        self._refit_iarchs = {}
        self._warmup = (warmup_manifest, warmup_model,
                        dict(warmup_options or {}))

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------

    def submit(self, datafiles, modelfile, tim_out=None, name=None,
               tenant=None, trace_id=None, **options):
        """Enqueue one request (thread-safe).  Raises
        :class:`ServeRejected` when the admission queue is full
        (backpressure), the request's tenant is over its quota, or the
        server is stopping; returns a :class:`ServeRequest` whose
        ``result()`` blocks for the per-request DataBunch.  ``tenant``
        labels the request's weighted-fair lane (None = 'default');
        ``trace_id`` is the caller's tracing context (None mints one),
        stamped into every event this request touches.  ``options``
        are make_wideband_lane options (fit_scat=, DM0=, ...)."""
        req = ServeRequest(datafiles, modelfile, options=options,
                           tim_out=tim_out, name=name, tenant=tenant,
                           trace_id=trace_id)
        if self._stopping.is_set():
            raise ServeRejected(
                f"server is stopping; request {req.name!r} rejected")
        if self._fatal is not None:
            raise ServeRejected(
                f"server died: {self._fatal!r}; request {req.name!r} "
                "rejected")
        if self.cache is not None and self._cache_try_hit(req):
            return req
        self.queue.submit(req)
        if self.tracer.enabled:
            self.tracer.emit("request_submit", req=req.name,
                             n_archives=len(req.datafiles),
                             tenant=req.tenant, trace_id=req.trace_id)
        return req

    def _cache_try_hit(self, req):
        """Content-addressed lookup at submit time.  On a hit the
        request resolves here: the stored ``.tim`` bytes are copied
        verbatim to the request's ``tim_out``, the request never enters
        the admission queue, and the hit is ledgered on the tenant
        without consuming quota or weighted-fair time.  On a miss the
        key is kept on the request, so a clean completion stores the
        result without hashing again.  Returns True on a hit."""
        try:
            key = content_key(
                list(req.datafiles) + [req.modelfile], req.options)
        except OSError:
            # unreadable input: the fit path reports the real error
            return False
        req._cache_key = key
        ent = self.cache.get_result(key, req.datafiles)
        if ent is None:
            if self.tracer.enabled:
                self.tracer.emit("cache_miss", req=req.name,
                                 source="server", tenant=req.tenant,
                                 trace_id=req.trace_id)
            return False
        result, entry_path, n_bytes = ent
        if req.tim_out:
            codec.copy_tim_atomic(entry_path, req.tim_out)
        result.tim_out = req.tim_out
        req._cache_hit = True
        req.t_submit = req.t_admit = time.monotonic()
        self.queue.record_hit(req.tenant, len(req.datafiles))
        self._cache_hits += 1
        self._cache_bytes += n_bytes
        if self._metrics is not None:
            self._metrics.inc("cache_hits")
            self._metrics.inc("cache_bytes", n_bytes)
        if self.tracer.enabled:
            self.tracer.emit("request_submit", req=req.name,
                             n_archives=len(req.datafiles),
                             tenant=req.tenant, trace_id=req.trace_id)
            self.tracer.emit("cache_hit", req=req.name, bytes=n_bytes,
                             source="server", tenant=req.tenant,
                             trace_id=req.trace_id)
            self.tracer.counter("cache_hit")
        self._complete(req, result=result)
        return True

    def stats(self):
        """Load snapshot (thread-safe): pending_archives is the
        admission queue's depth in ARCHIVES (submitted, not yet
        prepared: the backpressure bound), queue_len the queued
        requests, n_live the admitted-but-unresolved requests; cache
        hits ride outside the load signal; toas_per_s is the smoothed
        measured fit rate; capability the host's device record."""
        queue_len, pending = self.queue.load_snapshot()
        return {"pending_archives": pending,
                "queue_len": queue_len,
                "n_live": len(self._live),
                "cache_hits": self._cache_hits,
                "cache_bytes": self._cache_bytes,
                "toas_per_s": self._toa_rate,
                "capability": capability_summary(self._ex.devices[0])}

    def metrics(self):
        """Live metrics: the load snapshot plus the streaming registry's
        export (counters, gauges, latency histograms) and the per-tenant
        SLO snapshot.  The process-global h2d counters fold in, so the
        link-stall fraction rides the same reply."""
        from ..obs import metrics as obs_metrics

        queue_len, pending = self.queue.load_snapshot()
        out = {"pending_archives": pending,
               "queue_len": queue_len,
               "n_live": len(self._live),
               "cache_hits": self._cache_hits,
               "cache_bytes": self._cache_bytes,
               "toas_per_s": self._toa_rate,
               "metrics_enabled": self._metrics is not None,
               "metrics": None, "link_stall_frac": None,
               "slo": self._slo.snapshot() if self._slo else None}
        if self._metrics is not None:
            ex = self._metrics.export()
            g = obs_metrics.global_registry().export()
            merged = obs_metrics.merge_exports([ex, g])
            merged["gauges"] = {**g["gauges"], **ex["gauges"]}
            out["metrics"] = merged
            out["link_stall_frac"] = obs_metrics.link_stall_frac(merged)
        return out

    def start(self):
        """Run the optional warm-up, then start the serving thread.
        Returns self."""
        if self._started:
            raise RuntimeError("ToaServer.start() called twice")
        self._started = True
        manifest, wmodel, wopts = self._warmup
        if manifest:
            from ..utils.device import warmup_from_manifest

            warmed = warmup_from_manifest(
                manifest, modelfile=wmodel, devices=self._ex.devices,
                nsub_batch=self.nsub_batch, tracer=self.tracer,
                quiet=self.quiet, pipelines=self._ex.pipelines, **wopts)
            # trusted, not verified: warmup_options/warmup_model must
            # match the serving workload for the first real dispatch of
            # a warmed shape to be warm
            self._ex._warm.update(warmed)
        if self.tracer.enabled:
            self.tracer.emit(
                "serve_start", n_devices=len(self._ex.devices),
                nsub_batch=self.nsub_batch,
                max_wait_ms=round(self.max_wait_s * 1e3, 3),
                queue_depth=self.queue.max_pending)
        log(f"ppserve: serving on {len(self._ex.devices)} device(s), "
            f"bucket {self.nsub_batch} subints / "
            f"{self.max_wait_s * 1e3:.0f} ms deadline, queue depth "
            f"{self.queue.max_pending} archive(s)", quiet=self.quiet,
            tracer=None)
        self._thread = threading.Thread(target=self._loop,
                                        name="ppt-serve", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop serving.  drain=True: close the queue (new submissions
        reject), serve everything already accepted, then shut the
        executor's workers down.  drain=False: abort; outstanding
        requests fail.  Raises the serving loop's error if it died."""
        self._drain = bool(drain)
        self._stopping.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
        else:
            # never started: nothing admitted; fail anything queued
            self._fail_requests(self.queue.drain(),
                                ServeRejected("server never started"))
            self._ex._shutdown(wait=True)
        if self.tracer.enabled:
            self.tracer.emit("serve_stop", drained=bool(drain))
        if self._own_tracer:
            self.tracer.close()
        if self._fatal is not None:
            raise self._fatal

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        # on an exception path, do not block on a graceful drain
        self.stop(drain=exc_type is None)
        return False

    # ------------------------------------------------------------------
    # the serving loop (one thread owns the executor)
    # ------------------------------------------------------------------

    def _loop(self):
        ex = self._ex
        try:
            while True:
                req = self.queue.get(self._tick())
                if req is not None:
                    self._admit_request(req)
                ex.flush_stale(self.max_wait_s)
                ex._drain_ready()
                self._process_refits()
                if self._stopping.is_set() and (
                        not self._drain or len(self.queue) == 0):
                    break
            if self._drain:
                ex.flush_all()
                ex.drain_all()
                # drained archives may have queued refits, and each
                # refit admits more work: flush and drain until quiet
                # (bounded: every position refits at most once)
                while True:
                    self._process_refits()
                    if not self._refits_pending and \
                            not self._refit_iarchs:
                        break
                    ex.flush_all()
                    ex.drain_all()
                    # a refit archive that never completes through the
                    # drain would pin _refit_iarchs; assemble_leftover
                    # fires the _archive_done hook, which finalizes it
                    for ia in sorted(set(self._refit_iarchs)
                                     & set(self._by_iarch)):
                        ex.assemble_leftover(ia)
                # archives that never completed through the drain
                for ia in sorted(self._by_iarch):
                    ex.assemble_leftover(ia)
                ex._shutdown(wait=True)
            else:
                ex._shutdown(wait=False)
                self._fail_requests(
                    list(self._live.values()) + self.queue.drain(),
                    ServeRejected("server stopped without drain"))
        except BaseException as e:  # the loop must never die silently
            self._fatal = e
            ex._shutdown(wait=False)
            self._fail_requests(
                list(self._live.values()) + self.queue.drain(), e)

    def _tick(self):
        """How long the queue wait may block before the loop ticks
        again: the oldest bucket's remaining deadline, a short poll
        while dispatches are in flight, a longer idle poll otherwise."""
        if self._stopping.is_set() or self._refits_pending:
            return 0.0
        age = self._ex.oldest_bucket_age()
        if age is not None:
            return max(0.0, min(self.max_wait_s - age, 0.05))
        if any(self._ex.in_flight):
            return 0.002
        return 0.05

    def _lane_for(self, req):
        key = (os.path.abspath(req.modelfile),
               tuple(sorted((k, _freeze(v))
                            for k, v in req.options.items())))
        ent = self._lanes.pop(key, None)
        if ent is None:
            # one lane per (template, options): the model load amortizes
            # over every request that reuses it, and the key prefix
            # keeps same-layout buckets of different templates apart
            ent = make_wideband_lane(
                req.modelfile, nsub_batch=self.nsub_batch,
                quiet=self.quiet, tracer=self.tracer, key_prefix=(key,),
                device=self._ex.devices[0], **req.options)
        # re-insert = most recent; evict the oldest beyond the bound
        self._lanes[key] = ent
        while len(self._lanes) > LANE_CACHE_MAX:
            self._lanes.pop(next(iter(self._lanes)))
        return ent

    def _admit_request(self, req):
        req.t_admit = time.monotonic()
        try:
            lane, loader = self._lane_for(req)
        except Exception as e:
            # a bad modelfile or option set fails ITS request only
            self.queue.release(len(req.datafiles), tenant=req.tenant)
            self._complete(req, error=e)
            return
        self._live[id(req)] = req
        ex = self._ex
        from ..pipeline.toas import _iter_archives

        # archive loads run ahead of admission on prefetch threads: the
        # serving thread buckets archive N while N+1..N+4 load
        for pos, (f, d) in enumerate(
                _iter_archives(req.datafiles, loader, prefetch=True)):
            skip = None
            if isinstance(d, Exception):
                skip = str(d)
            if skip is None:
                ok = np.asarray(d.ok_isubs, int)
                if d.nsub == 0 or len(ok) == 0:
                    skip = "no subints to fit"
            if skip is not None:
                self.tracer.emit("archive_skip", datafile=f, reason=skip)
                self.tracer.counter("archives_skipped")
                log(f"Skipping {f}: {skip}", level="warn", tracer=None)
                req.n_skipped += 1
                self.queue.release(1, tenant=req.tenant)
                continue
            ia = self._iarch
            self._iarch += 1
            self._by_iarch[ia] = (req, pos)
            # admit may block on a full device queue; the drains it runs
            # fire _archive_done on this same thread
            if ex.admit(ia, f, d, ok, lane=lane) is None:
                del self._by_iarch[ia]
                req.n_skipped += 1
            self.queue.release(1, tenant=req.tenant)
            # keep latency honest while a long request streams in
            ex.flush_stale(self.max_wait_s)
            ex._drain_ready()
        req.all_admitted = True
        self._maybe_complete(req)

    # -- executor hooks (server thread) --------------------------------

    def _launched(self, seq, owners, pad):
        if self._metrics is not None:
            self._metrics.inc("dispatches")
            self._metrics.inc("rows_dispatched", len(owners))
        if not self.tracer.enabled:
            return
        members = {self._by_iarch[ia][0] for ia, _ in owners
                   if ia in self._by_iarch}
        names = {r.name for r in members}
        self.tracer.emit("batch_coalesce", seq=seq,
                         n_requests=len(names), requests=sorted(names),
                         rows=len(owners), pad=int(pad),
                         trace_ids=sorted({r.trace_id for r in members}))

    def _archive_done(self, iarch, m, out):
        ent = self._by_iarch.pop(iarch, None)
        if ent is None:
            return
        req, pos = ent
        self._ex.forget(iarch)  # keep the executor O(live work)
        rec = self._refit_iarchs.pop(iarch, None)
        if rec is not None:
            self._finish_refit(rec, m, out)
            return
        if (self.quality_refit and pos not in req.refit_pos
                and self._gate_trips(out)):
            # hold this position open (the request completes after the
            # refit; the demux order is unchanged) and queue exactly one
            # zap-and-refit, run from the serving loop, not from inside
            # this drain callback
            req.refit_pos.add(pos)
            self._refits_pending.append(dict(
                req=req, pos=pos, datafile=m.datafile,
                gof_before=self._gof_worst(out), meta=m, out=out))
            return
        req.meta[pos] = m
        req.assembled[pos] = out
        self._maybe_complete(req)

    # -- the quality-gated zap-and-refit -------------------------------

    def _gof_worst(self, out):
        """Worst (largest finite) per-TOA goodness-of-fit of one
        archive's assembly."""
        gofs = [t.flags.get("gof") for t in out[0]]
        gofs = [g for g in gofs if g is not None and np.isfinite(g)]
        return max(gofs) if gofs else None

    def _gate_trips(self, out):
        """True when any TOA of the assembly trips the thresholds (gof
        above quality_max_gof, or, with the S/N gate on, snr below
        quality_min_snr)."""
        for t in out[0]:
            gof = t.flags.get("gof")
            if gof is not None and np.isfinite(gof) \
                    and gof > self.quality_max_gof:
                return True
            if self.quality_min_snr > 0.0:
                snr = t.flags.get("snr")
                if snr is not None and np.isfinite(snr) \
                        and snr < self.quality_min_snr:
                    return True
        return False

    def _fallback_refit(self, rec, n_channels, reason):
        """A refit that cannot run (no channels to zap, nothing left to
        fit, a proposal error): serve the ORIGINAL result, with a
        warning."""
        req, pos = rec["req"], rec["pos"]
        if pos in req.assembled:
            # the refit resolved through a drain callback before the
            # failure surfaced: its result already demuxed
            return
        log(f"quality refit of {rec['datafile']} (request "
            f"{req.name!r}) not possible: {reason}; serving the "
            "original fit", level="warn", tracer=None)
        if self.tracer.enabled:
            self.tracer.emit(
                "refit", req=req.name, datafile=rec["datafile"],
                n_channels=int(n_channels),
                gof_before=rec["gof_before"],
                gof_after=rec["gof_before"], improved=False)
        req.meta[pos] = rec["meta"]
        req.assembled[pos] = rec["out"]
        self._maybe_complete(req)

    def _process_refits(self):
        """Run queued zap-and-refits (server thread, between executor
        drains): propose zaps with the ppzap median algorithm on the
        decoded load, apply them as an in-memory weight zap
        (quality.zap_bunch, the same as loading an offline-zapped
        archive), and re-admit the archive through the same lane.  One
        refit per archive position; a failure serves the original
        result."""
        from ..io.psrfits import load_data
        from ..pipeline.zap import get_zap_channels, zap_bunch

        while self._refits_pending:
            rec = self._refits_pending.pop(0)
            req, pos = rec["req"], rec["pos"]
            f = rec["datafile"]
            ia = None
            try:
                lane, loader = self._lane_for(req)
                # the proposal loads DECODED with ppzap's options (the
                # median algorithm reads host noise levels)
                d_prop = load_data(
                    f, dedisperse=False, dededisperse=True,
                    tscrunch=req.options.get("tscrunch", False),
                    pscrunch=True, quiet=True)
                full = get_zap_channels(d_prop, nstd=self.zap_nstd,
                                        tracer=self.tracer,
                                        device=self._ex.devices[0])
                n_channels = sum(len(z) for z in full)
                if n_channels == 0:
                    self._fallback_refit(
                        rec, 0, "the median algorithm flagged no "
                        "channels (contamination is not "
                        "noise-level-separable)")
                    continue
                d = zap_bunch(loader(f), full)
                ok = np.asarray(d.ok_isubs, int)
                if d.nsub == 0 or len(ok) == 0:
                    self._fallback_refit(
                        rec, n_channels, "zapping left no fittable subints")
                    continue
                if self.tracer.enabled:
                    self.tracer.emit("zap_apply", datafile=f,
                                     n_channels=int(n_channels))
                rec["n_channels"] = n_channels
                ia = self._iarch
                self._iarch += 1
                self._by_iarch[ia] = (req, pos)
                self._refit_iarchs[ia] = rec
                if self._ex.admit(ia, f, d, ok, lane=lane) is None:
                    self._by_iarch.pop(ia, None)
                    self._refit_iarchs.pop(ia, None)
                    self._fallback_refit(
                        rec, n_channels,
                        "the lane skipped the zapped archive")
                    continue
            except Exception as e:
                if ia is not None:
                    # a failed admit must not leave its registration: the
                    # drain loop would wait on it forever
                    self._by_iarch.pop(ia, None)
                    self._refit_iarchs.pop(ia, None)
                self._fallback_refit(rec, rec.get("n_channels", 0),
                                     f"{type(e).__name__}: {e}")

    def _finish_refit(self, rec, m, out):
        """A refit's fit completed: record the quality before and after,
        warn when the archive still trips the gate (the loop never
        refits twice), and demux the zapped fit."""
        req, pos = rec["req"], rec["pos"]
        gof_after = self._gof_worst(out)
        before = rec["gof_before"]
        improved = (gof_after is not None and before is not None
                    and gof_after < before)
        if self.tracer.enabled:
            self.tracer.emit(
                "refit", req=req.name, datafile=rec["datafile"],
                n_channels=int(rec.get("n_channels", 0)),
                gof_before=before, gof_after=gof_after,
                improved=bool(improved))
        if self._gate_trips(out):
            log(f"quality refit of {rec['datafile']} (request "
                f"{req.name!r}) still trips the gate after zapping "
                f"{rec.get('n_channels', 0)} channel(s) "
                f"(red-chi^2 {before} -> {gof_after}); serving the "
                "zapped fit, no further refits (the loop is bounded "
                "to one pass)", level="warn", tracer=None)
        req.meta[pos] = m
        req.assembled[pos] = out
        self._maybe_complete(req)

    # -- request completion --------------------------------------------

    def _maybe_complete(self, req):
        if not req.all_admitted:
            return
        if len(req.assembled) + req.n_skipped < len(req.datafiles):
            return
        try:
            positions = sorted(req.assembled)
            meta = [req.meta[p] for p in positions]
            assembled = {m.iarch: req.assembled[p]
                         for p, m in zip(positions, meta)}
            (TOA_list, order, DM0s, means,
             errs) = _collect_wideband(meta, assembled)
            if req.tim_out:
                # the one-shot checkpoint format in the REQUEST's archive
                # order: truncate, then per-archive TOA lines and a
                # completion sentinel
                open(req.tim_out, "w").close()
                for m in meta:
                    write_TOAs(assembled[m.iarch][0],
                               outfile=req.tim_out, append=True)
                    with open(req.tim_out, "a") as fh:
                        fh.write(_DONE_PREFIX
                                 + os.path.abspath(m.datafile) + "\n")
            result = DataBunch(
                TOA_list=TOA_list, order=order, DM0s=DM0s,
                DeltaDM_means=means, DeltaDM_errs=errs,
                tim_out=req.tim_out, n_skipped=req.n_skipped)
            self._complete(req, result=result)
        except Exception as e:
            self._complete(req, error=e)

    def _complete(self, req, result=None, error=None):
        if (self.cache is not None and result is not None
                and getattr(req, "_cache_key", None)
                and not getattr(req, "_cache_hit", False)):
            # a clean fresh fit lands in the store under the key hashed
            # at submit (put_result refuses partial results itself)
            stored = self.cache.put_result(req._cache_key, result)
            if stored and self.tracer.enabled:
                self.tracer.emit("cache_store", key=req._cache_key,
                                 bytes=stored)
        req._result = result
        req._error = error
        req.t_done = time.monotonic()
        self._live.pop(id(req), None)
        if (result is not None and error is None
                and not getattr(req, "_cache_hit", False)
                and result.TOA_list):
            # the measured-throughput EMA over admission -> done walls
            # of real fits (alpha 0.3)
            t_adm = req.t_admit if req.t_admit is not None \
                else req.t_submit
            wall = req.t_done - (t_adm if t_adm is not None
                                 else req.t_done)
            if wall > 0:
                rate = len(result.TOA_list) / wall
                self._toa_rate = (rate if self._toa_rate is None
                                  else 0.7 * self._toa_rate + 0.3 * rate)
        t_sub = req.t_submit if req.t_submit is not None else req.t_done
        t_adm = req.t_admit if req.t_admit is not None else req.t_done
        wall_s = req.t_done - t_sub
        queue_s = t_adm - t_sub
        if self._metrics is not None:
            self._metrics.inc("requests_total")
            if error is not None:
                self._metrics.inc("requests_failed")
            if result is not None:
                self._metrics.inc("toas_total",
                                  len(result.TOA_list or ()))
            self._metrics.observe("request_latency_s", wall_s)
            self._metrics.observe("queue_wait_s", queue_s)
        if self._slo is not None:
            # a failed request burns budget as an infinitely slow one
            breach = self._slo.observe(
                getattr(req, "tenant", None) or "default",
                wall_s if error is None else float("inf"))
            if breach is not None and self.tracer.enabled:
                self.tracer.emit("slo_breach", source="server", **breach)
        if self.tracer.enabled:
            self.tracer.emit(
                "request_done", req=req.name,
                n_toas=len(result.TOA_list) if result else 0,
                n_archives=len(result.order) if result else 0,
                wall_s=round(wall_s, 6), queue_s=round(queue_s, 6),
                error=str(error) if error else None,
                tenant=getattr(req, "tenant", None),
                trace_id=req.trace_id)
        req._event.set()

    def _fail_requests(self, requests, error):
        for req in requests:
            if not req.done():
                self._complete(req, error=error)
