"""The admission queue and request objects of the TOA serving loop
(counterpart of pulseportraiture_tpu/serve/queue.py).

The queue is the service's backpressure: it is bounded in ARCHIVES
(one archive is one load + prepare + bucket fill), and a submit that
would exceed the bound raises :class:`ServeRejected` instead of
absorbing unbounded host memory.  Device-side concurrency is bounded
separately by the executor's ``max_inflight``/``pipeline_depth``.

A :class:`ServeRequest` is one client submission: archives measured
against one template with one option set.  Its lifecycle is submit ->
admit (the server loads and buckets its archives; subints of different
requests coalesce into shared dispatches) -> done (the per-request
``.tim``/result is demultiplexed back out).  ``result()`` blocks the
client; the server thread resolves it.

Tenants: requests carry a ``tenant`` label and the queue keeps one FIFO
lane per tenant.  ``get`` serves lanes weighted-fair over archives (a
lane's virtual time is archives admitted / its
``config.serve_tenant_weight``; the lane furthest behind goes next, and
a lane waking from idle starts at the current virtual time so it cannot
burst on banked credit).  ``config.serve_tenant_quota`` caps any one
tenant's pending archives below the global bound; a submit over its
quota is rejected retryably, as global backpressure is.
"""

import itertools
import threading
import time

from ..obs.trace import new_trace_id

__all__ = ["ServeRejected", "ServeRequest", "AdmissionQueue"]


class ServeRejected(RuntimeError):
    """A submission the server did NOT accept: the admission queue is
    at capacity (backpressure — ``retryable`` is True, retry later or
    shed load) or the server is stopping/closed (``retryable`` False —
    resubmitting can never succeed).  Nothing about the request was
    enqueued."""

    def __init__(self, msg, retryable=False):
        super().__init__(msg)
        self.retryable = bool(retryable)


class ServeRequest:
    """One client submission to the serving loop.

    datafiles: archive paths (or a metafile path); modelfile: the
    template; options: make_wideband_lane kwargs (fit_scat=, DM0=,
    print_flux=, ...) — requests sharing (modelfile, options) share a
    lane and therefore coalesce into the same fused buckets; tim_out:
    optional path the server writes this request's .tim to (archive
    order, completion sentinels — byte-identical to the one-shot
    stream_wideband_TOAs checkpoint).  The server fills the bookkeeping
    fields; clients call :meth:`result`.
    """

    _ids = itertools.count()

    def __init__(self, datafiles, modelfile, options=None, tim_out=None,
                 name=None, tenant=None, trace_id=None):
        from ..pipeline.toas import _is_metafile, _read_metafile

        if isinstance(datafiles, str):
            self.datafiles = (_read_metafile(datafiles)
                              if _is_metafile(datafiles)
                              else [datafiles])
        else:
            self.datafiles = list(datafiles)
        if not self.datafiles:
            raise ValueError("ServeRequest: empty datafile list")
        self.modelfile = str(modelfile)
        self.options = dict(options or {})
        self.tim_out = tim_out
        self.name = str(name) if name is not None else \
            f"req{next(ServeRequest._ids)}"
        # QoS lane label: requests of one tenant share a weighted-fair
        # admission lane and a pending-archive quota
        self.tenant = str(tenant) if tenant is not None else "default"
        # tracing context: the caller's, or minted here, stamped into
        # every telemetry event this request touches on any host
        self.trace_id = str(trace_id) if trace_id else new_trace_id()
        # lifecycle timestamps (monotonic): submit by the queue, admit/
        # done by the server — what the request_done latency split and
        # the pptrace serve section report
        self.t_submit = None
        self.t_admit = None
        self.t_done = None
        # server-side demux state: archive position -> (meta, assembly)
        self.meta = {}
        self.assembled = {}
        self.n_skipped = 0
        self.all_admitted = False
        # archive positions already sent through the quality-gated
        # zap-and-refit loop (server-side; the EXACTLY-ONCE bound —
        # a position in here never refits again)
        self.refit_pos = set()
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        """Block up to ``timeout`` seconds for the server to resolve
        this request; True when resolved (result() will not block),
        False on timeout.  Unlike :meth:`result` this never raises —
        it is the polling primitive."""
        return self._event.wait(timeout)

    def result(self, timeout=None):
        """Block until the server resolves this request; returns the
        per-request DataBunch (TOA_list, order, DM0s, DeltaDM_means/
        errs, tim_out) or raises the server-side failure."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{self.name}: no result within {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result


class AdmissionQueue:
    """Bounded, thread-safe request queue feeding one serving loop,
    with per-tenant weighted-fair lanes and quotas.

    ``submit`` (any client thread) appends or REJECTS — it never
    blocks, so a client can tell load-shedding from slowness.  ``get``
    (the server thread) pops with a timeout so the serving loop keeps
    ticking its deadline flushes while idle.  The archive-count
    accounting is released as the server admits each archive
    (:meth:`release`), i.e. the bound covers submitted-but-not-yet-
    prepared work.

    tenant_quota: None (global bound only), an int (every tenant's
    pending-archive cap), or a dict {tenant: cap} with an optional
    ``'*'`` default — ``config.serve_tenant_quota`` /
    PPT_SERVE_TENANT_QUOTA.  tenant_weight: {tenant: weight} (``'*'``
    default; unlisted tenants weigh 1.0) —
    ``config.serve_tenant_weight`` / PPT_SERVE_TENANT_WEIGHT.
    """

    def __init__(self, max_pending, tenant_quota=None,
                 tenant_weight=None):
        from .. import config

        self.max_pending = max(1, int(max_pending))
        if tenant_quota is None:
            tenant_quota = config.serve_tenant_quota
        if tenant_weight is None:
            tenant_weight = config.serve_tenant_weight
        self.tenant_quota = tenant_quota
        self.tenant_weight = dict(tenant_weight or {})
        self._cv = threading.Condition()
        self._lanes = {}           # tenant -> [requests] (FIFO)
        self._pending = 0          # archives, global
        self._pending_tenant = {}  # tenant -> archives pending
        self._served = {}          # tenant -> archives ever popped
        self._hits = {}            # tenant -> cache-hit archives
        self._closed = False

    # -- QoS resolution ------------------------------------------------

    def _quota_for(self, tenant):
        q = self.tenant_quota
        if q is None:
            return None
        if isinstance(q, dict):
            q = q.get(tenant, q.get("*"))
            return None if q is None else int(q)
        return int(q)

    def _weight_for(self, tenant):
        w = self.tenant_weight.get(tenant,
                                   self.tenant_weight.get("*", 1.0))
        return max(float(w), 1e-9)

    def _vtime(self, tenant):
        """A lane's virtual time: archives admitted over its weight —
        the weighted-fair scheduler serves the lane furthest behind."""
        return self._served.get(tenant, 0) / self._weight_for(tenant)

    def __len__(self):
        with self._cv:
            return sum(len(q) for q in self._lanes.values())

    @property
    def pending_archives(self):
        with self._cv:
            return self._pending

    def load_snapshot(self):
        """One lock-held snapshot of (queue_len, pending_archives).

        ``len(q)`` and ``q.pending_archives`` are two separate lock
        acquisitions — a stat/metrics reply built from both can report
        TORN load (a submit landing between the reads shows its
        archives but not its queue entry, or vice versa).  Every
        stat-shaped reply reads load through here."""
        with self._cv:
            return (sum(len(q) for q in self._lanes.values()),
                    self._pending)

    def tenant_snapshot(self):
        """{tenant: {queued, pending_archives, cache_hits}}, the QoS
        view.  ``cache_hits`` counts
        result-cache hits recorded on the tenant's ledger: visible
        traffic that was never billed against the quota or the
        weighted-fair vtime."""
        with self._cv:
            return {t: {"queued": len(self._lanes.get(t, ())),
                        "pending_archives": self._pending_tenant
                        .get(t, 0),
                        "cache_hits": self._hits.get(t, 0)}
                    for t in set(self._lanes)
                    | set(self._pending_tenant) | set(self._hits)}

    def record_hit(self, tenant, n=1):
        """Ledger a result-cache hit for ``tenant``: the hit is O(1)
        work served outside the queue, so it must be seen (per-tenant
        accounting) but charged to
        neither the global admission bound, the tenant quota, nor the
        weighted-fair virtual time — billing hits as fits would starve
        a repeat-heavy tenant for traffic that costs nothing."""
        t = str(tenant) if tenant else "default"
        with self._cv:
            self._hits[t] = self._hits.get(t, 0) + int(n)

    def submit(self, request):
        """Enqueue or raise ServeRejected (queue full / tenant over
        quota / closed)."""
        n = len(request.datafiles)
        tenant = getattr(request, "tenant", None) or "default"
        with self._cv:
            if self._closed:
                raise ServeRejected(
                    "serving queue is closed (server stopping); "
                    f"request {request.name!r} rejected")
            quota = self._quota_for(tenant)
            if n > self.max_pending or (quota is not None
                                        and n > quota):
                # could NEVER fit, even into an idle queue: terminal,
                # not retryable — a retrying client would spin forever
                bound = self.max_pending if n > self.max_pending \
                    else quota
                knob = ("config.serve_queue_depth"
                        if n > self.max_pending
                        else f"tenant {tenant!r} quota "
                             "(config.serve_tenant_quota)")
                raise ServeRejected(
                    f"request {request.name!r} holds {n} archives, "
                    f"more than the whole bound {bound} of {knob}; "
                    "split it or raise the knob")
            if self._pending + n > self.max_pending:
                raise ServeRejected(
                    f"admission queue full: {self._pending} archive(s) "
                    f"pending + {n} submitted > queue depth "
                    f"{self.max_pending} (config.serve_queue_depth / "
                    "PPT_SERVE_QUEUE_DEPTH); retry later",
                    retryable=True)
            t_pending = self._pending_tenant.get(tenant, 0)
            if quota is not None and t_pending + n > quota:
                raise ServeRejected(
                    f"tenant {tenant!r} over quota: {t_pending} "
                    f"archive(s) pending + {n} submitted > tenant "
                    f"quota {quota} (config.serve_tenant_quota / "
                    "PPT_SERVE_TENANT_QUOTA); retry later",
                    retryable=True)
            lane = self._lanes.setdefault(tenant, [])
            if not lane:
                # a lane waking from idle starts at the CURRENT
                # virtual time: banked idle credit must not let it
                # monopolize the scheduler to "catch up"
                active = [self._vtime(t) for t, q in
                          self._lanes.items() if q and t != tenant]
                if active:
                    floor = min(active) * self._weight_for(tenant)
                    self._served[tenant] = max(
                        self._served.get(tenant, 0), int(floor))
            self._pending += n
            self._pending_tenant[tenant] = t_pending + n
            request.t_submit = time.monotonic()
            lane.append(request)
            self._cv.notify()

    def get(self, timeout=None):
        """Pop the next request weighted-fair across tenant lanes
        (FIFO within a lane), waiting up to ``timeout`` seconds; None
        on timeout (or closed-and-empty)."""
        with self._cv:
            if not any(self._lanes.values()) and not self._closed:
                self._cv.wait(timeout)
            active = sorted((t for t, q in self._lanes.items() if q),
                            key=lambda t: (self._vtime(t), t))
            if not active:
                return None
            tenant = active[0]
            req = self._lanes[tenant].pop(0)
            self._served[tenant] = self._served.get(tenant, 0) \
                + len(req.datafiles)
            return req

    def release(self, n=1, tenant=None):
        """Return ``n`` archives' worth of admission credit (the
        server admitted or abandoned them); ``tenant`` releases that
        lane's quota too."""
        with self._cv:
            self._pending = max(0, self._pending - int(n))
            if tenant is not None:
                t = str(tenant)
                self._pending_tenant[t] = max(
                    0, self._pending_tenant.get(t, 0) - int(n))

    def close(self):
        """Refuse all further submissions (graceful-drain entry);
        already-queued requests still drain."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain(self):
        """Pop everything still queued, every lane (abort path) — the
        caller fails these requests loudly."""
        with self._cv:
            out = []
            for t in sorted(self._lanes):
                out.extend(self._lanes[t])
            self._lanes = {}
            return out
