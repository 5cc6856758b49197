"""A campaign router over an elastic fleet of TOA servers (counterpart of
pulseportraiture_tpu/serve/router.py).

:class:`ToaRouter` shards TOA requests across N warm serving loops
(serve/server.ToaServer behind serve/transport.py transports):

- **Placement**: least-loaded with sticky per-template affinity (the
  affinity host leads while placing there would not leave it strictly
  costlier than the cheapest other), a cost model that divides each
  host's load by its measured TOAs/s (exactly least-loaded while nothing
  is measured), and retryable-backpressure retries up to ``retry_max``
  with capped exponential backoff between full fleet passes.
- **Membership and health** (serve/fleet.py): hosts join and leave at
  run time (:meth:`add_host`, :meth:`remove_host`, a watched
  ``fleet_file``), each walking ``JOINING -> HEALTHY -> SUSPECT -> DEAD
  -> REJOINED`` off bounded ``stat`` probes and transport errors.
- **Exactly-once failover**: a DEAD transition with requests in flight
  re-places them.  A request whose durable ``.tim`` already carries every
  completion sentinel is COLLECTED from the file
  (serve/codec.read_tim_result) and never fitted again; any other is
  re-dispatched with the dead host in its ``excluded`` set, and the
  ROUTER writes the replacement's ``.tim`` atomically from the returned
  payload.  A zombie host that finishes late rewrites the same path with
  the same bytes: the fits are deterministic.
- **Hedged requests** (``hedge_ms``): a request unresolved after the
  deadline launches ONE duplicate attempt on the least-loaded other
  host; the first completion wins and the loser is reaped in the
  background.  A hedging router writes every ``.tim`` itself, so two
  hosts never write one path.
- **The codec lane** (``write_tim='router'``): for fleets without a
  shared filesystem the full TOA payload returns over the wire and the
  router writes each ``.tim`` (serve/codec.write_tim_result),
  byte-identical to the host-written one.
- **Refit-aware routing** (``quality_refit=True``): archives of a
  collected result that trip ``config.quality_max_gof`` /
  ``quality_min_snr`` get exactly ONE zap-and-refit, placed on the
  current least-loaded HEALTHY host; the ``refit`` event carries the
  move (``host_from`` -> ``host``).  The zap proposal is the router's
  only device work: it runs on ``device`` (default cuda; raises with no
  card unless the caller asks for the CPU).  Enable this OR the
  server-side loop (``config.quality_refit``), not both.
- **The result cache**: a router-side hit short-circuits placement; the
  request never reaches a host.
- **Tenants**: ``submit(tenant=...)`` rides the wire into each host's
  weighted-fair admission lanes and lands on route_submit/route_done.

Telemetry: ``router_start`` once; per request ``route_submit`` /
``route_retry`` / ``route_done``, ``fleet_transition`` per health edge,
``route_failover`` per dead-host re-placement (action ``collected`` |
``redispatch`` | ``failed``), ``route_hedge`` per hedge, ``refit``,
``cache_hit`` / ``cache_miss``: what the "router" and "fleet" sections
of ``pptrace report`` read.
"""

import os
import threading
import time

from ..telemetry import log, resolve_tracer
from . import codec
from .cache import content_key, resolve_result_cache
from .fleet import HEALTHY, Fleet, FleetFileWatcher
from .queue import ServeRejected
from .transport import TransportError

__all__ = ["ToaRouter", "RouteHandle", "ROUTER_BACKOFF_BASE_S",
           "ROUTER_BACKOFF_CAP_S"]

# Backoff after a full fleet pass found no host with admission room:
# doubles per pass, capped.
ROUTER_BACKOFF_BASE_S = 0.05
ROUTER_BACKOFF_CAP_S = 2.0
# Per-attempt result poll slices: the short one while the attempt set can
# still change (hedging armed, or several attempts racing), the long one
# for a settled single attempt.
ROUTER_POLL_S = 0.1
ROUTER_POLL_SETTLED_S = 0.25
# Bound on one routed zap-and-refit round trip (it rides inside the
# original request's collection); past it the original result is served.
ROUTER_REFIT_TIMEOUT_S = 600.0
# Cadence of the reaper that collects and discards hedge losers.
ROUTER_REAP_S = 0.25


class RouteHandle:
    """One routed request: its submit spec (kept so the router can
    re-place it), its live placement attempts (primary and at most one
    hedge) and the blocking :meth:`result`."""

    def __init__(self, router, host, handle, name, n_archives, t_submit,
                 spec):
        self._router = router
        self.host = host            # current primary member
        self._handle = handle
        self.name = name
        self.n_archives = n_archives
        self._t_submit = t_submit
        self.spec = spec            # datafiles/modelfile/tim_out/options/
        #                             tenant/host_tim/trace_id
        # live attempts: [(member, handle, router_tim)]; router_tim marks
        # the attempts whose .tim the ROUTER writes at collection (codec
        # lane, hedges, failover replacements)
        self.attempts = [(host, handle, spec.get("host_tim") is None
                          and spec.get("tim_out") is not None)]
        self.excluded = set()       # labels this request must avoid
        self._collected = False     # accounting and telemetry fired
        self._done = threading.Event()
        self._result = None
        self._error = None
        self._hedged = False
        self._redispatching = False
        self._refit_done = False

    @property
    def tim_out(self):
        return self.spec.get("tim_out")

    @property
    def datafiles(self):
        return self.spec["datafiles"]

    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Non-raising poll (what a TransportServer fronting a router
        calls); True when result() will not block."""
        return self._done.wait(timeout)

    def result(self, timeout=None):
        """Block for the per-request DataBunch (the one-shot stream's
        result shape) or raise the request's failure; the router's load
        accounting and route_done fire exactly once either way.  A
        TimeoutError leaves the request collectable."""
        return self._router._await(self, timeout)


class ToaRouter:
    """Shard TOA requests across an elastic fleet of warm serving loops.

    transports: InProcTransport / SocketTransport objects or 'host:port'
    strings; may be empty when ``fleet_file`` supplies the membership.
    retry_max: total placement attempts per request (None =
    config.router_retry_max).  probe_ms: the stat-probe deadline (None =
    config.router_probe_ms).  hedge_ms: the hedge deadline in ms (None =
    config.router_hedge_ms, off by default).  write_tim: 'host' (the
    serving host writes each request's .tim: a shared filesystem) or
    'router' (the codec lane).  quality_refit: route ONE zap-and-refit of
    gate-tripping archives to the least-loaded HEALTHY host; device: the
    torch device of its zap proposal (default cuda, resolved through
    device.resolve_device when quality_refit is on).  fleet_file: a
    watched host list.  telemetry: a trace path or a shared Tracer.
    result_cache / cache_dir: the content-addressed result cache.
    cost_model: placement cost = load / measured relative speed (True,
    the default); False is raw least-loaded.  metrics / slo_targets: the
    router's own registry and SLO tracker (None reads config).

    ``submit`` and ``RouteHandle.result`` are safe from any thread (one
    lock guards placement and handle state; probes and transport I/O run
    outside it)."""

    def __init__(self, transports=(), retry_max=None, telemetry=None,
                 quiet=True, probe_ms=None, hedge_ms=None,
                 write_tim="host", quality_refit=False, fleet_file=None,
                 fleet_poll_s=1.0, result_cache=None, cache_dir=None,
                 cost_model=None, metrics=None, slo_targets=None,
                 device=None):
        from .. import config
        from ..device import resolve_device
        from ..obs.metrics import MetricsRegistry
        from ..obs.slo import SloTracker

        transports = list(transports)
        if not transports and not fleet_file:
            raise ValueError("ToaRouter: no host endpoints")
        if write_tim not in ("host", "router"):
            raise ValueError(
                f"ToaRouter: write_tim must be 'host' (shared "
                f"filesystem) or 'router' (codec lane), got {write_tim!r}")
        if retry_max is None:
            retry_max = config.router_retry_max
        self.retry_max = max(1, int(retry_max))
        if hedge_ms is None:
            hedge_ms = config.router_hedge_ms
        self.hedge_s = None if hedge_ms is None \
            else max(0.0, float(hedge_ms)) / 1e3
        self.write_tim = write_tim
        self.quality_refit = bool(quality_refit)
        # the refit's zap proposal is the router's only device work: a
        # router that never refits needs no device
        self.device = resolve_device(device) if self.quality_refit \
            else None
        self.cost_model = True if cost_model is None else bool(cost_model)
        self.quiet = quiet
        self.tracer, self._own_tracer = resolve_tracer(telemetry,
                                                       run="pproute")
        self.cache = resolve_result_cache(tracer=self.tracer,
                                          cache_dir=cache_dir,
                                          mode=result_cache)
        self.cache_hits = 0
        self.cache_bytes = 0
        # the router's own counters and route-latency histogram, and the
        # per-tenant SLOs over the END-TO-END routed latency
        want_metrics = config.metrics if metrics is None else bool(metrics)
        self._metrics = MetricsRegistry() if want_metrics else None
        targets = config.slo_targets if slo_targets is None \
            else slo_targets
        self._slo = SloTracker(targets) if targets else None
        self._lock = threading.Lock()
        self._affinity = {}   # abspath(modelfile) -> FleetMember
        self._inflight = {}   # label -> set of RouteHandle
        self._orphans = []    # (member, handle): hedge losers to reap
        self._reaper = None
        self._closed = False
        self.fleet = Fleet(tracer=self.tracer, probe_ms=probe_ms,
                           on_dead=self._failover_host, quiet=quiet)
        for t in transports:
            self.fleet.add(t)
        self._watcher = None
        if fleet_file:
            self._watcher = FleetFileWatcher(self, fleet_file,
                                             poll_s=fleet_poll_s,
                                             quiet=quiet)
            self._watcher.resync()
            self._watcher.start()
        if self.tracer.enabled:
            self.tracer.emit("router_start",
                             n_hosts=len(self.fleet.members()),
                             hosts=self.host_labels(),
                             retry_max=self.retry_max)

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    @property
    def hosts(self):
        """Current members (any state)."""
        return self.fleet.members()

    def host_labels(self):
        return [m.label for m in self.fleet.members()]

    def add_host(self, transport_or_address, label=None):
        """Join one endpoint at run time (JOINING; promoted by its first
        successful probe).  Returns the member's label."""
        if self._closed:
            raise RuntimeError("ToaRouter is closed")
        return self.fleet.add(transport_or_address, label=label).label

    def remove_host(self, label):
        """Leave one endpoint gracefully: no new placements; requests in
        flight there keep collecting.  True when it was a member."""
        member = self.fleet.remove(label)
        if member is None:
            return False
        with self._lock:
            for key in [k for k, v in self._affinity.items()
                        if v is member]:
                del self._affinity[key]
        return True

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------

    def _costs(self, loads):
        """Placement costs from archive loads: cost = load / relative
        speed, the speed being the host's measured TOAs/s over the
        fastest measured member's.  Unmeasured hosts count as fleet-fast;
        with nothing measured (or cost_model off) the costs ARE the
        loads.  Returns (costs, speeds)."""
        speeds = {m: 1.0 for m in loads}
        if self.cost_model:
            rates = {m: m.toas_per_s for m in loads
                     if m.toas_per_s is not None and m.toas_per_s > 0}
            if rates:
                top = max(rates.values())
                for m, r in rates.items():
                    speeds[m] = max(r / top, 1e-6)
        costs = {m: loads[m] / speeds[m] for m in loads}
        return costs, speeds

    def _rank(self, modelfile, n_archives, excluded=frozenset(),
              use_affinity=True):
        """Placeable hosts, best first: the template's affinity host
        leads while placing there would not leave it strictly costlier
        than the cheapest alternative; then cheapest cost.
        use_affinity=False ranks by cost alone (failover replacements and
        routed refits move OFF the original lane).  Loads come from the
        fleet's bounded probe pass.  Returns (ranked, sticky)."""
        loads = self.fleet.probe_all()
        loads = {m: v for m, v in loads.items() if m.label not in excluded}
        if not loads:
            return [], False
        costs, speeds = self._costs(loads)
        by_cost = sorted(costs, key=lambda m: (costs[m], m.index))
        if not use_affinity:
            return by_cost, False
        with self._lock:
            aff = self._affinity.get(modelfile)
        if aff is not None and aff in costs and by_cost[0] is not aff \
                and costs[aff] - costs[by_cost[0]] \
                < n_archives / speeds[aff]:
            by_cost.remove(aff)
            by_cost.insert(0, aff)
            return by_cost, True
        return by_cost, aff is not None and by_cost[0] is aff

    def _place(self, datafiles, modelfile, tim_out, name, options, tenant,
               excluded=frozenset(), attempt0=0, affinity=True,
               trace_id=None):
        """The placement loop: try the ranked hosts; retry retryable
        backpressure and unreachable hosts up to retry_max attempts with
        capped exponential backoff between full fleet passes; feed the
        health machine on transport errors.  Returns (member, handle,
        attempt, sticky) or raises the last failure."""
        n_archives = len(datafiles)
        mkey = os.path.abspath(str(modelfile))
        attempt = attempt0
        backoff = ROUTER_BACKOFF_BASE_S
        last_err = None
        while attempt < self.retry_max:
            ranked, sticky = self._rank(mkey, n_archives, excluded=excluded,
                                        use_affinity=affinity)
            if not ranked:
                # an empty pass still takes an attempt, or an all-DEAD
                # fleet would spin here forever
                attempt += 1
                last_err = RuntimeError(
                    "ToaRouter: no placeable hosts (fleet: "
                    f"{self.fleet.snapshot()})")
            for host in ranked:
                if attempt >= self.retry_max:
                    break
                attempt += 1
                try:
                    handle = host.transport.submit(
                        datafiles, modelfile, tim_out=tim_out, name=name,
                        options=options, tenant=tenant, trace_id=trace_id)
                except ServeRejected as e:
                    if not e.retryable:
                        raise  # could never fit anywhere
                    last_err = e
                except TransportError as e:
                    last_err = e
                    self.fleet.record_error(host, f"submit: {e}")
                else:
                    self.fleet.record_ok(host)
                    return (host, handle, attempt,
                            bool(sticky and host is ranked[0]))
                if self.tracer.enabled:
                    self.tracer.emit(
                        "route_retry", req=name, host=host.label,
                        attempt=attempt, backoff_s=round(backoff, 4),
                        error=str(last_err))
                sticky = False  # a rejecting affinity host lost its turn
            # a full pass found no room: back off so the loops drain,
            # then re-rank
            if attempt < self.retry_max:
                time.sleep(backoff)
                backoff = min(backoff * 2.0, ROUTER_BACKOFF_CAP_S)
        raise last_err if last_err is not None else RuntimeError(
            "ToaRouter: submit failed with no recorded error")

    def submit(self, datafiles, modelfile, tim_out=None, name=None,
               tenant=None, trace_id=None, **options):
        """Place one request on the fleet (thread-safe); returns a
        :class:`RouteHandle`.  Retries retryable backpressure and
        unreachable hosts up to ``retry_max`` placements and raises the
        last failure when the budget is spent; a terminal ServeRejected
        raises at once.  ``tenant`` labels the request's QoS lane;
        ``trace_id`` (None mints one) crosses the wire on every
        placement, hedges, failovers and refits included."""
        from ..obs.trace import new_trace_id
        from ..pipeline.toas import _is_metafile, _read_metafile

        if self._closed:
            raise RuntimeError("ToaRouter is closed")
        if isinstance(datafiles, str):
            datafiles = (_read_metafile(datafiles)
                         if _is_metafile(datafiles) else [datafiles])
        datafiles = list(datafiles)
        n_archives = len(datafiles)
        mkey = os.path.abspath(str(modelfile))
        # codec lane: the host never writes, the router demuxes at
        # collection; a hedging router writes every .tim itself (the
        # losing primary would otherwise rewrite the winner's file)
        host_tim = tim_out if (self.write_tim == "host"
                               and self.hedge_s is None) else None
        t0 = time.monotonic()
        trace_id = str(trace_id) if trace_id else new_trace_id()
        cache_key = None
        if self.cache is not None:
            hit_rh, cache_key = self._cache_lookup(
                datafiles, modelfile, tim_out, name, tenant, options,
                n_archives, t0, trace_id)
            if hit_rh is not None:
                return hit_rh
        host, handle, attempt, sticky = self._place(
            datafiles, modelfile, host_tim, name, options, tenant,
            trace_id=trace_id)
        spec = dict(datafiles=datafiles, modelfile=str(modelfile),
                    tim_out=tim_out, options=dict(options), tenant=tenant,
                    host_tim=host_tim, trace_id=trace_id)
        rh = RouteHandle(self, host, handle,
                         name if name is not None
                         else getattr(handle, "name", None),
                         n_archives, t0, spec)
        rh._cache_key = cache_key
        with self._lock:
            host.outstanding += n_archives
            host.n_requests += 1
            host.n_archives += n_archives
            self._affinity[mkey] = host
            self._inflight.setdefault(host.label, set()).add(rh)
        if self._metrics is not None:
            self._metrics.inc("route_submits")
        if self.tracer.enabled:
            self.tracer.emit(
                "route_submit", req=rh.name, host=host.label,
                n_archives=n_archives, attempt=attempt,
                affinity=bool(sticky), tenant=tenant, trace_id=trace_id)
        return rh

    def _cache_lookup(self, datafiles, modelfile, tim_out, name, tenant,
                      options, n_archives, t0, trace_id=None):
        """Content-addressed lookup before placement.  Returns
        ``(hit_handle, key)``: on a hit a PRE-RESOLVED RouteHandle (no
        attempts, never in flight, so failover and hedging cannot touch
        it) whose ``.tim`` is an atomic byte copy of the stored entry; on
        a miss ``(None, key)``, so the placed request fills the store at
        collection."""
        try:
            key = content_key(list(datafiles) + [modelfile], options)
        except OSError:
            # unreadable input: the placement path raises the real error
            return None, None
        ent = self.cache.get_result(key, datafiles)
        if ent is None:
            if self.tracer.enabled:
                self.tracer.emit("cache_miss", req=name, source="router",
                                 tenant=tenant, trace_id=trace_id)
            return None, key
        result, entry_path, n_bytes = ent
        if tim_out:
            codec.copy_tim_atomic(entry_path, tim_out)
        result.tim_out = tim_out
        spec = dict(datafiles=list(datafiles), modelfile=str(modelfile),
                    tim_out=tim_out, options=dict(options), tenant=tenant,
                    host_tim=None)
        rh = RouteHandle(self, None, None, name, n_archives, t0, spec)
        rh.attempts = []
        rh._collected = True
        rh._result = result
        self.cache_hits += 1
        self.cache_bytes += n_bytes
        wall = time.monotonic() - t0
        if self._metrics is not None:
            self._metrics.inc("route_submits")
            self._metrics.inc("route_done")
            self._metrics.inc("cache_hits")
            self._metrics.inc("cache_bytes", n_bytes)
            self._metrics.observe("route_latency_s", wall)
        if self._slo is not None:
            breach = self._slo.observe(tenant or "default", wall)
            if breach is not None and self.tracer.enabled:
                self.tracer.emit("slo_breach", source="router", **breach)
        if self.tracer.enabled:
            self.tracer.emit("route_submit", req=name, host=None,
                             n_archives=n_archives, attempt=0,
                             affinity=False, tenant=tenant,
                             trace_id=trace_id)
            self.tracer.emit("cache_hit", req=name, bytes=n_bytes,
                             source="router", tenant=tenant,
                             trace_id=trace_id)
            self.tracer.counter("cache_hit")
            self.tracer.emit("route_done", req=name, host=None,
                             wall_s=round(wall, 6),
                             n_toas=len(result.TOA_list), error=None,
                             tenant=tenant, hedged=False, failover=None,
                             trace_id=trace_id)
        rh._done.set()
        return rh, key

    # blocking conveniences mirroring serve.ToaClient ------------------

    def get_TOAs(self, datafiles, modelfile, timeout=None, tim_out=None,
                 name=None, tenant=None, **options):
        """Submit and wait (the one-shot stream's return shape)."""
        return self.submit(datafiles, modelfile, tim_out=tim_out,
                           name=name, tenant=tenant,
                           **options).result(timeout)

    def map(self, specs, timeout=None, return_errors=False):
        """Submit many, then wait for all, in spec order; specs are
        (datafiles, modelfile[, kwargs]) tuples (ToaClient.map's
        contract: serve.client.collect_results)."""
        from .client import collect_results

        handles = [self.submit(s[0], s[1],
                               **(dict(s[2]) if len(s) > 2 else {}))
                   for s in specs]
        return collect_results(handles, timeout, return_errors)

    # ------------------------------------------------------------------
    # collection: the poll loop, aware of hedges and failovers
    # ------------------------------------------------------------------

    def _await(self, rh, timeout):
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while True:
            if rh._done.is_set():
                if rh._error is not None:
                    raise rh._error
                return rh._result
            if (self.hedge_s is not None and not rh._hedged
                    and time.monotonic() - rh._t_submit >= self.hedge_s):
                self._launch_hedge(rh)
            with self._lock:
                attempts = list(rh.attempts)
            if not attempts:
                # a failover is re-placing this request on another
                # thread; yield and re-check
                time.sleep(0.01)
            settled = rh._collected or (len(attempts) == 1
                                        and self.hedge_s is None)
            slice_s = ROUTER_POLL_SETTLED_S if settled else ROUTER_POLL_S
            for host, handle, router_tim in attempts:
                left = None if deadline is None \
                    else max(0.0, deadline - time.monotonic())
                wait = slice_s if left is None else min(slice_s, left)
                try:
                    res = host.transport.result(handle, wait)
                except TimeoutError:
                    continue  # not resolved: keep it accounted
                except TransportError as e:
                    self.fleet.record_error(host, f"result: {e}")
                    self._failover_attempt(rh, host, handle, e)
                    break  # the attempts changed: re-snapshot
                except Exception as e:
                    # the request failed ON the host: deterministic and
                    # terminal
                    self._finish(rh, host, error=e, win_handle=handle)
                    raise
                else:
                    return self._finish(rh, host, result=res,
                                        router_tim=router_tim,
                                        win_handle=handle)
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{rh.name}: no result within {timeout} s")

    def _unaccount(self, rh, win_handle=None):
        """Release the load accounting of every live attempt of ``rh``;
        losing attempts go to the orphan reaper (caller holds the
        lock)."""
        for host, handle, _rt in rh.attempts:
            host.outstanding = max(0, host.outstanding - rh.n_archives)
            self._inflight.get(host.label, set()).discard(rh)
            if handle != win_handle:
                self._orphans.append((host, handle))
        rh.attempts = []
        if self._orphans and not self._closed and (
                self._reaper is None or not self._reaper.is_alive()):
            self._reaper = threading.Thread(target=self._reap_loop,
                                            name="ppt-route-reap",
                                            daemon=True)
            self._reaper.start()

    def _reap_loop(self):
        """Collect and discard abandoned attempts (hedge losers): the
        transports evict a handle at collection, so an uncollected loser
        would pin its payload for the connection's lifetime."""
        while not self._closed:
            with self._lock:
                orphans = list(self._orphans)
            if not orphans:
                return
            for host, handle in orphans:
                try:
                    host.transport.result(handle, 0.05)
                except TimeoutError:
                    continue  # still running
                except Exception:
                    pass      # dead host or failed request: forget it
                with self._lock:
                    try:
                        self._orphans.remove((host, handle))
                    except ValueError:
                        pass
            time.sleep(ROUTER_REAP_S)

    def _finish(self, rh, winner, result=None, error=None,
                router_tim=False, action=None, win_handle=None):
        """Resolve one request exactly once: release the accounting of
        every attempt, write the winner's ``.tim`` atomically when the
        winning attempt did not carry the host-side path, run the
        optional routed refit, fill the cache, emit route_done."""
        with self._lock:
            already = rh._collected
            if not already:
                rh._collected = True
                self._unaccount(rh, win_handle=win_handle)
        if already:
            # lost the race to a hedge twin: hand its outcome back
            rh._done.wait()
            if rh._error is not None:
                raise rh._error
            return rh._result
        hedged = rh._hedged
        if result is not None and router_tim and rh.tim_out:
            try:
                codec.write_tim_result(result, rh.tim_out)
                result.tim_out = rh.tim_out
            except (OSError, ValueError) as e:
                error, result = RuntimeError(
                    f"{rh.name}: result collected but its .tim could not "
                    f"be written at {rh.tim_out}: {e}"), None
        if result is not None and self.quality_refit and winner:
            try:
                result = self._maybe_refit(rh, winner, result)
            except Exception as e:
                # best-effort: a broken refit serves the ORIGINAL result
                log(f"routed refit of {rh.name!r} failed: "
                    f"{type(e).__name__}: {e}; serving the original fit",
                    quiet=False, level="warn", tracer=None)
        if (result is not None and error is None and self.cache is not None
                and getattr(rh, "_cache_key", None)):
            # put_result itself refuses partial or recovered payloads
            stored = self.cache.put_result(rh._cache_key, result)
            if stored and self.tracer.enabled:
                self.tracer.emit("cache_store", key=rh._cache_key,
                                 bytes=stored)
        rh._result = result
        rh._error = error
        wall_s = time.monotonic() - rh._t_submit
        tenant = rh.spec.get("tenant")
        if self._metrics is not None:
            self._metrics.inc("route_done")
            if error is not None:
                self._metrics.inc("route_failed")
            if hedged:
                self._metrics.inc("route_hedged")
            if action is not None:
                self._metrics.inc(f"route_failover_{action}")
            if result is not None:
                self._metrics.inc("toas_total", len(result.TOA_list or ()))
            self._metrics.observe("route_latency_s", wall_s)
        if self._slo is not None:
            breach = self._slo.observe(
                tenant or "default",
                wall_s if error is None else float("inf"))
            if breach is not None and self.tracer.enabled:
                self.tracer.emit("slo_breach", source="router", **breach)
        if self.tracer.enabled:
            self.tracer.emit(
                "route_done", req=rh.name,
                host=winner.label if winner is not None else None,
                wall_s=round(wall_s, 6),
                n_toas=len(result.TOA_list) if result else 0,
                error=str(error) if error else None, tenant=tenant,
                hedged=bool(hedged), failover=action,
                trace_id=rh.spec.get("trace_id"))
        rh._done.set()
        if error is not None:
            raise error
        return result

    # ------------------------------------------------------------------
    # hedging
    # ------------------------------------------------------------------

    def _launch_hedge(self, rh):
        """One duplicate attempt on the least-loaded other eligible host
        (none when there is nowhere else).  A hedge never writes
        host-side: the router writes the winner's .tim at collection."""
        with self._lock:
            if rh._hedged or rh._collected or not rh.attempts:
                return
            rh._hedged = True   # one hedge per request, even on failure
            primary = rh.attempts[0][0]
        loads = self.fleet.probe_all()
        costs, _speeds = self._costs(loads)
        cands = [m for m in sorted(costs, key=lambda m: (costs[m], m.index))
                 if m is not primary and m.label not in rh.excluded]
        if not cands:
            return
        host = cands[0]
        try:
            handle = host.transport.submit(
                rh.datafiles, rh.spec["modelfile"], tim_out=None,
                name=rh.name, options=rh.spec["options"],
                tenant=rh.spec.get("tenant"),
                trace_id=rh.spec.get("trace_id"))
        except (ServeRejected, TransportError) as e:
            log(f"hedge of {rh.name!r} on {host.label} not placed: {e}",
                quiet=self.quiet, level="warn", tracer=None)
            if isinstance(e, TransportError):
                self.fleet.record_error(host, f"hedge submit: {e}")
            return
        with self._lock:
            if rh._collected:
                return  # resolved while placing: abandon it
            rh.attempts.append((host, handle, True))
            host.outstanding += rh.n_archives
            self._inflight.setdefault(host.label, set()).add(rh)
        if self._metrics is not None:
            self._metrics.inc("hedges_launched")
        if self.tracer.enabled:
            self.tracer.emit("route_hedge", req=rh.name,
                             primary=primary.label, host=host.label,
                             trace_id=rh.spec.get("trace_id"))

    # ------------------------------------------------------------------
    # failover
    # ------------------------------------------------------------------

    def _failover_host(self, member):
        """Fleet callback: ``member`` went DEAD.  Re-place every request
        in flight on it, exactly once each."""
        with self._lock:
            handles = list(self._inflight.get(member.label, ()))
        for rh in handles:
            handle = None
            with self._lock:
                for h, k, _s in rh.attempts:
                    if h is member:
                        handle = k
                        break
            if handle is not None:
                self._failover_attempt(
                    rh, member, handle,
                    TransportError(f"{member.label} is DEAD"))

    def _failover_attempt(self, rh, member, handle, err):
        """One attempt of ``rh`` died with its host.  Idempotent (the
        awaiting thread and the fleet's on_dead callback may both come
        here): collect from the durable .tim when every sentinel landed,
        else re-dispatch with the dead host excluded; resolve with the
        error only when neither is possible."""
        with self._lock:
            live = [(h, k, s) for h, k, s in rh.attempts
                    if h is member and k == handle]
            if not live or rh._collected:
                return
            rh.attempts.remove(live[0])
            rh.excluded.add(member.label)
            member.outstanding = max(0, member.outstanding - rh.n_archives)
            self._inflight.get(member.label, set()).discard(rh)
            if rh.attempts:
                return  # the hedge twin races on
            if rh._redispatching:
                return
            rh._redispatching = True
        try:
            # exactly once: work whose .tim sentinels all landed is
            # durable; collect it, never fit it again
            if (self.write_tim == "host" and rh.tim_out
                    and codec.tim_complete(rh.tim_out, rh.datafiles)):
                res = codec.read_tim_result(rh.tim_out)
                if self.tracer.enabled:
                    self.tracer.emit("route_failover", req=rh.name,
                                     dead_host=member.label,
                                     action="collected", host=None,
                                     trace_id=rh.spec.get("trace_id"))
                log(f"failover: {rh.name!r} collected from its durable "
                    f".tim after {member.label} died (no re-fit)",
                    quiet=self.quiet, level="warn", tracer=None)
                self._finish(rh, None, result=res, action="collected")
                return
            # the replacement never writes host-side: if the "dead" host
            # still serves the original attempt, two hosts must not
            # write one path; the router writes the replacement's .tim
            host, handle2, attempt, _sticky = self._place(
                rh.datafiles, rh.spec["modelfile"], None, rh.name,
                rh.spec["options"], rh.spec.get("tenant"),
                excluded=frozenset(rh.excluded), affinity=False,
                trace_id=rh.spec.get("trace_id"))
            with self._lock:
                rh.attempts.append((host, handle2, rh.tim_out is not None))
                rh.host = host
                rh._handle = handle2
                host.outstanding += rh.n_archives
                host.n_requests += 1
                host.n_archives += rh.n_archives
                self._inflight.setdefault(host.label, set()).add(rh)
                rh._redispatching = False
            if self.tracer.enabled:
                self.tracer.emit("route_failover", req=rh.name,
                                 dead_host=member.label,
                                 action="redispatch", host=host.label,
                                 attempt=attempt,
                                 trace_id=rh.spec.get("trace_id"))
            log(f"failover: {rh.name!r} re-dispatched to {host.label} "
                f"after {member.label} died (excluded: "
                f"{sorted(rh.excluded)})", quiet=self.quiet, level="warn",
                tracer=None)
        except Exception as e:
            if self.tracer.enabled:
                self.tracer.emit("route_failover", req=rh.name,
                                 dead_host=member.label, action="failed",
                                 host=None,
                                 trace_id=rh.spec.get("trace_id"))
            try:
                self._finish(rh, None, error=e, action="failed")
            except Exception:
                pass  # the awaiting client re-raises from rh._error

    # ------------------------------------------------------------------
    # refit-aware routing
    # ------------------------------------------------------------------

    def _gate_trips(self, toas):
        import numpy as np

        from .. import config

        for t in toas:
            gof = t.flags.get("gof")
            if gof is not None and np.isfinite(gof) \
                    and float(gof) > config.quality_max_gof:
                return True
            if config.quality_min_snr > 0.0:
                snr = t.flags.get("snr")
                if snr is not None and np.isfinite(snr) \
                        and float(snr) < config.quality_min_snr:
                    return True
        return False

    def _worst_gof(self, toas):
        import numpy as np

        gofs = [float(t.flags["gof"]) for t in toas
                if t.flags.get("gof") is not None
                and np.isfinite(t.flags["gof"])]
        return max(gofs) if gofs else None

    def _maybe_refit(self, rh, winner, res):
        """The routed quality loop: archives of a collected result that
        trip the gate get exactly ONE zap-and-refit request on the
        current least-loaded HEALTHY host (affinity ignored); the refit
        TOAs replace the originals and the request .tim is rewritten.
        Every fallback serves the original result loudly."""
        if rh._refit_done:
            return res
        rh._refit_done = True
        try:
            groups = list(codec.iter_archive_toas(res))
        except ValueError as e:
            log(f"routed refit of {rh.name!r} skipped: {e}", quiet=False,
                level="warn", tracer=None)
            return res
        trips = [f for f, toas in groups if toas and self._gate_trips(toas)]
        if not trips:
            return res
        from ..io.psrfits import load_data
        from ..pipeline.zap import get_zap_channels, resolve_zap_nstd

        gof_before = {f: self._worst_gof(dict(groups)[f]) for f in trips}
        zap_map = {}
        for f in trips:
            try:
                d = load_data(f, dedisperse=False, dededisperse=True,
                              tscrunch=rh.spec["options"].get(
                                  "tscrunch", False),
                              pscrunch=True, quiet=True)
                lists = get_zap_channels(
                    d, nstd=resolve_zap_nstd(None), tracer=self.tracer,
                    device=self.device)
            except Exception as e:
                log(f"routed refit of {f} (request {rh.name!r}) not "
                    f"possible: {type(e).__name__}: {e}; serving the "
                    "original fit", quiet=False, level="warn", tracer=None)
                continue
            if sum(len(z) for z in lists):
                zap_map[f] = lists
            else:
                if self.tracer.enabled:
                    self.tracer.emit(
                        "refit", req=rh.name, datafile=f, n_channels=0,
                        gof_before=gof_before[f], gof_after=gof_before[f],
                        improved=False, host_from=winner.label,
                        host=winner.label)
                log(f"routed refit of {f} (request {rh.name!r}) not "
                    "possible: the median algorithm flagged no channels; "
                    "serving the original fit", quiet=False, level="warn",
                    tracer=None)
        if not zap_map:
            return res
        # least-loaded HEALTHY placement, affinity off
        loads = self.fleet.probe_all()
        costs, _speeds = self._costs(loads)
        healthy = [m for m in sorted(costs, key=lambda m: (costs[m], m.index))
                   if m.state == HEALTHY]
        if not healthy:
            log(f"routed refit of {rh.name!r}: no HEALTHY host to re-place "
                "on; serving the original fit", quiet=False, level="warn",
                tracer=None)
            return res
        host2 = healthy[0]
        refit_files = sorted(zap_map)
        try:
            with self._lock:
                host2.outstanding += len(refit_files)
                host2.n_requests += 1
                host2.n_archives += len(refit_files)
            try:
                handle = host2.transport.submit(
                    refit_files, rh.spec["modelfile"], tim_out=None,
                    name=f"{rh.name}:refit",
                    options={**rh.spec["options"], "zap_channels": zap_map},
                    tenant=rh.spec.get("tenant"),
                    trace_id=rh.spec.get("trace_id"))
                # bounded: a hung refit host falls back to the original
                res2 = host2.transport.result(handle, ROUTER_REFIT_TIMEOUT_S)
            finally:
                with self._lock:
                    host2.outstanding = max(
                        0, host2.outstanding - len(refit_files))
        except Exception as e:
            log(f"routed refit of {rh.name!r} on {host2.label} failed: "
                f"{type(e).__name__}: {e}; serving the original fit",
                quiet=False, level="warn", tracer=None)
            return res
        new_groups = dict(codec.iter_archive_toas(res2))
        pos2 = {f: i for i, f in enumerate(res2.order)}
        TOA_list = []
        for i, (f, toas) in enumerate(groups):
            if f in new_groups:
                toas = new_groups[f]
                j = pos2[f]
                res.DM0s[i] = res2.DM0s[j]
                res.DeltaDM_means[i] = res2.DeltaDM_means[j]
                res.DeltaDM_errs[i] = res2.DeltaDM_errs[j]
                gof_after = self._worst_gof(toas)
                n_ch = sum(len(z) for z in zap_map[f])
                improved = (gof_after is not None
                            and gof_before[f] is not None
                            and gof_after < gof_before[f])
                if self.tracer.enabled:
                    self.tracer.emit(
                        "refit", req=rh.name, datafile=f,
                        n_channels=int(n_ch), gof_before=gof_before[f],
                        gof_after=gof_after, improved=bool(improved),
                        host_from=winner.label, host=host2.label)
                if self._gate_trips(toas):
                    log(f"routed refit of {f} (request {rh.name!r}) still "
                        f"trips the gate after zapping {n_ch} channel(s) "
                        f"(red-chi^2 {gof_before[f]} -> {gof_after}); "
                        "serving the zapped fit, no further refits",
                        quiet=False, level="warn", tracer=None)
            TOA_list.extend(toas)
        res.TOA_list = TOA_list
        if rh.tim_out:
            try:
                codec.write_tim_result(res, rh.tim_out)
            except OSError as e:
                log(f"routed refit of {rh.name!r}: the merged result could "
                    f"not rewrite {rh.tim_out}: {e} (the host-written .tim "
                    "remains)", quiet=False, level="warn", tracer=None)
        return res

    # ------------------------------------------------------------------

    def stats(self):
        """Per-host placement snapshot: {label: {outstanding, n_requests,
        n_archives, state, toas_per_s}}."""
        with self._lock:
            return {m.label: {"outstanding": m.outstanding,
                              "n_requests": m.n_requests,
                              "n_archives": m.n_archives,
                              "state": m.state,
                              "toas_per_s": m.toas_per_s}
                    for m in self.fleet.members()}

    def metrics(self):
        """Fleet-wide live metrics: each host's ``metrics`` reply and the
        merged view (queue depth, in flight, TOAs/s, p50/p90/p99 by a
        bucket-wise histogram merge, cache hits, link stall fraction,
        health states), and the router's own route-latency registry and
        SLO snapshot.  A host whose ``metrics`` op fails degrades to its
        ``stat`` fields with the error recorded; the reply never raises
        on a sick fleet."""
        from ..obs import metrics as obs_metrics

        with self._lock:
            members = [(m.label, m.state, m.outstanding, m.n_requests,
                        m.n_archives, m.toas_per_s, m.transport)
                       for m in self.fleet.members()]
        hosts = {}
        host_exports = []
        for (label, state, outstanding, n_req, n_arch, rate,
             transport) in members:
            ent = {"state": state, "outstanding": outstanding,
                   "n_requests": n_req, "n_archives": n_arch,
                   "toas_per_s": rate, "queue_len": None,
                   "pending_archives": None, "n_live": None,
                   "link_stall_frac": None, "slo": None, "metrics": None,
                   "p50_s": None, "p99_s": None, "error": None}
            try:
                m = transport.metrics()
            except Exception as e:
                ent["error"] = str(e)
                try:
                    st = transport.stat()
                except Exception:
                    pass  # unreachable: the state says why
                else:
                    for k in ("queue_len", "pending_archives", "n_live",
                              "toas_per_s"):
                        ent[k] = st.get(k)
            else:
                for k in ("queue_len", "pending_archives", "n_live",
                          "toas_per_s", "link_stall_frac", "slo",
                          "cache_hits", "cache_bytes"):
                    ent[k] = m.get(k)
                ent["metrics"] = m.get("metrics")
                if ent["metrics"]:
                    host_exports.append(ent["metrics"])
                    h = (ent["metrics"].get("histograms") or {}) \
                        .get("request_latency_s")
                    if h:
                        ent["p50_s"] = obs_metrics.quantile_from_export(
                            h, 0.50)
                        ent["p99_s"] = obs_metrics.quantile_from_export(
                            h, 0.99)
            hosts[label] = ent
        merged = obs_metrics.merge_exports(host_exports)
        hl = merged["histograms"].get("request_latency_s")

        def _q(h, q):
            return obs_metrics.quantile_from_export(h, q) if h else None

        def _sum(key):
            vals = [hosts[lb][key] for lb in hosts
                    if hosts[lb][key] is not None]
            return sum(vals) if vals else None

        router_ex = (self._metrics.export()
                     if self._metrics is not None else None)
        n_sub = (router_ex or {}).get("counters", {}).get("route_submits", 0)
        rl = (router_ex or {}).get("histograms", {}).get("route_latency_s")
        return {
            "metrics_enabled": self._metrics is not None,
            "hosts": hosts,
            "fleet": {
                "n_hosts": len(hosts),
                "states": {lb: hosts[lb]["state"] for lb in hosts},
                "queue_depth": _sum("queue_len"),
                "pending_archives": _sum("pending_archives"),
                "in_flight": sum(hosts[lb]["outstanding"] for lb in hosts),
                "toas_per_s": _sum("toas_per_s"),
                "link_stall_frac": obs_metrics.link_stall_frac(merged),
                "p50_s": _q(hl, 0.50), "p90_s": _q(hl, 0.90),
                "p99_s": _q(hl, 0.99),
                "metrics": merged,
            },
            "router": {
                "cache_hits": self.cache_hits,
                "cache_bytes": self.cache_bytes,
                "cache_hit_rate": (round(self.cache_hits / n_sub, 4)
                                   if n_sub else None),
                "p50_s": _q(rl, 0.50), "p90_s": _q(rl, 0.90),
                "p99_s": _q(rl, 0.99),
                "metrics": router_ex,
                "slo": (self._slo.snapshot()
                        if self._slo is not None else None),
            },
        }

    def close(self):
        """Close every transport (idempotent).  The router never owns the
        remote servers: a fleet outlives its clients."""
        if self._closed:
            return
        self._closed = True
        if self._watcher is not None:
            self._watcher.stop()
        self.fleet.close()
        if self._own_tracer:
            self.tracer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
