"""Fleet membership and the per-host health state machine under the
router (counterpart of pulseportraiture_tpu/serve/fleet.py).

- **Health state machine**, ``JOINING -> HEALTHY -> SUSPECT -> DEAD ->
  REJOINED``:

  ============  =========================================  ==========
  state         meaning                                    placeable
  ============  =========================================  ==========
  JOINING       registered, no successful probe yet        no
  HEALTHY       probes and submits succeeding              yes
  SUSPECT       one probe timeout / transport error        yes
  DEAD          a second consecutive failure               no
  REJOINED      a DEAD host probed OK again (one           no
                more success confirms -> HEALTHY)
  ============  =========================================  ==========

  A success anywhere (probe or submit) resets the failure count:
  SUSPECT recovers to HEALTHY, DEAD steps to REJOINED, REJOINED confirms
  to HEALTHY.  Every edge emits a ``fleet_transition`` event, and the
  degrading edges a stderr warning.

- **Bounded probes with cached loads**: every placement pass refreshes
  the loads through :meth:`Fleet.probe_all`; each host's ``stat`` runs
  on its own daemon thread and the caller waits at most
  ``config.router_probe_ms``.  While a probe is outstanding the cached
  load is used, so one hung host never delays a placement; a probe past
  the deadline feeds SUSPECT (once), and its eventual completion still
  lands in the machine.  Probe threads do socket or queue reads only,
  never device work.

- **Dynamic membership**: :meth:`Fleet.add` / :meth:`Fleet.remove` at
  run time (``ToaRouter.add_host`` / ``remove_host``), and
  :class:`FleetFileWatcher` reconciles the fleet against a watched file
  (one host:port per line).  A string endpoint keeps its address as a
  re-dial factory: a DEAD socket host gets a fresh connection on its
  next probe, which is how a restarted ``ppserve --listen`` rejoins.

The router layers failover on top (serve/router.py): a DEAD transition
with requests in flight re-places them exactly once.
"""

import os
import threading
import time

from ..telemetry import NULL_TRACER, log

__all__ = ["JOINING", "HEALTHY", "SUSPECT", "DEAD", "REJOINED",
           "PLACEABLE_STATES", "FleetMember", "Fleet", "FleetFileWatcher"]

JOINING = "JOINING"
HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"
REJOINED = "REJOINED"
# placement draws ONLY from these: JOINING/REJOINED hosts are still being
# vetted (their next successful probe promotes them), DEAD hosts took
# work down with them once already
PLACEABLE_STATES = frozenset({HEALTHY, SUSPECT})

# A DEAD endpoint is re-probed at most this often.
DEAD_REPROBE_S = 1.0


class _Probe:
    """One in-flight stat probe: its completion event and the timed-out
    latch (a probe past the deadline feeds SUSPECT exactly once)."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.done = threading.Event()
        self.timed_out = False


class FleetMember:
    """One endpoint: its transport, health state and the router-side load
    bookkeeping placement reads."""

    def __init__(self, transport, index, factory=None):
        self.transport = transport
        self.index = index
        self.label = getattr(transport, "label", f"host{index}")
        # re-dial hook of a string endpoint
        self.factory = factory
        self.state = JOINING
        self.outstanding = 0   # archives submitted, result not collected
        self.n_requests = 0    # requests ever placed here
        self.n_archives = 0    # archives ever placed here
        self.cached_pending = None  # last stat()['pending_archives']
        # routing signals refreshed by every successful probe: the
        # host's smoothed measured TOAs/s (None until its first fit: the
        # cost model then counts it fleet-fast) and its capability record
        self.toas_per_s = None
        self.capability = None
        self._probe = None
        self._last_probe_t = 0.0

    def load(self):
        """Cached load: this router's outstanding archives plus the
        host's last-known admission-queue depth (other clients' submits
        show there).  Never blocks."""
        if self.cached_pending is None:
            return self.outstanding
        return self.outstanding + self.cached_pending


class Fleet:
    """Membership registry and health state machine over N endpoints.

    ``on_dead(member)`` fires (outside the fleet lock) whenever a member
    turns DEAD: the router's failover hangs there.  ``probe_ms`` bounds
    every placement pass's load refresh (None = config.router_probe_ms)."""

    def __init__(self, tracer=None, probe_ms=None, on_dead=None,
                 quiet=True):
        from .. import config

        self.tracer = tracer if tracer is not None else NULL_TRACER
        if probe_ms is None:
            probe_ms = config.router_probe_ms
        self.probe_s = max(1e-3, float(probe_ms)) / 1e3
        self.on_dead = on_dead
        self.quiet = quiet
        self._lock = threading.Lock()
        self._members = {}     # label -> FleetMember (insertion order)
        self._next_index = 0

    # ------------------------------------------------------------------
    # membership
    # ------------------------------------------------------------------

    def add(self, transport_or_address, label=None):
        """Register one endpoint (JOINING; the next probe promotes a
        reachable host).  A string opens a SocketTransport now
        (TransportError if unreachable) and keeps the address as the
        re-dial factory."""
        factory = None
        if isinstance(transport_or_address, str):
            from .transport import SocketTransport

            address = transport_or_address
            factory = lambda a=address: SocketTransport(a)  # noqa: E731
            transport = factory()
        else:
            transport = transport_or_address
        with self._lock:
            index = self._next_index
            member = FleetMember(transport, index, factory=factory)
            if label is not None:
                member.label = str(label)
            if member.label in self._members:
                try:
                    if factory is not None:
                        transport.close()
                except Exception:
                    pass
                raise ValueError(
                    f"fleet: duplicate host endpoint {member.label!r}")
            self._next_index += 1
            self._members[member.label] = member
        self._emit(member, None, JOINING, "join")
        return member

    def remove(self, label):
        """Administrative leave: no new placements; requests in flight on
        it keep collecting through its transport.  Returns the removed
        member (None when unknown)."""
        with self._lock:
            member = self._members.pop(str(label), None)
        if member is not None:
            self._emit(member, member.state, "LEFT", "removed")
        return member

    def members(self):
        with self._lock:
            return list(self._members.values())

    def get(self, label):
        with self._lock:
            return self._members.get(str(label))

    def snapshot(self):
        """{label: state}."""
        with self._lock:
            return {m.label: m.state for m in self._members.values()}

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------

    def _emit(self, member, old, new, reason):
        if self.tracer.enabled:
            self.tracer.emit("fleet_transition", host=member.label,
                             from_state=old, to_state=new,
                             reason=str(reason))
        level = "warn" if new in (SUSPECT, DEAD) else "info"
        log(f"fleet: {member.label} {old or '-'} -> {new} ({reason})",
            quiet=self.quiet, level=level, tracer=None)

    def record_ok(self, member, pending=None, toas_per_s=None,
                  capability=None):
        """A probe or submit succeeded: refresh the cached load (and the
        signals a probe carries) and take the recovery edges."""
        with self._lock:
            if self._members.get(member.label) is not member:
                return  # removed while the probe was in flight
            if pending is not None:
                member.cached_pending = int(pending)
            if toas_per_s is not None:
                member.toas_per_s = float(toas_per_s)
            if capability is not None:
                member.capability = capability
            old = member.state
            if old in (JOINING, SUSPECT):
                member.state = HEALTHY
            elif old == DEAD:
                member.state = REJOINED
            elif old == REJOINED:
                member.state = HEALTHY
            new = member.state
        if new != old:
            self._emit(member, old, new,
                       "probe ok" if pending is not None else "submit ok")

    def record_error(self, member, reason):
        """A probe timed out or a transport call failed: degrade
        (HEALTHY -> SUSPECT, SUSPECT/REJOINED -> DEAD); JOINING and DEAD
        stay.  A DEAD transition fires the failover callback."""
        with self._lock:
            if self._members.get(member.label) is not member:
                return
            old = member.state
            if old == HEALTHY:
                member.state = SUSPECT
            elif old in (SUSPECT, REJOINED):
                member.state = DEAD
            new = member.state
        if new != old:
            self._emit(member, old, new, reason)
        if new == DEAD and old != DEAD and self.on_dead is not None:
            self.on_dead(member)

    # ------------------------------------------------------------------
    # bounded probes
    # ------------------------------------------------------------------

    def _probe_worker(self, member, probe):
        try:
            from .transport import TransportError

            try:
                st = member.transport.stat()
            except TransportError:
                if member.factory is None:
                    raise
                # re-registration: a poisoned or refused connection with
                # a known address gets a fresh dial
                fresh = member.factory()
                old_t, member.transport = member.transport, fresh
                try:
                    old_t.close()
                except Exception:
                    pass
                st = fresh.stat()
            self.record_ok(member, pending=st["pending_archives"],
                           toas_per_s=st.get("toas_per_s"),
                           capability=st.get("capability"))
        except Exception as e:
            # one probe episode charges one strike: a probe that already
            # fed SUSPECT at its deadline must not count again
            if not probe.timed_out:
                self.record_error(member, f"probe failed: {e}")
        finally:
            probe.done.set()

    def _ensure_probe(self, member):
        """Start a probe unless one is outstanding; (probe, fresh)."""
        with self._lock:
            probe = member._probe
            if probe is not None and not probe.done.is_set():
                return probe, False
            if member.state == DEAD and \
                    time.monotonic() - member._last_probe_t < DEAD_REPROBE_S:
                return probe, False  # throttle dead-host re-dials
            probe = member._probe = _Probe()
            member._last_probe_t = probe.t0
        threading.Thread(target=self._probe_worker, args=(member, probe),
                         name=f"ppt-probe-{member.label}",
                         daemon=True).start()
        return probe, True

    def _probe_timeout(self, member, probe):
        """Mark one probe as past its deadline (once): the SUSPECT feed.
        The probe keeps running; its result still lands."""
        if probe is None or probe.timed_out or probe.done.is_set():
            return
        probe.timed_out = True
        self.record_error(
            member, f"stat probe exceeded {self.probe_s * 1e3:.0f} ms "
                    "(config.router_probe_ms)")

    def probe_all(self, timeout_s=None):
        """Refresh every member's load under ONE shared deadline and
        return ``{member: load}`` of the placeable members.  A host with
        a probe outstanding contributes its cached load at once."""
        if timeout_s is None:
            timeout_s = self.probe_s
        started = [(m, *self._ensure_probe(m)) for m in self.members()]
        deadline = time.monotonic() + timeout_s
        for member, probe, fresh in started:
            if probe is None:
                continue
            left = deadline - time.monotonic()
            if not (probe.done.is_set()
                    or (left > 0 and probe.done.wait(left))):
                self._probe_timeout(member, probe)
        return {m: m.load() for m in self.members()
                if m.state in PLACEABLE_STATES}

    def close(self):
        """Close every member transport."""
        for m in self.members():
            try:
                m.transport.close()
            except Exception:
                pass


class FleetFileWatcher(threading.Thread):
    """Reconcile a router's fleet against a watched host list.

    The file holds one ``host:port`` per line (blank lines and ``#``
    comments ignored).  Every ``poll_s`` the watcher re-reads it when its
    mtime (in ns) or its size moved and adds or removes hosts to match; only endpoints the
    watcher itself added are ever removed.  An unreachable new entry
    warns and is retried on the next poll.  Passes are serialized: the
    poll thread and a caller's :meth:`resync` never interleave, so a pass
    that read a file being saved in place (truncated, then written)
    cannot undo a later pass that read the whole file."""

    def __init__(self, router, path, poll_s=1.0, quiet=True):
        super().__init__(name="ppt-fleet-file", daemon=True)
        self.router = router
        self.path = str(path)
        self.poll_s = max(0.05, float(poll_s))
        self.quiet = quiet
        self._halt = threading.Event()
        self._resync_lock = threading.Lock()
        self._last_stamp = None
        self._managed = set()   # labels this watcher added
        self._warned = set()

    def parse(self):
        """The fleet file as an ordered list of host:port strings (a
        malformed line warns and is skipped); None when unreadable."""
        from .. import config

        hosts = []
        try:
            with open(self.path) as fh:
                lines = fh.readlines()
        except OSError as e:
            log(f"fleet-file {self.path}: unreadable ({e})", quiet=False,
                level="warn", tracer=None)
            return None
        for lineno, line in enumerate(lines, 1):
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            try:
                config.parse_hostport(s)
            except ValueError as e:
                log(f"fleet-file {self.path}:{lineno}: {e} — line "
                    "ignored", quiet=False, level="warn", tracer=None)
                continue
            if s not in hosts:
                hosts.append(s)
        return hosts

    def resync(self):
        """One reconciliation pass (the file read and the membership
        edits under one lock)."""
        with self._resync_lock:
            self._resync()

    def _resync(self):
        from .transport import TransportError

        hosts = self.parse()
        if hosts is None:
            return
        current = set(self.router.host_labels())
        for addr in hosts:
            if addr in current:
                continue
            try:
                self.router.add_host(addr)
                self._managed.add(addr)
                self._warned.discard(addr)
            except (TransportError, ValueError) as e:
                if addr not in self._warned:
                    self._warned.add(addr)
                    log(f"fleet-file: cannot join {addr} yet ({e}); "
                        "will retry", quiet=self.quiet, level="warn",
                        tracer=None)
        wanted = set(hosts)
        for label in sorted(self._managed - wanted):
            self._managed.discard(label)
            if label in current:
                self.router.remove_host(label)

    def _stamp(self):
        """(mtime in ns, size) of the fleet file, None when unreadable: an
        in-place save within one mtime tick of the last pass still
        changes the size (ROADMAP C6; the JAX watcher compares mtimes)."""
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        return st.st_mtime_ns, st.st_size

    def run(self):
        self.resync()
        while not self._halt.wait(self.poll_s):
            try:
                stamp = self._stamp()
                if stamp != self._last_stamp:
                    self._last_stamp = stamp
                    self.resync()
                elif self._warned:
                    # retry endpoints unreachable on the last pass
                    self.resync()
            except Exception as e:  # the watcher must never die
                log(f"fleet-file watcher: {e}", quiet=False, level="warn",
                    tracer=None)

    def stop(self):
        self._halt.set()
