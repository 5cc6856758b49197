"""Ingest sources: where the observatory pipeline's archives come from
(counterpart of pulseportraiture_tpu/ingest/source.py; host code, no
device work).

Both sources share one small contract the driver polls:

  ``poll()``   -> list of (path, wait_s) newly admissible since the
                  last call (wait_s = discovery -> admission latency)
  ``defer(p)`` -> put a path back for a later retry (the driver calls
                  this on a truncation probe failure or serve
                  backpressure; the path re-admits once stable again)
  ``pending()``-> paths seen but not yet admissible (for drain logic)
  ``name``     -> telemetry label ('folder:<dir>' / 'socket:<ep>')

The WATCH-FOLDER source admits a file only when (a) a ``<name>.done``
completion sentinel sits next to it, or (b) its (size, mtime) signature
has been unchanged for config.ingest_stable_ms.  Size-stability is a
heuristic (a stalled writer looks stable), which is why the driver also
runs the io.fitsio.scan_fits truncation probe before loading.

The SOCKET source is push-style: peers announce host-visible archive
paths over serve/transport.py's length-prefixed JSON framing (the JAX
package's wire, frame for frame, so a JAX ``announce`` reaches a port
SocketSource and the reverse).  An announcement declares completeness,
but announced files still pass the driver's truncation probe.
"""

import fnmatch
import os
import socket
import threading
import time

from .. import config
from ..serve.transport import TransportError, _recv_frame, _send_frame

__all__ = ["WatchFolderSource", "SocketSource", "announce"]


class WatchFolderSource:
    """Poll a directory for complete archives.

    folder:    directory to watch (must exist).
    patterns:  fnmatch patterns for candidate files (default
               ('*.fits',)); sentinel files are never candidates.
    poll_ms:   advisory poll cadence for the driver's idle sleep
               (default config.ingest_poll_ms) — poll() itself is
               cheap and stateless about time.
    stable_ms: size-stability window (default config.ingest_stable_ms).
    sentinel_suffix: completion-sentinel suffix ('.done'): the writer
               creates '<archive>.done' to bypass the stability wait.
    """

    def __init__(self, folder, patterns=("*.fits",), poll_ms=None,
                 stable_ms=None, sentinel_suffix=".done"):
        if not os.path.isdir(folder):
            raise ValueError(
                f"WatchFolderSource: {folder!r} is not a directory")
        self.folder = os.path.abspath(folder)
        self.patterns = tuple(patterns)
        self.poll_ms = (config.ingest_poll_ms if poll_ms is None
                        else float(poll_ms))
        self.stable_ms = (config.ingest_stable_ms if stable_ms is None
                          else float(stable_ms))
        self.sentinel_suffix = str(sentinel_suffix)
        self.name = f"folder:{self.folder}"
        # path -> {'sig': (size, mtime), 'first': t, 'changed': t}
        self._watch = {}
        self._admitted = set()

    def _candidates(self):
        for entry in sorted(os.listdir(self.folder)):
            if entry.endswith(self.sentinel_suffix):
                continue
            if any(fnmatch.fnmatch(entry, p) for p in self.patterns):
                yield os.path.join(self.folder, entry)

    def poll(self):
        """One admission pass -> list of (path, wait_s), in stable
        name order (deterministic for a fixed corpus)."""
        now = time.monotonic()
        out = []
        for path in self._candidates():
            if path in self._admitted:
                continue
            try:
                st = os.stat(path)
            except OSError:
                continue  # vanished between listdir and stat
            sig = (st.st_size, st.st_mtime)
            ent = self._watch.get(path)
            if ent is None or ent["sig"] != sig:
                first = ent["first"] if ent else now
                self._watch[path] = {"sig": sig, "first": first,
                                     "changed": now}
                ent = self._watch[path]
                # a changed file is by definition not stable yet; only
                # the explicit sentinel overrides
                if not os.path.exists(path + self.sentinel_suffix):
                    continue
            stable = (now - ent["changed"]) * 1e3 >= self.stable_ms
            if stable or os.path.exists(path + self.sentinel_suffix):
                self._admitted.add(path)
                self._watch.pop(path, None)
                out.append((path, now - ent["first"]))
        return out

    def defer(self, path):
        """Put an admitted path back for a later retry: its stability
        clock restarts, so it re-admits only after staying unchanged
        for another stable_ms (or via its sentinel)."""
        now = time.monotonic()
        self._admitted.discard(path)
        try:
            st = os.stat(path)
            sig = (st.st_size, st.st_mtime)
        except OSError:
            sig = None
        # keep the original discovery time so wait_s stays honest
        first = self._watch.get(path, {}).get("first", now)
        self._watch[path] = {"sig": sig, "first": first, "changed": now}

    def pending(self):
        return sorted(self._watch)


class SocketSource:
    """Accept archive-path announcements over the serve wire framing.

    Frames (4-byte BE length + JSON, zlib marker bit honored):
      {"op": "ingest", "datafiles": [path, ...]} -> {"ok": true, "n": n}
      {"op": "stat"} -> {"ok": true, "pending": n}
      anything else -> {"ok": false, "error": msg}
    Use as a context manager or call start()/stop(); ``endpoint`` is
    the bound (host, port) — port 0 binds ephemeral.
    """

    def __init__(self, listen="127.0.0.1:0"):
        host, port = config.parse_hostport(listen)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.endpoint = self._sock.getsockname()
        self.name = f"socket:{self.endpoint[0]}:{self.endpoint[1]}"
        self._lock = threading.Lock()
        self._queue = []       # (path, t_announced)
        self._deferred = []
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="ppt-ingest-socket")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            # connect to unblock accept()
            with socket.create_connection(self.endpoint, timeout=1.0):
                pass
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._sock.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                break
            if self._stop.is_set():
                conn.close()
                break
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        with conn:
            conn.settimeout(30.0)
            while True:
                try:
                    msg = _recv_frame(conn)
                except (TransportError, OSError):
                    return
                op = msg.get("op")
                if op == "ingest":
                    files = [str(f) for f in msg.get("datafiles", [])]
                    now = time.monotonic()
                    with self._lock:
                        self._queue.extend((f, now) for f in files)
                    _send_frame(conn, {"ok": True, "n": len(files)})
                elif op == "stat":
                    with self._lock:
                        n = len(self._queue) + len(self._deferred)
                    _send_frame(conn, {"ok": True, "pending": n})
                else:
                    _send_frame(conn, {"ok": False,
                                       "error": f"unknown op {op!r}"})
                    return

    def poll(self):
        now = time.monotonic()
        with self._lock:
            out = [(p, now - t) for p, t in self._queue]
            out += [(p, now - t) for p, t in self._deferred]
            self._queue = []
            self._deferred = []
        return out

    def defer(self, path):
        # no stability clock to restart: the announcer declared the
        # file complete, so a deferral (truncation / backpressure)
        # just re-queues it for the next poll
        with self._lock:
            self._deferred.append((path, time.monotonic()))

    def pending(self):
        with self._lock:
            return sorted(p for p, _ in self._queue + self._deferred)


def announce(endpoint, datafiles):
    """Client helper: announce host-visible archive paths to a
    SocketSource at 'host:port' (or a (host, port) tuple).  Returns
    the acknowledged count; raises TransportError on a refused or
    misbehaving peer."""
    if isinstance(endpoint, str):
        endpoint = config.parse_hostport(endpoint)
    files = ([datafiles] if isinstance(datafiles, str)
             else [str(f) for f in datafiles])
    try:
        with socket.create_connection(tuple(endpoint),
                                      timeout=10.0) as sock:
            _send_frame(sock, {"op": "ingest", "datafiles": files})
            reply = _recv_frame(sock)
    except OSError as e:
        raise TransportError(f"announce to {endpoint}: {e}")
    if not reply.get("ok"):
        raise TransportError(
            f"announce to {endpoint} refused: {reply.get('error')}")
    return int(reply.get("n", len(files)))
