"""The remote transport of the TOA service: the ToaClient surface over a
wire (counterpart of pulseportraiture_tpu/serve/transport.py).

A warm ``ToaServer`` is the unit a campaign scales out by: archives are
embarrassingly parallel, so a fleet routes requests across servers
instead of sharding one fit.  This module puts the in-process client
surface (submit / result / stat / metrics / drain) behind a
length-prefixed JSON-over-socket protocol, so a router
(serve/router.ToaRouter) can own servers that live in other processes.

- **No bulk data on the wire.**  Requests name archive paths the host
  can read (a shared filesystem), and each request's ``.tim`` is written
  by the serving host through its own demux, byte-identical to the
  one-shot stream whichever host served it.  Only the request spec and
  the per-TOA result records cross the socket (the codec lane,
  ``ToaRouter(write_tim='router')``, writes the ``.tim`` at the router
  from those records instead).
- **Backpressure crosses the wire intact.**  A remote ``ServeRejected``
  arrives with its ``retryable`` flag, so the router's retry policy does
  not care whether a host is local or remote.
- **One protocol, two transports.**  ``InProcTransport`` wraps a server
  of this process through the same result codec as the socket lane.

The wire is the JAX package's, frame for frame, so either package's
router drives either package's ``TransportServer``.  Every frame is a
4-byte big-endian length and a UTF-8 JSON object; a set top bit in the
length marks a zlib-compressed body (``config.transport_compress``).
Ops:

  {"op": "submit", "datafiles": [...], "modelfile": m,
   "tim_out": p|null, "name": n|null, "tenant": t|null,
   "trace_id": id|null, "options": {...}}
      -> {"ok": true, "handle": k}
      -> {"ok": false, "error": msg, "rejected": true,
          "retryable": bool}                 (ServeRejected)
      -> {"ok": false, "error": msg, "etype": "TypeError"}
  {"op": "result", "handle": k, "wait": seconds}
      -> {"ok": true, "done": false}        (poll again)
      -> {"ok": true, "done": true, "result": {...}}
      -> {"ok": false, "error": msg, "etype": "TypeError"}
  {"op": "stat"}
      -> {"ok": true, "pending_archives": n, "queue_len": n,
          "n_live": n, "cache_hits": n, "cache_bytes": n,
          "toas_per_s": x|null, "capability": {...}}
  {"op": "metrics"}
      -> {"ok": true, ...ToaServer.metrics()...}
  {"op": "drain", "timeout": seconds}
      -> {"ok": true, "n_done": n, "pending": n}

``result`` is a poll (the server blocks at most ``wait`` seconds per
frame), so one connection interleaves submits with requests in flight.
"""

import json
import socket
import struct
import threading
import time
import zlib

from ..telemetry import log
from .codec import decode_result, encode_result, roundtrip_result
from .queue import ServeRejected

__all__ = ["TransportError", "RemoteRequestError", "InProcTransport",
           "SocketTransport", "TransportServer", "KillableTransport",
           "parse_hostport", "encode_result", "decode_result"]

# A frame above this is a protocol violation, not a big request: the
# largest legitimate payload is a result frame (hundreds of bytes per
# TOA).
MAX_FRAME = 256 * 1024 * 1024
# The top bit of the length prefix (free, MAX_FRAME < 2**31) marks a
# zlib-compressed body; plain frames are the JAX package's exactly.
_FRAME_ZLIB = 0x80000000
# A frame smaller than this is never compressed: zlib costs more than the
# link would save.
COMPRESS_MIN_FRAME = 64 * 1024
# 'auto' compresses only when zlib saves at least this fraction.
COMPRESS_MIN_SAVING = 0.125
# Per-poll server-side block of the result op; the client loops.
RESULT_POLL_S = 0.25
# Per-round-trip server-side block of the drain op, well below the
# client's socket timeout; the client loops until nothing is pending.
DRAIN_CHUNK_S = 5.0


class TransportError(ConnectionError):
    """The transport itself failed (connection refused or reset, a
    protocol violation), as distinct from a request's own failure.  The
    router reads it as 'this host is unreachable' and places elsewhere."""


class RemoteRequestError(RuntimeError):
    """A request failed ON THE SERVING HOST; ``etype`` names the original
    exception class (the object itself stayed remote)."""

    def __init__(self, msg, etype="Exception"):
        super().__init__(msg)
        self.etype = str(etype)


def parse_hostport(spec):
    """'host:port' -> (host, port); the strict parse lives in config
    (shared with the PPT_ROUTER_HOSTS / PPT_SERVE_LISTEN hooks)."""
    from ..config import parse_hostport as _parse

    return _parse(spec)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _send_frame(sock, obj):
    """Send one length-prefixed JSON frame, zlib-compressing the body
    when ``config.transport_compress`` allows and the frame is big enough
    ('auto': the size and saving rule above; True: whenever smaller;
    False: never).  The receiver keys on the length's top bit."""
    from ..io.blockcodec import resolve_transport_compress

    body = json.dumps(obj, separators=(",", ":")).encode()
    mode = resolve_transport_compress()
    if mode is not False and len(body) >= COMPRESS_MIN_FRAME:
        comp = zlib.compress(body, 1)
        saving = 1.0 - len(comp) / len(body)
        if (mode is True and len(comp) < len(body)) or \
                (mode == "auto" and saving >= COMPRESS_MIN_SAVING):
            sock.sendall(struct.pack(">I", len(comp) | _FRAME_ZLIB) + comp)
            return
    sock.sendall(struct.pack(">I", len(body)) + body)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed mid-frame")
        buf += chunk
    return buf


def _recv_frame(sock):
    head = _recv_exact(sock, 4)
    (n,) = struct.unpack(">I", head)
    compressed = bool(n & _FRAME_ZLIB)
    n &= ~_FRAME_ZLIB
    if n > MAX_FRAME:
        raise TransportError(f"frame of {n} bytes exceeds the "
                             f"{MAX_FRAME}-byte protocol limit")
    body = _recv_exact(sock, n)
    if compressed:
        # the bound holds during the inflate: a hostile frame can inflate
        # ~1000x, so a plain zlib.decompress would allocate first
        try:
            d = zlib.decompressobj()
            body = d.decompress(body, MAX_FRAME + 1)
        except zlib.error as e:
            raise TransportError(f"bad compressed frame: {e}")
        if len(body) > MAX_FRAME or d.unconsumed_tail:
            raise TransportError(
                f"compressed frame inflates past the {MAX_FRAME}-byte "
                "protocol limit")
    return json.loads(body.decode())


# ---------------------------------------------------------------------------
# transports (the client side the router holds)
# ---------------------------------------------------------------------------

class InProcTransport:
    """The ToaClient surface against a ToaServer in THIS process, through
    the same result codec as the socket lane."""

    def __init__(self, server, label=None):
        self.server = server
        self.label = str(label) if label is not None else \
            f"inproc:{id(server):x}"
        self._handles = []
        self._lock = threading.Lock()

    def submit(self, datafiles, modelfile, tim_out=None, name=None,
               options=None, tenant=None, trace_id=None):
        req = self.server.submit(datafiles, modelfile, tim_out=tim_out,
                                 name=name, tenant=tenant,
                                 trace_id=trace_id, **dict(options or {}))
        with self._lock:
            self._handles.append(req)
        return req

    def result(self, handle, timeout=None):
        try:
            res = handle.result(timeout)
        except TimeoutError:
            raise  # still outstanding: it stays in the drain set
        except Exception:
            self._evict(handle)
            raise
        self._evict(handle)
        # both transports return the same result shapes
        return roundtrip_result(res)

    def _evict(self, handle):
        # collect-once, like the socket lane's per-connection handle
        # table: a collected request must not pin its result
        with self._lock:
            try:
                self._handles.remove(handle)
            except ValueError:
                pass

    def stat(self):
        return self.server.stats()

    def metrics(self):
        return self.server.metrics()

    def drain(self, timeout=None):
        """Wait for the not-yet-collected requests submitted through this
        transport; returns how many resolved.  ``timeout`` is a total
        deadline (the socket lane's meaning)."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        with self._lock:
            handles = list(self._handles)
        n = 0
        for h in handles:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if h.wait(left):
                n += 1
        return n

    def close(self):
        pass


class KillableTransport:
    """Fault injection: delegates to ``inner`` until :meth:`kill`, after
    which every transport call raises TransportError, the router's
    host-unreachable signal (what a reset socket gives a real fleet)."""

    def __init__(self, inner):
        self.inner = inner
        self.label = inner.label
        self.killed = False

    def kill(self):
        self.killed = True

    def _check(self):
        if self.killed:
            raise TransportError(f"{self.label} killed")

    def submit(self, *a, **kw):
        self._check()
        return self.inner.submit(*a, **kw)

    def result(self, handle, timeout=None):
        self._check()
        return self.inner.result(handle, timeout)

    def stat(self):
        self._check()
        return self.inner.stat()

    def metrics(self):
        self._check()
        return self.inner.metrics()

    def __getattr__(self, name):
        return getattr(self.inner, name)


class SocketTransport:
    """The ToaClient surface against a ``ppserve --listen`` host.

    One TCP connection per transport; a lock serializes frames, so the
    router may call it from many threads.  ``result`` polls (bounded
    server-side waits), so a slow request never blocks the connection
    for sibling submits."""

    def __init__(self, address, timeout=30.0):
        self.host, self.port = parse_hostport(address)
        self.label = f"{self.host}:{self.port}"
        self._lock = threading.Lock()
        self._io_timeout = float(timeout)
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self._io_timeout)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            raise TransportError(
                f"cannot reach ppserve at {self.label}: {e}")

    def _call(self, msg):
        with self._lock:
            if self._sock is None:
                raise TransportError(
                    f"transport to {self.label} is closed (a prior I/O "
                    "failure poisoned the connection)")
            try:
                _send_frame(self._sock, msg)
                reply = _recv_frame(self._sock)
            except (TransportError, OSError, ValueError) as e:
                # the framing is now ambiguous (a late reply to THIS op
                # would read as the next op's): close, so every later op
                # fails loudly instead of desynchronizing
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                if isinstance(e, TransportError):
                    raise
                raise TransportError(
                    f"transport to {self.label} failed: {e}")
        if not isinstance(reply, dict):
            raise TransportError(
                f"malformed reply from {self.label}: {reply!r}")
        return reply

    def submit(self, datafiles, modelfile, tim_out=None, name=None,
               options=None, tenant=None, trace_id=None):
        reply = self._call({"op": "submit",
                            "datafiles": list(datafiles)
                            if not isinstance(datafiles, str)
                            else datafiles,
                            "modelfile": str(modelfile),
                            "tim_out": tim_out, "name": name,
                            "tenant": tenant, "trace_id": trace_id,
                            "options": dict(options or {})})
        if reply.get("ok"):
            return reply["handle"]
        if reply.get("rejected"):
            # the remote admission queue's backpressure, flag intact
            raise ServeRejected(reply.get("error", "rejected"),
                                retryable=bool(reply.get("retryable")))
        raise RemoteRequestError(reply.get("error", "submit failed"),
                                 etype=reply.get("etype", "Exception"))

    def result(self, handle, timeout=None):
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while True:
            wait = RESULT_POLL_S if deadline is None else \
                max(0.0, min(RESULT_POLL_S, deadline - time.monotonic()))
            reply = self._call({"op": "result", "handle": handle,
                                "wait": wait})
            if not reply.get("ok"):
                raise RemoteRequestError(
                    reply.get("error", "request failed"),
                    etype=reply.get("etype", "Exception"))
            if reply.get("done"):
                return decode_result(reply["result"])
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no result from {self.label} within {timeout} s")

    def stat(self):
        reply = self._call({"op": "stat"})
        if not reply.get("ok"):
            raise TransportError(
                f"stat on {self.label} failed: {reply.get('error')}")
        out = {k: reply[k] for k in ("pending_archives", "queue_len",
                                     "n_live")}
        # a host without the cache counters or the routing signals
        # reads as 0 / None, so placement degrades to least-loaded
        for k in ("cache_hits", "cache_bytes"):
            out[k] = reply.get(k, 0)
        for k in ("toas_per_s", "capability"):
            out[k] = reply.get(k)
        return out

    def metrics(self):
        """The live-metrics op.  A host without it replies unknown-op,
        raised as a TransportError naming the mismatch, so a fleet
        aggregator can fall back to ``stat`` for that host."""
        reply = self._call({"op": "metrics"})
        if not reply.get("ok"):
            raise TransportError(
                f"metrics on {self.label} failed (pre-obs host?): "
                f"{reply.get('error')}")
        return {k: v for k, v in reply.items() if k != "ok"}

    def drain(self, timeout=None):
        """Wait for this connection's outstanding requests.  The server
        bounds each reply and reports how many are still pending; the
        client loops until done or ``timeout`` (returns the resolved
        count either way)."""
        deadline = None if timeout is None \
            else time.monotonic() + float(timeout)
        while True:
            wait = DRAIN_CHUNK_S if deadline is None else \
                max(0.0, min(DRAIN_CHUNK_S, deadline - time.monotonic()))
            reply = self._call({"op": "drain", "timeout": wait})
            if not reply.get("ok"):
                raise TransportError(
                    f"drain on {self.label} failed: {reply.get('error')}")
            n_done = int(reply.get("n_done", 0))
            if not reply.get("pending") or (
                    deadline is not None and time.monotonic() >= deadline):
                return n_done

    def close(self):
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None


# ---------------------------------------------------------------------------
# the listener (``ppserve --listen`` wraps this around its ToaServer)
# ---------------------------------------------------------------------------

class TransportServer:
    """Accept loop exposing one local ToaServer (or a ToaRouter: pproute
    --monitor) to SocketTransports.

    One daemon thread per connection and a handle table per connection
    (a dropped client's requests still run to completion: their .tim
    files are the durable artifact).  A request's failure replies as an
    error on its handle; only protocol violations drop the connection.
    No thread here touches the device: the server's own thread does."""

    def __init__(self, server, host="127.0.0.1", port=0, quiet=True):
        self.server = server
        self.quiet = quiet
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self.label = f"{self.host}:{self.port}"
        self._closing = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ppt-listen", daemon=True)

    def start(self):
        self._accept_thread.start()
        log(f"ppserve: listening on {self.label}", quiet=self.quiet,
            tracer=None)
        return self

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return  # close() shut the listening socket
            threading.Thread(target=self._serve_conn, args=(conn, addr),
                             name="ppt-conn", daemon=True).start()

    def _serve_conn(self, conn, addr):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        handles = {}
        next_id = 0
        try:
            while True:
                try:
                    msg = _recv_frame(conn)
                except TransportError:
                    return  # the client went away (normal teardown)
                op = msg.get("op") if isinstance(msg, dict) else None
                if op == "submit":
                    try:
                        req = self.server.submit(
                            msg["datafiles"], msg["modelfile"],
                            tim_out=msg.get("tim_out"),
                            name=msg.get("name"),
                            tenant=msg.get("tenant"),
                            trace_id=msg.get("trace_id"),
                            **dict(msg.get("options") or {}))
                    except ServeRejected as e:
                        _send_frame(conn, {
                            "ok": False, "error": str(e),
                            "rejected": True,
                            "retryable": bool(e.retryable)})
                    except Exception as e:
                        _send_frame(conn, {
                            "ok": False, "error": str(e),
                            "etype": type(e).__name__})
                    else:
                        handles[next_id] = req
                        _send_frame(conn, {"ok": True, "handle": next_id})
                        next_id += 1
                elif op == "result":
                    req = handles.get(msg.get("handle"))
                    if req is None:
                        _send_frame(conn, {
                            "ok": False,
                            "error": f"unknown handle "
                                     f"{msg.get('handle')!r} on this "
                                     "connection (already collected, "
                                     "or never submitted here)",
                            "etype": "KeyError"})
                        continue
                    wait = min(max(float(msg.get("wait", 0.0)), 0.0),
                               30.0)
                    if not req.wait(wait):
                        _send_frame(conn, {"ok": True, "done": False})
                        continue
                    # collect-once: a long-lived connection stays
                    # O(outstanding), no result pinned after collection
                    del handles[msg["handle"]]
                    try:
                        res = req.result(0)
                    except Exception as e:
                        _send_frame(conn, {
                            "ok": False, "error": str(e),
                            "etype": type(e).__name__})
                    else:
                        _send_frame(conn, {"ok": True, "done": True,
                                           "result": encode_result(res)})
                elif op == "stat":
                    st = self.server.stats()
                    _send_frame(conn, {"ok": True, **st})
                elif op == "metrics":
                    try:
                        m = self.server.metrics()
                    except Exception as e:
                        _send_frame(conn, {
                            "ok": False, "error": str(e),
                            "etype": type(e).__name__})
                    else:
                        _send_frame(conn, {"ok": True, **m})
                elif op == "drain":
                    # bounded: the reply comes well under the client's
                    # socket timeout with the pending count; the client
                    # loops (SocketTransport.drain).  An explicit 0.0 is
                    # a non-blocking probe; only None takes the chunk.
                    t_req = msg.get("timeout")
                    budget = DRAIN_CHUNK_S if t_req is None else \
                        min(max(float(t_req), 0.0), DRAIN_CHUNK_S)
                    t_end = time.monotonic() + budget
                    pending = len(handles)
                    for req in list(handles.values()):
                        if req.wait(max(0.0, t_end - time.monotonic())):
                            pending -= 1
                    _send_frame(conn, {"ok": True,
                                       "n_done": len(handles) - pending,
                                       "pending": pending})
                else:
                    _send_frame(conn, {
                        "ok": False,
                        "error": f"unknown op {op!r} (protocol "
                                 "mismatch? known ops: submit, "
                                 "result, stat, metrics, drain)"})
        except OSError:
            pass  # the peer reset mid-reply
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        self._closing.set()
        # shutdown() wakes the thread blocked in accept(); a bare close()
        # leaves the listener alive behind the blocked call
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread.is_alive():
            self._accept_thread.join(1.0)

    def __enter__(self):
        if not self._accept_thread.is_alive():
            self.start()
        return self

    def __exit__(self, *exc):
        self.close()
        return False
