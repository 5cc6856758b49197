"""Content-addressed result cache (counterpart of
pulseportraiture_tpu/serve/cache.py).

A TOA measurement is a pure function of (archives, template, options),
and the codec writes a request's ``.tim`` byte-exactly
(:func:`~.codec.write_tim_result` / :func:`~.codec.read_tim_result`),
so a hit is byte-identical to a fresh fit by construction:

- **Key**: SHA-256 over each archive's and the template's absolute
  path and bytes, the frozen fit-option snapshot (the form the
  server's lane cache keys on) and the numeric config knobs that can
  alter output bytes (:data:`NUMERIC_CONFIG_KEYS`).  The key equals
  the JAX package's for the same files, options and knob values, so
  one cache directory means the same thing to both packages.
- **Value**: the request's ``.tim``, written atomically; a hit is an
  atomic byte copy of the stored entry.
- **Store**: a bounded on-disk LRU under ``config.cache_dir`` sized by
  ``config.cache_max_mb``.  A torn entry (a ``.tim`` missing a
  completion sentinel) is a miss and is deleted.
- **Wiring**: the server checks at ``submit`` and populates when a
  clean fit completes; a hit is recorded on the tenant's ledger
  (``AdmissionQueue.record_hit``) but never billed against its quota.

``config.result_cache`` is off / 'auto' / on (``PPT_RESULT_CACHE``,
``ppserve --result-cache``); 'auto', the default, engages only when
``config.cache_dir`` is set.  The same store keeps the template
factory's built ``.gmodel``/``.spl`` files as opaque blobs
(:meth:`ResultCache.get_blob` / :meth:`~ResultCache.put_blob`,
``ppfactory --result-cache``) in the JAX package's blob format, so a
blob either package stored reads back in the other.
"""

import hashlib
import os
import threading

import numpy as np

from ..telemetry import NULL_TRACER
from . import codec

__all__ = ["ResultCache", "content_key", "resolve_result_cache",
           "NUMERIC_CONFIG_KEYS"]

# Config knobs that can (or are gated never to, but conservatively
# might) alter the bytes of a fitted .tim: device/fusion tri-states,
# precision selections, and the quality-loop thresholds.  They join
# the content key so flipping any of them invalidates instead of
# serving bytes fitted under a different numeric regime.  Serving /
# transport / telemetry knobs are deliberately absent — they cannot
# change result bytes, and keying on them would only shed hits.
NUMERIC_CONFIG_KEYS = (
    "dft_precision", "cross_spectrum_dtype", "dft_fold",
    "use_fast_fit", "use_matmul_dft", "fit_harmonic_window",
    "harmonic_window_tail", "scatter_compensated", "fit_fused",
    "fit_pallas", "fused_block", "lm_jacobian", "raw_subbyte",
    "bucket_pad", "zap_nstd", "quality_refit", "quality_max_gof",
    "quality_min_snr",
)

# Blob entries (template-factory artifacts) carry their own torn-entry
# detection: a fixed magic and an explicit payload length, verified on
# read, so a truncated file is a miss, never half an artifact.
_BLOB_MAGIC = b"PPTBLOB1\n"

# Knobs of the JAX package with no counterpart in the port (its Pallas
# mode and its matmul-DFT selection): they enter the key at the JAX
# package's defaults, so both packages key the same inputs alike.
_JAX_ONLY_KNOBS = {"use_matmul_dft": "auto", "fit_pallas": "auto"}


def _freeze(v):
    """Hashable canonical form of an option value (lists/dicts arrive
    from JSON request specs) — the same form the server's lane cache
    keys on, shared here so the content key and the lane key can never
    disagree about what an 'option change' is."""
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, np.ndarray):
        return (v.shape, v.tobytes())
    return v


def content_key(files, options):
    """SHA-256 hex digest over the CONTENT of a request: each file's
    absolute path and full bytes (archives + template/model), the
    frozen option snapshot, and the byte-relevant config knobs.
    Raises OSError if any input file is unreadable — callers fall back
    to the fit path, which reports the real error."""
    from .. import config

    h = hashlib.sha256()
    for path in files:
        p = os.path.abspath(str(path))
        h.update(b"\x00file\x00" + p.encode("utf-8", "surrogateescape"))
        with open(p, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
    frozen = tuple(sorted(
        (str(k), _freeze(v)) for k, v in dict(options or {}).items()))
    h.update(b"\x00options\x00" + repr(frozen).encode())
    knobs = tuple((k, getattr(config, k, _JAX_ONLY_KNOBS.get(k)))
                  for k in NUMERIC_CONFIG_KEYS)
    h.update(b"\x00config\x00" + repr(knobs).encode())
    return h.hexdigest()


class ResultCache:
    """Bounded on-disk LRU of content-addressed ``.tim`` results.

    One directory, flat layout: ``<key>.tim`` for TOA results and
    ``<key>.blob`` for factory artifacts.  Writes are atomic
    (temp-then-``os.replace``); recency is tracked in-process and
    mirrored to file mtimes so a re-opened cache resumes an
    approximate LRU order.  All methods are thread-safe.
    """

    def __init__(self, cache_dir, max_mb=None, tracer=None):
        from .. import config

        self.dir = os.path.abspath(str(cache_dir))
        os.makedirs(self.dir, exist_ok=True)
        self.max_bytes = int(
            float(config.cache_max_mb if max_mb is None else max_mb)
            * 1e6)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._lock = threading.Lock()
        # fname -> size, in LRU order (oldest first); seeded from the
        # directory so a restarted process inherits the prior store
        self._entries = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes_served = 0
        self.bytes_stored = 0
        try:
            found = []
            for fn in os.listdir(self.dir):
                if not fn.endswith((".tim", ".blob")):
                    continue
                fp = os.path.join(self.dir, fn)
                try:
                    st = os.stat(fp)
                except OSError:
                    continue
                found.append((st.st_mtime, fn, st.st_size))
            for _, fn, size in sorted(found):
                self._entries[fn] = size
        except OSError:
            pass

    # ------------------------------------------------------------------
    # internals (call with self._lock held unless noted)
    # ------------------------------------------------------------------

    def _path(self, fname):
        return os.path.join(self.dir, fname)

    def _touch(self, fname):
        """Refresh LRU recency: reinsert at the back, mirror to mtime
        (best-effort) so a future process sees the same order."""
        size = self._entries.pop(fname, None)
        if size is None:
            try:
                size = os.path.getsize(self._path(fname))
            except OSError:
                return
        self._entries[fname] = size
        try:
            os.utime(self._path(fname))
        except OSError:
            pass

    def _drop(self, fname, evict=False):
        size = self._entries.pop(fname, 0)
        try:
            os.unlink(self._path(fname))
        except OSError:
            pass
        if evict:
            self.evictions += 1
            if self.tracer.enabled:
                self.tracer.emit("cache_evict", key=fname, bytes=size)
                self.tracer.counter("cache_evict")

    def _account(self, fname, size):
        """Register a freshly stored entry and evict least-recently-used
        entries until the store fits ``max_bytes`` again."""
        self._entries.pop(fname, None)
        self._entries[fname] = size
        self.bytes_stored += size
        if size > self.max_bytes:
            # the entry ALONE can never fit: refuse it up front —
            # evicting the whole store to then drop it anyway would
            # trade every cached result for nothing
            self._drop(fname, evict=True)
            return
        total = sum(self._entries.values())
        while total > self.max_bytes and len(self._entries) > 1:
            oldest = next(iter(self._entries))
            if oldest == fname:  # never evict the entry just stored
                break
            total -= self._entries.get(oldest, 0)
            self._drop(oldest, evict=True)

    # ------------------------------------------------------------------
    # .tim results
    # ------------------------------------------------------------------

    def get_result(self, key, datafiles):
        """Look up a ``.tim`` result.  Returns ``(result, entry_path,
        n_bytes)`` on a hit — ``result`` is the recovered
        :class:`~..utils.bunch.DataBunch` (``recovered_from_tim`` shape:
        summary stats are not re-derived) and ``entry_path`` the stored
        file whose bytes ARE the fresh-fit bytes — or None on a miss.
        A torn entry (missing completion sentinels for any of
        ``datafiles``, or an unparseable tail) counts as a miss and is
        deleted."""
        fname = f"{key}.tim"
        path = self._path(fname)
        with self._lock:
            known = fname in self._entries or os.path.exists(path)
            if not known:
                self.misses += 1
                return None
            try:
                if not codec.tim_complete(path, datafiles):
                    raise ValueError("incomplete sentinel set")
                result = codec.read_tim_result(path)
                n_bytes = os.path.getsize(path)
            except (OSError, ValueError):
                # torn / truncated / foreign entry: a miss, never a
                # crash — and drop it so it cannot mislead again
                self._drop(fname)
                self.misses += 1
                return None
            self._touch(fname)
            self.hits += 1
            self.bytes_served += n_bytes
            return result, path, n_bytes

    def put_result(self, key, result):
        """Store a completed request's ``.tim`` payload.  Returns the
        stored byte count, or None when the result cannot be cached
        (skipped archives, ambiguous demux, write failure) — callers
        treat None as 'not cached', never an error."""
        if getattr(result, "n_skipped", 0):
            return None  # partial results write fewer sentinels
        if getattr(result, "recovered_from_tim", False):
            return None  # only cache fresh in-memory fits
        fname = f"{key}.tim"
        path = self._path(fname)
        try:
            codec.write_tim_result(result, path)  # atomic tmp+replace
            size = os.path.getsize(path)
        except (OSError, ValueError):
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        with self._lock:
            self._account(fname, size)
            if fname not in self._entries:  # evicted as oversize
                return None
        return size


    # ------------------------------------------------------------------
    # opaque blobs (template-factory artifacts)
    # ------------------------------------------------------------------

    def get_blob(self, key):
        """Look up an artifact blob: its bytes on a hit, None on a miss.
        A bad header or a length mismatch (a torn entry) is a miss and
        deletes the entry."""
        fname = f"{key}.blob"
        path = self._path(fname)
        with self._lock:
            if fname not in self._entries and not os.path.exists(path):
                self.misses += 1
                return None
            try:
                with open(path, "rb") as fh:
                    magic = fh.read(len(_BLOB_MAGIC))
                    header = fh.read(16)
                    payload = fh.read()
                if magic != _BLOB_MAGIC or len(header) != 16:
                    raise ValueError("bad blob header")
                if int(header.decode(), 16) != len(payload):
                    raise ValueError("torn blob")
            except (OSError, ValueError):
                self._drop(fname)
                self.misses += 1
                return None
            self._touch(fname)
            self.hits += 1
            self.bytes_served += len(payload)
            return payload

    def put_blob(self, key, data):
        """Store an artifact blob atomically; returns the stored byte
        count (None on failure, or when the blob alone exceeds the
        bound)."""
        data = bytes(data)
        fname = f"{key}.blob"
        path = self._path(fname)
        tmp = path + ".tmp~"
        try:
            with open(tmp, "wb") as fh:
                fh.write(_BLOB_MAGIC)
                fh.write(f"{len(data):016x}".encode())
                fh.write(data)
            os.replace(tmp, path)
            size = os.path.getsize(path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        with self._lock:
            self._account(fname, size)
            if fname not in self._entries:
                return None
        return size


def resolve_result_cache(tracer=None, cache_dir=None, mode=None,
                         max_mb=None):
    """Resolve the tri-state ``config.result_cache`` knob into a
    :class:`ResultCache` or None (cache off).

    - ``False`` / ``'off'`` — None;
    - ``'auto'`` (the default) — a cache iff ``config.cache_dir`` is
      set, so the cache is OFF out of the box;
    - ``True`` / ``'on'`` — a cache; raises ValueError LOUDLY when no
      cache directory is configured (an explicitly-on cache silently
      doing nothing would be a lie).

    ``cache_dir`` / ``mode`` / ``max_mb`` override the config globals
    (used by per-instance server and router arguments and tests).
    """
    from .. import config

    mode = config.result_cache if mode is None else mode
    cache_dir = config.cache_dir if cache_dir is None else cache_dir
    if isinstance(mode, str):
        mode = mode.lower()
    table = {False: False, "off": False, "false": False, "0": False,
             True: True, "on": True, "true": True, "1": True,
             "auto": "auto", None: False}
    if mode not in table:
        raise ValueError(
            f"config.result_cache={mode!r}: expected off|auto|on "
            "(False | 'auto' | True)")
    mode = table[mode]
    if mode is False:
        return None
    if mode == "auto" and not cache_dir:
        return None
    if not cache_dir:
        raise ValueError(
            "config.result_cache='on' requires config.cache_dir "
            "(PPT_CACHE_DIR / --cache-dir): an explicitly-on cache "
            "with nowhere to store entries would silently serve "
            "nothing")
    return ResultCache(cache_dir, max_mb=max_mb, tracer=tracer)
