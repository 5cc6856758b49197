"""Streaming metrics: thread-safe counters/gauges and fixed log-bucket
latency histograms (counterpart of pulseportraiture_tpu/obs/metrics.py).

A histogram keeps no samples, one count per bucket, so observing a
latency is a bisect plus an increment and the memory is constant however
long the server runs.  The bucket bounds are a module constant shared
with the JAX package, so exports of several processes merge by a
bucket-wise sum (:func:`merge_exports`).

Quantiles come from the cumulative bucket counts; with 8 buckets per
decade the worst-case relative error of a reported quantile is
10**(1/8) - 1 ~= 33%, enough for p50/p90/p99 and burn-rate alerting
(the exact latencies land in the JSONL trace).
"""

import bisect
import threading

# Fixed log-spaced bucket upper bounds, 8 per decade from 100 us to
# 1e4 s (65 finite bounds + one overflow bucket).  Shared by every
# exporter: changing these invalidates merging, so treat them as a
# wire-format constant.
_BUCKETS_PER_DECADE = 8
_DECADES = 8
HIST_BOUNDS = tuple(
    1e-4 * 10.0 ** (i / _BUCKETS_PER_DECADE)
    for i in range(_BUCKETS_PER_DECADE * _DECADES + 1))


class LatencyHistogram:
    """Fixed-bucket latency histogram; thread-safe, no sample
    retention."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * (len(HIST_BOUNDS) + 1)
        self._count = 0
        self._sum = 0.0

    def observe(self, value):
        i = bisect.bisect_left(HIST_BOUNDS, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value

    def export(self):
        with self._lock:
            return {"count": self._count, "sum": round(self._sum, 6),
                    "counts": list(self._counts)}


def quantile_from_export(hist, q):
    """Estimate the q-quantile (0 < q <= 1) from an exported histogram
    dict; returns None on an empty histogram.  The estimate is the
    geometric midpoint of the bucket holding the q-th sample."""
    total = hist.get("count", 0)
    if not total:
        return None
    counts = hist["counts"]
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            if i == 0:
                return HIST_BOUNDS[0]
            if i >= len(HIST_BOUNDS):
                return HIST_BOUNDS[-1]
            return (HIST_BOUNDS[i - 1] * HIST_BOUNDS[i]) ** 0.5
    return HIST_BOUNDS[-1]


def merge_exports(exports):
    """Merge a list of MetricsRegistry exports (bucket-wise histogram
    sum, counter sum; gauges are dropped — they are per-host facts)."""
    counters = {}
    hists = {}
    for ex in exports:
        if not ex:
            continue
        for k, v in (ex.get("counters") or {}).items():
            counters[k] = counters.get(k, 0) + v
        for name, h in (ex.get("histograms") or {}).items():
            m = hists.get(name)
            if m is None:
                hists[name] = {"count": h["count"], "sum": h["sum"],
                               "counts": list(h["counts"])}
            else:
                m["count"] += h["count"]
                m["sum"] = round(m["sum"] + h["sum"], 6)
                # zip stops at the shorter list, so a peer running a
                # different bound table can under-merge: refuse loudly
                if len(m["counts"]) != len(h["counts"]):
                    raise ValueError(
                        f"histogram '{name}' bucket-count mismatch "
                        f"({len(m['counts'])} vs {len(h['counts'])}): "
                        "the exporters disagree on HIST_BOUNDS")
                m["counts"] = [a + b
                               for a, b in zip(m["counts"], h["counts"])]
    return {"counters": counters, "gauges": {}, "histograms": hists}


class MetricsRegistry:
    """Thread-safe named counters, gauges, and latency histograms.

    One lock covers the name tables; each histogram carries its own
    lock so concurrent observes on different names never serialize on
    the registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}

    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name, value):
        with self._lock:
            self._gauges[name] = value

    def observe(self, name, value):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
        h.observe(value)

    def counter(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    def quantile(self, name, q):
        with self._lock:
            h = self._hists.get(name)
        return quantile_from_export(h.export(), q) if h else None

    def export(self):
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.export() for k, h in hists.items()}}


# Process-global registry for hot paths that have no handle on a
# server (the h2d copy workers live in the stream's transfer pipeline).
# ToaServer.metrics() folds these in so the link numbers ride the same
# export.
_GLOBAL = MetricsRegistry()


def global_registry():
    return _GLOBAL


def record_h2d(nbytes, h2d_s, overlap):
    """Account one host->device copy: total copy seconds vs copy
    seconds NOT hidden behind an in-flight fit (the live link-stall
    signal; the post-hoc equivalent is pptrace's h2d section)."""
    _GLOBAL.inc("h2d_copies")
    _GLOBAL.inc("h2d_bytes", int(nbytes))
    _GLOBAL.inc("h2d_us", int(h2d_s * 1e6))
    if not overlap:
        _GLOBAL.inc("h2d_stall_us", int(h2d_s * 1e6))


def link_stall_frac(export):
    """Fraction of copy seconds not hidden behind compute, from an
    export's counters; None before any copy has been accounted."""
    c = export.get("counters") or {}
    total = c.get("h2d_us", 0)
    if not total:
        return None
    return round(c.get("h2d_stall_us", 0) / total, 4)
