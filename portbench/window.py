"""The timed path: the port's stream executor in service mode, fed the
pool's archives already loaded, in a fixed order, as
``serve/server.ToaServer._admit_request`` feeds it.

Archives are admitted in groups that fill whole buckets of the program's
default ``nsub_batch``, so every dispatch has the shape that set-up warmed.
With ``spans`` the harness's calls into each layer are wrapped in
``torch.profiler.record_function`` (admit, drain; and the lane's prepare,
launch, scatter and assemble, the copy stage, the fit stage and B1's entry),
so that the trace can say what the host was doing in every idle gap.
"""

import contextlib
import inspect
import threading
import time

import numpy as np
import torch

SPAN = "portbench."


class Spans:
    """The harness's spans: each is kept as (name, start, end) on the
    host's monotonic clock, from whichever thread it ran on, and is also
    a ``record_function`` range, so the main thread's spans tie that
    clock to the profiler's timeline."""

    def __init__(self):
        self.done = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(SPAN + name):
                yield
        finally:
            with self._lock:
                self.done.append((name, t0, time.perf_counter()))

    def wrap(self, fn, name):
        def wrapped(*a, **kw):
            with self(name):
                return fn(*a, **kw)
        return wrapped


class _SpannedLane:
    """A lane whose hooks run inside spans named after them."""

    def __init__(self, lane, spans):
        self._lane = lane
        for hook in ("prepare", "launch", "scatter", "assemble"):
            setattr(self, hook, spans.wrap(getattr(lane, hook), hook))

    def __getattr__(self, name):
        return getattr(self._lane, name)


@contextlib.contextmanager
def b1_calls_recorded(calls, spans):
    """Record every call of B1's entry (ops.fused.fused_cross_spectrum)
    with the shapes that fix its work, inside a span: (rows, nchan, nbin,
    K, itemsize, want_m2, shared template)."""
    from pulseportraiture_tpu_torch.ops import fused

    orig = fused.fused_cross_spectrum

    def rec(port, model, w, nharm, *a, **kw):
        nchan, nbin = port.shape[-2], port.shape[-1]
        calls.append(dict(
            nb=port.numel() // (nchan * nbin), nchan=int(nchan),
            nbin=int(nbin), K=int(nharm), itemsize=port.element_size(),
            want_m2=bool(kw.get("want_m2", False)),
            shared=tuple(model.shape) == (nchan, nbin)))
        with spans("b1"):
            return orig(port, model, w, nharm, *a, **kw)

    fused.fused_cross_spectrum = rec
    try:
        yield calls
    finally:
        fused.fused_cross_spectrum = orig


def default_nsub_batch():
    """The program's default bucket size (make_wideband_lane's)."""
    from pulseportraiture_tpu_torch.pipeline.stream import make_wideband_lane

    return inspect.signature(make_wideband_lane).parameters[
        "nsub_batch"].default


class Campaign:
    """One executor and one lane over a loaded pool.

    ``results`` gathers, per admitted archive, the TOAs it returned:
    (pool index, subint, MJD day, MJD fraction, frequency, TOA error
    [us], DM, DM error and the scattering flags)."""

    FIELDS = ("isub", "day", "frac", "freq", "toa_err_us", "dm", "dm_err",
              "tau_us", "tau_freq", "tau_err_log10", "alpha", "alpha_err")

    def __init__(self, pool, lane, loaded, device, nsub_batch, tracer=None,
                 spans=False):
        from pulseportraiture_tpu_torch.pipeline.stream import (
            _StreamExecutor)

        self.pool = pool
        self.loaded = loaded
        self.spans = Spans() if spans else None
        self.lane = _SpannedLane(lane, self.spans) if spans else lane
        self.nsub_batch = int(nsub_batch)
        if (self.nsub_batch % pool.nsub
                or pool.narchive % (self.nsub_batch // pool.nsub)):
            raise ValueError(
                f"{pool.narchive} archives of {pool.nsub} subints do not "
                f"fill whole buckets of {self.nsub_batch}")
        self.group = self.nsub_batch // pool.nsub
        self.ex = _StreamExecutor(
            None, [], None, self.nsub_batch, prefetch=False, quiet=True,
            stream_devices=[device], tracer=tracer, service=True)
        self.ex.on_archive_done = self._done
        if spans:
            for pl in self.ex.pipelines:
                pl._run_copy = self.spans.wrap(pl._run_copy, "copy")
                pl._run_fit = self.spans.wrap(pl._run_fit, "fit")
                pl.put = self.spans.wrap(pl.put, "copy.put")
        self._ia = 0
        self._pool_of = {}
        self.results = []
        self.admitted_toas = 0

    def _done(self, ia, m, out):
        a = self._pool_of.pop(ia)
        rows = []
        for t in out[0]:
            fl = t.flags
            rows.append((fl["subint"], t.MJD.day, t.MJD.frac, t.frequency,
                         t.TOA_error, t.DM, t.DM_error,
                         fl.get("scat_time", np.nan),
                         fl.get("scat_ref_freq", np.nan),
                         fl.get("log10_scat_time_err", np.nan),
                         fl.get("scat_ind", np.nan),
                         fl.get("scat_ind_err", np.nan)))
        self.results.append((a, np.asarray(rows, np.float64).reshape(
            -1, len(self.FIELDS))))
        self.ex.forget(ia)

    def _admit(self, a):
        f, d = self.loaded[a]
        ok = np.asarray(d.ok_isubs, int)
        ia = self._ia
        self._ia += 1
        self._pool_of[ia] = a
        self.admitted_toas += len(ok)
        with self._span("admit"):
            self.ex.admit(ia, f, d, ok, lane=self.lane)

    def _span(self, name):
        return contextlib.nullcontext() if self.spans is None \
            else self.spans(name)

    def run(self, seconds=None, passes=None):
        """Admit the pool, group after group in a fixed order, until
        ``seconds`` have passed or ``passes`` passes were admitted; then
        drain.  Returns the seconds from the first admission to the last
        TOA on the host."""
        ngroups = self.pool.narchive // self.group
        t0 = time.perf_counter()
        i = 0
        while True:
            if passes is not None and i >= passes * ngroups:
                break
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            g = i % ngroups
            for a in range(g * self.group, (g + 1) * self.group):
                self._admit(a)
            with self._span("drain"):
                self.ex._drain_ready()
            i += 1
        with self._span("drain"):
            self.ex.flush_all()
            self.ex.drain_all()
        return time.perf_counter() - t0

    def close(self):
        self.ex._shutdown(wait=True)

    def returned_toas(self):
        return sum(len(r) for _, r in self.results)

    def stacked(self):
        """(pool index per admission, (n_admissions, nsub, field) array
        with NaN where a TOA is missing)."""
        ns = self.pool.nsub
        arr = np.full((len(self.results), ns, len(self.FIELDS)), np.nan)
        idx = np.empty(len(self.results), int)
        for i, (a, rows) in enumerate(self.results):
            idx[i] = a
            for r in rows:
                j = int(r[0])
                if 0 <= j < ns:
                    arr[i, j] = r
        return idx, arr
