"""A thin in-process client of a :class:`~.server.ToaServer`
(counterpart of pulseportraiture_tpu/serve/client.py).

The server's ``submit`` is already thread-safe; this wrapper is the
blocking convenience most callers want, submit-and-wait with
stream_wideband_TOAs's return shape, plus a fan-out helper for scripted
multi-request clients.
"""

__all__ = ["ToaClient", "collect_results"]


def collect_results(handles, timeout=None, return_errors=False):
    """Collect every handle's result, in order, waiting on ALL of
    them before anything raises — one failed request must never
    strand its siblings mid-flight.  With ``return_errors=True`` a
    failed slot holds its exception object; otherwise the first
    failure re-raises after the full collection pass."""
    out = []
    for h in handles:
        try:
            out.append(h.result(timeout))
        except Exception as e:
            out.append(e)
    if not return_errors:
        for r in out:
            if isinstance(r, Exception):
                raise r
    return out


class ToaClient:
    """Blocking client: each call is one request against the shared
    warm server; concurrent callers coalesce into shared fused
    dispatches whenever they use the same template and options."""

    def __init__(self, server):
        self.server = server

    def submit(self, datafiles, modelfile, tim_out=None, name=None,
               **options):
        """Non-blocking: returns the ServeRequest handle (may raise
        ServeRejected — the backpressure signal)."""
        return self.server.submit(datafiles, modelfile,
                                  tim_out=tim_out, name=name,
                                  **options)

    def get_TOAs(self, datafiles, modelfile, timeout=None,
                 tim_out=None, name=None, **options):
        """Submit and wait: returns the per-request DataBunch
        (TOA_list, order, DM0s, DeltaDM_means/errs, tim_out), the same
        result shape as stream_wideband_TOAs."""
        return self.submit(datafiles, modelfile, tim_out=tim_out,
                           name=name, **options).result(timeout)

    def map(self, specs, timeout=None, return_errors=False):
        """Submit many requests, then wait for all: ``specs`` is a
        sequence of (datafiles, modelfile[, kwargs-dict]) tuples;
        returns the results in spec order.  Submission errors
        (ServeRejected) raise immediately — before any wait — so a
        load-shedding server is visible at the call site.

        A request that fails MID-BATCH (a bad option set, a broken
        archive) is isolated: every sibling handle is still collected
        before anything raises, so one failure never strands the rest
        of the batch mid-flight.  With ``return_errors=True`` the
        failed slot holds its exception object instead of raising —
        the fan-out caller decides per request."""
        handles = []
        for spec in specs:
            datafiles, modelfile = spec[0], spec[1]
            kwargs = dict(spec[2]) if len(spec) > 2 else {}
            handles.append(self.submit(datafiles, modelfile, **kwargs))
        return collect_results(handles, timeout, return_errors)
