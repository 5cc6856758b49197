"""The ingest driver: sources -> warm ToaServer -> ordered streaming
``.tim`` (counterpart of pulseportraiture_tpu/ingest/driver.py).

No new executor: every admitted archive becomes ONE single-archive
request into the port's serving loop (serve/server.ToaServer), whose
continuous-batching deadline (config.serve_max_wait_ms) already bounds a
trickle's latency: a lone arrival launches a partial bucket, padded to
nsub_batch rows on the device, once the deadline passes; bursts coalesce.
The driver's own jobs are the observatory-specific edges:

* ADMISSION SAFETY: every candidate passes io.fitsio.scan_fits before
  it touches the loaders.  A truncated file raises the typed
  ``TruncatedFits`` (retryable) and the driver DEFERS it back to its
  source (retry once stable again).
* BACKPRESSURE: a full admission queue raises
  ``ServeRejected(retryable=True)``; the driver defers the archive and
  re-admits it on a later poll.
* ORDERED DURABLE OUTPUT: results append to the streaming ``.tim``
  strictly IN ADMISSION ORDER, each archive's TOA lines followed by the
  one-shot driver's completion sentinel, so the streamed file is
  byte-identical to ``stream_wideband_TOAs`` over the finished corpus at
  the same nsub_batch.

The driver runs on the caller's thread and never touches the device:
only the server's owner thread does, and ``on_toas`` (ppwatch's
incremental GLS and alerts) computes on the host.

Telemetry: ``ingest_admit`` per admission (wait_s = discovery ->
admission), ``ingest_skip`` per deferral with the reason ('truncated' |
'backpressure' | 'error').
"""

import os
import time

from .. import config
from ..io.fitsio import TruncatedFits, scan_fits
from ..io.tim import toa_string, write_TOAs
from ..pipeline.stream import _DONE_PREFIX
from ..serve.queue import ServeRejected
from ..telemetry import NULL_TRACER, finite, log

__all__ = ["IngestDriver"]


class IngestDriver:
    """Pump archives from ingest sources through a warm ToaServer.

    server:    a STARTED serve.ToaServer (the driver never owns it).
    modelfile: the template every admitted archive fits against.
    sources:   iterable of WatchFolderSource / SocketSource.
    tim_out:   streaming .tim path (append-only, admission order,
               durable sentinels).  None = keep results in memory only.
    on_toas:   optional callback(datafile, tim_toas) fired per
               completed archive IN ADMISSION ORDER with the archive's
               timing.tim.TimTOA list (parsed from the exact lines
               appended to tim_out) — the hook ppwatch chains the
               incremental GLS + alert monitor onto.
    options:   make_wideband_lane fit options, passed to every submit
               (requests sharing (modelfile, options) share a lane and
               coalesce).
    """

    def __init__(self, server, modelfile, sources, tim_out=None,
                 tracer=None, quiet=False, **options):
        self.server = server
        self.modelfile = str(modelfile)
        self.sources = list(sources)
        if not self.sources:
            raise ValueError("IngestDriver: no sources")
        self.tim_out = tim_out
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.quiet = quiet
        self.options = dict(options)
        self.on_toas = None
        # admission-ordered FIFO of dicts:
        #   {'datafile', 'request', 'source'}
        self._inflight = []
        self._seq = 0
        self.n_admitted = 0
        self.n_completed = 0
        self.n_deferred = 0
        self.n_errors = 0
        if tim_out and not os.path.exists(tim_out):
            open(tim_out, "a").close()

    # -- admission ------------------------------------------------------

    def _skip(self, source, path, reason):
        if self.tracer.enabled:
            self.tracer.emit("ingest_skip", datafile=path,
                             source=source.name, reason=reason)

    def _admit_one(self, source, path, wait_s):
        """Probe + submit one candidate.  Returns True when admitted,
        False when deferred back to the source."""
        try:
            scan_fits(path)
        except TruncatedFits as e:
            # half-written (or torn) file: retry once stable again —
            # the typed error is the signal this is a WAIT, not a
            # failure; a file torn forever just keeps deferring and
            # never reaches the loaders
            self.n_deferred += 1
            source.defer(path)
            self._skip(source, path, "truncated")
            log(f"ingest: deferred truncated {path}: {e}",
                quiet=self.quiet, tracer=None)
            return False
        except (OSError, ValueError) as e:
            # unreadable / structurally-bad candidate: poisoning one
            # file must not poison the source, so skip it for good
            self.n_errors += 1
            self._skip(source, path, "error")
            log(f"ingest: skipped unreadable {path}: {e}",
                level="warn", quiet=self.quiet, tracer=None)
            return True  # consumed (never retried)
        try:
            req = self.server.submit(
                [path], self.modelfile,
                name=f"ingest{self._seq}", **self.options)
        except ServeRejected as e:
            if not e.retryable:
                raise
            # backpressure: the serve queue is full — throttle the
            # source instead of queueing unboundedly here
            self.n_deferred += 1
            source.defer(path)
            self._skip(source, path, "backpressure")
            return False
        self._seq += 1
        self.n_admitted += 1
        self._inflight.append({"datafile": path, "request": req,
                               "source": source})
        if self.tracer.enabled:
            self.tracer.emit("ingest_admit", datafile=path,
                             source=source.name,
                             wait_s=finite(wait_s, 6))
        return True

    # -- ordered collection --------------------------------------------

    def _append_result(self, datafile, result):
        """Append one archive's TOA lines + sentinel to the streaming
        .tim (the server's own demux idiom — byte-identical lines) and
        fire on_toas with the parsed TimTOAs."""
        toas = list(result.TOA_list)
        if self.tim_out:
            write_TOAs(toas, outfile=self.tim_out, append=True)
            with open(self.tim_out, "a") as fh:
                fh.write(_DONE_PREFIX + os.path.abspath(datafile)
                         + "\n")
        if self.on_toas is not None:
            from ..timing.tim import read_tim

            lines = [toa_string(t) for t in toas]
            self.on_toas(datafile, read_tim(lines))

    def _collect_ready(self, block_s=0.0):
        """Drain completed HEAD-of-queue requests (admission order; a
        later-finished earlier archive blocks later ones — ordering is
        the contract).  Returns the number collected."""
        n = 0
        deadline = time.monotonic() + block_s
        while self._inflight:
            head = self._inflight[0]
            timeout = max(0.0, deadline - time.monotonic())
            if not head["request"].wait(timeout):
                break
            self._inflight.pop(0)
            try:
                result = head["request"].result(timeout=0.0)
            except Exception as e:
                # the fit failed server-side; the archive is consumed
                # (a deterministic failure would defer forever)
                self.n_errors += 1
                self._skip(head["source"], head["datafile"], "error")
                log(f"ingest: request for {head['datafile']} failed: "
                    f"{e}", level="warn", quiet=self.quiet, tracer=None)
                continue
            self._append_result(head["datafile"], result)
            self.n_completed += 1
            n += 1
        return n

    # -- the loop -------------------------------------------------------

    def run_once(self):
        """One poll cycle over every source + one collection pass.
        Returns the number of archives admitted this cycle."""
        admitted = 0
        for source in self.sources:
            for path, wait_s in source.poll():
                if self._admit_one(source, path, wait_s):
                    admitted += 1
        self._collect_ready()
        return admitted

    def drain(self, timeout=None):
        """Block until every in-flight request has been collected into
        the ordered .tim (up to ``timeout`` seconds).  Returns True
        when fully drained."""
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        while self._inflight:
            block = (1.0 if deadline is None
                     else min(1.0, deadline - time.monotonic()))
            if block <= 0:
                return False
            self._collect_ready(block_s=block)
        return True

    def run(self, stop=None, idle_polls=None, poll_ms=None):
        """Poll until ``stop`` (a threading.Event) is set — or, with
        ``idle_polls``, until that many consecutive polls admitted
        nothing, completed nothing, and left nothing in flight (the
        batch-corpus mode ppwatch --drain uses).  Drains in-flight
        work before returning."""
        poll_s = (config.ingest_poll_ms if poll_ms is None
                  else float(poll_ms)) * 1e-3
        idle = 0
        while True:
            if stop is not None and stop.is_set():
                break
            before = self.n_completed
            admitted = self.run_once()
            active = (admitted or self.n_completed != before
                      or self._inflight
                      or any(s.pending() for s in self.sources))
            idle = 0 if active else idle + 1
            if idle_polls is not None and idle >= idle_polls:
                break
            time.sleep(poll_s)
        self.drain()

    def stats(self):
        return {"admitted": self.n_admitted,
                "completed": self.n_completed,
                "deferred": self.n_deferred,
                "errors": self.n_errors,
                "inflight": len(self._inflight)}
