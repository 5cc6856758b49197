"""The online observatory pipeline (counterpart of
pulseportraiture_tpu/ingest/): wideband TOAs as archives arrive, through
the port's warm serving loop on the card.

* ``source.py``: where archives come from: a watch folder with
  size-stability and completion-sentinel admission, and a socket source
  on serve/transport.py's framing for push-style announcements
  (``announce`` is the client helper).
* ``driver.py``: the ingest driver: the typed truncation probe
  (io.fitsio.scan_fits), single-archive requests into a started
  serve.ToaServer (backpressure rides ServeRejected(retryable)), and the
  streaming ``.tim`` in admission order with the one-shot driver's
  completion sentinels.
* ``alerts.py``: CUSUM change detection on the timing-residual stream
  (glitches, DM steps, profile changes), each emitting the ``alert``
  telemetry event.

The ``ppwatch`` CLI (cli/ppwatch.py) chains folder -> TOAs ->
timing.IncrementalGLS -> alerts.
"""

from .alerts import AlertMonitor, CusumDetector  # noqa: F401
from .driver import IngestDriver  # noqa: F401
from .source import SocketSource, WatchFolderSource, announce  # noqa: F401

__all__ = ["WatchFolderSource", "SocketSource", "announce",
           "IngestDriver", "AlertMonitor", "CusumDetector"]
