"""The live observability plane of the serving loop (counterpart of
pulseportraiture_tpu/obs/).

- ``obs.metrics``: thread-safe counters and gauges plus fixed log-bucket
  latency histograms (p50/p90/p99 without sample retention), mergeable
  because every exporter shares the bucket bounds;
- ``obs.slo``: per-tenant latency objectives with multi-window burn-rate
  tracking and edge-triggered breach events;
- ``obs.trace``: the ``trace_id`` minted at submit time and stamped into
  every event a request touches;
- ``obs.merge``: stitch a router trace plus N host traces into
  per-request cross-host span timelines keyed by ``trace_id``
  (``pptrace merge``).
"""

from .merge import format_merge, main_merge, merge_traces
from .metrics import (HIST_BOUNDS, MetricsRegistry, global_registry,
                      link_stall_frac, merge_exports, quantile_from_export,
                      record_h2d)
from .slo import SloTracker
from .trace import new_trace_id

__all__ = [
    "HIST_BOUNDS", "MetricsRegistry", "SloTracker", "format_merge",
    "global_registry", "link_stall_frac", "main_merge", "merge_exports",
    "merge_traces", "new_trace_id", "quantile_from_export", "record_h2d",
]
