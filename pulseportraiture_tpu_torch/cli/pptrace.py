"""pptrace: read a campaign trace written by the port's drivers.

    python -m pulseportraiture_tpu_torch.cli.pptrace report   trace.jsonl
    python -m pulseportraiture_tpu_torch.cli.pptrace validate trace.jsonl
    python -m pulseportraiture_tpu_torch.cli.pptrace merge    router.jsonl \
        host0.jsonl host1.jsonl [--json]

Traces are written when telemetry is on: a driver's ``telemetry=``
argument (a path or a shared telemetry.Tracer), ``config.
telemetry_path``, ``PPT_TELEMETRY=path``, or the ``--telemetry PATH``
flag of pptoas, ppzap, ppfactory and pptime.  ``report`` prints the
device timeline, queue depths, the h2d link and transport-codec
ledger, checkpoint stalls, cold dispatches, the template factory, the
timing stage, zapping and fit quality; ``validate`` checks the schema.
``merge`` stitches a router trace and N host traces (any order; roles
are detected from the events) into one timeline per request, joined on
``trace_id``: placement, queue wait, fit, serve, hedges and failovers,
and the request's critical stage (obs/merge.py); ``--json`` prints the
merged structure.  The schema is the JAX package's, so either package's
pptrace reads either package's traces.
"""

import sys

from ..telemetry import main

if __name__ == "__main__":
    sys.exit(main())
