"""Trace-context minting (counterpart of
pulseportraiture_tpu/obs/trace.py).

A ``trace_id`` is minted once, at ``ToaServer.submit`` unless the caller
passes one, and stamped into every telemetry event the request touches.
The id is an opaque 16-hex-char token; nothing parses it, everything
joins on it.
"""

import uuid


def new_trace_id():
    """Mint a fresh opaque trace id (16 hex chars, collision-safe for
    any realistic campaign size)."""
    return uuid.uuid4().hex[:16]
