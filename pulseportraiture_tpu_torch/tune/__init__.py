"""The per-backend autotune subsystem (counterpart of
pulseportraiture_tpu/tune/).

- :mod:`~.capability`: the device's capability record and the tuning
  DB's backend fingerprint; the tri-state resolver is device.py's.
- :mod:`~.store`: the persisted JSON tuning DB keyed (backend
  fingerprint, shape class): loud on corruption or staleness, atomic on
  write, no re-sweep on a warm hit.
- :mod:`~.autotune`: the sweep harness (the output-identical tier by
  default, the numerics tier behind an explicit opt-in, min-of-N
  timing, the per-candidate byte gate, the combined no-regression
  gate).
"""

from .autotune import (IDENTITY_TIER, NUMERICS_TIER, Knob, SweepResult,
                       apply_from_db, apply_knobs, ensure_tuned,
                       shape_class_for, sweep, tuned_config)
from .capability import (KNOB_POLARITY, CapabilityRecord,
                         backend_fingerprint, capability_record,
                         capability_summary, resolve_auto)
from .store import SCHEMA_VERSION, TuningStore

__all__ = [
    "KNOB_POLARITY", "CapabilityRecord", "backend_fingerprint",
    "capability_record", "capability_summary", "resolve_auto",
    "SCHEMA_VERSION", "TuningStore",
    "IDENTITY_TIER", "NUMERICS_TIER", "Knob", "SweepResult",
    "apply_from_db", "apply_knobs", "ensure_tuned", "shape_class_for",
    "sweep", "tuned_config",
]
