"""Wideband timing: .tim reading, a NumPy GLS fitter with ELL1/BT
binary-orbit models, and the fleet-batched solve lane (counterpart of
pulseportraiture_tpu/timing/).

Read the wideband TOAs (+ -pp_dm DM measurements) back, fit a
linearized timing model jointly to arrival times and DMs, and report
white(ned) residuals.  Binary pulsars fit their Keplerian ELL1/BT
elements alongside spin/DMX; timing/fleet.py batches the per-pulsar
solves into padded torch calls on the card (the ``pptime`` CLI rides
it).
"""

from .binary import BinaryParams, parse_binary
from .fleet import TimingJob, fleet_gls_fit, toas_from_measurements
from .gls import WidebandGLSResult, wideband_gls_fit
from .incremental import GLSDriftError, IncrementalGLS
from .tim import TimTOA, read_tim

__all__ = ["read_tim", "TimTOA", "wideband_gls_fit",
           "WidebandGLSResult", "BinaryParams", "parse_binary",
           "TimingJob", "fleet_gls_fit", "toas_from_measurements",
           "IncrementalGLS", "GLSDriftError"]
