"""Published peaks of one NVIDIA H100 SXM and the least time of a kernel's
work, worked out from its shapes.

Copied from ``chip_smoke.py`` (``PEAK_*`` and ``cross_spectrum_bound_ms``)
so that the yardstick cannot move with the program.  The peaks are NVIDIA's
data sheet at the full 700 W power limit.
"""

import math

PEAK_FP32_FLOPS = 67e12
PEAK_FP64_FLOPS = 34e12
PEAK_HBM_BYTES = 3.35e12


def cross_spectrum_bound_ms(nb, nchan, nbin, K, itemsize, want_m2,
                            shared=True):
    """Least time of one B1 call (``fused_cross_spectrum``) on the card:
    the larger of its bytes (port, model and per-element weights read
    once, outputs written once) over HBM bandwidth and its fewest
    operations over the FP32 (or FP64) peak.  The fewest operations that
    give the same outputs are a real FFT of every data and template row
    (2.5 nbin log2 nbin FLOPs each) plus the epilogue (11 per output
    harmonic).  Returns (ms, "bytes" or "operations")."""
    rows = nb * nchan
    mrows = nchan if shared else rows
    flops = (2.5 * (rows + mrows) * nbin * math.log2(nbin)
             + 11.0 * rows * K)
    out = 2 * rows * K + (rows * K if want_m2 else rows)
    nbytes = itemsize * ((rows + mrows) * nbin + rows * K + out)
    peak = PEAK_FP32_FLOPS if itemsize == 4 else PEAK_FP64_FLOPS
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
