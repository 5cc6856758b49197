"""Exact rational spin-phase arithmetic.

frac(F0 * (epoch - PEPOCH)) is ~1e9 turns for an MSP campaign — one
f64 product aliases the fractional turn — so both producers of
absolute spin phase (synth.make_fake_pulsar's spin_coherent folding
and timing.gls's prefit residuals) reduce it in rational arithmetic
built from the SAME parfile-string representation.  Keeping a single
helper prevents the two sides drifting by the F0 float-rounding delta
(~F0 * 2^-53, a fake ~1 ns/100 days residual slope).
"""

from decimal import Decimal
from fractions import Fraction

__all__ = ["rational", "spin_F0", "spin_phase_frac", "day_phase_frac"]


def rational(v):
    """Exact Fraction from a parfile-style number: string (FORTRAN
    D-exponents included), float (exact binary value), int, or an
    already-converted Fraction (passed through)."""
    if isinstance(v, Fraction):
        return v
    if isinstance(v, float):
        return Fraction(v)
    return Fraction(Decimal(str(v).replace("D", "E").replace("d", "e")))


def spin_F0(par):
    """Exact F0 [Hz] as a Fraction from a parfile mapping (F0, else
    1/P0) — decimal-exact when the values are still strings."""
    if "F0" in par and par["F0"] is not None:
        return rational(par["F0"])
    return 1 / rational(par["P0"])


def spin_phase_frac(F0r, pepoch, day, frac_day):
    """frac(F0 * (epoch - PEPOCH)) in [0, 1), exactly.

    F0r: Fraction [Hz]; pepoch: parfile PEPOCH (any rational()-able
    value); day/frac_day: the epoch as (int MJD, f64 fractional day) —
    the framework's MJD representation."""
    dt_sec = (Fraction(int(day)) - rational(pepoch)) * 86400 \
        + Fraction(float(frac_day)) * 86400
    return float((F0r * dt_sec) % 1)


def day_phase_frac(F0r, pepoch_int_day, day):
    """frac(F0 * whole-day offset) in [0, 1), exactly — the
    integer-day part of the reduction, for callers that handle the
    sub-day remainder (< ~1e7 turns, safe in f64) separately."""
    return float((F0r * ((int(day) - int(pepoch_int_day)) * 86400)) % 1)
