"""High-precision MJD arithmetic.

TOA epochs need ~1e-13 day (~10 ns) precision — beyond a single
float64.  The reference leans on PSRCHIVE's C++ MJD class
(pptoas.py:572-575); here we keep a host-side (int day, float64
fractional day) pair, which holds ~1e-17 day of precision in the
fraction.
"""

from dataclasses import dataclass

SECPERDAY = 86400.0


@dataclass(frozen=True)
class MJD:
    """An epoch as (integer MJD, fractional day in [0, 1))."""

    day: int
    frac: float

    def __post_init__(self):
        # normalize so 0 <= frac < 1 exactly once at construction
        d = int(self.frac // 1.0)
        if d != 0:
            object.__setattr__(self, "day", self.day + d)
            object.__setattr__(self, "frac", self.frac - d)

    @classmethod
    def from_float(cls, mjd):
        d = int(mjd // 1.0)
        return cls(d, float(mjd) - d)

    def add_days(self, days):
        d = int(days // 1.0)
        return MJD(self.day + d, self.frac + (days - d))

    def add_seconds(self, sec):
        return self.add_days(sec / SECPERDAY)

    def __add__(self, days):
        return self.add_days(days)

    def __sub__(self, other):
        """Difference in days (float) against another MJD."""
        if isinstance(other, MJD):
            return (self.day - other.day) + (self.frac - other.frac)
        return self.add_days(-other)

    def to_float(self):
        return self.day + self.frac

    def tim_string(self, ndecimals=15):
        """'{day}.{frac}' with the fraction rendered to ndecimals —
        full precision for .tim files (reference pplib.py:3551-3585
        writes 13 decimals; we default to 15)."""
        frac_str = f"{self.frac:.{ndecimals}f}"
        if frac_str.startswith("1"):  # rounding carried over
            return MJD(self.day + 1, 0.0).tim_string(ndecimals)
        return f"{self.day}{frac_str[1:]}"

    def __repr__(self):
        return f"MJD({self.tim_string()})"
