"""Read IPTA/tempo2-style .tim files (the format io/tim.py writes).

Line grammar (reference write_TOAs, pplib.py:3588-3649):
  archive freq MJDint.MJDfrac err_us site -flag value ...
with the wideband DM carried in ``-pp_dm`` / ``-pp_dme`` flags and the
TEMPO2 convention that 0.0 MHz means infinite frequency
(pplib.py:3613).  The MJD is split digit-exactly into (int day,
float64 fractional day) — parsing it as one float64 would cost ~us of
timing precision.
"""

from dataclasses import dataclass, field

__all__ = ["TimTOA", "read_tim"]


@dataclass
class TimTOA:
    archive: str
    frequency: float          # MHz; inf for the 0.0 convention
    mjd_int: int
    mjd_frac: float           # [0, 1) day, full f64 precision
    error_us: float
    site: str
    dm: float = None          # -pp_dm  [pc cm^-3]
    dm_err: float = None      # -pp_dme
    flags: dict = field(default_factory=dict)

    @property
    def mjd(self):
        """Approximate (single-f64) MJD — display/grouping only."""
        return self.mjd_int + self.mjd_frac


def read_tim(path_or_lines):
    """Parse a .tim file (or iterable of lines) into a list of TimTOA.

    Skips comments (#, C), blank lines, and directives (FORMAT, MODE,
    EFAC-style lines with fewer than 5 leading data columns)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    toas = []
    for line in lines:
        s = line.strip()
        if not s or s.startswith("#") or s.startswith("C "):
            continue
        parts = s.split()
        if len(parts) < 5 or parts[0].upper() in ("FORMAT", "MODE",
                                                  "EFAC", "EQUAD",
                                                  "TIME", "JUMP"):
            continue
        try:
            freq = float(parts[1])
            mjd_s = parts[2]
            err = float(parts[3])
        except ValueError:
            continue
        if "." in mjd_s:
            day_s, frac_s = mjd_s.split(".", 1)
            mjd_int = int(day_s)
            mjd_frac = float("0." + frac_s)
        else:
            mjd_int, mjd_frac = int(mjd_s), 0.0
        flags = {}
        i = 5
        while i < len(parts):
            if parts[i].startswith("-") and i + 1 < len(parts):
                flags[parts[i][1:]] = parts[i + 1]
                i += 2
            else:
                i += 1
        dm = flags.get("pp_dm")
        dm_err = flags.get("pp_dme")
        toas.append(TimTOA(
            archive=parts[0],
            frequency=float("inf") if freq == 0.0 else freq,
            mjd_int=mjd_int, mjd_frac=mjd_frac, error_us=err,
            site=parts[4],
            dm=float(dm) if dm is not None else None,
            dm_err=float(dm_err) if dm_err is not None else None,
            flags=flags))
    return toas
