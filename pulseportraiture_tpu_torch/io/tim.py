"""TOA records and .tim output.

Parity targets: reference pptoas.py:42-84 (TOA class),
pplib.py:3502-3649 (filter_TOAs / write_princeton_TOA / write_TOAs).
The reference's filter_TOAs defects (`criterio` typo, `.appens`,
returning the flag instead of the culled list; SURVEY §2.8) are fixed
here, not replicated.
"""

import operator

import numpy as np

_OPS = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
        "<=": operator.le, "==": operator.eq, "!=": operator.ne}


class TOA:
    """One wideband TOA: epoch + reference frequency + error + DM and
    arbitrary flags (reference pptoas.py:42-84)."""

    def __init__(self, archive, frequency, MJD, TOA_error, telescope,
                 telescope_code, DM=None, DM_error=None, flags=None):
        self.archive = archive
        self.frequency = frequency
        self.MJD = MJD  # utils.mjd.MJD
        self.TOA_error = TOA_error  # [us]
        self.telescope = telescope
        self.telescope_code = telescope_code
        self.DM = DM
        self.DM_error = DM_error
        self.flags = dict(flags) if flags else {}

    def write_TOA(self, inf_is_zero=True, outfile=None):
        write_TOAs(self, inf_is_zero=inf_is_zero, outfile=outfile,
                   append=True)

    def __repr__(self):
        return (f"TOA({self.archive}, {self.frequency} MHz, "
                f"{self.MJD}, +/-{self.TOA_error:.3f} us)")


def filter_TOAs(TOAs, flag, cutoff, criterion=">=", pass_unflagged=False,
                return_culled=False):
    """Filter a TOA list on a flag value (reference pplib.py:3502-3548
    with its three defects fixed)."""
    op = _OPS.get(criterion)
    if op is None:
        print(f"Undefined criterion {criterion}; defaulting to '=='")
        op = operator.eq
    kept, culled = [], []
    for toa in TOAs:
        if flag in toa.flags:
            (kept if op(toa.flags[flag], cutoff) else culled).append(toa)
        else:
            (kept if pass_unflagged else culled).append(toa)
    return (kept, culled) if return_culled else kept


def _mjd_fields(day, frac, ndecimals):
    """(day, '.ffff...') with rounding carry handled — delegates to
    MJD.tim_string so 0.99999..9 rounds to the next day, not to a
    silent 1-day error."""
    from ..utils.mjd import MJD

    s = MJD(int(day), float(frac)).tim_string(ndecimals)
    whole, _, fracpart = s.partition(".")
    return int(whole), "." + fracpart


def princeton_TOA_string(TOA_MJDi, TOA_MJDf, TOA_err, nu_ref, dDM,
                         obs="@", name=" " * 13):
    """Princeton-format TOA line (reference pplib.py:3551-3585)."""
    if nu_ref == np.inf:
        nu_ref = 0.0
    day, frac = _mjd_fields(TOA_MJDi, TOA_MJDf, 13)
    toa = f"{day:5d}" + frac
    return (f"{obs} {name:>13s} {nu_ref:8.3f} {toa} {TOA_err:8.3f}"
            f"              {dDM:9.5f}")


def write_princeton_TOAs(TOAs, outfile=None, dDMs=None):
    """Write Princeton-style TOAs for a list of TOA objects — the
    reference CLI advertises this but the method was never written
    (pptoas.py:1658 latent AttributeError; SURVEY §2.8)."""
    lines = []
    for i, toa in enumerate(TOAs):
        dDM = dDMs[i] if dDMs is not None else (toa.flags.get("pp_ddm", 0.0))
        lines.append(princeton_TOA_string(
            toa.MJD.day, toa.MJD.frac, toa.TOA_error, toa.frequency, dDM,
            obs=toa.telescope_code))
    _emit(lines, outfile, append=False)


def toa_string(toa, inf_is_zero=True):
    """One loosely-IPTA .tim line (reference pplib.py:3588-3649):
    `archive freq MJD err code [-pp_dm ...] [-pp_dme ...] [-flag val]...`
    with the TEMPO2 convention that 0.0 MHz means infinite frequency
    and per-flag-type value formatting."""
    freq = toa.frequency
    if freq == np.inf and inf_is_zero:
        freq = 0.0
    mjd = toa.MJD.tim_string(15)
    s = f"{toa.archive} {freq:.8f} {mjd}   {toa.TOA_error:.3f}  " \
        f"{toa.telescope_code}"
    if toa.DM is not None:
        s += f" -pp_dm {toa.DM:.7f}"
    if toa.DM_error is not None:
        s += f" -pp_dme {toa.DM_error:.7f}"
    for flag, value in toa.flags.items():
        if value is None:
            continue
        if hasattr(value, "lower"):
            s += f" -{flag} {value}"
        elif "int" in str(type(value)):
            s += f" -{flag} {value:d}"
        elif "_cov" in flag:
            s += f" -{flag} {value:.1e}"
        elif "phs" in flag:
            s += f" -{flag} {value:.8f}"
        elif "flux" in flag:
            s += f" -{flag} {value:.5f}"
        else:
            s += f" -{flag} {value:.3f}"
    return s


def write_TOAs(TOAs, inf_is_zero=True, SNR_cutoff=0.0, outfile=None,
               append=True):
    """Write .tim lines to a file or stdout (reference
    pplib.py:3588-3649; appends by default, the reference's de-facto
    checkpointing behavior, SURVEY §5)."""
    toas = TOAs if hasattr(TOAs, "__len__") else [TOAs]
    # only apply the S/N filter when a cutoff is actually requested —
    # with the reference's unconditional pass_unflagged=False, a TOA
    # list without 'snr' flags would be silently dropped
    if SNR_cutoff > 0.0:
        toas = filter_TOAs(toas, "snr", SNR_cutoff, ">=",
                           pass_unflagged=False)
    _emit([toa_string(t, inf_is_zero) for t in toas], outfile, append)


def _emit(lines, outfile, append):
    if outfile is None:
        for line in lines:
            print(line)
    else:
        with open(outfile, "a" if append else "w") as f:
            f.write("".join(line + "\n" for line in lines))
