"""Telescope name -> TOA site code mapping.

Mirrors the reference's telescope_codes.py: prefer the observatory
tables of a TEMPO2 runtime ($TEMPO2/observatory/observatories.dat and
aliases, telescope_codes.py:7-32), falling back to a built-in table of
standard tempo/tempo2 observatory codes.
"""

import os

# name (upper) -> (one-character tempo code or itoa code, canonical name)
_BUILTIN = {
    "GBT": ("1", "gbt"),
    "GREEN BANK": ("1", "gbt"),
    "QUABBIN": ("2", "quabbin"),
    "ARECIBO": ("3", "arecibo"),
    "AO": ("3", "arecibo"),
    "HOBART": ("4", "hobart"),
    "PRINCETON": ("5", "princeton"),
    "VLA": ("6", "vla"),
    "PARKES": ("7", "pks"),
    "PKS": ("7", "pks"),
    "JODRELL": ("8", "jb"),
    "JODRELL BANK": ("8", "jb"),
    "JB": ("8", "jb"),
    "JBODFB": ("8", "jb"),
    "JBROACH": ("8", "jb"),
    "JBDFB": ("8", "jb"),
    "GB300": ("a", "gb300"),
    "GB140": ("b", "gb140"),
    "GB853": ("c", "gb853"),
    "LA PALMA": ("d", "lap"),
    "HARTEBEESTHOEK": ("e", "hart"),
    "HARTRAO": ("e", "hart"),
    "NANCAY": ("f", "ncy"),
    "NCY": ("f", "ncy"),
    "NUPPI": ("f", "ncy"),
    "EFFELSBERG": ("g", "eff"),
    "EFF": ("g", "eff"),
    "JBMK2": ("h", "jbmk2"),
    "WSRT": ("i", "wsrt"),
    "WESTERBORK": ("i", "wsrt"),
    "FAST": ("k", "fast"),
    "GMRT": ("r", "gmrt"),
    "CHIME": ("y", "chime"),
    "PRINCETON-OBS": ("5", "princeton"),
    "SRT": ("z", "srt"),
    "SARDINIA": ("z", "srt"),
    "LOFAR": ("t", "lofar"),
    "DE601": ("EF", "eflfrlba"),
    "DE602": ("UW", "uwlfrlba"),
    "DE603": ("TB", "tblfrlba"),
    "DE604": ("PO", "polfrlba"),
    "DE605": ("JU", "julfrlba"),
    "FR606": ("NC", "nclfrlba"),
    "SE607": ("ON", "onlfrlba"),
    "UK608": ("CH", "chlfrlba"),
    "MEERKAT": ("m", "meerkat"),
    "KAT-7": ("k7", "kat7"),
    "MOST": ("u", "most"),
    "MWA": ("x", "mwa"),
    "LWA": ("x", "lwa1"),
    "LWA1": ("x", "lwa1"),
    "NANSHAN": ("n", "nanshan"),
    "UAO": ("n", "nanshan"),
    "DSS_43": ("tid43", "tid43"),
    "TIDBINBILLA": ("tid43", "tid43"),
    "BARYCENTER": ("@", "bat"),
    "@": ("@", "bat"),
    "COE": ("coe", "coe"),
    "SSB": ("@", "bat"),
    "GEOCENTER": ("0", "geo"),
    "STL": ("stl", "stl"),
    "ATA": ("j", "ata"),
}


def _from_tempo2():
    """Parse $TEMPO2/observatory/{observatories.dat,aliases} into
    {ALIAS_UPPER: (code, canonical)}; returns {} when unavailable."""
    t2 = os.environ.get("TEMPO2")
    if not t2:
        return {}
    obs_path = os.path.join(t2, "observatory", "observatories.dat")
    alias_path = os.path.join(t2, "observatory", "aliases")
    if not os.path.isfile(obs_path):
        return {}
    table = {}
    canonical = {}
    try:
        with open(obs_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 5 and not line.strip().startswith("#"):
                    name, code = parts[3], parts[4]
                    canonical[name.upper()] = (code, name.lower())
                    table[name.upper()] = (code, name.lower())
                    try:
                        _TEMPO2_ITRF[name.lower()] = (
                            float(parts[0]), float(parts[1]),
                            float(parts[2]))
                    except ValueError:
                        pass
        if os.path.isfile(alias_path):
            with open(alias_path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and not line.strip().startswith("#"):
                        canon = parts[0].upper()
                        if canon in canonical:
                            for alias in parts[1:]:
                                table[alias.upper()] = canonical[canon]
    except OSError:
        return {}
    return table


# canonical name (lower) -> ITRF (x, y, z) [m], filled from a TEMPO2
# runtime's observatories.dat columns 1-3 when $TEMPO2 is set
_TEMPO2_ITRF = {}

telescope_code_dict = {**_BUILTIN, **_from_tempo2()}


def telescope_code(name):
    """TOA site code for a telescope name; unknown names pass through
    unchanged (reference pplib.py:2773-2777)."""
    try:
        return telescope_code_dict[str(name).upper()][0]
    except KeyError:
        return str(name)


def canonical_name(name):
    """Canonical tempo2 site name for a telescope name/alias, or None."""
    try:
        return telescope_code_dict[str(name).upper()][1]
    except KeyError:
        return None


def tempo2_itrf(name):
    """ITRF (x, y, z) [m] from a TEMPO2 runtime's observatory table,
    or None when $TEMPO2 is unset or the site is unknown."""
    canon = canonical_name(name)
    return _TEMPO2_ITRF.get(canon or str(name).lower())
