"""The comparison that decides ``correct``: every TOA the timed path
returned, against the reference's TOA of the same subint.

Each number is the worst over all returned TOAs, so an answer altered in
any pass over the pool shows.  A cell compares the numbers its
``limits/<cell>.json`` names:

- ``missing_toas``: TOAs admitted but not returned, or not finite (an
  archive whose subints did not all come back is never assembled, so
  all its TOAs count);
- ``fit_dev_sigma``: the worst deviation of any fitted quantity of a
  TOA from the reference's, over the reference's error of it: the
  arrival time (the program's TOA moved to the reference's frequency
  along the program's own DM, modulo one period), the DM and, on the
  scattering lane, the scattering time (moved to the reference's
  frequency along the program's own index) and the index;
- ``err_dev_rel``: the largest relative difference of the TOA, DM (and
  scattering) errors;
- ``reference_unconverged``: subints whose reference Newton steps did not
  converge (a fault of the yardstick, never a pass).
"""

import math

import numpy as np

from .reference import DCONST

SECPERDAY = 86400.0


def _worst(x):
    x = np.asarray(x, float)
    if x.size == 0:
        return math.inf
    return float(np.max(np.where(np.isfinite(x), x, np.inf)))


def compare(pool, idx, prog, ref, fields, admitted):
    """Numbers of one run: ``idx`` (n,) pool archive of each admission
    that returned, ``prog`` (n, nsub, len(fields)) its TOAs (NaN where
    missing), ``ref`` the reference's dict of (narchive, nsub) arrays,
    ``admitted`` the TOAs the run admitted."""
    F = {k: prog[..., i] for i, k in enumerate(fields)}
    R = {k: v[idx] for k, v in ref.items()}
    key = ["day", "frac", "freq", "toa_err_us", "dm", "dm_err"]
    if pool.scat:
        key += ["tau_us", "tau_freq", "tau_err_log10", "alpha", "alpha_err"]
    good = np.ones(F["day"].shape, bool)
    for k in key:
        good &= np.isfinite(F[k])
    n = {"missing_toas": int(admitted - np.count_nonzero(good))}
    dt = ((F["day"] - pool.start[0]) * SECPERDAY + F["frac"] * SECPERDAY
          - R["toa_s"]
          + DCONST * F["dm"] * (R["freq"] ** -2.0 - F["freq"] ** -2.0))
    # a TOA marks the arrival of a pulse: both sides wrap the phase into
    # one turn, so two TOAs a whole period apart are the same TOA
    dt -= pool.period_s * np.round(dt / pool.period_s)
    devs = [np.abs(dt) / (R["toa_err_us"] * 1e-6),
            np.abs(F["dm"] - R["dm"]) / R["dm_err"]]
    errs = [F["toa_err_us"] / R["toa_err_us"], F["dm_err"] / R["dm_err"]]
    if pool.scat:
        tau_p = F["tau_us"] * (R["tau_freq"] / F["tau_freq"]) ** F["alpha"]
        devs += [np.abs(tau_p - R["tau_us"]) / R["tau_err_us"],
                 np.abs(F["alpha"] - R["alpha"]) / R["alpha_err"]]
        tau_err_p = F["tau_err_log10"] * F["tau_us"] * math.log(10.0)
        errs += [tau_err_p / R["tau_err_us"],
                 F["alpha_err"] / R["alpha_err"]]
    n["fit_dev_sigma"] = _worst([d[good] for d in devs])
    n["err_dev_rel"] = _worst([np.abs(e - 1.0)[good] for e in errs])
    n["reference_unconverged"] = int(np.size(ref["ok"])
                                     - np.count_nonzero(ref["ok"]))
    return n


def reference_as_program(pool, ref):
    """A reference's TOAs in the program's place: one admission of every
    pool archive, laid out as ``compare`` reads the program's."""
    from .window import Campaign

    fields = Campaign.FIELDS
    na, ns = pool.narchive, pool.nsub
    out = np.full((na, ns, len(fields)), np.nan)
    day = np.floor(ref["toa_s"] / SECPERDAY)
    vals = {"isub": np.broadcast_to(np.arange(ns), (na, ns)),
            "day": pool.start[0] + day,
            "frac": (ref["toa_s"] - day * SECPERDAY) / SECPERDAY,
            "freq": ref["freq"], "toa_err_us": ref["toa_err_us"],
            "dm": ref["dm"], "dm_err": ref["dm_err"]}
    if pool.scat:
        vals.update({"tau_us": ref["tau_us"], "tau_freq": ref["tau_freq"],
                     "tau_err_log10": ref["tau_err_us"]
                     / (ref["tau_us"] * math.log(10.0)),
                     "alpha": ref["alpha"], "alpha_err": ref["alpha_err"]})
    for i, k in enumerate(fields):
        if k in vals:
            out[..., i] = vals[k]
    return np.arange(na), out


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): every number the cell compares
    (those its limits name) at or under its limit (NaN never is)."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    ok = all(v <= lim for _, v, lim in rows)
    return bool(ok), rows
