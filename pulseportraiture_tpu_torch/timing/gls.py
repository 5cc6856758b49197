"""Wideband generalized-least-squares timing fit (NumPy, float64;
counterpart of pulseportraiture_tpu/timing/gls.py).

The DMDATA-1 likelihood the reference validates with an external tempo
run (examples/example_make_model_and_TOAs.ipynb cells 43-56): arrival
times AND the per-TOA wideband DM measurements enter one weighted
least-squares system,

    chi^2 = sum_i ((t_res_i - A_t_i @ x) / sigma_t_i)^2
          + sum_i ((DM_i - DM_model(t_i) - A_d_i @ x) / sigma_DM_i)^2

linearized about a barycentric spin ephemeris (F0 [, F1] at PEPOCH)
plus a piecewise-constant DM model (DMX per observing epoch — exactly
the structure make_fake_pulsar injects) plus an
orbital Roemer delay for ELL1/BT binaries (timing/binary.py) with its
Keplerian elements in the fit.  White noise only; Shapiro and
relativistic orbital terms remain unmodeled and are refused loudly.

The LINEARIZATION (exact rational spin-phase reduction, binary delay
evaluation, design-column assembly) is host work — timing needs
~1e-13 day precision, beyond f32 and beneath any launch floor at a
handful of TOAs — so the binary partials run through the torch op on
the CPU (``device="cpu"``, by design, not as a fallback).  The SOLVE
is factored out (``build_gls_system`` / ``gls_solve_np``) so
timing/fleet.py can batch it: one padded device call solves the whole
pulsar fleet's systems with this module's single-pulsar path as the
digit oracle.  Both lanes run the same algorithm — column-normalized
normal equations through a pseudoinverse — so serial-vs-batched stays
digit-comparable.
"""

from dataclasses import dataclass

import numpy as np

from ..config import Dconst
from . import binary as _binary

__all__ = ["wideband_gls_fit", "WidebandGLSResult", "build_gls_system",
           "gls_solve_np", "finalize_gls"]

SECPERDAY = 86400.0

# Binary-orbit parfile keys, split by modeling status:
#
# * _SUPPORTED_BINARY_KEYS enter the timing model (timing/binary.py):
#   Keplerian ELL1/BT elements plus their secular DOT derivatives.
# * _UNMODELED_BINARY_KEYS still refuse loudly: Shapiro delay in both
#   its (M2, SINI) and orthometric (H3, H4, STIG) parameterizations —
#   the orthometric keys used to slip PAST the old refusal and get
#   silently mistimed — plus relativistic/alternate-parameterization
#   terms (GAMMA, OMDOT, FB-series, geometry keys).  Silently ignoring
#   any of them would produce arrival-time residuals with unmodeled
#   orbital structure that the fitted columns partially absorb — a
#   misfit with no visible symptom.
_SUPPORTED_BINARY_KEYS = frozenset({
    "BINARY", "PB", "A1",
    "TASC", "EPS1", "EPS2",              # ELL1 elements
    "T0", "ECC", "E", "OM",              # BT elements
    "PBDOT", "XDOT", "A1DOT",            # secular derivatives
    "EPS1DOT", "EPS2DOT",
})
_UNMODELED_BINARY_KEYS = frozenset({
    # Shapiro delay (classic and orthometric parameterizations)
    "SINI", "M2", "SHAPMAX", "H3", "H4", "STIG",
    # relativistic / alternate-parameterization terms
    "GAMMA", "OMDOT", "ECCDOT", "EDOT", "FB0", "FB1",
    "MTOT", "KOM", "KIN",
})
# The union: every binary key the fit knows of.
_BINARY_KEYS = _SUPPORTED_BINARY_KEYS | _UNMODELED_BINARY_KEYS


@dataclass
class WidebandGLSResult:
    params: dict              # name -> fitted offset value
    param_errs: dict
    time_resids_us: np.ndarray   # post-fit [us]
    prefit_resids_us: np.ndarray
    dm_resids: np.ndarray        # post-fit DM residuals [pc cm^-3]
    toa_errs_us: np.ndarray
    dm_errs: np.ndarray
    epochs: np.ndarray           # epoch index per TOA
    dmx: np.ndarray              # fitted DMX per epoch [pc cm^-3]
    dmx_errs: np.ndarray
    chi2: float
    dof: int
    wrms_us: float
    n_dropped_no_dm: int = 0     # input TOAs without -pp_dm/-pp_dme
    binary: object = None        # timing.binary.BinaryParams or None

    @property
    def red_chi2(self):
        return self.chi2 / max(self.dof, 1)


def _group_epochs(mjds, gap_days=0.5):
    """Epoch index per TOA: a new epoch wherever the (sorted) MJDs jump
    by more than gap_days."""
    order = np.argsort(mjds)
    out = np.zeros(len(mjds), int)
    cur = 0
    prev = None
    for j in order:
        if prev is not None and mjds[j] - prev > gap_days:
            cur += 1
        out[j] = cur
        prev = mjds[j]
    return out


def build_gls_system(toas, par, fit_f0=True, fit_f1=False,
                     fit_binary=True, epoch_gap_days=0.5,
                     allow_wraps=False):
    """Linearize the wideband timing model about ``par`` — everything
    except the solve.  Host work in float64; the binary partials come
    from the torch op run with device="cpu" (module docstring).

    Returns a dict-like system (plain attributes via a small class
    would be overkill; the fleet lane treats it as data):
      A          (2n, p) whitened stacked design matrix
      r          (2n,)  whitened stacked residual vector
      names      fitted global-parameter names (pre-DMX columns)
      nep        number of DMX epochs
      epochs, sig_t, dm_errs, errs_us, r_t, r_d, n, n_dropped, binary
    Raises exactly like the old monolithic fit: missing PEPOCH/F0,
    unmodeled binary keys, partial binary element sets, < 2 usable
    TOAs, lost phase connection.
    """
    def fget(key, default=None):
        v = par.get(key, default)
        return float(str(v).replace("D", "E")) if v is not None else None

    # refuse parfiles whose binary keys this model does NOT implement,
    # LOUDLY: fitting anyway would silently time the pulsar against a
    # wrong (orbit-smeared) phase prediction.  Keplerian ELL1/BT
    # elements are modeled (timing/binary.py); Shapiro/relativistic
    # terms are not.
    unmodeled = sorted(k for k in _UNMODELED_BINARY_KEYS
                       if par.get(k) is not None) if hasattr(par, "get") \
        else []
    if unmodeled:
        raise ValueError(
            "wideband_gls_fit: the parfile carries binary-orbit "
            f"parameters ({', '.join(unmodeled)}) that this fit does "
            "not model — it implements Keplerian ELL1/BT orbits "
            "(PB, A1, TASC/T0, EPS1/EPS2 or ECC/OM, and their DOT "
            "derivatives) but no Shapiro or relativistic terms.  "
            "Remove them, or time these TOAs with tempo2/PINT.")
    bp = _binary.parse_binary(par) if hasattr(par, "get") else None

    PEPOCH = fget("PEPOCH")
    if PEPOCH is None:
        raise ValueError(
            "wideband_gls_fit: parfile is missing PEPOCH (the spin "
            "reference epoch); add a 'PEPOCH <mjd>' line")
    if fget("F0") is None and fget("P0") is None:
        raise ValueError(
            "wideband_gls_fit: parfile has neither F0 nor P0; one spin "
            "parameter is required")
    DM0 = fget("DM", 0.0)

    n_in = len(toas)
    toas = [t for t in toas if t.dm is not None and t.dm_err]
    n = len(toas)
    n_dropped = n_in - n
    if n_dropped:
        import warnings

        warnings.warn(
            f"wideband_gls_fit: dropped {n_dropped} of {n_in} TOAs "
            "without -pp_dm/-pp_dme wideband DM flags (they cannot "
            "enter the DMDATA system)", stacklevel=2)
    if n < 2:
        raise ValueError("wideband GLS needs >= 2 TOAs with -pp_dm")
    freqs = np.array([t.frequency for t in toas])
    errs_us = np.array([t.error_us for t in toas])
    dms = np.array([t.dm for t in toas])
    dm_errs = np.array([t.dm_err for t in toas])
    mjd_i = np.array([t.mjd_int for t in toas], np.int64)
    mjd_f = np.array([t.mjd_frac for t in toas])
    mjds = mjd_i + mjd_f

    epochs = _group_epochs(mjds, epoch_gap_days)
    nep = epochs.max() + 1

    # orbital Roemer delay of the par's binary model at each TOA, plus
    # the closed-form partials for the design columns.  Evaluated at
    # the (topocentric=barycentric here) arrival epoch; the ~ms
    # dispersion offset changes the orbital phase by ~2pi*ms/PB —
    # orders below the TOA errors.  The torch op is the production
    # lane (the same partials feed the fleet's batched systems); the
    # NumPy oracle in timing/binary.py guards its digits.  It runs on
    # the CPU: the rest of the linearization is host float64 work, a
    # few hundred elements per pulsar, and a card round trip here
    # would cost more than the arithmetic.
    delay_s = 0.0
    dparts = None
    if bp is not None:
        d, parts = _binary.binary_delay_and_partials(bp, mjd_i, mjd_f,
                                                     device="cpu")
        delay_s = d.numpy()
        dparts = parts.numpy()

    # infinite-frequency arrival time: subtract the MODEL dispersion
    # delay (par DM; the DMX corrections are fitted linearly below) at
    # the TOA's reference frequency.  Using the measured DMs here would
    # leak their noise into the arrival times and double-count the DMX
    # columns.
    disp_s = np.where(np.isfinite(freqs),
                      Dconst * DM0 * freqs ** -2.0, 0.0)
    # seconds since PEPOCH (f64: used only for design columns, where
    # ns precision is irrelevant)
    dt_s = ((mjd_i - int(PEPOCH)) * SECPERDAY
            + (mjd_f - (PEPOCH - int(PEPOCH))) * SECPERDAY
            - disp_s - delay_s)

    # prefit phase residuals (nearest-turn wrap).  F0 * dt is ~1e9
    # turns for an MSP campaign — one f64 product would cost ns-level
    # rounding — so the integer-day part is reduced modulo 1 in exact
    # rational arithmetic via the SAME helper/representation the
    # spin-coherent synth uses (utils/spin.py; a float-rounded F0 here
    # would fake a ~1 ns/100 days residual slope against it), and only
    # the < half-day remainder (~1e7 turns, ~0.01 ns f64 error) is a
    # float product.  The binary delay is seconds-scale, so its phase
    # F0*delay (~1e2 turns) is safe as a float product.
    from ..utils.spin import day_phase_frac, spin_F0

    F0r = spin_F0(par)
    F0 = float(F0r)  # design/conversion value, consistent with F0r
    pep_i = int(PEPOCH)
    phase_day = np.array(
        [day_phase_frac(F0r, pep_i, di) for di in mjd_i])
    phase_rem = F0 * ((mjd_f - (PEPOCH - pep_i)) * SECPERDAY
                      - disp_s - delay_s)
    phase = phase_day + phase_rem
    dphase = phase - np.round(phase)
    # phase-connection validation.  Nearest-turn wrapping is only valid
    # when every TRUE residual phase sits inside a +-0.5-turn window
    # around a common offset (the OFFSET parameter absorbs the mean).
    # The observable, rotation-invariant symptom of lost connection is
    # the OCCUPIED CIRCULAR ARC of the prefit residuals: residuals of
    # a connected campaign cluster (any cluster position is fine —
    # a constant offset at the +-0.5 boundary must NOT false-fire),
    # while a drifting-F0 campaign smears them over the circle.  When
    # more than half the circle is occupied no single wrap window can
    # contain the data and the fit would silently time wrapped
    # aliases.  A badly-wrong binary model trips this too — by design:
    # its orbit-smeared prediction IS lost phase connection.
    if not allow_wraps and n > 1:
        s = np.sort(dphase)
        largest_gap = max(float(np.diff(s).max(initial=0.0)),
                          1.0 - float(s[-1] - s[0]))
        occupied = 1.0 - largest_gap
        if occupied > 0.5:
            raise ValueError(
                "wideband_gls_fit: prefit phase residuals occupy "
                f"{occupied:.2f} turns of the phase circle — phase "
                "connection is lost and the nearest-turn wrap would "
                "silently time wrapped aliases.  Improve F0/F1"
                + ("/the binary model" if bp is not None else "")
                + " (or pass allow_wraps=True to accept per-TOA "
                "wrapping).")
    r_t = dphase / F0  # seconds

    # design matrix, time rows: d(model delay)/d(param) in seconds
    cols = {}
    cols["OFFSET"] = np.ones(n)
    # spin columns carry tempo's sign convention: the fitted value is
    # the CORRECTION TO ADD to the par parameter (residuals shrink when
    # the par moves toward truth)
    if fit_f0:
        cols["F0"] = -dt_s / F0
    if fit_f1:
        cols["F1"] = -0.5 * dt_s ** 2.0 / F0
    # binary columns: d(Roemer delay)/d(element) — a pulse is LATE by
    # the extra delay, so the column is +d(delay)/d(param) and the
    # fitted value is again the correction to ADD to the par element
    if bp is not None and fit_binary:
        for name, row in zip(bp.param_names, dparts):
            cols[name] = row
    # DMX columns affect BOTH the time rows (through the dispersion
    # delay at the TOA frequency) and the DM rows
    names = list(cols)
    A_t = np.stack([cols[k] for k in names], axis=1)
    dmx_t = np.zeros((n, nep))
    finite = np.isfinite(freqs)
    for j in range(nep):
        sel = (epochs == j) & finite
        dmx_t[sel, j] = Dconst * freqs[sel] ** -2.0
    A_t = np.concatenate([A_t, dmx_t], axis=1)

    # DM rows: residual = DM_i - (DM0 + DMX[epoch])
    r_d = dms - DM0
    A_d = np.zeros((n, A_t.shape[1]))
    for j in range(nep):
        A_d[epochs == j, len(names) + j] = 1.0

    # stack and whiten
    sig_t = errs_us * 1e-6
    A = np.concatenate([A_t / sig_t[:, None], A_d / dm_errs[:, None]])
    r = np.concatenate([r_t / sig_t, r_d / dm_errs])

    from ..utils.bunch import DataBunch

    return DataBunch(A=A, r=r, names=names, nep=nep, epochs=epochs,
                     sig_t=sig_t, dm_errs=dm_errs, errs_us=errs_us,
                     r_t=r_t, r_d=r_d, n=n, n_dropped=n_dropped,
                     binary=bp)


def gls_solve_np(A, r):
    """Host-NumPy solve of one whitened system — the per-pulsar oracle
    the fleet's batched torch program mirrors op-for-op.

    Column-normalize (the raw design spans ~12 decades: seconds-per-Hz
    vs seconds-per-DM columns, which wrecks both conditioning and the
    pseudoinverse's singular-value threshold), solve the normal
    equations through a pseudoinverse (rank-deficient columns — e.g.
    an all-zero pad column in the fleet lane — drop out with zero
    value and zero error instead of blowing up), and return
    (x, perr, cov, post, chi2) with ``post`` the whitened post-fit
    residual vector."""
    col = np.sqrt((A ** 2.0).sum(axis=0))
    col = np.where(col > 0, col, 1.0)
    An = A / col
    N = np.linalg.pinv(An.T @ An)
    xn = N @ (An.T @ r)
    x = xn / col
    cov = (N / col[:, None]) / col[None, :]
    perr = np.sqrt(np.maximum(np.diag(cov), 0.0))
    post = r - An @ xn
    chi2 = float((post ** 2.0).sum())
    return x, perr, cov, post, chi2


def finalize_gls(system, x, perr, post, chi2):
    """Assemble a WidebandGLSResult from a solved system (shared by
    the single-pulsar path and the fleet lane)."""
    s = system
    n = s.n
    nglob = len(s.names)
    post_t = post[:n] * s.sig_t
    post_d = post[n:2 * n] * s.dm_errs
    dof = 2 * n - (nglob + s.nep)
    w = s.sig_t ** -2.0
    wrms = np.sqrt((post_t ** 2.0 * w).sum() / w.sum()) * 1e6
    params = dict(zip(s.names, x[:nglob]))
    param_errs = dict(zip(s.names, perr[:nglob]))
    return WidebandGLSResult(
        params=params, param_errs=param_errs,
        time_resids_us=post_t * 1e6, prefit_resids_us=s.r_t * 1e6,
        dm_resids=post_d, toa_errs_us=s.errs_us, dm_errs=s.dm_errs,
        epochs=s.epochs, dmx=x[nglob:nglob + s.nep],
        dmx_errs=perr[nglob:nglob + s.nep],
        chi2=chi2, dof=dof, wrms_us=float(wrms),
        n_dropped_no_dm=s.n_dropped, binary=s.binary)


def wideband_gls_fit(toas, par, fit_f0=True, fit_f1=False,
                     fit_binary=True, epoch_gap_days=0.5,
                     allow_wraps=False):
    """Fit (phase offset[, dF0[, dF1]][, binary elements], DMX per
    epoch) to wideband TOAs.

    toas: list of timing.tim.TimTOA (needs frequency, mjd, error_us,
    dm, dm_err).  par: dict-like with F0 or P0, PEPOCH, DM (the
    parse_parfile output is fine — string values are converted).  A
    parfile with a complete ELL1 (PB/A1/TASC[/EPS1/EPS2]) or BT
    (PB/A1/T0[/ECC/OM]) element set gets its orbital Roemer delay
    modeled and — with fit_binary=True — its Keplerian elements
    fitted as corrections (dPB, dA1, dTASC/dT0, dEPS1/dECC,
    dEPS2/dOM) alongside the spin/DMX columns.  Shapiro and
    relativistic keys (SINI/M2/H3/H4/STIG/GAMMA/OMDOT/...) are still
    refused loudly, as are partial or unsupported binary models.

    Returns WidebandGLSResult; DM measurements and arrival times are
    fit jointly (DMDATA-1 style), with the model DM at each TOA =
    par DM + DMX[epoch].

    TOAs lacking wideband DM measurements cannot enter the DMDATA
    system; they are dropped with a warning and counted in the
    result's n_dropped_no_dm (they used to vanish silently).

    Phase connection is validated: each prefit residual is wrapped to
    the nearest turn independently, which is only meaningful when the
    ephemeris predicts phase to well under half a turn across the
    campaign.  If the wrapped residuals occupy more than half the
    phase circle, the pulse numbering is ambiguous and the fit would
    silently time a wrapped alias — that raises unless
    allow_wraps=True (for callers who accept per-TOA wrapping, e.g.
    offset-only fits on scrambled data)."""
    system = build_gls_system(toas, par, fit_f0=fit_f0, fit_f1=fit_f1,
                              fit_binary=fit_binary,
                              epoch_gap_days=epoch_gap_days,
                              allow_wraps=allow_wraps)
    x, perr, _, post, chi2 = gls_solve_np(system.A, system.r)
    return finalize_gls(system, x, perr, post, chi2)
