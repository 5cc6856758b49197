"""Incremental wideband GLS: sequential rank-update timing for an
online ingest lane (counterpart of
pulseportraiture_tpu/timing/incremental.py).

The batch fit (timing/gls.py) rebuilds and re-solves the whole
campaign's whitened system on every call — O(n p^2) per update once a
watch folder is appending TOAs one archive at a time.  This module
keeps the UN-NORMALIZED normal equations (M = A^T A, b = A^T r)
resident and folds each new wideband TOA in as a rank-2 update (one
whitened arrival-time row + one whitened DM row), then reproduces
``gls_solve_np``'s exact algorithm from the accumulated quantities:
the column norms it normalizes by are sqrt(diag(M)), so the
column-normalized normal matrix, the pseudoinverse, the covariance
and the parameter vector all come out of M and b alone — O(p^2)
memory and O(p^3) solve per update, independent of campaign length.

Two structural events break the pure rank-update picture and are
handled explicitly:

* DMX COLUMN GROWTH — a new observing epoch adds a (time + DM) design
  column.  Old rows have exactly zero in the new column, so M and b
  grow by a zero row/column and the update proceeds; nothing is
  recomputed.
* EPOCH RENUMBERING — a TOA arriving out of time order can change the
  epoch assignment of PREVIOUS TOAs (``_group_epochs`` is defined on
  the sorted MJDs).  That invalidates the accumulated columns, so the
  lane detects it and rebuilds from ``build_gls_system`` (a structural
  resolve), keeping correctness for arbitrary arrival order.

The batch solver stays the DIGIT ORACLE: every ``resolve_every``
updates (config.gls_resolve_every) the lane rebuilds the full system,
compares solutions, and REFUSES loudly (``GLSDriftError``) if the
incremental parameters drifted beyond ``drift_tol`` — float
accumulation is not allowed to rot silently.  The resolve also
re-anchors the accumulated state to the batch system, so drift can
never compound across resolve windows.

Host NumPy, as in the JAX package; the binary partials come from the
torch op run with device="cpu", as in timing/gls.build_gls_system.
"""

import numpy as np

from .. import config
from .gls import build_gls_system, finalize_gls, gls_solve_np
from ..config import Dconst
from . import binary as _binary

__all__ = ["IncrementalGLS", "GLSDriftError"]

SECPERDAY = 86400.0


class GLSDriftError(ValueError):
    """The incremental solution drifted from the batch oracle beyond
    tolerance at a periodic resolve — the accumulated normal equations
    are no longer trustworthy and the caller must restart the lane
    (or investigate the campaign: a drift this large usually means the
    system turned ill-conditioned, not that float addition failed)."""


def _solve_from_normal(M, b):
    """``gls_solve_np`` reproduced from the accumulated normal
    equations: col_j = sqrt(M_jj) is exactly sqrt((A**2).sum(axis=0)),
    so the normalized normal matrix is M / (col col^T) and the
    normalized RHS is b / col."""
    col = np.sqrt(np.maximum(np.diag(M), 0.0))
    col = np.where(col > 0, col, 1.0)
    Mn = (M / col[:, None]) / col[None, :]
    bn = b / col
    N = np.linalg.pinv(Mn)
    xn = N @ bn
    x = xn / col
    cov = (N / col[:, None]) / col[None, :]
    perr = np.sqrt(np.maximum(np.diag(cov), 0.0))
    return x, perr, cov


class IncrementalGLS:
    """Sequential wideband GLS over a growing TOA stream.

    >>> lane = IncrementalGLS(par)
    >>> for toa in stream:          # timing.tim.TimTOA
    ...     result = lane.update(toa)   # WidebandGLSResult or None
    ``update`` returns None until two usable TOAs have arrived (the
    batch fit's own minimum); after that every call returns the
    current full WidebandGLSResult, digit-comparable to running
    ``wideband_gls_fit`` on the TOAs seen so far.

    resolve_every: full batch resolves + drift gate every N updates
    (default config.gls_resolve_every; 0 disables the periodic gate —
    structural resolves on epoch renumbering still happen).
    drift_tol: max |x_inc - x_batch| (absolute + relative) tolerated
    at a resolve before GLSDriftError.
    tracer: optional telemetry.Tracer; every full resolve bumps its
    ``incremental_resolves`` counter.
    """

    def __init__(self, par, fit_f0=True, fit_f1=False, fit_binary=True,
                 epoch_gap_days=0.5, resolve_every=None,
                 drift_tol=1e-10, allow_wraps=False, tracer=None):
        self.tracer = tracer
        self.par = par
        self.fit_f0 = fit_f0
        self.fit_f1 = fit_f1
        self.fit_binary = fit_binary
        self.epoch_gap_days = float(epoch_gap_days)
        self.resolve_every = (config.gls_resolve_every
                              if resolve_every is None
                              else int(resolve_every))
        self.drift_tol = float(drift_tol)
        self.allow_wraps = allow_wraps
        self.n_updates = 0
        self.n_resolves = 0

        # par-derived constants, validated exactly like the batch fit
        # (build_gls_system refuses unmodeled binary keys etc.; run a
        # cheap dry parse now so a bad par fails at construction, not
        # at the 2nd TOA)
        def fget(key, default=None):
            v = par.get(key, default)
            return (float(str(v).replace("D", "E"))
                    if v is not None else None)

        if fget("PEPOCH") is None:
            raise ValueError(
                "IncrementalGLS: parfile is missing PEPOCH")
        if fget("F0") is None and fget("P0") is None:
            raise ValueError(
                "IncrementalGLS: parfile has neither F0 nor P0")
        self._PEPOCH = fget("PEPOCH")
        self._DM0 = fget("DM", 0.0)
        from ..utils.spin import spin_F0

        self._F0r = spin_F0(par)
        self._F0 = float(self._F0r)
        self._bp = (_binary.parse_binary(par)
                    if hasattr(par, "get") else None)

        self._toas = []          # usable TOAs, arrival order
        self._n_dropped = 0
        self._names = None       # global column names (fixed)
        self._nep = 0
        self._M = None           # (p, p) accumulated A^T A
        self._b = None           # (p,) accumulated A^T r
        self._rows_t = []        # whitened time rows (len p_at_birth)
        self._rows_d = []        # whitened DM rows
        self._r_w = []           # (r_t_w, r_d_w) per TOA
        self._solution = None    # latest WidebandGLSResult

    # ------------------------------------------------------------------
    def _toa_row(self, toa, epoch, nep):
        """One TOA's whitened (time row, DM row, r_t, r_d) exactly as
        ``build_gls_system`` constructs them — same column order, same
        exact-rational phase reduction."""
        from ..utils.spin import day_phase_frac

        freq = float(toa.frequency)
        mjd_i = np.int64(toa.mjd_int)
        mjd_f = float(toa.mjd_frac)
        sig_t = float(toa.error_us) * 1e-6
        dm_err = float(toa.dm_err)

        delay_s = 0.0
        dparts = None
        if self._bp is not None:
            d, parts = _binary.binary_delay_and_partials(
                self._bp, np.array([mjd_i]), np.array([mjd_f]),
                device="cpu")
            delay_s = float(d[0])
            dparts = parts[:, 0].numpy()

        finite = np.isfinite(freq)
        disp_s = Dconst * self._DM0 * freq ** -2.0 if finite else 0.0
        pep = self._PEPOCH
        dt_s = ((int(mjd_i) - int(pep)) * SECPERDAY
                + (mjd_f - (pep - int(pep))) * SECPERDAY
                - disp_s - delay_s)

        phase = (day_phase_frac(self._F0r, int(pep), int(mjd_i))
                 + self._F0 * ((mjd_f - (pep - int(pep))) * SECPERDAY
                               - disp_s - delay_s))
        dphase = phase - np.round(phase)
        r_t = dphase / self._F0

        cols = {"OFFSET": 1.0}
        if self.fit_f0:
            cols["F0"] = -dt_s / self._F0
        if self.fit_f1:
            cols["F1"] = -0.5 * dt_s ** 2.0 / self._F0
        if self._bp is not None and self.fit_binary:
            for name, v in zip(self._bp.param_names, dparts):
                cols[name] = float(v)
        names = list(cols)
        nglob = len(names)
        row_t = np.zeros(nglob + nep)
        for j, k in enumerate(names):
            row_t[j] = cols[k]
        if finite:
            row_t[nglob + epoch] = Dconst * freq ** -2.0
        row_d = np.zeros(nglob + nep)
        row_d[nglob + epoch] = 1.0
        r_d = float(toa.dm) - self._DM0

        return (names, row_t / sig_t, row_d / dm_err,
                r_t / sig_t, r_d / dm_err, sig_t, dm_err, r_t, r_d)

    def _rebuild(self):
        """Structural resolve: rebuild the accumulated state from the
        batch system (epoch renumbering, or re-anchoring after a
        periodic resolve)."""
        system = build_gls_system(
            self._toas, self.par, fit_f0=self.fit_f0,
            fit_f1=self.fit_f1, fit_binary=self.fit_binary,
            epoch_gap_days=self.epoch_gap_days,
            allow_wraps=self.allow_wraps)
        n = system.n
        self._names = list(system.names)
        self._nep = int(system.nep)
        A, r = system.A, system.r
        self._M = A.T @ A
        self._b = A.T @ r
        self._rows_t = [A[i].copy() for i in range(n)]
        self._rows_d = [A[n + i].copy() for i in range(n)]
        self._r_w = [(float(r[i]), float(r[n + i])) for i in range(n)]
        return system

    def _epochs(self, mjds):
        from .gls import _group_epochs

        return _group_epochs(np.asarray(mjds), self.epoch_gap_days)

    def _system_bunch(self):
        """A build_gls_system-shaped bunch assembled from the resident
        state, for finalize_gls."""
        from ..utils.bunch import DataBunch

        n = len(self._toas)
        mjds = [t.mjd_int + t.mjd_frac for t in self._toas]
        epochs = self._epochs(mjds)
        p = len(self._names) + self._nep
        A = np.zeros((2 * n, p))
        r = np.zeros(2 * n)
        for i in range(n):
            A[i, :len(self._rows_t[i])] = self._rows_t[i]
            A[n + i, :len(self._rows_d[i])] = self._rows_d[i]
            r[i], r[n + i] = self._r_w[i]
        sig_t = np.array([t.error_us * 1e-6 for t in self._toas])
        dm_errs = np.array([t.dm_err for t in self._toas])
        return DataBunch(
            A=A, r=r, names=self._names, nep=self._nep, epochs=epochs,
            sig_t=sig_t, dm_errs=dm_errs,
            errs_us=np.array([t.error_us for t in self._toas]),
            r_t=r[:n] * sig_t, r_d=r[n:] * dm_errs, n=n,
            n_dropped=self._n_dropped, binary=self._bp)

    # ------------------------------------------------------------------
    def update(self, toa):
        """Fold one TimTOA into the solution.  Returns the current
        WidebandGLSResult (None until >= 2 usable TOAs)."""
        if toa.dm is None or not toa.dm_err:
            self._n_dropped += 1
            return self._solution
        self._toas.append(toa)
        n = len(self._toas)
        if n < 2:
            return None
        self.n_updates += 1

        mjds = [t.mjd_int + t.mjd_frac for t in self._toas]
        epochs = self._epochs(mjds)
        structural = (
            self._M is None
            or len(self._rows_t) != n - 1
            or not np.array_equal(
                self._epochs(mjds[:-1]), epochs[:-1]))
        if structural:
            # first solvable update, or epoch renumbering: batch build
            self._rebuild()
        else:
            epoch = int(epochs[-1])
            if epoch >= self._nep:
                # DMX column growth: old rows are exactly zero in the
                # new column, so M/b grow by a zero row/column
                grow = epoch + 1 - self._nep
                self._M = np.pad(self._M, ((0, grow), (0, grow)))
                self._b = np.pad(self._b, (0, grow))
                self._nep = epoch + 1
            (_names, a_t, a_d, rt_w, rd_w, _sig, _dme, _rt, _rd) = \
                self._toa_row(toa, epoch, self._nep)
            self._M += np.outer(a_t, a_t) + np.outer(a_d, a_d)
            self._b += a_t * rt_w + a_d * rd_w
            self._rows_t.append(a_t)
            self._rows_d.append(a_d)
            self._r_w.append((rt_w, rd_w))

        x, perr, _cov = _solve_from_normal(self._M, self._b)
        system = self._system_bunch()
        # gls_solve_np's post = r - An @ xn == r - A @ x up to
        # normalization round-off; the raw form is the same math
        post = system.r - system.A @ x
        chi2 = float((post ** 2.0).sum())
        self._solution = finalize_gls(system, x, perr, post, chi2)

        if self.resolve_every and \
                self.n_updates % self.resolve_every == 0:
            self.resolve()
        return self._solution

    def resolve(self):
        """Full batch resolve: rebuild the system, gate incremental
        drift against the oracle, re-anchor the accumulated state.
        Returns the batch WidebandGLSResult."""
        x_inc = None
        if self._M is not None:
            x_inc, _, _ = _solve_from_normal(self._M, self._b)
        system = self._rebuild()
        x, perr, _cov, post, chi2 = gls_solve_np(system.A, system.r)
        self.n_resolves += 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.counter("incremental_resolves")
        if x_inc is not None and len(x_inc) == len(x):
            scale = np.maximum(1.0, np.abs(x))
            drift = float(np.max(np.abs(x_inc - x) / scale))
            if drift > self.drift_tol:
                raise GLSDriftError(
                    f"incremental GLS drifted {drift:.3e} from the "
                    f"batch oracle after {self.n_updates} update(s) "
                    f"(tolerance {self.drift_tol:.1e}) — the "
                    "accumulated normal equations are not "
                    "trustworthy; restart the lane")
        self._solution = finalize_gls(system, x, perr, post, chi2)
        return self._solution

    @property
    def result(self):
        """Latest WidebandGLSResult (None before 2 usable TOAs)."""
        return self._solution
