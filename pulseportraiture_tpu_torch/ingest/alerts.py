"""Anomaly alerting on the timing-residual stream (counterpart of
pulseportraiture_tpu/ingest/alerts.py: NumPy on the host, the same
semantics).

Three detectors ride the incremental GLS lane's output:

* GLITCH — a pulsar glitch is an ACHROMATIC step in rotational phase
  (and usually frequency): every post-glitch arrival lands early by
  the same amount at every observing frequency.  The detector runs a
  two-sided CUSUM on the newest TOA's whitened post-fit time residual
  — before the fit's global columns can re-absorb a recent step, the
  newest residuals carry it almost in full.
* DM STEP — an interstellar-medium event moves the dispersion measure:
  a CHROMATIC nu^-2 delay signature across the band, which the
  wideband pipeline has already collapsed into per-TOA DM
  measurements.  The detector CUSUMs each COMPLETED epoch's
  error-weighted MEASURED DM against the median of the epochs before
  it (one sample per epoch: the running estimate of an open epoch
  would double-count).  It deliberately rides the measured stream,
  NOT the fitted per-epoch DMX: at a single band-center frequency per
  TOA a DMX column doubles as a free per-epoch time offset, so the
  GLS absorbs any unmodeled ACHROMATIC step (a glitch!) into DMX —
  far cheaper in chi^2 than leaving microseconds in the time rows —
  and the fitted stream chromatically confuses the two event kinds.
  The measured DMs come straight from each archive's portrait fit and
  cannot be moved by the timing solution.
* PROFILE CHANGE — mode changes / instrumental trouble reshape the
  pulse profile without moving its arrival time: the portrait fit's
  per-TOA reduced chi^2 (the same statistic the quality gates ride)
  rises persistently.  The detector CUSUMs the gof excess over 1.

CUSUM (Page 1954): with standardized innovations z_i, accumulate
S+ = max(0, S+ + z - k) and S- = max(0, S- - z - k); an alert fires
when either crosses h.  k (config.alert_cusum_k) sets the smallest
drift that accumulates — half the step size you care about is the
classic choice — and h (config.alert_cusum_h) trades detection delay
against false alarms.  After an alarm the sums reset (one event, one
alert).

Every alert emits the ``alert`` telemetry event (kind/pulsar/mjd/
score/threshold) that pptrace's alerts section and the n_alert /
alert_fp_rate summary keys aggregate.  For synthetic corpora,
``known_events`` lets the monitor tag each alert ``fp``
(false-positive) against ground truth.
"""

import numpy as np

from .. import config
from ..telemetry import NULL_TRACER, finite

__all__ = ["CusumDetector", "AlertMonitor"]


class CusumDetector:
    """Two-sided standardized CUSUM with reset-on-alarm.

    ``update(z)`` -> None, or the crossing score (signed: negative
    means the low-side sum crossed) when |S| first exceeds h.  After a
    crossing ``last_lag`` holds the number of samples since the
    estimated CHANGE ONSET, so the alert localizes the event rather
    than the (possibly delayed) detection.  The onset estimate starts
    from the classic one — where the crossing side's sum last left
    zero — then skips leading samples whose contribution (|z| - k) is
    a negligible fraction of the window's average: a single weak noise
    sample that happened to lift the sum off zero just before a hard
    step must not pull the onset early, while a slow drift (all
    contributions comparable) still localizes at its true start.
    """

    def __init__(self, k=None, h=None):
        self.k = config.alert_cusum_k if k is None else float(k)
        self.h = config.alert_cusum_h if h is None else float(h)
        if self.h <= 0:
            raise ValueError(f"CusumDetector: h must be > 0, got "
                             f"{self.h}")
        self.s_pos = 0.0
        self.s_neg = 0.0
        self.n = 0
        self.last_lag = None
        self._pos_start = None  # sample index where s_pos left zero
        self._neg_start = None
        self._zs = []           # z history; sample n -> _zs[n-1-_z0]
        self._z0 = 0

    def _onset(self, start, sign, score):
        window = [sign * self._zs[i - 1 - self._z0] - self.k
                  for i in range(start, self.n + 1)]
        floor = 0.5 * abs(score) / len(window)
        for off, c in enumerate(window):
            if c >= floor:
                return start + off
        return start

    def update(self, z):
        z = float(z)
        self.n += 1
        self._zs.append(z)
        if len(self._zs) > 8192:
            drop = len(self._zs) - 4096
            self._zs = self._zs[drop:]
            self._z0 += drop
        prev_pos, prev_neg = self.s_pos, self.s_neg
        self.s_pos = max(0.0, self.s_pos + z - self.k)
        self.s_neg = max(0.0, self.s_neg - z - self.k)
        if self.s_pos > 0 and prev_pos == 0:
            self._pos_start = self.n
        if self.s_neg > 0 and prev_neg == 0:
            self._neg_start = self.n
        if self.s_pos > self.h or self.s_neg > self.h:
            pos = self.s_pos > self.h
            score = self.s_pos if pos else -self.s_neg
            start = self._pos_start if pos else self._neg_start
            start = max(start or self.n, self._z0 + 1)
            onset = self._onset(start, 1.0 if pos else -1.0, score)
            self.last_lag = self.n - onset + 1
            self.reset()
            return score
        return None

    def reset(self):
        self.s_pos = 0.0
        self.s_neg = 0.0
        self._pos_start = None
        self._neg_start = None


class AlertMonitor:
    """Chain the detectors onto an incremental timing stream.

    pulsar:  label for the alert events.
    warmup:  ignore the first ``warmup`` observations on the per-TOA
             arms (glitch / profile) — the earliest fits swing while
             the solution is still rank-poor, and those transients are
             not anomalies.
    dm_warmup: minimum PRIOR epochs before the DM arm feeds its CUSUM
             (default 4 — enough to estimate the epochs' intrinsic
             scatter robustly; a shorter baseline's noisy median both
             false-alarms and mislocalizes).  The arm samples once per
             completed epoch against the median of all prior epochs,
             so it self-stabilizes much faster than the per-TOA arms —
             a per-TOA-sized warmup would swallow genuine early-epoch
             steps.
    epoch_gap_days: observations separated by more than this close the
             running DM epoch (default 0.5, the incremental lane's
             epoch rule; the arm groups arrival-ordered TOAs itself so
             the measured stream needs no fit at all).
    min_amp_sigma: a dm_step alert must also carry an amplitude of at
             least this many measurement sigmas (default 3.0): the
             CUSUM's accumulate-small-drifts strength is a weakness
             for ALERTING, where a 2-sigma wiggle that technically
             crossed h is noise, not an ISM event.  Crossings below
             the floor are dropped silently (no refractory advance).
    max_gof: profile-change arm's reference gof (default
             config.quality_max_gof): the CUSUM accumulates gof - 1
             and uses (max_gof - 1) as its k, so only persistent
             excess beyond fit noise accumulates.
    known_events: optional list of {'kind', 'mjd'[, 'window_days']}
             ground-truth events; each alert is then tagged
             ``fp=True/False`` by proximity (default window 5 days) —
             detection and false-alarm checks read this.
    refractory_days: suppress repeat alerts of one kind within this
             many days of the previous crossing (default 30).  A
             persistent step keeps re-crossing a reset CUSUM until the
             fit absorbs it; chain-suppression collapses that tail
             into the single alert the event deserves, while a
             genuinely new event after a quiet gap fires fresh.

    Feed it per TOA:  ``observe(result, toa[, gof=...])`` with the
    WidebandGLSResult the incremental lane returned AFTER folding
    ``toa`` in; call ``finish()`` once the stream ends to score the
    final (still-open) measured-DM epoch.  Fired alerts accumulate in
    ``.alerts`` and emit telemetry as they happen.
    """

    def __init__(self, pulsar, tracer=None, k=None, h=None, warmup=4,
                 dm_warmup=4, epoch_gap_days=0.5, min_amp_sigma=3.0,
                 max_gof=None, known_events=None,
                 refractory_days=30.0):
        self.pulsar = str(pulsar)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.warmup = int(warmup)
        self.dm_warmup = int(dm_warmup)
        self.epoch_gap_days = float(epoch_gap_days)
        self.min_amp_sigma = float(min_amp_sigma)
        self.max_gof = (config.quality_max_gof if max_gof is None
                        else float(max_gof))
        self.known_events = ([dict(e) for e in known_events]
                             if known_events is not None else None)
        self.glitch = CusumDetector(k=k, h=h)
        self.dm = CusumDetector(k=k, h=h)
        self.profile = CusumDetector(k=max(self.max_gof - 1.0, 0.0)
                                     if k is None else k, h=h)
        self.refractory_days = float(refractory_days)
        self._last_cross = {}  # kind -> mjd of last crossing
        self.alerts = []
        self._n_obs = 0
        self._dm_fed = []      # epoch index per fed DM-arm sample
        self._ep_means = []    # closed epochs: weighted-mean measured DM
        self._ep_errs = []     # ... and its standard error
        self._ep_mjds = []     # ... and first observed-TOA MJD
        self._cur_w = 0.0      # open epoch: sum of 1/err^2
        self._cur_wd = 0.0     # ... sum of dm/err^2
        self._cur_first = None
        self._cur_last = None
        self._mjds = []        # observed-TOA MJDs, arrival order

    # -- emission -------------------------------------------------------

    def _emit(self, kind, mjd, score, threshold, **extra):
        # chain-suppression: every crossing advances the refractory
        # clock, so a persistent step's re-fires collapse into the one
        # alert already emitted
        last = self._last_cross.get(kind)
        self._last_cross[kind] = float(mjd)
        if last is not None and \
                float(mjd) - last <= self.refractory_days:
            return None
        alert = {"kind": kind, "pulsar": self.pulsar,
                 "mjd": float(mjd), "score": float(score),
                 "threshold": float(threshold)}
        if self.known_events is not None:
            alert["fp"] = not any(
                e["kind"] == kind
                and abs(float(e["mjd"]) - float(mjd))
                <= float(e.get("window_days", 5.0))
                for e in self.known_events)
        alert.update(extra)
        self.alerts.append(alert)
        if self.tracer.enabled:
            self.tracer.emit(
                "alert", kind=kind, pulsar=self.pulsar,
                mjd=finite(mjd, 6), score=finite(score, 3),
                threshold=finite(threshold, 3),
                **{k: (finite(v) if isinstance(v, float) else v)
                   for k, v in alert.items()
                   if k not in ("kind", "pulsar", "mjd", "score",
                                "threshold")})
        return alert

    # -- the observation hooks -----------------------------------------

    def _close_epoch(self):
        """Finalize the open measured-DM epoch and CUSUM it against
        the median of the epochs before it."""
        if not self._cur_w > 0:
            return
        j = len(self._ep_means)
        mean = self._cur_wd / self._cur_w
        err = float(np.sqrt(1.0 / self._cur_w))
        self._ep_means.append(float(mean))
        self._ep_errs.append(err)
        self._ep_mjds.append(float(self._cur_first))
        self._cur_w = self._cur_wd = 0.0
        self._cur_first = self._cur_last = None
        if j < self.dm_warmup:
            # too few prior epochs for a scatter estimate — don't
            # feed the detector at all (a fed-but-unemittable
            # crossing would silently consume the event)
            return
        prior = np.asarray(self._ep_means[:j], float)
        base = float(np.median(prior))
        if not err > 0:
            return
        # standardize by the measurement error and the prior epochs'
        # robust scatter in quadrature: a pulsar with intrinsic
        # epoch-to-epoch DM wander (ISM turbulence) has innovation
        # scatter beyond the formal error, and a CUSUM fed z's of
        # std > 1 turns that wander into false alarms.  The MAD is
        # immune to the few post-step outliers; the quadrature sum
        # double-counts err slightly (the scatter estimate already
        # contains it), which errs on the quiet side — the right bias
        # for an alerting system whose scatter estimate rides a
        # handful of epochs.
        scatter = 1.4826 * float(np.median(np.abs(prior - base)))
        z = (mean - base) / float(np.hypot(err, scatter))
        self._dm_fed.append(j)
        score = self.dm.update(z)
        if score is None:
            return
        # localize at the CUSUM change onset, not the (maybe delayed)
        # crossing epoch, at that epoch's first observed TOA
        lag = self.dm.last_lag or 1
        j0 = (self._dm_fed[-lag] if lag <= len(self._dm_fed) else j)
        base0 = float(np.median(np.asarray(self._ep_means[:j0],
                                           float)))
        amp = float(np.median(np.asarray(self._ep_means[j0:j + 1],
                                         float)) - base0)
        if abs(amp) < self.min_amp_sigma * self._ep_errs[j0]:
            return  # a sub-floor crossing is noise
        self._emit("dm_step", self._ep_mjds[j0], score, self.dm.h,
                   epoch=int(j0), amp=amp)

    def observe(self, result, toa, gof=None):
        """One TOA folded into the incremental solution.  Returns the
        alerts fired by this observation."""
        n_before = len(self.alerts)
        mjd = float(toa.mjd_int) + float(toa.mjd_frac)
        if toa.dm is not None and toa.dm_err:
            # mirrors the lane's usability test so _mjds stays aligned
            # with the fit's residual stream (arrival order, usable
            # TOAs only)
            self._mjds.append(mjd)
            # DM arm: accumulate the measured DM into the running
            # epoch; a gap beyond epoch_gap_days closes it and scores
            # the completed epoch
            if self._cur_last is not None and \
                    mjd - self._cur_last > self.epoch_gap_days:
                self._close_epoch()
            if self._cur_first is None:
                self._cur_first = mjd
            w = 1.0 / float(toa.dm_err) ** 2
            self._cur_w += w
            self._cur_wd += w * float(toa.dm)
            self._cur_last = mjd
        if result is not None:
            # glitch arm: the newest whitened post-fit time residual
            self._n_obs += 1
            z = (float(result.time_resids_us[-1])
                 / float(result.toa_errs_us[-1]))
            score = self.glitch.update(z)
            if score is not None and self._n_obs > self.warmup:
                # localize at the change start (glitch sample i rode
                # the i+1-th usable TOA: the first usable TOA yields
                # no fit yet)
                lag = self.glitch.last_lag or 1
                idx = len(self._mjds) - lag
                mjd_ev = (self._mjds[idx]
                          if 0 <= idx < len(self._mjds) else mjd)
                self._emit("glitch", mjd_ev, score, self.glitch.h)
        if gof is None and getattr(toa, "flags", None):
            gof = toa.flags.get("gof")
        if gof is not None:
            # one-sided: only EXCESS gof is an anomaly — a stream
            # whose gof sits persistently below 1 (conservative error
            # bars) must not accumulate on the low side
            score = self.profile.update(max(float(gof) - 1.0, 0.0))
            if score is not None and self.profile.n > self.warmup:
                self._emit("profile_change", mjd, score,
                           self.profile.h, gof=float(gof))
        return self.alerts[n_before:]

    def finish(self):
        """Score the final (still-open) measured-DM epoch; call when
        the stream ends.  Returns alerts fired."""
        n_before = len(self.alerts)
        self._close_epoch()
        return self.alerts[n_before:]
