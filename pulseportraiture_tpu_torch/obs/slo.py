"""SLO engine: per-tenant latency objectives with multi-window
burn-rate tracking (counterpart of pulseportraiture_tpu/obs/slo.py).

An objective is "fraction ``objective`` of a tenant's requests finish
within ``target_s`` seconds".  The error budget is ``1 - objective``;
the burn rate over a window is the window's bad-request fraction
divided by the budget, so burn 1.0 means "consuming budget exactly at
the sustainable rate" and burn 10 means "the whole budget gone in a
tenth of the period".  Following the standard multi-window alerting
pattern, a breach fires only when BOTH the short and the long window
burn above threshold — the short window gives fast detection, the long
window keeps a transient blip from paging — and it is edge-triggered:
one ``slo_breach`` event per excursion, re-armed when the short window
recovers.

Window accounting is time-bucketed ring counters (no sample
retention): constant memory per (tenant, window), O(1) per observe.
"""

import threading
import time

DEFAULT_WINDOWS = (300.0, 3600.0)  # 5 min fast-burn, 1 h slow-burn
_NBUCKETS = 30


class _WindowCounts:
    """Ring of (total, bad) counts over a sliding window."""

    def __init__(self, window_s):
        self.window_s = float(window_s)
        self.bucket_s = self.window_s / _NBUCKETS
        self._ring = [[0, 0] for _ in range(_NBUCKETS)]
        self._epoch = None  # absolute bucket index of _ring[0]'s slot

    def _advance(self, now):
        idx = int(now / self.bucket_s)
        if self._epoch is None:
            self._epoch = idx - _NBUCKETS + 1
        shift = idx - (self._epoch + _NBUCKETS - 1)
        if shift >= _NBUCKETS:
            for slot in self._ring:
                slot[0] = slot[1] = 0
            self._epoch = idx - _NBUCKETS + 1
        elif shift > 0:
            for i in range(shift):
                self._ring[(self._epoch + i) % _NBUCKETS] = [0, 0]
            self._epoch += shift
        return idx

    def add(self, now, bad):
        idx = self._advance(now)
        slot = self._ring[idx % _NBUCKETS]
        slot[0] += 1
        if bad:
            slot[1] += 1

    def rates(self, now):
        self._advance(now)
        total = sum(s[0] for s in self._ring)
        bad = sum(s[1] for s in self._ring)
        return total, bad


class SloTracker:
    """Per-tenant latency-objective tracker.

    ``targets`` maps tenant -> latency threshold in seconds; the ``*``
    key is the default applied to tenants without their own entry (the
    ``parse_tenant_spec`` convention).  Tenants with no applicable
    target are observed for attainment bookkeeping but never burn or
    breach.  ``clock`` is injectable for deterministic tests."""

    def __init__(self, targets, objective=0.99, windows=DEFAULT_WINDOWS,
                 burn_threshold=10.0, clock=time.monotonic):
        self._targets = dict(targets or {})
        self.objective = float(objective)
        self.budget = max(1.0 - self.objective, 1e-9)
        self.windows = tuple(float(w) for w in windows)
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        self._good = {}      # tenant -> lifetime within-target count
        self._total = {}     # tenant -> lifetime observed count
        self._wins = {}      # tenant -> {window_s: _WindowCounts}
        self._alerting = set()

    def target_for(self, tenant):
        t = self._targets.get(tenant, self._targets.get("*"))
        return float(t) if t is not None else None

    def observe(self, tenant, latency_s, now=None):
        """Account one finished request.  Returns a breach record dict
        the first time a tenant crosses into fast-burn (both windows
        above threshold), else None."""
        target = self.target_for(tenant)
        if now is None:
            now = self._clock()
        with self._lock:
            self._total[tenant] = self._total.get(tenant, 0) + 1
            if target is None:
                return None
            bad = latency_s > target
            if not bad:
                self._good[tenant] = self._good.get(tenant, 0) + 1
            wins = self._wins.get(tenant)
            if wins is None:
                wins = self._wins[tenant] = {
                    w: _WindowCounts(w) for w in self.windows}
            for wc in wins.values():
                wc.add(now, bad)
            burns = {}
            for w, wc in wins.items():
                total, nbad = wc.rates(now)
                burns[w] = (nbad / total / self.budget) if total else 0.0
            hot = all(b >= self.burn_threshold for b in burns.values())
            if hot and tenant not in self._alerting:
                self._alerting.add(tenant)
                return {"tenant": tenant, "target_s": target,
                        "burn_short": round(burns[self.windows[0]], 3),
                        "burn_long": round(burns[self.windows[-1]], 3),
                        "window_s": self.windows[0]}
            if not hot and burns[self.windows[0]] < self.burn_threshold:
                self._alerting.discard(tenant)
        return None

    def burn_rate(self, tenant, window_s, now=None):
        if now is None:
            now = self._clock()
        with self._lock:
            wins = self._wins.get(tenant)
            if not wins or window_s not in wins:
                return 0.0
            total, nbad = wins[window_s].rates(now)
        return (nbad / total / self.budget) if total else 0.0

    def snapshot(self, now=None):
        """Per-tenant attainment + burn rates, for the metrics export."""
        if now is None:
            now = self._clock()
        out = {}
        with self._lock:
            for tenant, total in self._total.items():
                target = self.target_for(tenant)
                good = self._good.get(tenant, 0)
                ent = {"target_s": target, "total": total,
                       "good": good,
                       "attainment": round(good / total, 4) if total
                       and target is not None else None,
                       "alerting": tenant in self._alerting}
                wins = self._wins.get(tenant) or {}
                burns = {}
                for w, wc in wins.items():
                    wt, wb = wc.rates(now)
                    burns[str(int(w))] = round(
                        wb / wt / self.budget, 3) if wt else 0.0
                ent["burn"] = burns
                out[tenant] = ent
        return out
