"""Stage-attribution profiler for device programs (counterpart of
pulseportraiture_tpu/profiling.py).

Answers "where does a batch's time go?" with numbers that hold on an
asynchronous device:

- **Slope timing** (:func:`devtime`): K calls are queued back to back,
  each result reduced to a scalar ON THE DEVICE (an on-device
  ``.sum()``), and the host syncs once, with ``.item()`` on the last
  scalar; the slope between the K-call and 1-call walls is the
  steady-state device time.  Min over ``nrun`` measurements, the usual
  estimator of the unloaded cost.  On CUDA the K calls queue
  asynchronously, so the slope holds; a function that synchronizes
  inside itself (a convergence read with ``.item()``, a host copy) turns
  its slope into wall time, host work included.
- **Prefix stages**: cumulative slices of the real program, each
  measured on its own; a stage's cost is the difference between its
  prefix's slope and the previous prefix's.
- **Piece stages**: what follows the last prefix, measured on
  precomputed inputs (e.g. the Newton loop on a prepared cross-spectrum).
- **The attribution check**: ``attributed = slope(last prefix) +
  sum(pieces)`` against the full program's slope.  The sum is built
  only from programs measured on their own, never from differences that
  include the full slope (which would telescope to 1 by construction).

Typical use::

    stages = [
        Stage("dft",  dft_prefix_fn,  kind="prefix"),
        Stage("prep", prep_prefix_fn, kind="prefix"),
        Stage("newton", loop_on_precomputed_fn, kind="piece"),
    ]
    att = profile_stages(full_fn, stages, pick=lambda r: r.phi)
    print(att.breakdown_ms())      # {"stage_dft_ms": ..., ...}
"""

import time
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["devtime", "Stage", "StageTiming", "Attribution",
           "profile_stages"]


def _scl(x):
    """The on-device scalar reduction of a stage's result."""
    return torch.as_tensor(x).sum()


def _identity(x):
    return x


def devtime(fn, pick=_identity, K=4, warm=1, nrun=3):
    """Slope-time ``fn`` (``pick`` selects the tensor of its result to
    reduce on the device).  Returns ``(slope_s, single_s)``.

    The K calls are queued back to back, each reduced to a scalar on
    the device, with ONE host sync (``.item()``); the single synchronized
    call and the K-call run each take the MIN over ``nrun``
    measurements.  When the slope comes out non-positive (the two
    populations disagree under load), the conservative ``tK / K``
    counts one round trip against the K calls."""
    for _ in range(warm):
        _scl(pick(fn())).item()

    def single():
        t0 = time.perf_counter()
        _scl(pick(fn())).item()
        return time.perf_counter() - t0

    def krun():
        t0 = time.perf_counter()
        for _ in range(K):
            s = _scl(pick(fn()))
        s.item()
        return time.perf_counter() - t0

    t1 = min(single() for _ in range(nrun))
    tK = min(krun() for _ in range(nrun))
    slope = (tK - t1) / (K - 1)
    if slope <= 0:
        slope = tK / K
    return slope, t1


class Stage(NamedTuple):
    """One named slice of a program that can be dispatched on its own.

    kind 'prefix': a cumulative slice of the real program (each prefix
    contains the previous ones); its cost is the difference from the
    previous prefix's slope.  kind 'piece': a remainder on precomputed
    inputs (costs add directly).  ``fn`` takes no arguments (close over
    the inputs); ``pick`` selects the tensor to reduce on the device
    (default: the result itself)."""

    name: str
    fn: Callable
    kind: str = "prefix"
    pick: Callable = _identity


class StageTiming(NamedTuple):
    name: str
    kind: str
    slope_s: float   # the stage program's own slope
    cost_s: float    # attributed cost (differenced for prefixes)


class Attribution(NamedTuple):
    """profile_stages' result: the full program's slope, the per-stage
    costs and the attribution check."""

    total_s: float
    single_s: float
    stages: tuple          # of StageTiming
    attributed_s: float    # last prefix slope + sum of piece slopes
    attributed_frac: float

    def check(self, min_frac=0.9):
        """True when the stages measured on their own cover at least
        ``min_frac`` of the full slope."""
        return self.attributed_frac >= min_frac

    def cost(self, name):
        for s in self.stages:
            if s.name == name:
                return s.cost_s
        raise KeyError(name)

    def breakdown_ms(self, ndigits=2):
        """JSON-ready flat dict: each stage's attributed cost in ms, the
        full slope and the attribution fraction."""
        out = {}
        for s in self.stages:
            out[f"stage_{s.name}_ms"] = round(s.cost_s * 1e3, ndigits)
        out["full_ms"] = round(self.total_s * 1e3, ndigits)
        out["attributed_frac"] = round(self.attributed_frac, 3)
        return out


def profile_stages(full_fn, stages, pick=_identity, K=4, warm=1, nrun=3,
                   devtime_fn: Optional[Callable] = None):
    """Measure ``full_fn`` and each :class:`Stage`; return an
    :class:`Attribution`.

    ``stages``: prefixes in cumulative order, then pieces (in any
    order).  ``pick`` applies to full_fn's result.  ``devtime_fn``
    replaces the timer (tests stub it)."""
    dt = devtime_fn or devtime
    total_s, single_s = dt(full_fn, pick, K=K, warm=warm, nrun=nrun)

    timings = []
    prev_prefix = 0.0
    last_prefix = 0.0
    piece_sum = 0.0
    seen_piece = False
    for st in stages:
        if st.kind not in ("prefix", "piece"):
            raise ValueError(f"unknown stage kind {st.kind!r}")
        slope_s, _ = dt(st.fn, st.pick, K=K, warm=warm, nrun=nrun)
        if st.kind == "prefix":
            if seen_piece:
                raise ValueError(
                    "prefix stages must precede piece stages "
                    f"(got prefix {st.name!r} after a piece)")
            cost = max(slope_s - prev_prefix, 0.0)
            prev_prefix = slope_s
            last_prefix = slope_s
        else:
            seen_piece = True
            cost = slope_s
            piece_sum += slope_s
        timings.append(StageTiming(st.name, st.kind, slope_s, cost))

    attributed = last_prefix + piece_sum
    frac = attributed / total_s if total_s > 0 else float("nan")
    return Attribution(total_s, single_s, tuple(timings), attributed, frac)
