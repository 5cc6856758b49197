"""The per-backend autotune harness (counterpart of
pulseportraiture_tpu/tune/autotune.py).

- **Knob tiers.**  :data:`IDENTITY_TIER` holds only knobs whose every
  value is documented output-identical (the plain fused version's block,
  bucket padding, pipeline depth, the batched LM's compaction, the
  harmonic window), and the harness does not trust the documentation:
  every candidate's artifact (whatever ``run_fn`` returns: .tim bytes
  or a digest) is gated byte-identical against the default's before its
  time counts.  :data:`NUMERICS_TIER` changes digits; it is swept only
  behind the explicit ``numerics=True`` opt-in and is exempt from the
  byte gate.
- **Min-of-N timing**: each candidate is timed ``nrun`` times and the
  minimum wall compared; ``time_fn`` is injectable, so tests sweep
  without a clock.
- **Per-knob sweep, then a combined no-regression gate**: each knob is
  swept against the default config alone; the combined winners are
  checked again (bytes and wall) and fall back to the defaults on a
  regression, so ``tuned_s <= default_s`` in every result.
- **Persistence**: winners go to the JSON tuning DB
  (tune/store.TuningStore) keyed (backend fingerprint, shape class);
  :func:`ensure_tuned` on a warm DB applies the stored knobs and sweeps
  nothing (``tune_apply`` with ``db_hit`` true, no ``tune_sweep``).

The DB keys and the trace events (``tune_probe``, ``tune_sweep``,
``tune_apply``) are the JAX package's, so the two packages read each
other's DBs under one fingerprint.
"""

import contextlib
import time
from typing import NamedTuple

from ..telemetry import NULL_TRACER
from .capability import capability_record
from .store import TuningStore

__all__ = ["Knob", "IDENTITY_TIER", "NUMERICS_TIER", "SweepResult",
           "tuned_config", "shape_class_for", "sweep", "ensure_tuned",
           "apply_knobs", "apply_from_db"]


class Knob(NamedTuple):
    """One sweepable knob: ``name`` is both the config attribute and the
    tuning-DB key; ``candidates`` are the values tried beyond the current
    config value (the default is always in the comparison)."""

    name: str
    candidates: tuple


# Output-identical tier: the JAX package's, value for value, so the DB
# keys agree across the two packages.  On the card two of its knobs time
# the same program: the CUDA kernel tiles by its own fixed row block
# (fused_block shapes only the plain version), and lm_compact_every
# reaches only the template factory's batched LM, never the stream.
IDENTITY_TIER = (
    Knob("fused_block", (None, 8, 16, 32)),
    Knob("bucket_pad", (False, True)),
    Knob("stream_pipeline_depth", (1, 2, 4)),
    Knob("lm_compact_every", (None, 8, 16, 32)),
    Knob("fit_harmonic_window", ("auto", None)),
)

# Numerics tier: the JAX package's.  On a CUDA device dft_precision
# 'default' runs the matmul DFTs' products in TF32 (ops.fourier
# .matmul_precision); the fused kernels compute every setting in full
# precision.
NUMERICS_TIER = (
    Knob("cross_spectrum_dtype", ("bfloat16", None)),
    Knob("dft_precision", ("highest", "default")),
)


class SweepResult(NamedTuple):
    knobs: dict        # accepted winners (attr -> value); {} = defaults
    default_s: float   # min-of-N wall of the default config
    tuned_s: float     # min-of-N wall of the accepted set (<= default_s)
    n_swept: int       # candidates actually timed
    n_rejected: int    # candidates refused by the identity gate


@contextlib.contextmanager
def tuned_config(overrides):
    """Apply ``overrides`` (config attr -> value) for the block and
    restore the previous values after: the sweep's candidate isolation."""
    from .. import config

    saved = {k: getattr(config, k) for k in overrides}
    try:
        for k, v in overrides.items():
            setattr(config, k, v)
        yield
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def apply_knobs(knobs):
    """Set accepted winners on config for the rest of the process (the
    campaign's start-up, unlike the scoped tuned_config)."""
    from .. import config

    for k, v in knobs.items():
        setattr(config, k, v)


def shape_class_for(nchan, nbin):
    """The tuning DB's shape-class key of a bucket layout."""
    return f"{int(nchan)}x{int(nbin)}"


def _default_time_fn(run_fn, nrun):
    def time_fn(overrides):
        best = None
        for _ in range(max(1, int(nrun))):
            t0 = time.perf_counter()
            run_fn(overrides)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best
    return time_fn


def sweep(run_fn, knobs=None, time_fn=None, nrun=3, numerics=False,
          tracer=NULL_TRACER, shape_class="default"):
    """One full sweep against the CURRENT config values.

    ``run_fn(overrides)`` runs the representative workload under the
    candidate overrides and returns its identity artifact (.tim bytes
    or a stable digest); it must build its state afresh, so that a
    candidate's knob reaches the code.  ``time_fn(overrides)`` returns
    the candidate's wall seconds (default: the min of ``nrun`` walls of
    ``run_fn``).  Each knob sweeps on its own; an identity-tier
    candidate whose artifact differs from the default's is rejected
    before it is timed; the combined winners are checked again and fall
    back to the defaults on any regression.  One ``tune_sweep`` event
    per knob."""
    from .. import config

    if knobs is None:
        knobs = IDENTITY_TIER + (NUMERICS_TIER if numerics else ())
    if time_fn is None:
        time_fn = _default_time_fn(run_fn, nrun)
    identity_names = {k.name for k in IDENTITY_TIER}
    baseline = run_fn({})
    default_s = float(time_fn({}))
    winners = {}
    n_swept = n_rejected = 0
    for knob in knobs:
        default_val = getattr(config, knob.name)
        best_val, best_s = default_val, default_s
        rejected = []
        for cand in knob.candidates:
            if cand == default_val:
                continue
            ov = {knob.name: cand}
            gate = knob.name in identity_names or not numerics
            if gate and run_fn(ov) != baseline:
                # a value that changes the bytes is out, however fast
                rejected.append(cand)
                n_rejected += 1
                continue
            t = float(time_fn(ov))
            n_swept += 1
            if t < best_s:
                best_val, best_s = cand, t
        if tracer.enabled:
            tracer.emit(
                "tune_sweep", shape_class=str(shape_class),
                knob=knob.name, default=repr(default_val),
                winner=repr(best_val),
                n_candidates=len(knob.candidates),
                n_rejected=len(rejected),
                default_s=round(default_s, 6), best_s=round(best_s, 6))
        if best_val != default_val:
            winners[knob.name] = best_val
    tuned_s = default_s
    if winners:
        with tuned_config(winners):
            combined_ok = run_fn({}) == baseline
            t_comb = float(time_fn({})) if combined_ok else None
        if not combined_ok or t_comb > default_s:
            # the combination must beat the defaults on the bytes and
            # the clock, or the defaults ship: a tuned run is never slower
            winners = {}
        else:
            tuned_s = t_comb
    return SweepResult(knobs=winners, default_s=default_s,
                       tuned_s=tuned_s, n_swept=n_swept,
                       n_rejected=n_rejected)


def _emit_apply(tracer, shape_class, db_hit, db_path, knobs, default_s,
                tuned_s):
    if tracer.enabled:
        tracer.emit("tune_apply", shape_class=str(shape_class),
                    db_hit=db_hit,
                    db_path=str(db_path) if db_path else None,
                    knobs={k: repr(v) for k, v in knobs.items()},
                    default_s=default_s, tuned_s=tuned_s)


def ensure_tuned(run_fn, shape_class, db_path=None, knobs=None,
                 time_fn=None, nrun=3, numerics=None, tracer=NULL_TRACER,
                 apply=True, device=None):
    """The campaign entry point: return (and by default apply) the
    winning knobs of ``device``'s fingerprint (None: the default CUDA
    device) and ``shape_class``, sweeping only when the tuning DB has no
    entry.

    ``db_path`` None falls back to ``config.tune_db``; with no DB path
    the sweep runs unpersisted.  ``numerics`` None follows
    ``config.tune_numerics``.  Emits ``tune_probe`` (the capability
    record) and ``tune_apply`` (with the DB-hit witness) either way."""
    from .. import config

    if db_path is None:
        db_path = getattr(config, "tune_db", None)
    if numerics is None:
        numerics = bool(getattr(config, "tune_numerics", False))
    if tracer.enabled:
        rec = capability_record(device=device)
        tracer.emit("tune_probe", backend=rec.platform,
                    device_kind=rec.device_kind,
                    fingerprint=rec.fingerprint,
                    dispatch_floor_s=rec.dispatch_floor_s,
                    matmul_gflops=rec.matmul_gflops,
                    dft_gflops=rec.dft_gflops)
    store = TuningStore(db_path, device=device) if db_path else None
    ent = store.get(shape_class) if store else None
    if ent is not None:
        winners = dict(ent["knobs"])
        _emit_apply(tracer, shape_class, True, db_path, winners,
                    ent.get("default_s"), ent.get("tuned_s"))
        if apply:
            apply_knobs(winners)
        return winners
    res = sweep(run_fn, knobs=knobs, time_fn=time_fn, nrun=nrun,
                numerics=numerics, tracer=tracer, shape_class=shape_class)
    if store is not None:
        store.put(shape_class, res.knobs, default_s=res.default_s,
                  tuned_s=res.tuned_s, n_swept=res.n_swept,
                  identity_preserving=not numerics)
    _emit_apply(tracer, shape_class, False, db_path, res.knobs,
                round(res.default_s, 6), round(res.tuned_s, 6))
    if apply:
        apply_knobs(res.knobs)
    return res.knobs


def apply_from_db(shape_class=None, db_path=None, tracer=NULL_TRACER,
                  device=None):
    """Apply stored winners without sweeping (``ppserve --tune-db``):
    load the DB of ``device``'s fingerprint, pick ``shape_class`` (or
    the sole stored class when None), apply it and witness the hit.
    Returns the applied knobs ({} when the DB has nothing for this
    backend; the store warns when it refuses the file)."""
    from .. import config

    if db_path is None:
        db_path = getattr(config, "tune_db", None)
    if not db_path:
        return {}
    store = TuningStore(db_path, device=device)
    classes = store.shape_classes()
    if shape_class is None:
        if len(classes) != 1:
            return {}
        shape_class = classes[0]
    ent = store.get(shape_class)
    if ent is None:
        return {}
    winners = dict(ent["knobs"])
    _emit_apply(tracer, shape_class, True, db_path, winners,
                ent.get("default_s"), ent.get("tuned_s"))
    apply_knobs(winners)
    return winners
