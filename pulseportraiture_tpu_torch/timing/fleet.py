"""Fleet-batched wideband GLS timing: every pulsar's solution from a
handful of padded batched solves (counterpart of
pulseportraiture_tpu/timing/fleet.py).

A PTA campaign ends with N_psr independent linear solves, each
milliseconds of math behind a full launch and transfer floor.  So:

* the LINEARIZATION stays on host (timing/gls.build_gls_system —
  exact rational spin-phase reduction per pulsar; f64 host work that
  no accelerator improves at these sizes);
* the SOLVES are bucketed by power-of-two (rows, params) class,
  zero-padded (extra rows and columns are exactly inert: zero rows
  add nothing to the normal equations, zero columns ride the
  pseudoinverse's null space out with zero value and zero error),
  the batch axis padded to its own power of two with all-zero
  systems, and each bucket solved by ONE batched torch program
  (``_solve_program``) on the fleet's device in float64;
* that program mirrors timing/gls.gls_solve_np op-for-op
  (column-normalized normal equations through a pseudoinverse), so
  batched-vs-serial stays digit-comparable: the serial lane runs the
  SAME padded program one pulsar at a time (batched=False), and the
  host lane (gls_device=False) is the NumPy oracle.

Where the JAX package names the lane tri-state ``device``, the port
names it ``gls_device``: ``device`` is the torch device on every port
entry point.  ``telemetry=`` writes the JAX package's events
(telemetry.py): one ``timing_fit`` per solve dispatch and a
``fleet_end`` rollup, on whatever tracer the caller threads through
(stream_ipta_campaign passes its campaign tracer, so archives -> TOAs
-> timing solutions land in one trace).
"""

import time

import numpy as np
import torch

from ..device import resolve_auto, resolve_device
from ..telemetry import log, resolve_tracer
from ..utils.bunch import DataBunch
from .gls import build_gls_system, finalize_gls, gls_solve_np
from .tim import TimTOA, read_tim

__all__ = ["TimingJob", "fleet_gls_fit", "toas_from_measurements",
           "resolve_gls_device", "fleet_stats"]

# the last fleet_gls_fit's bucket shapes, host linearization wall and
# per-solve walls, for chip_smoke's fleet lines
_STATS = {}


def fleet_stats():
    """The last fleet_gls_fit call's record: the linearization wall [s]
    and one dict per solve call (bucket, B, rows, wall_s; on CUDA also
    ms, its CUDA-event time)."""
    return dict(_STATS)


def _pow2(n):
    """Smallest power of two >= n (>= 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def resolve_gls_device(setting=None, device=None):
    """Tri-state resolution of the fleet solve lane, mirroring the
    align_device/gauss_device convention: None follows
    config.gls_device; 'auto' = on for a CUDA ``device``; True/False
    force.  Loud on anything else."""
    if setting is None:
        from .. import config

        setting = getattr(config, "gls_device", "auto")
    return resolve_auto("gls_device", setting, resolve_device(device),
                        label="gls_device")


class TimingJob:
    """One pulsar's timing problem: TOAs + parfile (+ per-pulsar fit
    overrides forwarded to build_gls_system, e.g. fit_f1=True for the
    one pulsar with a measurable spindown)."""

    def __init__(self, pulsar, toas, par, **fit_kwargs):
        self.pulsar = str(pulsar)
        if isinstance(toas, str):
            toas = read_tim(toas)
        self.toas = list(toas)
        if isinstance(par, str):
            from ..io.psrfits import parse_parfile

            par = parse_parfile(par)
        self.par = par
        self.fit_kwargs = dict(fit_kwargs)


def toas_from_measurements(toa_list):
    """Adapt pipeline TOA objects (io/tim.TOA, as collected by
    GetTOAs / the streaming entry points) to the TimTOA records the timing
    fit consumes — the in-memory equivalent of writing and re-reading
    a .tim file, minus the formatting round-trip."""
    out = []
    for t in toa_list:
        out.append(TimTOA(
            archive=str(t.archive), frequency=float(t.frequency),
            mjd_int=int(t.MJD.day), mjd_frac=float(t.MJD.frac),
            error_us=float(t.TOA_error), site=str(t.telescope_code),
            dm=None if t.DM is None else float(t.DM),
            dm_err=None if t.DM_error is None else float(t.DM_error),
            flags=dict(t.flags)))
    return out


def _solve_program(A, r):
    """gls_solve_np over a padded (B, m, p) float64 batch: column
    normalization, normal equations, batched pseudoinverse, whitened
    post-fit residuals.  Returns (x, perr, post, chi2).

    The pseudoinverse's cut-off is JAX's default, passed explicitly:
    ``rtol = 10 * max(p, p) * eps`` relative to the largest singular
    value (torch's default is max(p, p) * eps, NumPy's rcond 1e-15), so
    a marginal system drops the same directions as the JAX program.
    An all-zero pad system has no singular value above the cut-off and
    comes out as zeros; a zero pad column has norm 0, kept at 1 by the
    ``col > 0`` guard, and rides the null space out with zero value
    and zero error.

    Each row's arithmetic must not depend on the batch width B, or the
    serial lane (B = 1) and the batched lane part by cond(G) x eps (~1e-9
    on a decade-long BT campaign): the column norms and G keep their
    batched-matmul form, and the three matrix-vector products are
    elementwise products summed along their contiguous last axis,
    because a matrix-vector product takes other kernels at B = 1 than at
    B = 64 on the CPU and on the card."""
    col = torch.sqrt(torch.sum(A * A, dim=-2))
    col = torch.where(col > 0, col, torch.ones_like(col))
    An = A / col[..., None, :]
    G = An.transpose(-1, -2) @ An
    p = G.shape[-1]
    N = torch.linalg.pinv(G, rtol=10.0 * p * torch.finfo(G.dtype).eps)
    Atr = torch.sum(An.transpose(-1, -2).contiguous() * r[..., None, :],
                    dim=-1)
    xn = torch.sum(N * Atr[..., None, :], dim=-1)
    x = xn / col
    perr = torch.sqrt(torch.clamp(
        torch.diagonal(N, dim1=-2, dim2=-1), min=0.0)) / col
    post = r - torch.sum(An * xn[..., None, :], dim=-1)
    chi2 = torch.sum(post * post, dim=-1)
    return x, perr, post, chi2


def _solve_bucket(systems, nrow, nparam, batched, key, dev, records,
                  tracer):
    """Solve a list of (index, system) pairs in one padded call
    (batched=True) or one B=1 call per system (the serial A/B arm) on
    ``dev``.  Returns {index: (x, perr, post, chi2)}."""
    out = {}
    groups = [systems] if batched else [[s] for s in systems]
    cuda = dev.type == "cuda"
    for group in groups:
        B = _pow2(len(group)) if batched else 1
        A = np.zeros((B, nrow, nparam))
        r = np.zeros((B, nrow))
        for b, (_, s) in enumerate(group):
            m, p = s.A.shape
            A[b, :m, :p] = s.A
            r[b, :m] = s.r
        t0 = time.perf_counter()
        At = torch.as_tensor(A, dtype=torch.float64, device=dev)
        rt = torch.as_tensor(r, dtype=torch.float64, device=dev)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        res = _solve_program(At, rt)
        if cuda:
            ev[1].record()
        x, perr, post, chi2 = (v.cpu().numpy() for v in res)
        rec = dict(bucket=key, B=B, rows=len(group),
                   wall_s=time.perf_counter() - t0)
        if cuda:
            rec["ms"] = ev[0].elapsed_time(ev[1])
        records.append(rec)
        if tracer.enabled:
            tracer.emit("timing_fit", bucket=key, rows=len(group),
                        pad=B - len(group), wall_s=round(rec["wall_s"], 6),
                        batched=bool(batched))
        for b, (idx, s) in enumerate(group):
            m, p = s.A.shape
            out[idx] = (x[b, :p], perr[b, :p], post[b, :m],
                        float(chi2[b]))
    return out


def fleet_gls_fit(jobs, fit_f0=True, fit_f1=False, fit_binary=True,
                  epoch_gap_days=0.5, allow_wraps=False, gls_device=None,
                  batched=True, telemetry=None, quiet=True, device=None):
    """Wideband GLS timing solutions for a whole pulsar fleet.

    jobs: sequence of TimingJob (or (pulsar, toas, par) tuples; toas
    may be a .tim path, par a parfile path).  Fit options are
    campaign-wide defaults; per-job fit_kwargs override.

    gls_device: the lane (the JAX package's ``device``): None follows
    config.gls_device ('auto' = on for a CUDA ``device``); False =
    host-NumPy per-pulsar solves (the oracle lane); True = bucketed
    batched solves on ``device`` (default cuda).  batched: True packs
    each power-of-two (rows, params) bucket into one call; False runs
    the SAME padded program per pulsar — the serial arm (only
    meaningful with the batched lane).

    telemetry: tracer or path (resolve_tracer semantics); one
    ``timing_fit`` per solve dispatch and a ``fleet_end`` rollup.

    Returns DataBunch(pulsars, results={pulsar: WidebandGLSResult},
    n_dispatches, wall_s, device, batched), ``device`` True when the
    batched lane ran, as in the JAX package.  A pulsar whose parfile or
    TOAs are invalid raises the underlying loud error naming it — a
    fleet with a broken member should fail visibly, not drop it.
    """
    dev = resolve_device(device)
    jobs = [j if isinstance(j, TimingJob) else TimingJob(*j)
            for j in jobs]
    names = [j.pulsar for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate pulsar names in jobs: {names}")
    use_device = resolve_gls_device(gls_device, dev)
    tracer, own_tracer = resolve_tracer(telemetry, run="fleet_gls_fit")
    t0 = time.time()
    try:
        systems = []
        for j in jobs:
            kw = dict(fit_f0=fit_f0, fit_f1=fit_f1, fit_binary=fit_binary,
                      epoch_gap_days=epoch_gap_days,
                      allow_wraps=allow_wraps)
            kw.update(j.fit_kwargs)
            try:
                systems.append(build_gls_system(j.toas, j.par, **kw))
            except Exception as e:
                raise type(e)(f"fleet_gls_fit: pulsar {j.pulsar!r}: "
                              f"{e}") from e
        records = []
        _STATS.clear()
        _STATS.update(linearize_s=time.time() - t0, solves=records)

        solved = {}
        n_dispatches = 0
        if not use_device:
            for i, s in enumerate(systems):
                t1 = time.perf_counter()
                x, perr, _, post, chi2 = gls_solve_np(s.A, s.r)
                solved[i] = (x, perr, post, chi2)
                m, p = s.A.shape
                wall1 = time.perf_counter() - t1
                records.append(dict(bucket=f"host:{m}x{p}", B=1, rows=1,
                                    wall_s=wall1))
                if tracer.enabled:
                    tracer.emit("timing_fit", bucket=f"host:{m}x{p}",
                                rows=1, pad=0, wall_s=round(wall1, 6),
                                batched=False)
                n_dispatches += 1
        else:
            buckets = {}
            for i, s in enumerate(systems):
                m, p = s.A.shape
                buckets.setdefault((_pow2(m), _pow2(p)),
                                   []).append((i, s))
            for (mm, pp), group in sorted(buckets.items()):
                solved.update(_solve_bucket(group, mm, pp, batched,
                                            f"{mm}x{pp}", dev, records,
                                            tracer))
                n_dispatches += 1 if batched else len(group)

        results = {}
        for i, (j, s) in enumerate(zip(jobs, systems)):
            x, perr, post, chi2 = solved[i]
            results[j.pulsar] = finalize_gls(s, x, perr, post, chi2)
        wall = time.time() - t0
        tracer.emit("fleet_end", n_pulsars=len(jobs),
                    n_dispatches=n_dispatches, wall_s=round(wall, 6))
        log(f"fleet GLS: {len(jobs)} pulsar(s) solved in "
            f"{n_dispatches} dispatch(es) "
            f"({'device' if use_device else 'host'}"
            f"{', batched' if use_device and batched else ''}) in "
            f"{wall:.3f} s", quiet=quiet, tracer=tracer)
    finally:
        if own_tracer:
            tracer.close()
    return DataBunch(pulsars=names, results=results,
                     n_dispatches=n_dispatches, wall_s=wall,
                     device=use_device, batched=bool(batched))
