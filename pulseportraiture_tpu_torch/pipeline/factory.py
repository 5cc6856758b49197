"""Template factory: fleet-scale Gaussian/spline model building
(counterpart of pulseportraiture_tpu/pipeline/factory.py).

`build_templates` fits MANY pulsars' profile and portrait stages per
call of the batched LM engine (fit/lm.levenberg_marquardt_batched)
instead of one ppgauss-style pulsar at a time:

- **Profile stage**: every job's breadth-first `ngauss in 1..max_ngauss`
  trial problems (matching-pursuit seeds, fit/gauss.profile_trial_seeds)
  are fused across the whole fleet, bucketed by (nbin, power-of-two
  ngauss class), and fit in one call per bucket; the best reduced chi2
  per pulsar is selected on host with the serial acceptance rule.
- **Portrait stage**: each ppgauss iteration's evolving-Gaussian
  portrait fits are bucketed by (nbin, power-of-two nchan, power-of-two
  ngauss, model code) classes — channels padded with +inf errors
  (exactly-zero residual rows), components padded frozen at zero
  amplitude, batch rows padded to the next power of two with fully-
  frozen duplicates of row 0 — while each pulsar's rotate/convergence
  bookkeeping (the (phi, DM) check and the data rotation between
  iterations) stays between batched iterations, exactly as in
  GaussPortrait.make_gaussian_model.
- **Spline jobs** ride the same batched profile lane: the S/N-weighted
  mean profile is Gaussian-smoothed by the fleet's shared profile
  call and injected into make_spline_model(smooth_mean_prof=...);
  eigenprofile smoothing stays wavelet-based (eigenvectors have
  negative lobes the sign-constrained Gaussian basis cannot represent).

Where it runs: on ``device`` (default cuda), as pipeline/gauss.py; the
JAX package pins this path to the host (utils/device.on_host) only
because some TPU runtimes cannot compile complex FFTs.  Routing:
config.gauss_device tri-state ('auto' = on for a CUDA device;
PPT_GAUSS_DEVICE; per-call gauss_device=).  The serial lane runs the
SAME padded problems one at a time through the single-problem engine
and is the digit-exactness oracle.  ``telemetry=`` writes the JAX
package's events (telemetry.py): one `template_fit` per bucket
dispatch, one `template_job` per finished template and a
`factory_end` rollup; the walls by stage also go to
pipeline.portrait.template_stats() and the call counts to
factory_stats().

JOIN (metafile) jobs are refused loudly — multi-receiver fits keep the
single-pulsar ppgauss path, whose join parameters ride the LM problem
vector.
"""

import os
import time

import numpy as np

from ..config import default_model_code, scattering_alpha
from ..device import resolve_device
from ..fit.gauss import (fit_gaussian_portraits_batched,
                         fit_gaussian_profiles_batched,
                         pad_portrait_params, pad_profile_params,
                         portrait_vary, profile_trial_seeds,
                         profile_vary, select_best_trial,
                         use_gauss_device)
from ..fit.lm import _pow2ceil, use_lm_jacobian
from ..io.gmodel import write_gmodel
from ..io.psrfits import noise_std_ps
from ..telemetry import NULL_TRACER, log, resolve_tracer
from ..utils.bunch import DataBunch
from .portrait import lap
from .toas import _is_metafile

__all__ = ["build_templates", "TemplateJob", "gauss_smooth_mean",
           "factory_stats"]

# the last build_templates call's LM calls and buckets
_STATS = {}

_RESULT_FIELDS = ("x", "x_err", "chi2", "dof", "nfev", "success",
                  "stalled")


def factory_stats():
    """The last build_templates call: ``lm_calls``, the LM engine calls
    it made (one per bucket on the batched lane, one per problem on the
    serial lane), and ``buckets``, one (stage, key, rows, padded rows)
    tuple per bucket fit."""
    return dict(_STATS)


def gauss_smooth_mean(dp, max_ngauss=8, wid0=0.02, rchi2_tol=0.1,
                      gauss_device=None, max_iter=100, device=None):
    """Gaussian-smooth a portrait's S/N-weighted mean profile through
    the template LM lane (batched or serial per ``gauss_device``):
    breadth-first trials, host selection, analytic regeneration, on
    ``device`` (default: the portrait's).  Returns the smoothed mean
    profile (nbin,) — feed it to ``make_spline_model(smooth_mean_prof=
    ...)``.  This is the single-pulsar form of what build_templates'
    spline jobs get from the fleet's shared profile buckets
    (``ppspline --gauss-device`` routes here)."""
    from ..fit.gauss import fit_profile_trials, gen_gaussian_profile_flat
    from .spline import snr_weighted_mean

    dev = resolve_device(dp.device if device is None else device)
    profile = np.asarray(snr_weighted_mean(dp), float)
    noise = float(noise_std_ps(profile))
    sel = fit_profile_trials(profile, max_ngauss, noise, wid0=wid0,
                             rchi2_tol=rchi2_tol, max_iter=max_iter,
                             serial=not use_gauss_device(gauss_device, dev),
                             device=dev)
    if sel is None:
        raise ValueError(
            "gauss_smooth_mean: every trial fit failed (non-finite "
            "chi2) — check the profile and noise level")
    return gen_gaussian_profile_flat(sel.params, len(profile),
                                     device=dev).cpu().numpy()


class TemplateJob:
    """One pulsar's template-building state inside the fleet loop:
    the loaded portrait object (all host bookkeeping — reference-
    profile selection, convergence checks, rotations — runs on it, the
    same methods the single-pulsar path uses) plus the per-iteration
    fit state the bucketed calls read and write."""

    def __init__(self, datafile, kind, dp, outfile):
        self.datafile = datafile
        self.kind = kind
        self.dp = dp
        self.outfile = outfile
        # profile stage
        self.seeds = None
        self.trial_idx = []      # (bucket_key, row) per trial
        self.ngauss = None
        self.profile_red_chi2 = None
        # portrait stage (gauss jobs)
        self.x0 = None           # current flat portrait params
        self.alpha = None        # current scattering index
        self.flags = None
        self.niter = 0
        self.itern = 0
        self.converged = False
        self.fit_converged = True  # no LM fit of the job hit max_iter
        self.model = None

    @property
    def n_ok(self):
        return len(self.dp.ok_ichans)


def _profile_bucket_key(nbin, ngauss):
    return (int(nbin), _pow2ceil(ngauss))


def _portrait_bucket_key(nbin, nchan, ngauss, model_code):
    return (int(nbin), _pow2ceil(nchan), _pow2ceil(ngauss), model_code)


def _pad_rows(arrays, vary, B_pad):
    """Pad a bucket's stacked problem arrays to B_pad rows by
    duplicating row 0 with vary all-False: a fully-frozen problem has a
    zero gradient, is done on its first iteration and cannot perturb
    real rows (every step is per row); its results are discarded."""
    B = len(vary)
    if B == B_pad:
        return arrays, vary
    pad = B_pad - B
    arrays = [np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
              for a in arrays]
    vary = np.concatenate([vary, np.zeros((pad,) + vary.shape[1:],
                                          bool)])
    return arrays, vary


def _host_fields(res, B):
    """The real rows of an LMResult of tensors, as numpy."""
    return {f: getattr(res, f)[:B].cpu().numpy() for f in _RESULT_FIELDS}


def _resolved_jac_mode():
    """The Jacobian source the factory's dispatches use: every Gaussian
    residual ships its analytic companion, so 'auto' resolves to
    'analytic' and only an explicit 'ad' keeps autodiff (carried on
    every template_fit event)."""
    return "ad" if use_lm_jacobian() == "ad" else "analytic"


def _emit_template_fit(tracer, stage, bucket, B, B_pad, out, wall,
                       batched):
    if tracer.enabled:
        tracer.emit("template_fit", stage=stage, bucket=bucket, rows=B,
                    pad=B_pad - B, nfev_max=int(out["nfev"].max()),
                    wall_s=round(wall, 6), batched=bool(batched),
                    jac=_resolved_jac_mode())


def _dispatch_profiles(bucket_key, rows, batched, max_iter, dev,
                       tracer=NULL_TRACER):
    """Fit one profile bucket: rows = list of (job, trial_g, x0, vary,
    profile, noise).  Returns per-row LMResult fields (numpy), real
    rows only."""
    nbin, gclass = bucket_key
    B = len(rows)
    B_pad = _pow2ceil(B) if batched else B
    data = np.stack([r[4] for r in rows])
    errs = np.asarray([r[5] for r in rows], float)
    x0s = np.stack([r[2] for r in rows])
    vary = np.stack([r[3] for r in rows])
    (data, errs, x0s), vary = _pad_rows([data, errs, x0s], vary, B_pad)
    t0 = time.perf_counter()
    res = fit_gaussian_profiles_batched(data, x0s, errs, vary,
                                        max_iter=max_iter,
                                        serial=not batched, device=dev)
    out = _host_fields(res, B)
    wall = time.perf_counter() - t0
    _count(("profile", bucket_key, B, B_pad), batched)
    _emit_template_fit(tracer, "profile", f"prof:{nbin}b:{gclass}g", B,
                       B_pad, out, wall, batched)
    return out


def _dispatch_portraits(bucket_key, rows, batched, max_iter, dev,
                        tracer=NULL_TRACER):
    """Fit one portrait bucket: rows = list of (job, x0_full, vary,
    data_pad, errs_pad, freqs_pad, nu_ref, P, nchan_valid)."""
    nbin, cclass, gclass, model_code = bucket_key
    B = len(rows)
    B_pad = _pow2ceil(B) if batched else B
    data = np.stack([r[3] for r in rows])
    errs = np.stack([r[4] for r in rows])
    freqs = np.stack([r[5] for r in rows])
    nu_refs = np.asarray([r[6] for r in rows], float)
    Ps = np.asarray([r[7] for r in rows], float)
    ncv = np.asarray([r[8] for r in rows], int)
    x0s = np.stack([r[1] for r in rows])
    vary = np.stack([r[2] for r in rows])
    (data, errs, freqs, nu_refs, Ps, ncv, x0s), vary = _pad_rows(
        [data, errs, freqs, nu_refs, Ps, ncv, x0s], vary, B_pad)
    t0 = time.perf_counter()
    res = fit_gaussian_portraits_batched(
        data, x0s, errs, vary, freqs, nu_refs, Ps,
        model_code=model_code, nchan_valid=ncv, max_iter=max_iter,
        serial=not batched, device=dev)
    out = _host_fields(res, B)
    wall = time.perf_counter() - t0
    _count(("portrait", bucket_key, B, B_pad), batched)
    _emit_template_fit(tracer, "portrait",
                       f"port:{cclass}c:{nbin}b:{gclass}g", B, B_pad, out,
                       wall, batched)
    return out


def _count(bucket, batched):
    _STATS["buckets"].append(bucket)
    _STATS["lm_calls"] += 1 if batched else bucket[2]


def build_templates(datafiles, kind="gauss", outdir=None, outfiles=None,
                    max_ngauss=8, wid0=0.02, rchi2_tol=0.1, tau=0.0,
                    fixloc=False, fixwid=False, fixamp=False,
                    fixscat=True, fixalpha=True,
                    scattering_index=scattering_alpha,
                    model_code=default_model_code, niter=0,
                    fiducial_gaussian=False, normalize=None,
                    gauss_device=None, max_iter=200,
                    profile_max_iter=100, write=True,
                    spline_kwargs=None, telemetry=None, quiet=True,
                    device=None):
    """Build one template per archive for a whole fleet, batching the
    LM fits across pulsars (module docstring has the architecture), on
    ``device`` (default cuda).

    datafiles: archive paths (or preloaded DataPortrait-like objects
    paired as (object, name) tuples).  kind: 'gauss' | 'spline', or a
    per-file sequence.  outfiles: explicit output paths (else
    outdir/<base> or <datafile> + '.gmodel'/'.spl').  gauss_device:
    per-call lane override (None -> config.gauss_device).  Remaining
    options follow make_gaussian_model / make_spline_model.
    telemetry: a trace path or telemetry.Tracer (None follows
    config.telemetry_path): template_fit per bucket dispatch,
    template_job per job, factory_end.

    Returns a list of DataBunch(datafile, kind, model, outfile, ngauss,
    converged, iters, red_chi2, fit_converged) in input order:
    ``converged`` is the (phi, DM) check of the JAX package's result;
    ``fit_converged`` (the port's addition) says that the selected
    profile trial and every portrait fit of the job succeeded (stopped
    before max_iter) — a fit capped at max_iter is not reproducible to
    the last digits across two lanes of one program.
    """
    if not datafiles:
        raise ValueError("build_templates: no datafiles given")
    max_ngauss = int(max_ngauss)
    if max_ngauss < 1:
        raise ValueError(
            f"build_templates needs max_ngauss >= 1 (got {max_ngauss})")
    dev = resolve_device(device)
    batched = use_gauss_device(gauss_device, dev)
    kinds = ([kind] * len(datafiles) if isinstance(kind, str)
             else list(kind))
    if len(kinds) != len(datafiles):
        raise ValueError("kind must be a string or one entry per "
                         "datafile")
    for k in kinds:
        if k not in ("gauss", "spline"):
            raise ValueError(f"unknown template kind {k!r} "
                             "('gauss' or 'spline')")
    _STATS.clear()
    _STATS.update(lm_calls=0, buckets=[])

    tracer, own_tracer = resolve_tracer(telemetry, run="build_templates")
    t_run = time.perf_counter()
    n_dispatch = 0
    try:
        # ---- load the fleet (host IO) ------------------------------------
        from .gauss import (GaussPortrait, portrait_fit_flags,
                            profile_to_portrait_params)
        from .spline import SplinePortrait, snr_weighted_mean

        jobs = []
        for i, df in enumerate(datafiles):
            if isinstance(df, tuple):
                dp, name = df
            else:
                if _is_metafile(df):
                    raise ValueError(
                        f"build_templates: {df!r} is a metafile — JOIN "
                        "(multi-receiver) fits keep the single-pulsar "
                        "ppgauss path, whose join parameters ride "
                        "the LM problem vector")
                cls = GaussPortrait if kinds[i] == "gauss" \
                    else SplinePortrait
                dp, name = cls(df, quiet=True, device=dev), str(df)
            if outfiles is not None:
                out = outfiles[i]
            else:
                ext = ".gmodel" if kinds[i] == "gauss" else ".spl"
                out = (os.path.join(outdir, os.path.basename(name) + ext)
                       if outdir else name + ext)
            if normalize:
                dp.normalize_portrait(normalize)
            jobs.append(TemplateJob(name, kinds[i], dp, out))
        if outdir:
            os.makedirs(outdir, exist_ok=True)

        # ---- profile stage: fleet x trials, one call per bucket ----------
        prof_buckets = {}
        for job in jobs:
            dp = job.dp
            if job.kind == "gauss":
                profile, nu_ref = dp.select_ref_profile()
                dp.nu_ref = nu_ref
            else:
                profile = snr_weighted_mean(dp)
            profile = np.asarray(profile, float)
            noise = float(noise_std_ps(profile))
            job.seeds = profile_trial_seeds(profile, max_ngauss, wid0=wid0,
                                            tau=tau, noise=noise)
            for g, seed in enumerate(job.seeds, start=1):
                key = _profile_bucket_key(len(profile), g)
                padded, _ = pad_profile_params(seed, key[1])
                vary = profile_vary(g, key[1], fit_scattering=not fixscat)
                rows = prof_buckets.setdefault(key, [])
                job.trial_idx.append((key, len(rows)))
                rows.append((job, g, padded, vary, profile, noise))
        prof_results = {}
        with lap("factory profile trials"):
            for key in sorted(prof_buckets):
                prof_results[key] = _dispatch_profiles(
                    key, prof_buckets[key], batched, profile_max_iter, dev,
                    tracer)
                n_dispatch += 1

        # ---- per-job trial selection (host, serial-loop semantics) -------
        for job in jobs:
            reds, xs, xerrs, succ, stall = [], [], [], [], []
            for (key, row), g in zip(job.trial_idx, range(1, max_ngauss + 1)):
                r = prof_results[key]
                reds.append(float(r["chi2"][row])
                            / max(float(r["dof"][row]), 1.0))
                nsel = 2 + 3 * g
                xs.append(r["x"][row][:nsel])
                xerrs.append(r["x_err"][row][:nsel])
                succ.append(bool(r["success"][row]))
                stall.append(bool(r["stalled"][row]))
            ibest = select_best_trial(reds, rchi2_tol=rchi2_tol,
                                      success=succ, stalled=stall)
            if ibest is None:
                raise ValueError(
                    f"build_templates: every profile trial of "
                    f"{job.datafile!r} failed (non-finite chi2 for all "
                    f"ngauss in 1..{max_ngauss})")
            job.ngauss = ibest + 1
            job.fit_converged = succ[ibest]
            job.profile_red_chi2 = reds[ibest]
            job.dp.init_params = np.asarray(xs[ibest])
            job.dp.init_param_errs = np.asarray(xerrs[ibest])
            job.dp.ngauss = job.ngauss
            log(f"{job.datafile}: {job.ngauss} components, profile red "
                f"chi2 {reds[ibest]:.2f}", quiet=quiet, tracer=tracer)

        # ---- spline jobs: spline build on the Gauss-smoothed mean --------
        from ..fit.gauss import gen_gaussian_profile_flat

        for job in jobs:
            if job.kind != "spline":
                continue
            with lap("factory spline build"):
                smooth_mean = gen_gaussian_profile_flat(
                    job.dp.init_params, job.dp.nbin, device=dev).cpu().numpy()
                job.model = job.dp.make_spline_model(
                    smooth=True, smooth_mean_prof=smooth_mean,
                    model_name=None, quiet=True, **(spline_kwargs or {}))
            job.converged = True
            job.itern = 1
            if write:
                with lap("factory write"):
                    job.dp.write_model(job.outfile, quiet=True)
            if tracer.enabled:
                tracer.emit("template_job", datafile=job.datafile,
                            kind="spline", ngauss=int(job.ngauss),
                            converged=True, iters=1)

        # ---- portrait stage: iterate bucketed fleet fits -----------------
        from ..ops.phasor import guess_fit_freq

        gauss_jobs = [j for j in jobs if j.kind == "gauss"]
        for job in gauss_jobs:
            dp = job.dp
            job.x0 = profile_to_portrait_params(dp.init_params)
            job.alpha = float(scattering_index)
            job.flags = portrait_fit_flags(
                job.ngauss, fixloc=fixloc, fixwid=fixwid, fixamp=fixamp,
                fixscat=fixscat, fiducial_gaussian=fiducial_gaussian)
            dp._flags_cache = job.flags
            dp.model_name = job.outfile
            dp.model_code = model_code
            dp.nu_fit = float(guess_fit_freq(dp._t(dp.freqsxs[0]),
                                             dp._t(dp.SNRsxs[0])))
            job.niter = int(niter)
        active = list(gauss_jobs)
        itern = 0
        while active:
            buckets = {}
            for job in active:
                dp = job.dp
                key = _portrait_bucket_key(dp.nbin, job.n_ok, job.ngauss,
                                           model_code)
                nbin, cclass, gclass = key[0], key[1], key[2]
                okc = dp.ok_ichans
                data = np.zeros((cclass, nbin))
                data[:job.n_ok] = dp.port[okc]
                errs_full = np.where(dp.noise_stds > 0, dp.noise_stds,
                                     np.median(dp.noise_stds[okc]))
                errs = np.full(cclass, np.inf)
                errs[:job.n_ok] = errs_full[okc]
                freqs = np.full(cclass, dp.freqsxs[0][-1])
                freqs[:job.n_ok] = dp.freqsxs[0]
                xp, _ = pad_portrait_params(job.x0, gclass)
                x0_full = np.concatenate([xp, [job.alpha]])
                vary = portrait_vary(job.flags, gclass,
                                     fit_scattering_index=not fixalpha)
                buckets.setdefault(key, []).append(
                    (job, x0_full, vary, data, errs, freqs, dp.nu_ref,
                     float(dp.Ps[0]), job.n_ok))
            with lap(f"factory portrait LM {itern}"):
                for key in sorted(buckets):
                    rows = buckets[key]
                    out = _dispatch_portraits(key, rows, batched, max_iter,
                                              dev, tracer)
                    n_dispatch += 1
                    for b, row in enumerate(rows):
                        job = row[0]
                        dp = job.dp
                        nmain = 2 + 6 * job.ngauss
                        dp.fitted_params = out["x"][b][:nmain].copy()
                        dp.fit_errs = out["x_err"][b][:nmain].copy()
                        job.alpha = float(out["x"][b][-1])
                        job.fit_converged &= bool(out["success"][b])
                        dp.portrait_red_chi2 = (float(out["chi2"][b])
                                                / max(float(out["dof"][b]),
                                                      1.0))
                        job.x0 = dp.fitted_params
            still = []
            with lap(f"factory convergence {itern}"):
                for job in active:
                    dp = job.dp
                    dp._rebuild_model(model_code, job.alpha, float(dp.Ps[0]))
                    converged = dp.check_convergence(efac=1.0, quiet=True)
                    job.itern += 1
                    if converged or job.itern > job.niter:
                        job.converged = bool(converged)
                    else:
                        dp.rotate_stuff(phase=dp.phi, DM=dp.DM,
                                        nu_ref=dp.nu_fit)
                        still.append(job)
            active = still
            itern += 1

        # ---- finalize gauss jobs -----------------------------------------
        for job in gauss_jobs:
            dp = job.dp
            dp.scattering_index = job.alpha
            job.model = dp._to_gmodel(job.outfile, model_code, job.alpha,
                                      int(not fixalpha), job.flags,
                                      float(dp.Ps[0]))
            dp.gaussian_model = job.model
            if write:
                with lap("factory write"):
                    write_gmodel(job.model, job.outfile, quiet=True)
            if tracer.enabled:
                tracer.emit("template_job", datafile=job.datafile,
                            kind="gauss", ngauss=int(job.ngauss),
                            converged=bool(job.converged),
                            iters=int(job.itern))
            log(f"{job.datafile}: portrait red chi2 "
                f"{dp.portrait_red_chi2:.2f} after {job.itern} "
                f"iteration(s)"
                + ("" if job.converged else " (not converged)"),
                quiet=quiet, tracer=tracer)

        if tracer.enabled:
            tracer.emit("factory_end", n_jobs=len(jobs),
                        n_dispatches=n_dispatch,
                        wall_s=round(time.perf_counter() - t_run, 6))
        return [DataBunch(
            datafile=j.datafile, kind=j.kind, model=j.model,
            outfile=(j.outfile if write else None), ngauss=j.ngauss,
            converged=j.converged, iters=j.itern,
            fit_converged=j.fit_converged,
            red_chi2=(getattr(j.dp, "portrait_red_chi2", None)
                      if j.kind == "gauss" else j.profile_red_chi2))
            for j in jobs]
    finally:
        if own_tracer:
            tracer.close()
