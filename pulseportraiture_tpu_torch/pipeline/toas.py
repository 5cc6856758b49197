"""Wideband TOA measurement pipeline (counterpart of pulseportraiture_tpu/pipeline/toas.py).

GetTOAs.get_TOAs: per archive, all usable subints are stacked into one
(nsub, nchan, nbin) batch per fit-flag group and fitted on the device
by one call, routed as in the JAX package: groups without scattering
take the fast lane (fit.portrait.fit_portrait_batch_fast) where
config.use_fast_fit resolves on, every other group (tau/alpha free, a
tau seed, an instrumental response, or the fast fit off) the complex
engine (fit.portrait.fit_portrait_batch).  TOAs, DMs, scattering flags
and the per-archive DeltaDM statistics are assembled on the host
exactly as in the JAX package.

GetTOAs.get_narrowband_TOAs: one TOA per usable (subint, channel),
every profile of an archive fitted by one batched phase-shift call on
the device (fit.phase_shift.fit_phase_shift_batch), or with fit_scat
the complex engine over single-channel portraits with (phi, tau) free.
get_crosscheck_TOAs (and its get_psrchive_TOAs shim) is the JAX
package's independent host NumPy estimator.

GetTOAs.get_channels_to_zap (after get_TOAs): the model-based post-fit
channel cut behind ``ppzap -m`` (quality/postfit).

``telemetry=`` on get_TOAs and get_channels_to_zap writes the JAX
package's trace events (telemetry.py): archive_load/archive_fit/
quality/archive_skip/run_end, and zap_propose.
"""

import time

import numpy as np
import torch

from ..config import Dconst, scattering_alpha
from ..device import resolve_device
from ..fit.portrait import (FitFlags, estimate_tau_batch, fit_portrait_batch,
                            fit_portrait_batch_fast, use_fast_fit_default,
                            warn_bf16_high_snr)
from ..io.psrfits import load_data
from ..io.tim import TOA
from ..ops.rotation import rotate_portrait
from ..ops.scattering import scattering_portrait_FT, scattering_times
from ..telemetry import finite, log, resolve_tracer
from .models import TemplateModel

__all__ = ["GetTOAs", "weighted_mean", "effective_fit_flags",
           "doppler_corrected_DM_GM", "snr_weighted_nu_fit",
           "load_for_toas", "delta_dm_stats", "scat_time_flags",
           "scat_seed_tau0", "scattering_toa_flags", "reref_tau",
           "DEFAULT_IR_DICT", "build_instrumental_response_FT"]

MAX_NFILE = 999  # parity: cfitsio open-file guard


def weighted_mean(values, errs):
    """Error-weighted mean and its uncertainty."""
    values = np.asarray(values, float)
    errs = np.asarray(errs, float)
    good = errs > 0
    w = np.where(good, 1.0 / np.where(good, errs, 1.0) ** 2, 0.0)
    wsum = w.sum()
    if wsum == 0.0:
        return float(np.mean(values)), np.inf
    mean = float((values * w).sum() / wsum)
    return mean, float(wsum ** -0.5)


def scat_time_flags(tau_rot, tau_err_rot, seconds_per_rot, log10_tau):
    """TOA flags of a fitted scattering timescale (tau and its error in
    linear rotations; seconds_per_rot: P or P / doppler_factor);
    scat_time in microseconds."""
    flags = {"scat_time": tau_rot * seconds_per_rot * 1e6}
    if log10_tau:
        safe = max(tau_rot, 1e-300)
        flags["log10_scat_time"] = np.log10(safe * seconds_per_rot)
        flags["log10_scat_time_err"] = tau_err_rot / (safe * np.log(10.0))
    else:
        flags["scat_time_err"] = tau_err_rot * seconds_per_rot * 1e6
    return flags


def _validate_scat_guess(scat_guess, fit_scat):
    """scat_guess as a (tau_s, nu_MHz, alpha) triple, the literal 'auto'
    (which needs fit_scat), or None; anything else raises."""
    if isinstance(scat_guess, str):
        if scat_guess.strip().lower() != "auto":
            raise ValueError(
                f"scat_guess string must be 'auto', got {scat_guess!r}")
        if not fit_scat:
            raise ValueError("scat_guess='auto' requires fit_scat=True")
        return "auto"
    if scat_guess is not None and len(tuple(scat_guess)) != 3:
        raise ValueError(
            "scat_guess must be (tau_s, nu_MHz, alpha), 'auto', or None")
    return scat_guess


def scat_seed_tau0(scat_guess, fit_scat, nok, nbin, P_mean, nu_fit_arr,
                   default_alpha, ports=None, modelx=None, noise=None,
                   masks=None, device=None):
    """(tau0 [rot at nu_fit] per subint, alpha0), shared by GetTOAs and
    the stream's decoded lane: a (tau_s, nu, alpha) triple scaled to
    each nu_fit; 'auto' the data-driven estimate_tau_batch in float32
    on ``device``; None the neutral half bin when fitting, else zeros."""
    alpha0 = default_alpha
    if scat_guess is not None and not isinstance(scat_guess, str):
        t_s, nu_s, a_s = scat_guess
        tau0 = (t_s / P_mean) * (np.asarray(nu_fit_arr) / nu_s) ** a_s
        alpha0 = a_s
    elif fit_scat and scat_guess == "auto":
        import torch

        dev = resolve_device(device)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        tau0 = estimate_tau_batch(
            f32(ports), f32(modelx), f32(noise),
            None if masks is None else f32(masks)).cpu().numpy()
    elif fit_scat:
        tau0 = np.full(nok, 0.5 / nbin)
    else:
        tau0 = np.zeros(nok)
    return tau0, alpha0


def reref_tau(tau, tau_err, nu_from, nu_to, alpha):
    """Re-reference a scattering timescale and its error between
    frequencies along its own power law: tau' = tau (nu'/nu)^alpha, the
    error scaled by the same factor (the alpha covariance neglected)."""
    r = (np.asarray(nu_to, float) / np.asarray(nu_from, float)) \
        ** np.asarray(alpha, float)
    return tau * r, tau_err * np.abs(r)


def scattering_toa_flags(tau, tau_err, nu_tau, alpha, alpha_err, P, df,
                         log10_tau, alpha_fitted, nu_ref_tau=None):
    """The scat_* TOA flags of one fitted subint: scat_time [us] (and
    its log10 form), the Doppler-corrected reference frequency, the
    index and, when fitted, its error.  nu_ref_tau re-references tau
    first; None when the caller already did."""
    if nu_ref_tau is not None:
        tau, tau_err = reref_tau(tau, tau_err, nu_tau, nu_ref_tau, alpha)
        nu_tau = float(nu_ref_tau)
    flags = scat_time_flags(tau, tau_err, P / df, log10_tau)
    flags["scat_ref_freq"] = nu_tau * df
    flags["scat_ind"] = alpha
    if alpha_fitted:
        flags["scat_ind_err"] = alpha_err
    return flags


DEFAULT_IR_DICT = {"DM-smear": False, "wids": [], "irf_types": []}


def build_instrumental_response_FT(ird, freqs0, nbin, DM_guess, P_mean,
                                   bw=0.0):
    """(nchan, nharm) float64 host instrumental-response FT of one
    archive layout, or None when the dict requests nothing: the product
    of the achromatic (width [rot], kind) kernels and, with "DM-smear",
    per-channel DM-smearing sincs.  Unpaired wids/kinds raise."""
    ird = {**DEFAULT_IR_DICT, **(ird or {})}
    if len(ird["wids"]) != len(ird["irf_types"]):
        raise ValueError(
            "instrumental_response_dict: wids and irf_types must pair "
            f"up (got {len(ird['wids'])} widths, "
            f"{len(ird['irf_types'])} kinds)")
    if not (ird["wids"] or ird["DM-smear"]):
        return None
    import torch

    from ..ops.gaussian import instrumental_response_port_FT

    freqs0 = np.asarray(freqs0, float)
    nchan = len(freqs0)
    chan_bw = float(np.abs(np.median(np.diff(freqs0)))) if nchan > 1 \
        else float(bw) / max(nchan, 1)
    return instrumental_response_port_FT(
        nbin // 2 + 1, torch.as_tensor(freqs0),
        widths=tuple(ird["wids"]), kinds=tuple(ird["irf_types"]),
        DM_smear=DM_guess if ird["DM-smear"] else None,
        chan_bw=chan_bw, P=P_mean).numpy()


def effective_fit_flags(nchx_i, base):
    """Degenerate-geometry flag demotion: one usable channel ->
    phase-only; two channels with GM requested -> drop GM."""
    if nchx_i <= 1:
        return (True, False, False, False, False)
    if nchx_i == 2 and base[2]:
        return (True, base[1], False, base[3], base[4])
    return base


def doppler_corrected_DM_GM(DM, GM, df, fit_DM, fit_GM, bary):
    """(DM, GM) with the PSRCHIVE barycentric convention applied:
    DM *= df, GM *= df^3 under bary for FITTED parameters."""
    if bary:
        if fit_DM:
            DM = DM * df
        if fit_GM:
            GM = GM * df ** 3
    return DM, GM


def snr_weighted_nu_fit(snrs_chan, freqs0):
    """Per-subint fit reference frequency: the S/N * nu^-2-weighted
    center-of-mass frequency, with a mean-frequency fallback for empty
    subints.  snrs_chan: (nsub, nchan) masked channel S/Ns."""
    w = np.maximum(snrs_chan, 0.0) * freqs0 ** -2.0
    denom = (w * freqs0 ** -2.0).sum(axis=1)
    denom = np.where(denom > 0, denom, 1.0)
    nu_fit = np.sqrt(w.sum(axis=1) / denom)
    return np.where(np.isfinite(nu_fit) & (nu_fit > 0), nu_fit,
                    freqs0.mean())


def load_for_toas(f, tscrunch=False, quiet=True, dtype=None):
    """The load_data configuration every TOA driver uses: dispersed
    data, pscrunched, no flux profile, archive object dropped."""
    return load_data(f, dedisperse=False, dededisperse=True,
                     tscrunch=tscrunch, pscrunch=True, flux_prof=False,
                     refresh_arch=False, return_arch=False, quiet=quiet,
                     dtype=np.float64 if dtype is None else dtype)


def delta_dm_stats(dDMs, dDM_errs):
    """Per-archive offset-DM mean and inflated error: inverse-variance
    weights when every error is positive, uniform otherwise; variance
    inflated by the weighted scatter when more than one subint."""
    dDMs = np.asarray(dDMs, float)
    errs = np.asarray(dDM_errs, float)
    n = len(dDMs)
    if n == 0:
        return np.nan, np.nan
    if np.all(errs > 0):
        w = errs ** -2.0
    else:
        w = np.ones(n)
    mean = float(np.average(dDMs, weights=w))
    var = 1.0 / w.sum()
    if n > 1:
        var *= float(((dDMs - mean) ** 2 * w).sum() / (n - 1))
    return mean, float(np.sqrt(var))


def _iter_archives(datafiles, loader, prefetch):
    """Yield (datafile, DataBunch-or-Exception).  With prefetch, worker
    threads load archives ahead of the consumer (prefetch: True = depth
    4, an int sets the depth)."""
    if not prefetch or len(datafiles) <= 1:
        for f in datafiles:
            try:
                yield f, loader(f)
            except Exception as e:
                yield f, e
        return
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    depth = 4 if prefetch is True else max(1, int(prefetch))

    def safe(f):
        try:
            return loader(f)
        except Exception as e:
            return e

    with ThreadPoolExecutor(max_workers=min(depth, 4)) as ex:
        futs = deque()
        it = iter(datafiles)
        for f in datafiles[:depth]:
            next(it)
            futs.append((f, ex.submit(safe, f)))
        while futs:
            f, fut = futs.popleft()
            nxt = next(it, None)
            if nxt is not None:
                futs.append((nxt, ex.submit(safe, nxt)))
            yield f, fut.result()


def _read_metafile(path):
    with open(path) as f:
        return [line.strip() for line in f
                if line.strip() and not line.strip().startswith("#")]


def _is_metafile(path):
    """A metafile is a short ASCII list of existing file paths."""
    try:
        with open(path, "rb") as f:
            head = f.read(256)
        head.decode("ascii")
    except (UnicodeDecodeError, OSError):
        return False
    if head.startswith(b"SIMPLE"):
        return False
    import os

    names = _read_metafile(path)
    return bool(names) and all(os.path.exists(n) for n in names[:3])


class GetTOAs:
    """Measure wideband TOAs + DMs (+ GM), or narrowband TOAs, from
    archives.

    Construct with datafiles (single archive, metafile, or list), a
    modelfile (.gmodel, spline model or PSRFITS template) and the device
    the fits run on (default cuda), call get_TOAs() (or
    get_narrowband_TOAs()), read the per-archive parallel result lists,
    pass TOA_list to io.tim.write_TOAs.
    """

    def __init__(self, datafiles, modelfile, quiet=False, device=None):
        from ..utils.device import enable_compile_cache

        # the kernels' shared build directory (config.compile_cache_dir /
        # PPT_COMPILE_CACHE / pptoas --compile-cache); a no-op when unset
        enable_compile_cache()
        self.device = resolve_device(device)
        if isinstance(datafiles, str):
            if _is_metafile(datafiles):
                self.datafiles = _read_metafile(datafiles)
            else:
                self.datafiles = [datafiles]
        else:
            self.datafiles = list(datafiles)
        if len(self.datafiles) > MAX_NFILE:
            raise ValueError(
                f"> {MAX_NFILE} archives in one run; split the metafile")
        self.modelfile = str(modelfile)
        self.model = TemplateModel(modelfile, quiet=quiet,
                                   device=self.device)
        # instrumental-response config: set "DM-smear" True and/or
        # append (width [rot], kind) pairs to wids/irf_types before
        # get_TOAs
        self.instrumental_response_dict = {
            "DM-smear": False, "wids": [], "irf_types": []}
        for name in ("obs", "doppler_fs", "nu0s", "nu_fits", "nu_refs",
                     "ok_isubs", "epochs", "MJDs", "Ps", "phis",
                     "phi_errs", "TOAs", "TOA_errs", "DM0s", "DMs",
                     "DM_errs", "DeltaDM_means", "DeltaDM_errs", "GMs",
                     "GM_errs", "taus", "tau_errs", "alphas", "alpha_errs",
                     "scales", "scale_errs", "snrs", "channel_snrs",
                     "profile_fluxes", "profile_flux_errs", "fluxes",
                     "flux_errs", "flux_freqs", "covariances", "red_chi2s",
                     "channel_red_chi2s", "nfevals", "rcs",
                     "fit_durations", "order", "TOA_list"):
            setattr(self, name, [])
        self.quiet = quiet

    def get_TOAs(self, datafile=None, tscrunch=False, nu_refs=None,
                 DM0=None, bary=True, fit_DM=True, fit_GM=False,
                 fit_scat=False, log10_tau=True, scat_guess=None,
                 fix_alpha=False, print_phase=False, print_flux=False,
                 print_parangle=False, addtnl_toa_flags={},
                 nu_fits=None, max_iter=40, prefetch=False, quiet=None,
                 bounds=None, quality_flags=False, telemetry=None):
        """Measure wideband TOAs (the JAX package's get_TOAs).

        fit_scat fits the scattering timescale (log10 tau by default,
        linear with log10_tau=False) and, unless fix_alpha, its index;
        scat_guess: a (tau_s, nu_MHz, alpha) seed, 'auto' for the
        per-subint data-driven estimate (fit.portrait.estimate_tau_batch)
        or None (the neutral half bin).  nu_refs: (nu_DM, nu_tau)
        output reference frequencies, None for the zero-covariance ones.
        bounds: optional (5, 2) [lo, hi] box on (phi, DM, GM,
        tau-or-log10-tau, alpha); a fit converging ON a bound reports
        return code 0.  quality_flags=True adds per-TOA -nfev and -chi2
        flags.  telemetry: a trace path or telemetry.Tracer (None follows
        config.telemetry_path; default off): per-archive load/fit events,
        per-TOA quality and a run_end rollup."""
        if quiet is None:
            quiet = self.quiet
        if bounds is not None:
            bounds = np.asarray(bounds, float)
            if bounds.shape != (5, 2):
                raise ValueError(
                    f"bounds must be (5, 2) [lo, hi] rows for (phi, DM,"
                    f" GM, tau, alpha); got shape {bounds.shape}")
            if np.any(np.isnan(bounds)):
                raise ValueError("bounds: NaN entries (use +-np.inf "
                                 "for open bounds)")
            if np.any(bounds[:, 0] > bounds[:, 1]):
                raise ValueError("bounds: a lower bound exceeds its "
                                 "upper bound")
        scat_guess = _validate_scat_guess(scat_guess, fit_scat)
        if not fit_scat:
            log10_tau = False
        self.fit_flags = [1, int(fit_DM), int(fit_GM), int(fit_scat),
                          int(fit_scat and not fix_alpha)]
        self.log10_tau = log10_tau
        self.tscrunch = tscrunch
        self.bary = bary
        self.DM0 = DM0
        datafiles = self.datafiles if datafile is None else [datafile]
        nu_ref_DM = nu_refs[0] if nu_refs is not None else None
        nu_ref_tau = nu_refs[1] if nu_refs is not None else None
        scat = dict(fit_scat=bool(fit_scat), log10_tau=bool(log10_tau),
                    scat_guess=scat_guess, fix_alpha=bool(fix_alpha),
                    nu_ref_tau=nu_ref_tau)
        load_times = {}
        tracer, own_tracer = resolve_tracer(telemetry,
                                            run="GetTOAs.get_TOAs")
        ntoa_before = len(self.TOA_list)
        narch_before = len(self.order)
        # batched fit calls (one per flag group per archive): run_end's
        # nfit has the stream drivers' per-dispatch meaning
        nfit_calls = 0

        def _loader(f):
            t0 = time.time()
            try:
                return load_for_toas(f, tscrunch=tscrunch, quiet=quiet)
            finally:
                load_times[f] = time.time() - t0

        try:
            for datafile, d in _iter_archives(datafiles, _loader, prefetch):
                t_start = time.time()
                if isinstance(d, Exception):
                    tracer.emit("archive_skip", datafile=datafile,
                                reason=str(d))
                    log(f"Skipping {datafile}: {d}", level="warn")
                    continue
                if d.nsub == 0 or len(d.ok_isubs) == 0:
                    tracer.emit("archive_skip", datafile=datafile,
                                reason="no subints to fit")
                    log(f"No subints to fit in {datafile}; skipping.",
                        level="warn")
                    continue
                if tracer.enabled:
                    tracer.emit("archive_load", datafile=datafile,
                                load_s=round(load_times.get(datafile, 0.0),
                                             6),
                                n_ok=len(d.ok_isubs))
                nfit_calls += self._fit_archive(
                    datafile, d, DM0, bary, fit_DM, fit_GM, nu_fits,
                    nu_ref_DM, max_iter, bounds, print_phase, print_flux,
                    print_parangle, addtnl_toa_flags, quality_flags, quiet,
                    t_start, load_times, tracer, **scat)
            if tracer.enabled:
                done = self.fit_durations[narch_before:]
                tracer.emit("run_end", driver="GetTOAs.get_TOAs",
                            n_toas=len(self.TOA_list) - ntoa_before,
                            n_archives=len(self.order) - narch_before,
                            nfit=nfit_calls, fit_s=round(sum(done), 6))
        finally:
            # an exception mid-campaign still leaves a closed,
            # counter-bearing trace
            if own_tracer:
                tracer.close()

    def _fit_archive(self, datafile, d, DM0, bary, fit_DM, fit_GM, nu_fits,
                     nu_ref_DM, max_iter, bounds, print_phase, print_flux,
                     print_parangle, addtnl_toa_flags, quality_flags,
                     quiet, t_start, load_times, tracer, fit_scat=False,
                     log10_tau=False, scat_guess=None, fix_alpha=False,
                     nu_ref_tau=None):
        """Fit and assemble one loaded archive; returns the number of
        batched fit calls (0 when the archive was skipped)."""
        nsub, nchan, nbin = d.nsub, d.nchan, d.nbin
        ok = np.asarray(d.ok_isubs, int)
        nok = len(ok)
        P_mean = float(np.mean(d.Ps[ok]))
        freqs0 = np.asarray(d.freqs[0], float)
        DM_stored = float(d.DM)
        DM0_arch = DM_stored if DM0 is None else float(DM0)
        DM_guess = DM_stored if DM_stored != 0.0 else DM0_arch

        try:
            modelx = self.model.portrait(freqs0, nbin, P=P_mean)
        except ValueError as e:
            tracer.emit("archive_skip", datafile=datafile, reason=str(e))
            log(f"Skipping {datafile}: {e}", level="warn")
            return 0

        ports = np.asarray(d.subints[ok, 0], float)
        masks = np.asarray(d.weights[ok] > 0.0, float)
        noise = np.asarray(d.noise_stds[ok, 0], float)
        snrs_chan = np.asarray(d.SNRs[ok, 0], float) * masks

        if nu_fits is not None:
            nu_fit_arr = np.full(nok, float(nu_fits[0]))
        else:
            nu_fit_arr = snr_weighted_nu_fit(snrs_chan, freqs0)

        # tau seed [rot at nu_fit]; 'auto' estimates it per subint from
        # the data (|X| is phase-invariant: no alignment needed first)
        tau0, alpha0 = scat_seed_tau0(
            scat_guess, fit_scat, nok, nbin, P_mean, nu_fit_arr,
            self.model.gauss.alpha if self.model.is_gaussian
            else scattering_alpha,
            ports=ports, modelx=modelx, noise=noise, masks=masks,
            device=self.device)

        theta0 = np.zeros((nok, 5))
        theta0[:, 1] = DM_guess
        theta0[:, 3] = (np.log10(np.maximum(tau0, 1e-12)) if log10_tau
                        else tau0)
        theta0[:, 4] = alpha0

        nchx = masks.sum(axis=1).astype(int)
        base = (True, bool(fit_DM), bool(fit_GM), bool(fit_scat),
                bool(fit_scat and not fix_alpha))
        groups = {}
        for i in range(nok):
            groups.setdefault(
                effective_fit_flags(nchx[i], base), []).append(i)

        ir_FT = build_instrumental_response_FT(
            self.instrumental_response_dict, freqs0, nbin, DM_guess, P_mean,
            bw=d.bw)

        fit_duration = 0.0
        res_arrays = {k: np.full(nok, np.nan) for k in
                      ("phi", "phi_err", "DM", "DM_err", "GM", "GM_err",
                       "tau", "tau_err", "alpha", "alpha_err", "nu_DM",
                       "nu_GM", "nu_tau", "snr", "chi2", "dof")}
        res_arrays["nfeval"] = np.zeros(nok, int)
        res_arrays["rc"] = np.full(nok, -2, int)
        scales_arr = np.zeros((nok, nchan))
        scale_errs_arr = np.zeros((nok, nchan))
        channel_snrs_arr = np.zeros((nok, nchan))
        covs = np.zeros((nok, 5, 5))

        for flags, idx in groups.items():
            idx = np.asarray(idx, int)
            tfit = time.time()
            # groups without scattering take the fast lane where
            # config.use_fast_fit resolves on; a fixed nonzero tau seed
            # (a scattering run's degenerate group) still needs the
            # scattering kernel, so it goes to the complex engine
            use_fast = (not flags[3] and not flags[4] and ir_FT is None
                        and not np.any(theta0[idx][:, 3] != 0.0)
                        and use_fast_fit_default(self.device))
            if use_fast:
                r = fit_portrait_batch_fast(
                    np.asarray(ports[idx], np.float32),
                    # host numpy template: lets the harmonic-window 'auto'
                    # derivation see the model's spectrum
                    np.asarray(modelx, np.float32),
                    np.asarray(noise[idx], np.float32),
                    np.asarray(freqs0, np.float32),
                    np.asarray(d.Ps[ok][idx], np.float32),
                    np.asarray(nu_fit_arr[idx], np.float32),
                    nu_out=nu_ref_DM,
                    theta0=np.asarray(theta0[idx], np.float32),
                    fit_flags=FitFlags(*flags),
                    chan_masks=np.asarray(masks[idx], np.float32),
                    max_iter=max_iter, bounds=bounds, device=self.device)
            else:
                # float64 in; the engine runs it as float32 on CUDA.  The
                # template stays 2-D (shared by the batch).  log10_tau
                # unconditionally: a degenerate group of a log10 run
                # still carries its fixed tau seed in log10
                r = fit_portrait_batch(
                    ports[idx], modelx, noise[idx], freqs0, d.Ps[ok][idx],
                    nu_fit_arr[idx], nu_out=nu_ref_DM, theta0=theta0[idx],
                    fit_flags=FitFlags(*flags), chan_masks=masks[idx],
                    log10_tau=log10_tau, max_iter=max_iter, ir_FT=ir_FT,
                    bounds=bounds, device=self.device)
            r = {k: v.detach().cpu().numpy()
                 for k, v in r._asdict().items()}
            fit_duration += time.time() - tfit
            for k in ("phi", "phi_err", "DM", "DM_err", "GM", "GM_err",
                      "tau", "tau_err", "alpha", "alpha_err", "nu_DM",
                      "nu_GM", "nu_tau", "snr", "chi2", "dof"):
                res_arrays[k][idx] = r[k]
            res_arrays["nfeval"][idx] = r["nfeval"]
            res_arrays["rc"][idx] = r["return_code"]
            scales_arr[idx] = r["scales"] * masks[idx]
            scale_errs_arr[idx] = r["scale_errs"] * masks[idx]
            channel_snrs_arr[idx] = r["channel_snrs"] * masks[idx]
            covs[idx] = r["covariance"]

        if tracer.enabled:
            tracer.emit("archive_fit", datafile=datafile, n_ok=nok,
                        fit_s=round(fit_duration, 6))
            dofs = np.maximum(res_arrays["dof"], 1.0)
            with np.errstate(invalid="ignore"):
                # finite() maps NaN/Inf of degenerate fits to JSON null
                tracer.emit(
                    "quality", datafile=datafile,
                    snr=[finite(v, 3) for v in res_arrays["snr"]],
                    gof=[finite(float(c) / float(s), 4) for c, s in
                         zip(res_arrays["chi2"], dofs)],
                    nfev=[int(v) for v in res_arrays["nfeval"]])

        with np.errstate(invalid="ignore"):
            warn_bf16_high_snr(float(np.nanmax(
                channel_snrs_arr, initial=0.0)), quiet=quiet)

        # user-requested tau output reference (None keeps each fit's
        # zero-covariance frequency)
        if fit_scat and nu_ref_tau is not None:
            res_arrays["tau"], res_arrays["tau_err"] = reref_tau(
                res_arrays["tau"], res_arrays["tau_err"],
                res_arrays["nu_tau"], nu_ref_tau, res_arrays["alpha"])
            res_arrays["nu_tau"] = np.full(nok, float(nu_ref_tau))

        phis = np.full(nsub, np.nan)
        phi_errs = np.full(nsub, np.nan)
        TOAs_arr = [None] * nsub
        TOA_errs = np.full(nsub, np.nan)
        DMs = np.full(nsub, np.nan)
        DM_errs = np.full(nsub, np.nan)
        GMs = np.full(nsub, np.nan)
        GM_errs = np.full(nsub, np.nan)
        taus = np.full(nsub, np.nan)
        tau_errs = np.full(nsub, np.nan)
        alphas = np.full(nsub, np.nan)
        alpha_errs = np.full(nsub, np.nan)
        snrs_sub = np.full(nsub, np.nan)
        red_chi2s = np.full(nsub, np.nan)
        nfevals = np.zeros(nsub, int)
        rcs = np.full(nsub, -2, int)
        nu_refs_sub = np.full((nsub, 3), np.nan)
        scales_full = np.zeros((nsub, nchan))
        scale_errs_full = np.zeros((nsub, nchan))
        channel_snrs_full = np.zeros((nsub, nchan))
        covariances = np.zeros((nsub, 5, 5))
        profile_fluxes = np.zeros((nsub, nchan))
        profile_flux_errs = np.zeros((nsub, nchan))
        fluxes = np.full(nsub, np.nan)
        flux_errs = np.full(nsub, np.nan)
        flux_freqs = np.full(nsub, np.nan)
        MJDs = np.full(nsub, np.nan)

        for j, isub in enumerate(ok):
            phi = float(res_arrays["phi"][j])
            P = float(d.Ps[isub])
            epoch = d.epochs[isub]
            toa_mjd = epoch.add_seconds(phi * P + d.backend_delay)
            df = float(d.doppler_factors[isub]) if bary else 1.0
            DM_j, GM_j = doppler_corrected_DM_GM(
                float(res_arrays["DM"][j]), float(res_arrays["GM"][j]),
                df, self.fit_flags[1], self.fit_flags[2], bary)

            phis[isub] = phi
            phi_errs[isub] = res_arrays["phi_err"][j]
            TOAs_arr[isub] = toa_mjd
            TOA_errs[isub] = res_arrays["phi_err"][j] * P * 1e6
            DMs[isub] = DM_j
            DM_errs[isub] = res_arrays["DM_err"][j]
            GMs[isub] = GM_j
            GM_errs[isub] = res_arrays["GM_err"][j]
            taus[isub] = res_arrays["tau"][j]
            tau_errs[isub] = res_arrays["tau_err"][j]
            alphas[isub] = res_arrays["alpha"][j]
            alpha_errs[isub] = res_arrays["alpha_err"][j]
            snrs_sub[isub] = res_arrays["snr"][j]
            dof = max(float(res_arrays["dof"][j]), 1.0)
            red_chi2s[isub] = res_arrays["chi2"][j] / dof
            nfevals[isub] = res_arrays["nfeval"][j]
            rcs[isub] = res_arrays["rc"][j]
            nu_refs_sub[isub] = (res_arrays["nu_DM"][j],
                                 res_arrays["nu_GM"][j],
                                 res_arrays["nu_tau"][j])
            scales_full[isub] = scales_arr[j]
            scale_errs_full[isub] = scale_errs_arr[j]
            channel_snrs_full[isub] = channel_snrs_arr[j]
            covariances[isub] = covs[j]
            MJDs[isub] = toa_mjd.to_float()

            if print_flux:
                okc = np.asarray(d.ok_ichans[isub], int)
                means = modelx.mean(axis=1)
                profile_fluxes[isub, okc] = means[okc] * \
                    scales_full[isub, okc]
                profile_flux_errs[isub, okc] = np.abs(means[okc]) * \
                    scale_errs_full[isub, okc]
                fl, fl_err = weighted_mean(profile_fluxes[isub, okc],
                                           profile_flux_errs[isub, okc])
                ffreq, _ = weighted_mean(freqs0[okc],
                                         profile_flux_errs[isub, okc])
                fluxes[isub], flux_errs[isub] = fl, fl_err
                flux_freqs[isub] = ffreq

            okc = np.asarray(d.ok_ichans[isub], int)
            freqsx = freqs0[okc]
            toa_flags = {}
            DM_out, DM_err_out = DM_j, float(DM_errs[isub])
            if not self.fit_flags[1]:
                DM_out = DM_err_out = None
            if self.fit_flags[2]:
                toa_flags["gm"] = GM_j
                toa_flags["gm_err"] = float(GM_errs[isub])
            if self.fit_flags[3]:
                toa_flags.update(scattering_toa_flags(
                    float(res_arrays["tau"][j]),
                    float(res_arrays["tau_err"][j]),
                    float(res_arrays["nu_tau"][j]),
                    float(res_arrays["alpha"][j]),
                    float(res_arrays["alpha_err"][j]), P, df, log10_tau,
                    bool(self.fit_flags[4])))
            toa_flags["be"] = d.backend
            toa_flags["fe"] = d.frontend
            toa_flags["f"] = f"{d.frontend}_{d.backend}"
            toa_flags["nbin"] = int(nbin)
            toa_flags["nch"] = int(nchan)
            toa_flags["nchx"] = int(len(freqsx))
            toa_flags["bw"] = float(freqsx.max() - freqsx.min()) \
                if len(freqsx) else 0.0
            toa_flags["chbw"] = abs(float(d.bw)) / nchan
            toa_flags["subint"] = int(isub)
            toa_flags["tobs"] = float(d.subtimes[isub])
            toa_flags["fratio"] = float(freqsx.max() / freqsx.min()) \
                if len(freqsx) else 1.0
            toa_flags["tmplt"] = self.modelfile
            toa_flags["snr"] = float(res_arrays["snr"][j])
            if nu_ref_DM is None and self.fit_flags[1]:
                toa_flags["phi_DM_cov"] = float(covs[j][0, 1])
            toa_flags["gof"] = float(red_chi2s[isub])
            if quality_flags:
                toa_flags["nfev"] = int(res_arrays["nfeval"][j])
                toa_flags["chi2"] = float(res_arrays["chi2"][j])
            if print_phase:
                toa_flags["phs"] = phi
                toa_flags["phs_err"] = float(phi_errs[isub])
            if print_flux:
                toa_flags["flux"] = float(fluxes[isub])
                toa_flags["flux_err"] = float(flux_errs[isub])
                toa_flags["flux_ref_freq"] = float(flux_freqs[isub])
            if print_parangle:
                toa_flags["par_angle"] = float(d.parallactic_angles[isub])
            toa_flags.update(addtnl_toa_flags)
            self.TOA_list.append(TOA(
                datafile, float(res_arrays["nu_DM"][j]), toa_mjd,
                float(TOA_errs[isub]), d.telescope, d.telescope_code,
                DM_out, DM_err_out, toa_flags))

        DeltaDM_mean, DeltaDM_err = delta_dm_stats(
            DMs[ok] - DM0_arch, DM_errs[ok])
        self.order.append(datafile)
        self.obs.append(d.telescope_code)
        self.doppler_fs.append(np.asarray(d.doppler_factors))
        self.nu0s.append(d.nu0)
        self.nu_fits.append(nu_fit_arr)
        self.nu_refs.append(nu_refs_sub)
        self.ok_isubs.append(ok)
        self.epochs.append(d.epochs)
        self.MJDs.append(MJDs)
        self.Ps.append(np.asarray(d.Ps))
        self.phis.append(phis)
        self.phi_errs.append(phi_errs)
        self.TOAs.append(TOAs_arr)
        self.TOA_errs.append(TOA_errs)
        self.DM0s.append(DM0_arch)
        self.DMs.append(DMs)
        self.DM_errs.append(DM_errs)
        self.DeltaDM_means.append(DeltaDM_mean)
        self.DeltaDM_errs.append(DeltaDM_err)
        self.GMs.append(GMs)
        self.GM_errs.append(GM_errs)
        self.taus.append(taus)
        self.tau_errs.append(tau_errs)
        self.alphas.append(alphas)
        self.alpha_errs.append(alpha_errs)
        self.scales.append(scales_full)
        self.scale_errs.append(scale_errs_full)
        self.snrs.append(snrs_sub)
        self.channel_snrs.append(channel_snrs_full)
        self.profile_fluxes.append(profile_fluxes)
        self.profile_flux_errs.append(profile_flux_errs)
        self.fluxes.append(fluxes)
        self.flux_errs.append(flux_errs)
        self.flux_freqs.append(flux_freqs)
        self.covariances.append(covariances)
        self.red_chi2s.append(red_chi2s)
        self.nfevals.append(nfevals)
        self.rcs.append(rcs)
        self.fit_durations.append(fit_duration)
        if not quiet:
            tot = time.time() - t_start + load_times.get(datafile, 0.0)
            med = np.nanmedian(phi_errs[ok]) * np.mean(d.Ps[ok]) * 1e6
            log("--------------------------\n"
                f"{datafile}\n"
                f"~{fit_duration / max(nok, 1):.4f} sec/TOA (fit), "
                f"{tot:.2f} sec total\n"
                f"Med. TOA error is {med:.3f} us", quiet=quiet)
        return len(groups)

    def _fitted_model(self, iarch, isub, d, modelx, freqs0):
        """The template rotated onto the (dispersed) data at the fitted
        (phi, DM), including any fitted scattering: the reconstruction
        the reference's show_fit draws (pptoas.py:1375-1476).  Host
        float64 out; the rotation runs on self.device."""
        nbin = modelx.shape[-1]
        dev = self.device
        tau_r = float(self.taus[iarch][isub])
        port_model = np.array(modelx, float)
        if np.isfinite(tau_r) and tau_r > 0.0:
            tt = scattering_times(
                tau_r, float(self.alphas[iarch][isub]),
                torch.as_tensor(freqs0, dtype=torch.float64, device=dev),
                float(self.nu_refs[iarch][isub][2]))
            B = scattering_portrait_FT(tt, nbin // 2 + 1).cpu().numpy()
            port_model = np.fft.irfft(B * np.fft.rfft(port_model, axis=-1),
                                      n=nbin, axis=-1)
        phi = float(self.phis[iarch][isub])
        DM = float(self.DMs[iarch][isub])
        df = float(self.doppler_fs[iarch][isub]) if self.bary else 1.0
        return rotate_portrait(
            torch.as_tensor(port_model, device=dev), -phi, -DM / df,
            float(self.Ps[iarch][isub]),
            torch.as_tensor(freqs0, dtype=torch.float64, device=dev),
            float(self.nu_refs[iarch][isub][0])).cpu().numpy()

    def show_subint(self, datafile=None, isub=0, show=True,
                    savefig=False):
        """Display one subintegration portrait (reference
        pptoas.py:1345-1373; viz/)."""
        from ..viz.plots import show_portrait

        datafile = datafile or self.order[0]
        d = load_data(datafile, dedisperse=False, dededisperse=True,
                      tscrunch=self.tscrunch, pscrunch=True, quiet=True)
        return show_portrait(
            np.asarray(d.subints[isub, 0]) *
            (np.asarray(d.weights[isub]) > 0)[:, None],
            d.phases, d.freqs[isub],
            title=f"{datafile} subint {isub}", show=show,
            savefig=savefig or None)

    def show_fit(self, datafile=None, isub=0, show=True, savefig=False):
        """Data / fitted-model / residual triptych of one subint
        (reference pptoas.py:1375-1476; viz/): the template rotated and
        scaled by the fit, on self.device."""
        from ..viz.plots import show_residual_plot

        datafile = datafile or self.order[0]
        iarch = self.order.index(datafile)
        d = load_data(datafile, dedisperse=False, dededisperse=True,
                      tscrunch=self.tscrunch, pscrunch=True, quiet=True)
        freqs0 = np.asarray(d.freqs[0], float)
        modelx = self.model.portrait(freqs0, d.nbin,
                                     P=float(np.mean(d.Ps)))
        aligned = self._fitted_model(iarch, isub, d, modelx, freqs0)
        scaled = self.scales[iarch][isub][:, None] * aligned
        return show_residual_plot(
            np.asarray(d.subints[isub, 0]), scaled, d.phases, freqs0,
            noise_stds=np.asarray(d.noise_stds[isub, 0]),
            weights=np.asarray(d.weights[isub]),
            titles=(f"{datafile} subint {isub}",
                    str(self.modelfile), "Residuals"),
            show=show, savefig=savefig or None, device=self.device)

    def get_channels_to_zap(self, SNR_threshold=8.0, rchi2_threshold=1.3,
                            iterate=True, show=False, device=None,
                            telemetry=None, zap_device=None):
        """Flag channels with bad per-channel reduced chi2 or low S/N
        (reference pptoas.py:1266-1343).  Requires get_TOAs() results;
        fills self.zap_channels as [archive][subint] index lists.

        Per archive, the template is rotated onto every usable subint at
        its fitted (phi, DM/df) in one batched float64 call on
        self.device, and the per-channel reduced chi^2 of the residual
        feeds the cut of quality/postfit: the host numpy oracle, or with
        the ``zap_device`` tri-state (None follows config.zap_device;
        'auto' = on CUDA devices) its torch twin on self.device, which
        flags the same channels.  telemetry: a trace path or Tracer; one
        ``zap_propose`` per archive.  show: draw show_fit for every subint
        with a flagged channel (the JAX package accepts show and draws
        nothing).  device: the JAX package's name of the same tri-state
        (the torch device is self.device); give one of the two."""
        from .zap import resolve_zap_device

        if device is not None and zap_device is not None \
                and device != zap_device:
            raise ValueError("get_channels_to_zap: device and zap_device "
                             "name one tri-state; got both, differing")
        if zap_device is None:
            zap_device = device
        use_device = resolve_zap_device(zap_device, self.device)
        dev = self.device
        tracer, own_tracer = resolve_tracer(telemetry,
                                            run="get_channels_to_zap")
        self.zap_channels = []
        try:
            for iarch, datafile in enumerate(self.order):
                self.zap_channels.append(self._archive_zaps(
                    iarch, datafile, use_device, dev, tracer,
                    SNR_threshold, rchi2_threshold, iterate))
        finally:
            if own_tracer:
                tracer.close()
        if show:
            for datafile, zaps in zip(self.order, self.zap_channels):
                for isub, chans in enumerate(zaps):
                    if chans:
                        self.show_fit(datafile, isub, show=True)
        return self.zap_channels

    def _archive_zaps(self, iarch, datafile, use_device, dev, tracer,
                      SNR_threshold, rchi2_threshold, iterate):
        """One archive's post-fit cut for get_channels_to_zap: the
        [subint] lists of flagged channels."""
        from ..quality.postfit import postfit_cut_device, postfit_cut_np

        d = load_data(datafile, dedisperse=False, dededisperse=True,
                      tscrunch=self.tscrunch, pscrunch=True, quiet=True)
        nbin, nchan = d.nbin, d.nchan
        freqs0 = np.asarray(d.freqs[0], float)
        modelx = self.model.portrait(freqs0, nbin,
                                     P=float(np.mean(d.Ps)))
        ok = np.asarray(self.ok_isubs[iarch], int)
        nok = len(ok)
        t0 = time.perf_counter()
        chan_rchi2 = np.zeros((nok, nchan))
        chan_snr = np.zeros((nok, nchan))
        snr_tot = np.full(nok, np.nan)
        okc_mask = np.zeros((nok, nchan), bool)
        for j, isub in enumerate(ok):
            okc_mask[j, np.asarray(d.ok_ichans[isub], int)] = True
        rows = np.flatnonzero(okc_mask.any(axis=1))
        if len(rows):
            subs = ok[rows]
            f64 = dict(dtype=torch.float64, device=dev)
            df = (np.asarray(self.doppler_fs[iarch])[subs] if self.bary
                  else np.ones(len(subs)))
            phi = torch.as_tensor(self.phis[iarch][subs], **f64)
            DM = torch.as_tensor(self.DMs[iarch][subs], **f64)
            P = torch.as_tensor(np.asarray(d.Ps)[subs], **f64)
            nu_ref = torch.as_tensor(self.nu_refs[iarch][subs, 0], **f64)
            aligned = rotate_portrait(
                torch.as_tensor(modelx, **f64), -phi[:, None],
                (-DM / torch.as_tensor(df, **f64))[:, None], P[:, None],
                torch.as_tensor(freqs0, **f64), nu_ref[:, None])
            port = torch.as_tensor(
                np.asarray(d.subints[subs, 0], float), **f64)
            scales = torch.as_tensor(self.scales[iarch][subs], **f64)
            noise = np.asarray(d.noise_stds[subs, 0], float)
            noise = torch.as_tensor(np.where(noise > 0, noise, 1.0),
                                    **f64)
            resid = port - scales[..., None] * aligned
            chan_rchi2[rows] = ((resid ** 2).sum(dim=-1) / noise ** 2
                                / max(nbin - 1, 1)).cpu().numpy()
            chan_snr[rows] = self.channel_snrs[iarch][subs]
            snr_tot[rows] = self.snrs[iarch][subs]
        if not nok:
            bad = np.zeros((0, nchan), bool)
        elif use_device:
            bad = postfit_cut_device(
                chan_rchi2, chan_snr, snr_tot, okc_mask,
                SNR_threshold=SNR_threshold,
                rchi2_threshold=rchi2_threshold, iterate=iterate,
                device=dev)
        else:
            bad = postfit_cut_np(
                chan_rchi2, chan_snr, snr_tot, okc_mask,
                SNR_threshold=SNR_threshold,
                rchi2_threshold=rchi2_threshold, iterate=iterate)
        arch_zaps = [[] for _ in range(d.nsub)]
        for j, isub in enumerate(ok):
            arch_zaps[isub] = sorted(int(c) for c in np.flatnonzero(bad[j]))
        if tracer.enabled:
            tracer.emit("zap_propose", datafile=datafile,
                        n_channels=int(bad.sum()), n_iter=0,
                        device=bool(use_device),
                        wall_s=round(time.perf_counter() - t0, 6))
        return arch_zaps

    def apply_one_DM(self):
        """Replace each TOA's DM with the per-archive DM0 + weighted
        mean DeltaDM, inflating errors (the CLI --one_DM behavior)."""
        for iarch, datafile in enumerate(self.order):
            one_DM = self.DM0s[iarch] + self.DeltaDM_means[iarch]
            for toa in self.TOA_list:
                if toa.archive == datafile and toa.DM is not None:
                    toa.DM = one_DM
                    toa.DM_error = self.DeltaDM_errs[iarch]
                    toa.flags["one_DM"] = "True"

    def get_narrowband_TOAs(self, datafile=None, tscrunch=False,
                            fit_scat=False, log10_tau=True,
                            scat_guess=None, print_phase=False,
                            addtnl_toa_flags={}, max_iter=40, quiet=None):
        """Per-channel FFTFIT TOAs (the JAX package's
        get_narrowband_TOAs): every (subint, channel) profile of an
        archive in one batched fit_phase_shift_batch call on the device.

        fit_scat fits a per-channel scattering timescale beside the
        phase: the complex engine on (nsub * nchan) single-channel
        portraits with (phi, tau) free, each tau referenced to its
        channel's frequency.  scat_guess: a (tau [s], freq [MHz], alpha)
        seed, 'auto' (the broadband estimate_tau_batch per subint scaled
        to each channel with the default index) or None (half a bin).
        The linear parameterization (log10_tau=False) needs scat_guess."""
        from ..fit.phase_shift import fit_phase_shift_batch

        scat_guess = _validate_scat_guess(scat_guess, fit_scat)
        if quiet is None:
            quiet = self.quiet
        if fit_scat and not log10_tau and scat_guess is None:
            raise ValueError(
                "get_narrowband_TOAs: log10_tau=False needs scat_guess "
                "(the linear parameterization cannot converge from the "
                "neutral half-bin seed)")
        datafiles = self.datafiles if datafile is None else [datafile]
        for datafile in datafiles:
            try:
                d = load_for_toas(datafile, tscrunch=tscrunch, quiet=quiet)
            except Exception as e:
                log(f"Skipping {datafile}: {e}", level="warn")
                continue
            ok = np.asarray(d.ok_isubs, int)
            if len(ok) == 0:
                continue
            nchan, nbin = d.nchan, d.nbin
            nok = len(ok)
            freqs0 = np.asarray(d.freqs[0], float)
            P_mean = float(np.mean(d.Ps[ok]))
            modelx = self.model.portrait(freqs0, nbin, P=P_mean)
            ports = np.asarray(d.subints[ok, 0])
            noise = np.asarray(d.noise_stds[ok, 0])
            taus = tau_errs = None
            if fit_scat:
                r = self._narrowband_scatter_fit(
                    ports, modelx, noise, freqs0, np.asarray(d.Ps[ok]),
                    np.asarray(d.weights[ok] > 0.0, float), P_mean,
                    scat_guess, log10_tau, max_iter)
                phase, phase_err, snr, red_chi2, taus, tau_errs = r
            else:
                r = fit_phase_shift_batch(ports, modelx, noise,
                                          device=self.device)
                phase, phase_err, snr, red_chi2 = (
                    v.cpu().numpy() for v in (r.phase, r.phase_err, r.snr,
                                              r.red_chi2))
            self.order.append(datafile)
            self.ok_isubs.append(ok)
            for j, isub in enumerate(ok):
                P = float(d.Ps[isub])
                for ichan in np.asarray(d.ok_ichans[isub], int):
                    toa_mjd = d.epochs[isub].add_seconds(
                        float(phase[j, ichan]) * P + d.backend_delay)
                    toa_flags = {
                        "be": d.backend, "fe": d.frontend,
                        "f": f"{d.frontend}_{d.backend}",
                        "nbin": int(nbin), "subint": int(isub),
                        "chan": int(ichan),
                        "tobs": float(d.subtimes[isub]),
                        "tmplt": self.modelfile,
                        "snr": float(snr[j, ichan]),
                        "gof": float(red_chi2[j, ichan]),
                    }
                    if fit_scat:
                        toa_flags.update(scat_time_flags(
                            float(taus[j, ichan]),
                            float(tau_errs[j, ichan]), P, log10_tau))
                        # each channel's tau is referenced to its own
                        # frequency
                        toa_flags["scat_ref_freq"] = float(freqs0[ichan])
                    if print_phase:
                        toa_flags["phs"] = float(phase[j, ichan])
                        toa_flags["phs_err"] = float(phase_err[j, ichan])
                    toa_flags.update(addtnl_toa_flags)
                    self.TOA_list.append(TOA(
                        datafile, float(freqs0[ichan]), toa_mjd,
                        float(phase_err[j, ichan]) * P * 1e6,
                        d.telescope, d.telescope_code, None, None,
                        toa_flags))

    def _narrowband_scatter_fit(self, ports, modelx, noise, freqs0, Ps,
                                masks, P_mean, scat_guess, log10_tau,
                                max_iter):
        """get_narrowband_TOAs' fit_scat branch: (phase, phase_err, snr,
        red_chi2, tau, tau_err), each (nok, nchan) host numpy."""
        import torch

        nok, nchan, nbin = ports.shape
        n = nok * nchan
        flat_freqs = np.broadcast_to(freqs0, (nok, nchan)).reshape(n, 1)
        if scat_guess == "auto":
            # the broadband estimate per subint, scaled to each channel
            # with the default index
            def f32(x):
                return torch.as_tensor(np.asarray(x, np.float32),
                                       device=self.device)

            tau_sub = estimate_tau_batch(f32(ports), f32(modelx),
                                         f32(noise)).cpu().numpy()
            nu_mid = float(np.mean(freqs0))
            tau_seed = (tau_sub[:, None] * (freqs0[None, :] / nu_mid)
                        ** scattering_alpha).reshape(n)
        elif scat_guess is not None:
            t_s, nu_s, a_s = scat_guess
            tau_seed = (t_s / P_mean) * (flat_freqs[:, 0] / nu_s) ** a_s
        else:
            tau_seed = np.full(n, 0.5 / nbin)
        th0 = np.zeros((n, 5))
        th0[:, 3] = (np.log10(np.maximum(tau_seed, 1e-12)) if log10_tau
                     else tau_seed)
        models = torch.as_tensor(np.asarray(modelx)).expand(
            nok, nchan, nbin).reshape(n, 1, nbin)
        r = fit_portrait_batch(
            ports.reshape(n, 1, nbin), models, noise.reshape(n, 1),
            flat_freqs, np.repeat(Ps, nchan), flat_freqs[:, 0],
            theta0=th0, fit_flags=FitFlags(True, False, False, True, False),
            chan_masks=masks.reshape(n, 1), log10_tau=log10_tau,
            max_iter=max_iter, device=self.device)
        r = {k: v.detach().cpu().numpy() for k, v in r._asdict().items()}
        dof = np.maximum(r["dof"], 1.0)
        return tuple(np.reshape(v, (nok, nchan)) for v in (
            r["phi"], r["phi_err"], r["snr"], r["chi2"] / dof, r["tau"],
            r["tau_err"]))

    def get_crosscheck_TOAs(self, datafile=None, tscrunch=False, DM0=None,
                            oversamp=16, addtnl_toa_flags={},
                            append_to_list=False, quiet=None):
        """Independent-algorithm wideband TOAs on the host (NumPy,
        float64), sharing no code with the fit engines: channels are
        derotated by the header DM and frequency-scrunched with 1/sigma^2
        weights, the phase is the argmax of the oversampled circular CCF
        with the scrunched template refined by a parabola, and the error
        the FFTFIT curvature formula.  Returns the TOA list;
        append_to_list=True also appends it to TOA_list."""
        if quiet is None:
            quiet = self.quiet
        datafiles = self.datafiles if datafile is None else [datafile]
        out = []
        for datafile in datafiles:
            try:
                d = load_for_toas(datafile, tscrunch=tscrunch, quiet=quiet)
            except Exception as e:
                log(f"Skipping {datafile}: {e}", level="warn")
                continue
            ok = np.asarray(d.ok_isubs, int)
            if len(ok) == 0:
                continue
            nchan, nbin = d.nchan, d.nbin
            nharm = nbin // 2 + 1
            freqs0 = np.asarray(d.freqs[0], float)
            P_mean = float(np.mean(d.Ps[ok]))
            modelx = np.asarray(
                self.model.portrait(freqs0, nbin, P=P_mean), float)
            DM_guess = float(d.DM) if d.DM else (DM0 or 0.0)
            k = np.arange(nharm)
            nlag = nbin * oversamp
            Mf_chan = np.fft.rfft(modelx, axis=-1)
            for isub in ok:
                P = float(d.Ps[isub])
                okc = np.asarray(d.ok_ichans[isub], int)
                if len(okc) == 0:
                    continue
                port = np.asarray(d.subints[isub, 0], float)
                sig = np.asarray(d.noise_stds[isub, 0], float)
                wch = np.zeros(nchan)
                wch[okc] = np.where(sig[okc] > 0, sig[okc] ** -2.0, 0.0)
                # derotate the data by the header DM so its channels add
                # coherently; the template's channels are aligned
                delays = (Dconst * DM_guess / P) * (
                    freqs0 ** -2.0 - float(d.nu0) ** -2.0)
                ph = np.exp(2.0j * np.pi * np.outer(delays, k))
                Df = (np.fft.rfft(port, axis=-1) * ph * wch[:, None]).sum(0)
                Mf = (Mf_chan * wch[:, None]).sum(0)
                cc = np.fft.irfft(Df * np.conj(Mf), n=nlag)
                j0 = int(np.argmax(cc))
                ym, y0, yp = cc[(j0 - 1) % nlag], cc[j0], cc[(j0 + 1) % nlag]
                denom = ym - 2.0 * y0 + yp
                frac = 0.5 * (ym - yp) / denom if denom != 0.0 else 0.0
                phi = (j0 + frac) / nlag
                phi = (phi + 0.5) % 1.0 - 0.5
                # FFTFIT curvature error from the scrunched profile's
                # noise (E|rfft_k|^2 = nbin sigma^2 for white noise)
                prof = np.fft.irfft(Df / max(wch.sum(), 1e-300), n=nbin)
                spec = np.abs(np.fft.rfft(prof)) ** 2
                noise = np.sqrt(np.mean(spec[-len(spec) // 4:]) / nbin)
                sigF = noise * np.sqrt(nbin / 2.0) * max(wch.sum(), 1e-300)
                e = np.exp(2.0j * np.pi * k * phi)
                p = (np.abs(Mf) ** 2).sum() / sigF ** 2
                c = np.real(Df * np.conj(Mf) * e).sum() / sigF ** 2
                c2 = np.real(Df * np.conj(Mf) * e
                             * (2.0 * np.pi * k) ** 2).sum() / sigF ** 2
                scale = max(c, 0.0) / p
                phi_err = (abs(scale * c2)) ** -0.5 \
                    if scale > 0 and c2 != 0 else 1.0 / nbin
                toa_mjd = d.epochs[isub].add_seconds(
                    phi * P + d.backend_delay)
                toa_flags = {
                    "be": d.backend, "fe": d.frontend,
                    "f": f"{d.frontend}_{d.backend}",
                    "nbin": int(nbin), "subint": int(isub),
                    "tobs": float(d.subtimes[isub]),
                    "tmplt": self.modelfile, "alg": "ccf-parabolic",
                }
                toa_flags.update(addtnl_toa_flags)
                toa = TOA(datafile, float(d.nu0), toa_mjd,
                          phi_err * P * 1e6, d.telescope,
                          d.telescope_code, None, None, toa_flags)
                out.append(toa)
                if append_to_list:
                    self.TOA_list.append(toa)
        return out

    def get_psrchive_TOAs(self, datafile=None, tscrunch=False,
                          algorithm="PGS", addtnl_toa_flags={},
                          quiet=None, **kwargs):
        """The reference's PSRCHIVE-delegating cross-check, answered by
        get_crosscheck_TOAs (PSRCHIVE is not a dependency).  algorithm
        and any pat-oriented keywords are accepted and ignored, with a
        log line; each TOA's -alg flag names the estimator."""
        if (algorithm != "PGS" or kwargs) and not (quiet or self.quiet):
            ignored = ([f"algorithm={algorithm!r}"] if algorithm != "PGS"
                       else []) + [f"{k}=..." for k in kwargs]
            log("get_psrchive_TOAs: ignoring PSRCHIVE-specific "
                f"option(s) {', '.join(ignored)}")
        return self.get_crosscheck_TOAs(
            datafile=datafile, tscrunch=tscrunch,
            addtnl_toa_flags=addtnl_toa_flags, quiet=quiet)

