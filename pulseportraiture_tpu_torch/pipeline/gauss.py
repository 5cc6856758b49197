"""Evolving Gaussian-component template building, the ppgauss pipeline
(counterpart of pulseportraiture_tpu/pipeline/gauss.py).

An initial profile fit (the breadth-first auto fit over component
counts, or a single auto Gaussian), then the portrait fit, alternating
with a (phi, DM) convergence check that rotates the data between
iterations; JOIN un-rotation at the end; .gmodel and error-file output.

Where it runs: the JAX package wraps this whole path in
utils/device.on_host only because some TPU runtimes cannot compile
complex FFTs.  The card can, so the model evaluations, both LM engines
and the convergence fit run on the portrait's ``device``, in float64
(the LM's ftol and the |phi| < sigma_phi decision need it).  Only what
the JAX package does in numpy stays on the host: the .gmodel I/O, the
trial seeds and their selection, the JOIN channel bookkeeping.
"""

import numpy as np
import torch

from ..config import default_model_code, scattering_alpha
from ..fit.gauss import (fit_gaussian_portrait, fit_gaussian_profile,
                         fit_profile_trials, gen_gaussian_portrait_flat,
                         use_gauss_device)
from ..fit.phase_shift import fit_phase_shift
from ..fit.portrait import FitFlags, fit_portrait
from ..io.gmodel import (model_from_flat, model_to_flat, read_gmodel,
                         write_gmodel)
from ..io.psrfits import noise_std_ps
from ..models.gaussian import gen_gaussian_profile
from ..ops.phasor import guess_fit_freq
from .portrait import DataPortrait as _BasePortrait
from .portrait import lap

__all__ = ["portrait_fit_flags", "profile_to_portrait_params",
           "GaussPortrait", "DataPortrait"]


def portrait_fit_flags(ngauss, fixloc=False, fixwid=False, fixamp=False,
                       fixscat=True, fiducial_gaussian=False):
    """The portrait-layout fit flags (ppgauss.py:147-166): dc and every
    component's (loc, wid, amp) vary; tau and the evolution moduli
    follow the fix* options; fiducial_gaussian pins the first
    component's loc evolution."""
    flags = np.zeros(2 + 6 * ngauss, int)
    flags[0] = 1                       # dc
    flags[1] = int(not fixscat)        # tau
    for ig in range(ngauss):
        flags[2 + 6 * ig + 0] = 1                  # loc
        flags[2 + 6 * ig + 1] = int(not fixloc)    # mloc
        flags[2 + 6 * ig + 2] = 1                  # wid
        flags[2 + 6 * ig + 3] = int(not fixwid)    # mwid
        flags[2 + 6 * ig + 4] = 1                  # amp
        flags[2 + 6 * ig + 5] = int(not fixamp)    # mamp
    if fiducial_gaussian and ngauss:
        flags[2 + 1] = 0  # first component's loc evolution fixed
    return flags


def profile_to_portrait_params(profile_params):
    """[dc, tau, (loc, wid, amp)*g] -> [dc, tau, (loc, mloc, wid, mwid,
    amp, mamp)*g] with zero evolution slopes."""
    profile_params = np.asarray(profile_params, float)
    ngauss = (len(profile_params) - 2) // 3
    out = np.zeros(2 + 6 * ngauss)
    out[:2] = profile_params[:2]
    for ig in range(ngauss):
        loc, wid, amp = profile_params[2 + 3 * ig: 5 + 3 * ig]
        out[2 + 6 * ig: 8 + 6 * ig] = [loc, 0.0, wid, 0.0, amp, 0.0]
    return out


class GaussPortrait(_BasePortrait):
    """DataPortrait with make_gaussian_model (alias ``DataPortrait`` for
    ppgauss-style scripts)."""

    # -- initial profile fit ----------------------------------------------
    def select_ref_profile(self, nu_ref=None, bw_ref=None):
        """Mean profile of the (nu_ref, bw) band slice, or of the whole
        portrait.  Returns (profile, nu_ref)."""
        freqs = self.freqs[0]
        okc = self.ok_ichans
        if nu_ref is None:
            prof = self.portx.mean(axis=0)
            nu_ref = float(freqs[okc].mean())
        else:
            bw_ref = bw_ref or abs(self.bw) / 4.0
            sel = okc[np.abs(freqs[okc] - nu_ref) <= bw_ref / 2.0]
            if not len(sel):
                raise ValueError("no unzapped channels in the reference "
                                 "band slice")
            prof = self.port[sel].mean(axis=0)
        return np.asarray(prof, float), float(nu_ref)

    def fit_profile(self, profile=None, tau=0.0, fixscat=True,
                    auto_gauss=0.0, profile_fit_flags=None, show=True):
        """Fit Gaussian components to one profile.  With auto_gauss != 0
        (the initial width [rot]) a single Gaussian, non-interactively
        (ppgauss.py:450-487); otherwise the interactive GaussianSelector
        (viz/selector.py; show=True opens its window)."""
        if profile is None:
            profile, _ = self.select_ref_profile()
        noise = float(noise_std_ps(profile))
        if not auto_gauss:
            from ..viz.selector import GaussianSelector

            sel = GaussianSelector(profile, noise, tau=tau, fixscat=fixscat,
                                   show=show, device=self.device)
            self.init_params = np.asarray(sel.fitted_params)
            self.init_param_errs = np.asarray(sel.fit_errs)
            self.ngauss = (len(self.init_params) - 2) // 3
            return self.init_params
        amp = float(profile.max())
        wid = float(auto_gauss)
        first = amp * gen_gaussian_profile(
            {"dc": 0.0, "locs": np.array([0.5]), "wids": np.array([wid]),
             "amps": np.array([1.0]), "mlocs": np.zeros(1),
             "mwids": np.zeros(1), "mamps": np.zeros(1), "tau": 0.0,
             "alpha": 0.0}, len(profile), scattered=False,
            device=self.device)
        loc = 0.5 + float(fit_phase_shift(profile, first, noise,
                                          device=self.device).phase)
        loc %= 1.0
        fgp = fit_gaussian_profile(
            profile, [0.0, tau, loc, wid, amp], noise,
            fit_flags=profile_fit_flags, fit_scattering=not fixscat,
            quiet=True, device=self.device)
        self.init_params = np.asarray(fgp.fitted_params)
        self.init_param_errs = np.asarray(fgp.fit_errs)
        self.ngauss = (len(self.init_params) - 2) // 3
        return self.init_params

    def auto_fit_profile(self, profile=None, max_ngauss=8, wid0=0.02,
                         rchi2_tol=0.1, tau=0.0, fixscat=True,
                         gauss_device=None, quiet=True):
        """Breadth-first multi-component auto fit: every ngauss in
        1..max_ngauss, seeded by matching pursuit on the profile, fit at
        once on the batched engine (or one at a time on the serial
        oracle lane: gauss_device, None -> config.gauss_device), the
        best reduced chi2 selected on the host by the serial add-refit
        loop's rule."""
        max_ngauss = int(max_ngauss)
        if max_ngauss < 1:
            raise ValueError(
                f"auto_fit_profile needs max_ngauss >= 1 (got "
                f"{max_ngauss}): no trial component counts to fit")
        if profile is None:
            profile, _ = self.select_ref_profile()
        profile = np.asarray(profile, float)
        noise = float(noise_std_ps(profile))
        with lap("profile trials"):
            sel = fit_profile_trials(
                profile, max_ngauss, noise, wid0=wid0, tau=tau,
                fit_scattering=not fixscat, rchi2_tol=rchi2_tol,
                serial=not use_gauss_device(gauss_device, self.device),
                device=self.device)
        if sel is None:
            raise ValueError(
                f"auto_fit_profile: every trial fit of "
                f"{self.datafile!r} failed (non-finite chi2 for all "
                f"ngauss in 1..{max_ngauss}); check the input profile "
                "and noise level")
        self.trials = sel
        self.init_params = sel.params
        self.init_param_errs = sel.param_errs
        self.ngauss = sel.ngauss
        if not quiet:
            print(f"auto_fit_profile: {self.ngauss} components, "
                  f"red chi2 = {sel.red_chi2s[sel.index]:.2f}")
        return self.init_params

    # -- the main loop -----------------------------------------------------
    def make_gaussian_model(self, modelfile=None, ref_prof=(None, None),
                            tau=0.0, fixloc=False, fixwid=False,
                            fixamp=False, fixscat=True, fixalpha=True,
                            scattering_index=scattering_alpha,
                            model_code=default_model_code, niter=0,
                            fiducial_gaussian=False, auto_gauss=0.0,
                            writemodel=False, outfile=None,
                            writeerrfile=False, errfile=None,
                            model_name=None, residplot=None,
                            gauss_device=None, max_ngauss=8,
                            quiet=False):
        """Fit the evolving-Gaussian portrait model (reference
        ppgauss.py:62-245; same options).  Returns the GaussianModel.
        residplot: a path; the data / model / residual figure is saved
        there (viz/)."""
        P = float(self.Ps[0])
        nbin = self.nbin
        njoin = len(getattr(self, "join_ichans", []))
        if modelfile:
            start_model = read_gmodel(modelfile, quiet=quiet)
            self.nu_ref = start_model.nu_ref
            model_code = start_model.code
            scattering_index = start_model.alpha
            init_portrait, _ = model_to_flat(start_model)
            init_portrait = init_portrait.copy()
            init_portrait[1] *= nbin / P  # tau seconds -> bins
            self.ngauss = start_model.ngauss
            model_name = model_name or start_model.name
        else:
            profile, nu_ref = self.select_ref_profile(*ref_prof)
            self.nu_ref = nu_ref
            if not len(np.atleast_1d(getattr(self, "init_params", []))):
                self.auto_fit_profile(profile, wid0=auto_gauss or 0.02,
                                      max_ngauss=max_ngauss, tau=tau,
                                      fixscat=fixscat,
                                      gauss_device=gauss_device,
                                      quiet=quiet)
            init_portrait = profile_to_portrait_params(self.init_params)
        model_name = model_name or (str(self.datafile) + ".gmodel")
        self.model_name = model_name
        self.model_code = model_code

        flags = portrait_fit_flags(self.ngauss, fixloc=fixloc,
                                   fixwid=fixwid, fixamp=fixamp,
                                   fixscat=fixscat,
                                   fiducial_gaussian=fiducial_gaussian)
        self._flags_cache = flags

        join_params = None
        if njoin:
            join_params = (self.join_ichans,
                           np.asarray(self.join_params, float),
                           np.asarray(self.join_fit_flags, int))

        self.nu_fit = float(guess_fit_freq(self._t(self.freqsxs[0]),
                                           self._t(self.SNRsxs[0])))
        errs = np.where(self.noise_stds > 0, self.noise_stds,
                        np.median(self.noise_stds[self.ok_ichans]))
        x0 = init_portrait
        self.niter = int(niter)
        self.iterations = []
        itern = 0
        while True:
            if not quiet:
                print(f"Fitting Gaussian model portrait... "
                      f"(iteration {itern})")
            with lap(f"portrait LM {itern}"):
                fgp = fit_gaussian_portrait(
                    self.port[self.ok_ichans], x0, scattering_index,
                    errs[self.ok_ichans], flags, int(not fixalpha),
                    self.freqsxs[0], self.nu_ref, model_code=model_code,
                    join_params=join_params, P=P, quiet=True,
                    device=self.device)
            self.fitted_params = np.asarray(fgp.fitted_params)
            self.fit_errs = np.asarray(fgp.fit_errs)
            self.portrait_red_chi2 = float(fgp.red_chi2)
            scattering_index = float(fgp.scattering_index)
            if njoin:
                self.join_params = list(np.asarray(fgp.join_fit, float))
                self.join_fit_errs = np.asarray(fgp.join_fit_errs, float)
            x0 = self.fitted_params
            self._rebuild_model(model_code, scattering_index, P)
            with lap(f"convergence fit {itern}"):
                converged = self.check_convergence(efac=1.0, quiet=quiet)
            self.iterations.append(dict(
                nfev=fgp.nfev, red_chi2=self.portrait_red_chi2,
                phi=self.phi, phierr=self.phierr, DM=self.DM,
                DMerr=self.DMerr, converged=converged))
            with lap(f"write {itern}"):
                if writemodel:
                    self.write_model(outfile=outfile, quiet=True)
                if writeerrfile:
                    self.write_errfile(errfile=errfile, quiet=True)
            itern += 1
            if converged or itern > self.niter:
                break
            # rotate the DATA by the fitted residual (phi, DM)
            # (ppgauss.py:198-202)
            if not njoin:
                self.rotate_stuff(phase=self.phi, DM=self.DM,
                                  nu_ref=self.nu_fit)

        # JOIN un-rotation at the end (ppgauss.py:213-231)
        if njoin:
            for ii in range(njoin):
                jic = self.join_ichans[ii]
                self.port[jic] = self._rotate(
                    self.port[jic], -self.join_params[2 * ii],
                    -self.join_params[2 * ii + 1], self.freqs[0][jic],
                    self.nu_ref)
            self._condense()

        self.scattering_index = scattering_index
        self.gaussian_model = self._to_gmodel(model_name, model_code,
                                              scattering_index,
                                              int(not fixalpha), flags, P)
        if residplot:
            from ..viz.plots import show_residual_plot

            show_residual_plot(self.port, np.asarray(self.model),
                               self.phases, self.freqs[0],
                               noise_stds=self.noise_stds,
                               weights=self.weights, show=False,
                               savefig=residplot, device=self.device)
        if not quiet:
            resid = self.portx - self.model[self.ok_ichans]
            print(f"\nResiduals mean: {resid.mean():.2e}")
            print(f"Residuals std:  {resid.std():.2e}")
            print(f"Data std:       "
                  f"{np.median(self.noise_stdsxs[0]):.2e}\n")
        return self.gaussian_model

    def _rebuild_model(self, model_code, alpha, P):
        self.model = gen_gaussian_portrait_flat(
            self.fitted_params, self.freqs[0], self.nu_ref, self.nbin,
            alpha, code=model_code, P=P, device=self.device).cpu().numpy()
        self.modelx = self.model[self.ok_ichans]

    def _to_gmodel(self, name, code, alpha, fit_alpha, flags, P):
        params = self.fitted_params.copy()
        params[1] *= P / self.nbin  # tau bins -> seconds
        return model_from_flat(name, code, self.nu_ref, params, flags,
                               alpha, fit_alpha)

    def check_convergence(self, efac=1.0, quiet=False):
        """Fit (phi, DM) of the data against the current model with the
        complex engine in float64 on the device: converged when both
        are within their errors (ppgauss.py:285-341; always a bool).
        float64 on every device: the port's device_f32 knob would run
        the engine in float32 on the card, and the |phi| < sigma_phi
        decision that ends --niter could flip."""
        portx = self.portx
        modelx = self.modelx
        njoin = len(getattr(self, "join_ichans", []))
        if njoin:
            portx = portx.copy()
            modelx = modelx.copy()
            for ii in range(njoin):
                jic = self.join_ichans[ii]
                # which rows of the condensed (ok_ichans) views hold this
                # join's channels: host index arithmetic, as in JAX
                okpos = np.searchsorted(self.ok_ichans, jic)
                okpos = okpos[(okpos < len(self.ok_ichans))
                              & (np.isin(jic, self.ok_ichans))]
                if not len(okpos):
                    continue
                phi_j = self.join_params[2 * ii]
                dDM_j = self.join_params[2 * ii + 1]
                fsel = self.freqsxs[0][okpos]
                portx[okpos] = self._rotate(portx[okpos], -phi_j, -dDM_j,
                                            fsel, self.nu_ref)
                modelx[okpos] = self._rotate(modelx[okpos], -phi_j,
                                             -dDM_j, fsel, self.nu_ref)
        res = fit_portrait(
            portx, modelx, self.noise_stdsxs[0], self.freqsxs[0],
            float(self.Ps[0]), nu_fit=self.nu_fit, nu_out=self.nu_fit,
            fit_flags=FitFlags(True, True, False, False, False),
            dtype=torch.float64, device=self.device)
        self.phi = float(res.phi)
        self.phierr = float(res.phi_err)
        self.DM = float(res.DM)
        self.DMerr = float(res.DM_err)
        self.red_chi2 = float(res.red_chi2)
        if not quiet:
            print(f" phase offset of {self.phi:.2e} +/- "
                  f"{self.phierr:.2e} [rot]")
            print(f" DM of {self.DM:.6e} +/- {self.DMerr:.2e} "
                  f"[cm**-3 pc]")
            print(f" red. chi**2 of {self.red_chi2:.2f}.")
        phase_ok = min(abs(self.phi), abs(1 - self.phi)) < \
            abs(self.phierr) * efac
        dm_ok = abs(self.DM) < abs(self.DMerr) * efac
        if phase_ok and dm_ok and not quiet:
            print("\nIteration converged.\n")
        return bool(phase_ok and dm_ok)

    # -- output ------------------------------------------------------------
    def write_model(self, outfile=None, quiet=False):
        """Write the fitted .gmodel (ppgauss.py:343-361; written after
        every iteration by make_gaussian_model)."""
        if not hasattr(self, "fitted_params"):
            raise RuntimeError("no fitted model yet")
        outfile = outfile or (str(self.datafile) + ".gmodel")
        model = self._to_gmodel(
            getattr(self, "model_name", outfile),
            getattr(self, "model_code", default_model_code),
            getattr(self, "scattering_index", scattering_alpha),
            0, self._current_flags(), float(self.Ps[0]))
        write_gmodel(model, outfile, quiet=quiet)
        return outfile

    def write_errfile(self, errfile=None, quiet=False):
        """Write the parameter errors in the .gmodel grammar
        (ppgauss.py:363-379)."""
        if not hasattr(self, "fit_errs"):
            raise RuntimeError("no fitted model yet")
        errfile = errfile or (str(self.datafile) + ".gmodel_errs")
        errs = self.fit_errs.copy()
        errs[1] *= float(self.Ps[0]) / self.nbin
        model = model_from_flat(
            getattr(self, "model_name", errfile) + "_errs",
            getattr(self, "model_code", default_model_code),
            self.nu_ref, errs, self._current_flags(),
            getattr(self, "scattering_index", scattering_alpha), 0)
        write_gmodel(model, errfile, quiet=quiet)
        return errfile

    def _current_flags(self):
        n = len(self.fitted_params)
        return getattr(self, "_flags_cache", np.ones(n, int))


# reference ppgauss scripts use the name DataPortrait
DataPortrait = GaussPortrait
