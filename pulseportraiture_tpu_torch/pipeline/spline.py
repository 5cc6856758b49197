"""PCA + B-spline template building, the ppspline pipeline (counterpart of
pulseportraiture_tpu/pipeline/spline.py).

The S/N-weighted mean profile, the weighted PCA, the significant-
eigenvector selection with auto-tuned wavelet smoothing, a parametric
B-spline fit of the projected shape curve against frequency, the model
regeneration, and .spl / .npz output (reference ppspline.py:39-217).

Where it runs: the JAX package pins this path to the host CPU
(utils/device.on_host) only because some TPU runtimes cannot compile
complex FFTs.  Here the PCA, the smoothing and the model evaluation run
on the portrait's ``device`` in float64; scipy's splprep
(models.spline.fit_spline_curve) and the file I/O stay on the host.
"""

import numpy as np

from ..io.splmodel import SplineModel, write_spline_model
from ..models.spline import (find_significant_eigvec, fit_spline_curve,
                             gen_spline_portrait, pca,
                             reconstruct_portrait)
from ..models.wavelet import smart_smooth
from .portrait import DataPortrait as _BasePortrait
from .portrait import lap

__all__ = ["snr_weighted_mean", "SplinePortrait", "DataPortrait"]


def snr_weighted_mean(dp):
    """The S/N-weighted mean profile of a portrait, the profile
    make_spline_model subtracts and smooths."""
    SNRsx = np.asarray(dp.SNRsxs[0], float)
    w = SNRsx / SNRsx.sum()
    # the trailing normalization is ~1.0 by construction; kept so this
    # equals the JAX package's to the last digit
    return (dp.portx * w[:, None]).sum(axis=0) / w.sum()


class SplinePortrait(_BasePortrait):
    """DataPortrait with make_spline_model / write_model (alias
    ``DataPortrait`` for ppspline-style scripts)."""

    def make_spline_model(self, max_ncomp=10, smooth=True,
                          snr_cutoff=150.0, rchi2_tol=0.1, k=3, sfac=1.0,
                          max_nbreak=None, model_name=None,
                          smooth_mean_prof=None, quiet=False, **kwargs):
        """Build the PCA + spline model; the reference's options and
        semantics (ppspline.py:39-217).  smooth_mean_prof: an externally
        smoothed mean profile (same nbin) used instead of the wavelet
        smart_smooth of the mean when smooth=True."""
        dev = self.device
        port = self.portx
        SNRsx = np.asarray(self.SNRsxs[0], float)
        noise_x = np.asarray(self.noise_stdsxs[0], float)
        pca_weights = SNRsx / SNRsx.sum()
        mean_prof = snr_weighted_mean(self)
        freqs = np.asarray(self.freqsxs[0], float)
        nbin = port.shape[1]
        if nbin % 2 != 0:
            if not quiet:
                print(f"nbin = {nbin} is odd; cannot wavelet_smooth.")
            smooth = False

        with lap("pca"):
            port_t = self._t(port)
            mean_t = self._t(mean_prof)
            eigval, eigvec = pca(port_t, mean_t, self._t(pca_weights))
            eigval = eigval.cpu().numpy()
            eigvec = eigvec.cpu().numpy()
        return_max = 10 if max_ncomp is None else min(max_ncomp, 10)
        with lap("find_significant_eigvec"):
            ieig, smooth_eigvec = find_significant_eigvec(
                eigvec, check_max=10, return_max=return_max,
                snr_cutoff=snr_cutoff, return_smooth=True,
                rchi2_tol=rchi2_tol, device=dev, **kwargs)
        if not smooth:
            smooth_eigvec = eigvec.copy()
        ncomp = len(ieig)
        if smooth:
            if smooth_mean_prof is not None:
                smooth_mean_prof = np.asarray(smooth_mean_prof, float)
                if smooth_mean_prof.shape != mean_prof.shape:
                    raise ValueError(
                        f"smooth_mean_prof shape "
                        f"{smooth_mean_prof.shape} != mean profile "
                        f"shape {mean_prof.shape}")
            else:
                with lap("smooth mean"):
                    smooth_mean_prof = smart_smooth(
                        mean_t, rchi2_tol=rchi2_tol,
                        device=dev).cpu().numpy()
            if not smooth_mean_prof.any():
                # smart_smooth zeroes a profile that no (nlevel, fact)
                # passes: right for noise eigenvectors, wrong for the
                # mean; keep the raw mean instead of a zero model
                smooth_mean_prof = mean_prof
            self.smooth_mean_prof = smooth_mean_prof
            self.smooth_eigvec = smooth_eigvec
        used_mean = smooth_mean_prof if smooth else mean_prof
        used_eigvec = smooth_eigvec[:, ieig] if ncomp else \
            np.zeros((nbin, 0))

        with lap("spline fit"):
            if ncomp == 0:
                proj_port = port[:, :0]
                tck = (np.array([freqs.min(), freqs.max()]),
                       np.zeros((0, 2)), 1)
                modelx = np.tile(used_mean, (len(freqs), 1))
                model = np.tile(used_mean, (len(self.freqs[0]), 1))
                reconst_port = modelx
            else:
                ev_t = self._t(used_eigvec)
                proj_port = ((port_t - mean_t) @ ev_t).cpu().numpy()
                reconst_port = reconstruct_portrait(
                    port_t, mean_t, ev_t).cpu().numpy()
                tck = fit_spline_curve(proj_port, freqs, flux_errs=noise_x,
                                       snrs=SNRsx, sfac=sfac,
                                       max_nbreak=max_nbreak, k=k)
                modelx = gen_spline_portrait(used_mean, freqs, used_eigvec,
                                             tck, device=dev).cpu().numpy()
                model = gen_spline_portrait(
                    used_mean, self.freqs[0], used_eigvec, tck,
                    device=dev).cpu().numpy()

        self.ieig = ieig
        self.ncomp = ncomp
        self.eigvec = eigvec
        self.eigval = eigval
        self.mean_prof = mean_prof
        self.proj_port = proj_port
        self.reconst_port = reconst_port
        self.tck = tck
        self.model_name = model_name or (str(self.datafile) + ".spl")
        self.model = model
        self.modelx = modelx
        self.spline_model = SplineModel(
            modelname=self.model_name, source=self.source,
            datafile=str(self.datafile), mean_prof=used_mean,
            eigvec=used_eigvec, tck=tck)
        if not quiet:
            nbreak = len(np.unique(np.asarray(tck[0])))
            print(f"B-spline interpolation model {self.model_name} uses "
                  f"{ncomp} basis profile components and {nbreak} "
                  f"breakpoints (degree k={tck[2]}).")
        return self.spline_model

    def write_model(self, outfile=None, quiet=False):
        """Write the spline model (.spl pickle or .npz)."""
        if not hasattr(self, "spline_model"):
            raise RuntimeError("call make_spline_model first")
        outfile = outfile or self.model_name
        with lap("write"):
            write_spline_model(self.spline_model, outfile, quiet=quiet)
        return outfile

    # plotting wrappers (ppspline.py:246-288)
    def show_eigenprofiles(self, **kwargs):
        from ..viz.plots import show_eigenprofiles

        ncomp = getattr(self, "ncomp", 0)
        kwargs.setdefault("device", self.device)
        show_eigenprofiles(
            self.eigvec[:, self.ieig] if ncomp else np.zeros((self.nbin, 0)),
            smooth_eigvec=(self.smooth_eigvec[:, self.ieig]
                           if hasattr(self, "smooth_eigvec") and ncomp
                           else None),
            mean_prof=self.mean_prof,
            smooth_mean_prof=getattr(self, "smooth_mean_prof", None),
            **kwargs)

    def show_spline_curve_projections(self, **kwargs):
        from ..viz.plots import show_spline_curve_projections

        snrs = np.asarray(self.SNRsxs[0], float)
        kwargs.setdefault("weights", snrs / snrs.sum())
        kwargs.setdefault("device", self.device)
        show_spline_curve_projections(self.proj_port, self.freqsxs[0],
                                      tck=self.tck, **kwargs)


# reference ppspline scripts use the name DataPortrait
DataPortrait = SplinePortrait
