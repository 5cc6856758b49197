"""DataPortrait: one t-scrunched data portrait and its metadata, the base
of the template builders (counterpart of
pulseportraiture_tpu/pipeline/portrait.py).

A single archive, or a metafile of archives from different receivers
(the JOIN path: one frequency-sorted portrait with per-join (phase,
dDM) alignment parameters).  The portrait is host float64 numpy, as in
the JAX package; the math on it (phase fits, rotations, wavelet
smoothing, the flux fit) runs on the portrait's ``device``.  The JAX
package wraps these entry points in utils/device.on_host only because
some TPU runtimes cannot compile complex FFTs; the card can, so nothing
here is pinned to the host but the archive I/O and the joinfile.
"""

import time
from contextlib import contextmanager

import numpy as np
import torch

from ..device import resolve_device
from ..fit.phase_shift import fit_phase_shift
from ..io.psrfits import load_data, noise_std_ps, unload_new_archive
from .toas import _is_metafile, _read_metafile

__all__ = ["normalize_portrait", "DataPortrait", "template_stats",
           "reset_template_stats"]

# wall seconds by stage of the template builders since the last reset
_WALLS = {}


def template_stats():
    """{stage: wall seconds} of the template builders (load, normalize,
    profile trials, each portrait iteration's LM, convergence fit and
    write; PCA, eigenvector selection, spline fit) since
    reset_template_stats(); a stage's wall ends at its first host read
    of a device result."""
    return dict(_WALLS)


def reset_template_stats():
    _WALLS.clear()


@contextmanager
def lap(stage):
    """Add the wall of the block to stage in template_stats()."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _WALLS[stage] = _WALLS.get(stage, 0.0) + time.perf_counter() - t0


def normalize_portrait(port, method="rms", weights=None,
                       return_norms=False, device=None):
    """Normalize each channel profile (reference pplib.py:2553-2598):
    'mean' | 'max' | 'prof' (scale against the weighted mean profile
    by a phase-shift fit, on ``device``, default cuda) | 'rms' (unit
    noise) | 'abs' (unit L2 norm).  Host float64 in and out.  'prof'
    runs one small fit per channel, with a host read each, as the JAX
    package's per-channel loop does."""
    port = np.asarray(port, float)
    if method not in ("mean", "max", "prof", "rms", "abs"):
        raise ValueError(f"unknown normalization method {method!r}")
    norm_port = np.zeros_like(port)
    norm_vals = np.ones(len(port))
    if method == "prof":
        good = np.where(port.sum(axis=1) != 0.0)[0]
        w = np.ones(len(good)) if weights is None \
            else np.asarray(weights)[good]
        mean_prof = np.average(port[good], axis=0, weights=w)
    for ichan in range(len(port)):
        if not port[ichan].any():
            continue
        if method == "mean":
            norm = port[ichan].mean()
        elif method == "max":
            norm = port[ichan].max()
        elif method == "prof":
            norm = float(fit_phase_shift(port[ichan], mean_prof,
                                         device=device).scale)
        elif method == "rms":
            norm = float(noise_std_ps(port[ichan]))
        else:
            norm = float(np.sqrt((port[ichan] ** 2).sum()))
        if norm != 0.0:
            norm_port[ichan] = port[ichan] / norm
            norm_vals[ichan] = norm
    return (norm_port, norm_vals) if return_norms else norm_port


class DataPortrait:
    """Load one archive, or a metafile of archives from different
    receivers (the JOIN path), into a t/p-scrunched portrait ready for
    template building.  ``device`` (default cuda; a host with no card
    raises) is where the portrait's math runs."""

    def __init__(self, datafile=None, joinfile=None, quiet=False,
                 device=None, **load_data_kwargs):
        self.device = resolve_device(device)
        self.datafile = datafile
        self.joinfile = joinfile
        self.norm_values = None
        self.joins = []
        load_data_kwargs.setdefault("tscrunch", True)
        load_data_kwargs.setdefault("pscrunch", True)
        load_data_kwargs.setdefault("dedisperse", True)
        with lap("load"):
            if isinstance(datafile, str) and _is_metafile(datafile):
                self._init_join(datafile, quiet, load_data_kwargs)
            else:
                self._init_single(datafile, quiet, load_data_kwargs)
        if joinfile:
            self.apply_joinfile(joinfile, quiet=quiet)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, float), dtype=torch.float64,
                               device=self.device)

    # -- construction ------------------------------------------------------
    def _unpack(self, d):
        self.data = d
        self.source = d.source
        self.nbin = d.nbin
        self.phases = d.phases
        self.nu0 = d.nu0
        self.bw = d.bw
        self.Ps = np.atleast_1d(np.asarray(d.Ps))
        self.freqs = np.atleast_2d(np.asarray(d.freqs))
        self.port = np.asarray(d.subints[0, 0], float)
        self.weights = np.asarray(d.weights[0], float)
        self.noise_stds = np.asarray(d.noise_stds[0, 0], float)
        self.SNRs = np.asarray(d.SNRs[0, 0], float)
        self.ok_ichans = np.asarray(d.ok_ichans[0], int)
        self._condense()

    def _condense(self):
        """x-suffixed views keep only the unzapped channels."""
        okc = self.ok_ichans
        self.portx = self.port[okc]
        self.freqsxs = [self.freqs[0][okc]]
        self.noise_stdsxs = [self.noise_stds[okc]]
        self.SNRsxs = [self.SNRs[okc]]

    def _init_single(self, datafile, quiet, kwargs):
        self._unpack(load_data(datafile, quiet=quiet, **kwargs))

    def _init_join(self, metafile, quiet, kwargs):
        """Concatenate archives across receivers, sorted by frequency;
        per-archive (phase, dDM) JOIN parameters seeded by mean-profile
        phase fits against the first archive (pplib.py:163-315)."""
        paths = _read_metafile(metafile)
        datas = [load_data(p, quiet=quiet, **kwargs) for p in paths]
        nbin = datas[0].nbin
        for d in datas[1:]:
            if d.nbin != nbin:
                raise ValueError("JOIN archives must share nbin")
        ports = [np.asarray(d.subints[0, 0], float) for d in datas]
        freqs = np.concatenate([np.asarray(d.freqs[0]) for d in datas])
        order = np.argsort(freqs)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        # the channel indices of each archive in the sorted portrait
        self.join_params = []
        self.join_fit_flags = []
        self.join_ichans = []
        start = 0
        ref_prof = ports[0].mean(axis=0)
        for iarch, d in enumerate(datas):
            n = ports[iarch].shape[0]
            self.join_ichans.append(np.sort(inv[start:start + n]))
            start += n
            if iarch == 0:
                phase_guess = 0.0
            else:
                phase_guess = float(fit_phase_shift(
                    ports[iarch].mean(axis=0), ref_prof,
                    device=self.device).phase)
            # (phase, dDM) per join; the first archive is the anchor
            self.join_params.extend([phase_guess, 0.0])
            self.join_fit_flags.extend([0, 0] if iarch == 0 else [1, 1])
            self.joins.append(paths[iarch])
        d0 = datas[0]
        self.data = d0
        self.source = d0.source
        self.nbin = nbin
        self.phases = d0.phases
        self.Ps = np.atleast_1d(np.asarray(d0.Ps))
        all_freqs = freqs[order]
        self.freqs = all_freqs[None, :]
        self.nu0 = float(all_freqs.mean())
        self.bw = float(all_freqs.max() - all_freqs.min())
        self.port = np.concatenate(ports, axis=0)[order]
        self.weights = np.concatenate(
            [np.asarray(d.weights[0]) for d in datas])[order]
        self.noise_stds = np.concatenate(
            [np.asarray(d.noise_stds[0, 0]) for d in datas])[order]
        self.SNRs = np.concatenate(
            [np.asarray(d.SNRs[0, 0]) for d in datas])[order]
        self.ok_ichans = np.where(self.weights > 0)[0]
        self._condense()

    # -- transforms --------------------------------------------------------
    def normalize_portrait(self, method="rms"):
        """In-place channel normalization; the values are kept so that
        unnormalize_portrait can restore the portrait."""
        with lap("normalize"):
            self.port, norms = normalize_portrait(
                self.port, method, weights=self.weights, return_norms=True,
                device=self.device)
        self.norm_values = norms
        self.norm_method = method
        self.noise_stds = np.where(norms != 0.0, self.noise_stds / norms,
                                   self.noise_stds)
        self._condense()
        return norms

    def unnormalize_portrait(self):
        if self.norm_values is None:
            raise RuntimeError("portrait was not normalized")
        self.port = self.port * self.norm_values[:, None]
        self.noise_stds = self.noise_stds * self.norm_values
        self.norm_values = None
        self._condense()

    def smooth_portrait(self, **kwargs):
        """Wavelet-denoise every channel profile on the device."""
        from ..models.wavelet import wavelet_smooth

        self.port = wavelet_smooth(self._t(self.port), device=self.device,
                                   **kwargs).cpu().numpy()
        self._condense()

    def fit_flux_profile(self, guessA=1.0, guessalpha=0.0, plot=False,
                         savefig=None, quiet=True):
        """Power-law fit to the phase-averaged flux against frequency
        (pplib.py:448-506), on the device; plot draws it (viz/)."""
        from ..fit.powlaw import fit_powlaw

        okc = self.ok_ichans
        fluxes = self.port[okc].mean(axis=1)
        flux_errs = self.noise_stds[okc] / np.sqrt(self.nbin)
        flux_errs = np.where(flux_errs > 0, flux_errs, 1.0)
        freqs = self.freqs[0][okc]
        res = fit_powlaw(fluxes, init_params=[guessA, guessalpha],
                         errs=flux_errs, nu_ref=self.nu0, freqs=freqs,
                         device=self.device)
        self.flux_fit = res
        if plot:
            from ..viz.plots import plot_flux_profile

            plot_flux_profile(freqs, fluxes, flux_errs, res, self.nu0,
                              savefig=savefig)
        if not quiet:
            print(f"flux spectral index alpha = {float(res.alpha):.3f} "
                  f"+/- {float(res.alpha_err):.3f}")
        return res

    def _rotate(self, arr, phase, DM=0.0, freqs=None, nu_ref=None):
        """rotate_portrait of a host array on the device, back to host."""
        from ..ops.rotation import rotate_portrait

        if freqs is None:
            return rotate_portrait(self._t(arr), phase).cpu().numpy()
        return rotate_portrait(self._t(arr), phase, DM, float(self.Ps[0]),
                               self._t(freqs), nu_ref).cpu().numpy()

    def rotate_stuff(self, phase=0.0, DM=0.0, ichans=None, nu_ref=None,
                     model=False):
        """Coherently rotate the data (or model) portrait and any
        derived products (pplib.py:545-592)."""
        if nu_ref is None:
            nu_ref = self.nu0
        if ichans is None:
            ichans = np.arange(self.port.shape[0])
        ichans = np.asarray(ichans, int)
        freqs = self.freqs[0][ichans]
        if not model:
            self.port[ichans] = self._rotate(self.port[ichans], phase, DM,
                                             freqs, nu_ref)
            for attr in ("prof", "mean_prof"):
                if hasattr(self, attr):
                    setattr(self, attr, self._rotate(
                        getattr(self, attr)[None], phase)[0])
            if hasattr(self, "eigvec"):
                self.eigvec = self._rotate(self.eigvec.T, phase).T
            self._condense()
        elif hasattr(self, "model"):
            self.model[ichans] = self._rotate(self.model[ichans], phase, DM,
                                              freqs, nu_ref)
            if hasattr(self, "modelx"):
                self.modelx = self.model[self.ok_ichans]
            if hasattr(self, "smooth_mean_prof"):
                self.smooth_mean_prof = self._rotate(
                    self.smooth_mean_prof[None], phase)[0]
            if hasattr(self, "smooth_eigvec"):
                self.smooth_eigvec = self._rotate(self.smooth_eigvec.T,
                                                  phase).T

    # -- JOIN persistence --------------------------------------------------
    def write_join_parameters(self, outfile, quiet=False):
        """Persist the JOIN (phase, dDM) pairs (pplib.py:508-543)."""
        with open(outfile, "w") as f:
            for iarch, path in enumerate(self.joins):
                phi, dDM = self.join_params[2 * iarch: 2 * iarch + 2]
                f.write(f"{path} {phi:+.8f} {dDM:+.8f}\n")
        if not quiet:
            print(f"{outfile} written.")

    def apply_joinfile(self, joinfile, quiet=False):
        """Rotate each join's channels by persisted (phase, dDM)
        (pplib.py:351-377)."""
        with open(joinfile) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                path, phi, dDM = parts[0], float(parts[1]), float(parts[2])
                if path in self.joins:
                    iarch = self.joins.index(path)
                    self.rotate_stuff(phase=phi, DM=dDM,
                                      ichans=self.join_ichans[iarch])
                    self.join_params[2 * iarch] = phi
                    self.join_params[2 * iarch + 1] = dDM
        if not quiet:
            print(f"Applied {joinfile}.")

    # -- output ------------------------------------------------------------
    def _archive(self):
        arch = self.data.arch
        if arch is None:
            from ..io.psrfits import read_archive

            arch = read_archive(self.datafile)
        return arch

    def unload_archive(self, outfile, quiet=False):
        """Write the (possibly transformed) portrait back to a PSRFITS
        file by cloning the source archive (pplib.py:594-616)."""
        unload_new_archive(self.port[None, None], self._archive(), outfile,
                           DM=self.data.DM, dmc=1,
                           weights=self.weights[None], quiet=quiet)

    def write_model_archive(self, outfile, quiet=False):
        """Write the model portrait as an archive (pplib.py:618-636)."""
        if not hasattr(self, "model"):
            raise RuntimeError("no model built yet")
        unload_new_archive(np.asarray(self.model)[None, None],
                           self._archive(), outfile, DM=0.0, dmc=1,
                           weights=np.ones_like(self.weights)[None],
                           quiet=quiet)

    # -- plotting (viz/) ----------------------------------------------------
    def show_data_portrait(self, **kwargs):
        from ..viz.plots import show_portrait

        show_portrait(self.port * (self.weights > 0)[:, None],
                      self.phases, self.freqs[0], **kwargs)

    def show_model_portrait(self, **kwargs):
        from ..viz.plots import show_portrait

        show_portrait(np.asarray(self.model), self.phases, self.freqs[0],
                      **kwargs)

    def show_model_fit(self, **kwargs):
        from ..viz.plots import show_residual_plot

        kwargs.setdefault("device", self.device)
        show_residual_plot(self.port, np.asarray(self.model),
                           self.phases, self.freqs[0],
                           noise_stds=self.noise_stds,
                           weights=self.weights, **kwargs)
