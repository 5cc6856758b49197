"""Template-model dispatch (counterpart of pulseportraiture_tpu/pipeline/models.py).

One entry point for a .gmodel text file, a spline model (.spl pickle
or .npz) or a PSRFITS archive as the template, keyed on file magic.
"""

import numpy as np

from ..device import resolve_device
from ..io.gmodel import gen_gmodel_portrait, read_gmodel
from ..io.splmodel import read_spline_model

__all__ = ["TemplateModel", "sniff_model_type"]


def sniff_model_type(path):
    """'fits' | 'gmodel' | 'spline' by magic bytes / parseability."""
    with open(path, "rb") as f:
        head = f.read(512)
    if head.startswith(b"SIMPLE"):
        return "fits"
    if head.startswith(b"PK\x03\x04") or str(path).endswith(".npz"):
        return "spline"
    try:
        text = head.decode("ascii")
    except UnicodeDecodeError:
        return "spline"  # pickle
    for line in text.splitlines():
        if line.split() and line.split()[0] in ("MODEL", "CODE", "FREQ"):
            return "gmodel"
    return "spline"


class TemplateModel:
    """A loaded template, evaluated lazily per (freqs, nbin, P) and
    cached per unique frequency layout.  A .gmodel or spline portrait is
    built in float64 on ``device``; the cached portrait is host numpy
    (the fast fit derives its harmonic window from it there, and moves
    it to the device once per fit call)."""

    def __init__(self, modelfile, quiet=True, device=None):
        self.modelfile = str(modelfile)
        self.device = resolve_device(device)
        self.kind = sniff_model_type(modelfile)
        self._cache = {}
        self.gauss = None
        self.spline = None
        self.fits_port = None
        self.fits_freqs = None
        if self.kind == "gmodel":
            self.gauss = read_gmodel(modelfile, quiet=quiet)
            self.name = self.gauss.name
            self.nu_ref_model = self.gauss.nu_ref
        elif self.kind == "spline":
            self.spline = read_spline_model(modelfile, quiet=quiet)
            self.name = self.spline.modelname
            lo, hi = self.spline.freq_range()
            self.nu_ref_model = 0.5 * (lo + hi)
        else:
            from ..io.psrfits import load_data

            td = load_data(modelfile, dedisperse=True, pscrunch=True,
                           tscrunch=True, quiet=quiet)
            self.fits_port = np.asarray(td.subints[0, 0])
            self.fits_freqs = np.asarray(td.freqs[0])
            self.name = td.source
            self.nu_ref_model = float(td.nu0)

    @property
    def is_gaussian(self):
        return self.kind == "gmodel"

    def has_scattering(self):
        return self.kind == "gmodel" and self.gauss.tau != 0.0

    def portrait(self, freqs, nbin, P=None):
        """(nchan, nbin) host model portrait at the given channel
        frequencies.  FITS templates require matching nbin and are
        matched channel-by-nearest-frequency."""
        freqs = np.atleast_1d(np.asarray(freqs, float))
        key = (freqs.tobytes(), int(nbin),
               None if P is None else round(float(P), 12))
        if key in self._cache:
            return self._cache[key]
        if self.kind == "gmodel":
            port = gen_gmodel_portrait(self.gauss, np.arange(nbin), freqs,
                                       P=P, quiet=True, device=self.device)
        elif self.kind == "spline":
            port = self.spline.portrait(freqs, nbin=nbin, device=self.device)
        else:
            if self.fits_port.shape[-1] != nbin:
                raise ValueError(
                    f"FITS template nbin={self.fits_port.shape[-1]} != "
                    f"data nbin={nbin}")
            idx = np.abs(self.fits_freqs[None, :]
                         - freqs[:, None]).argmin(axis=1)
            port = self.fits_port[idx]
        port = np.asarray(port)
        self._cache[key] = port
        return port
