"""Spline (PCA + B-spline) model files (counterpart of pulseportraiture_tpu/io/splmodel.py).

Two on-disk forms, both read and written:
- the reference-compatible pickle ``[modelname, source, datafile,
  mean_prof, eigvec, tck]`` (``.spl``), read with a latin1 retry for
  files pickled by Python 2;
- a versioned ``.npz`` (``.npz``/``.ppspl``): the same content without
  executing a pickle.

``SplineModel.portrait(freqs, nbin, device)`` evaluates through
models/spline.gen_spline_portrait, in float64 on the device.
"""

import pickle
from dataclasses import dataclass, field

import numpy as np

from ..models.spline import bspline_eval, gen_spline_portrait

__all__ = ["SplineModel", "write_spline_model", "read_spline_model",
           "spline_model_coords", "NPZ_VERSION"]

NPZ_VERSION = 1


@dataclass
class SplineModel:
    modelname: str
    source: str
    datafile: str
    mean_prof: np.ndarray  # (nbin,)
    eigvec: np.ndarray     # (nbin, ncomp)
    tck: tuple             # (t (nknot,), c (ncomp, ncoef), k)
    extra: dict = field(default_factory=dict)

    @property
    def nbin(self):
        return len(self.mean_prof)

    @property
    def ncomp(self):
        return self.eigvec.shape[1] if self.eigvec.ndim == 2 else 0

    def freq_range(self):
        t = np.asarray(self.tck[0], float)
        return float(t.min()), float(t.max())

    def portrait(self, freqs, nbin=None, device=None):
        """(nchan, nbin) float64 host model portrait at the given
        frequencies, built on ``device`` (default cuda); a different nbin
        by Fourier resampling plus the half-bin fix."""
        return gen_spline_portrait(
            self.mean_prof, np.atleast_1d(np.asarray(freqs, float)),
            self.eigvec, self.tck, nbin=nbin, device=device).cpu().numpy()


def _normalize_tck(tck):
    t, c, k = tck
    t = np.asarray(t, float)
    c = (np.asarray([np.asarray(ci, float) for ci in c])
         if isinstance(c, (list, tuple)) else np.asarray(c, float))
    if c.ndim == 1:
        c = c[None]
    return (t, c, int(k))


def write_spline_model(model, filename, quiet=False):
    """Write a SplineModel: a ``.spl`` name gets the reference pickle,
    any other name the versioned npz."""
    t, c, k = _normalize_tck(model.tck)
    if str(filename).endswith(".spl"):
        payload = [model.modelname, model.source, model.datafile,
                   np.asarray(model.mean_prof), np.asarray(model.eigvec),
                   (t, [ci for ci in c], k)]
        with open(filename, "wb") as f:
            pickle.dump(payload, f, protocol=2)
    else:
        np.savez(filename, format_version=NPZ_VERSION,
                 modelname=model.modelname, source=model.source,
                 datafile=model.datafile,
                 mean_prof=np.asarray(model.mean_prof),
                 eigvec=np.asarray(model.eigvec), tck_t=t, tck_c=c,
                 tck_k=k)
    if not quiet:
        print(f"{filename} written.")


def read_spline_model(modelfile, quiet=False):
    """Either on-disk form -> SplineModel.  A pickle runs code when it is
    loaded: read ``.spl`` files only from sources you trust."""
    if not quiet:
        print(f"Reading model from {modelfile}...")
    if str(modelfile).endswith((".npz", ".ppspl")):
        z = np.load(modelfile, allow_pickle=False)
        return SplineModel(
            modelname=str(z["modelname"]), source=str(z["source"]),
            datafile=str(z["datafile"]), mean_prof=z["mean_prof"],
            eigvec=z["eigvec"],
            tck=(z["tck_t"], z["tck_c"], int(z["tck_k"])))
    with open(modelfile, "rb") as f:
        try:
            payload = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            payload = pickle.load(f, encoding="latin1")
    modelname, source, datafile, mean_prof, eigvec, tck = payload
    return SplineModel(
        modelname=str(modelname), source=str(source),
        datafile=str(datafile), mean_prof=np.asarray(mean_prof, float),
        eigvec=np.asarray(eigvec, float), tck=_normalize_tck(tck))


def spline_model_coords(model, freqs, device=None):
    """The projected curve coordinates (nchan, ncomp) at the given
    frequencies, float64 host numpy."""
    return bspline_eval(np.atleast_1d(np.asarray(freqs, float)),
                        _normalize_tck(model.tck),
                        device=device).cpu().numpy()
