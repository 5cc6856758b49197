"""Carry the JAX package's parameters over to the port.

The wideband TOA path has no trained weights: its parameters are the
template.  A Gaussian template crosses as its fields — a JAX-package
``GaussianModel`` (duck-typed: name, code, nu_ref, dc, tau, alpha, the
component arrays and fit_flags) or the flat vectors of its
``io.gmodel.model_to_flat`` — and becomes the port's GaussianModel; a
spline template crosses as a JAX-package ``SplineModel`` (duck-typed:
the names, mean_prof, eigvec and tck) and becomes the port's
SplineModel.  Both packages then build the same portrait.  Nothing here
imports JAX.
"""

import numpy as np

from .io.gmodel import model_from_flat
from .io.splmodel import SplineModel, _normalize_tck
from .models.gaussian import GaussianModel

__all__ = ["gaussian_model_from_fields", "gaussian_model_from_flat",
           "spline_model_from_fields"]

_ARRAYS = ("locs", "wids", "amps", "mlocs", "mwids", "mamps")


def gaussian_model_from_fields(model):
    """Any object with the GaussianModel fields -> the port's
    GaussianModel, arrays copied to float64 host numpy."""
    flags = {k: (np.array(v) if np.ndim(v) else int(v))
             for k, v in dict(getattr(model, "fit_flags", {}) or {}).items()}
    return GaussianModel(
        name=str(model.name), code=str(model.code),
        nu_ref=float(model.nu_ref), dc=float(model.dc),
        tau=float(model.tau), alpha=float(model.alpha),
        fit_flags=flags,
        **{k: np.array(np.asarray(getattr(model, k)), dtype=np.float64)
           for k in _ARRAYS})


def gaussian_model_from_flat(name, code, nu_ref, params, fit_flags, alpha,
                             fit_alpha=0):
    """``model_to_flat`` vectors (params [dc, tau, (loc, mloc, wid,
    mwid, amp, mamp) * ngauss] and their fit flags) -> GaussianModel."""
    return model_from_flat(name, code, nu_ref, params, fit_flags, alpha,
                           fit_alpha)


def spline_model_from_fields(model):
    """Any object with the SplineModel fields -> the port's SplineModel,
    arrays copied to float64 host numpy."""
    return SplineModel(
        modelname=str(model.modelname), source=str(model.source),
        datafile=str(model.datafile),
        mean_prof=np.array(np.asarray(model.mean_prof), dtype=np.float64),
        eigvec=np.array(np.asarray(model.eigvec), dtype=np.float64),
        tck=_normalize_tck(model.tck),
        extra=dict(getattr(model, "extra", {}) or {}))
