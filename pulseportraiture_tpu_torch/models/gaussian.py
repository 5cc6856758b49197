"""Frequency-evolving Gaussian-component portrait models (counterpart of
pulseportraiture_tpu/models/gaussian.py).

A model is ngauss Gaussian components whose (loc, wid, amp) each evolve
with frequency by a power law ('0') or a linear law ('1'), selected by
a three-digit code string, plus a DC offset and a scattering (tau,
alpha) pair — the .gmodel format's semantics.  The model itself is
host data (a dataclass of numpy arrays); generation runs in torch on
the device the caller names.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gaussian import gaussian_profile_FT
from ..ops.scattering import scattering_portrait_FT, scattering_times

__all__ = ["GaussianModel", "gen_gaussian_portrait",
           "gen_gaussian_portrait_FT", "gen_gaussian_profile"]


def power_law_evolution(value, mod_index, freqs, nu_ref):
    """param(nu) = value * (nu/nu_ref)**mod_index."""
    return value * (freqs / nu_ref) ** mod_index


def linear_evolution(value, slope, freqs, nu_ref):
    """param(nu) = value + slope * (nu - nu_ref)."""
    return value + slope * (freqs - nu_ref)


_EVOLUTION = {"0": power_law_evolution, "1": linear_evolution}


@dataclass
class GaussianModel:
    """A .gmodel in memory.

    locs/wids/amps and their evolution moduli are (ngauss,) arrays at
    the reference frequency nu_ref [MHz]; tau is the scattering
    timescale in *seconds* at nu_ref (the on-disk unit); fit flags are
    kept for round-tripping.
    """

    name: str
    code: str
    nu_ref: float
    dc: float
    tau: float
    alpha: float
    locs: np.ndarray
    wids: np.ndarray
    amps: np.ndarray
    mlocs: np.ndarray
    mwids: np.ndarray
    mamps: np.ndarray
    fit_flags: dict = field(default_factory=dict)

    @property
    def ngauss(self):
        return len(np.atleast_1d(self.locs))

    def params(self, device=None, dtype=torch.float64):
        """The parameters as a dict of tensors on ``device``."""
        dev = resolve_device(device)
        return {k: torch.as_tensor(np.asarray(getattr(self, k), float),
                                   dtype=dtype, device=dev)
                for k in ("dc", "tau", "alpha", "locs", "wids", "amps",
                          "mlocs", "mwids", "mamps")}


def evolved_components(params, freqs, nu_ref, code="000"):
    """(locs, wids, amps) each (nchan, ngauss) at the given freqs."""
    f = freqs[:, None]
    locs = _EVOLUTION[code[0]](params["locs"][None, :],
                               params["mlocs"][None, :], f, nu_ref)
    wids = _EVOLUTION[code[1]](params["wids"][None, :],
                               params["mwids"][None, :], f, nu_ref)
    amps = _EVOLUTION[code[2]](params["amps"][None, :],
                               params["mamps"][None, :], f, nu_ref)
    return locs, wids, amps


def gaussian_components_FT(params, freqs, nu_ref, nharm, code="000"):
    """rFFT (nchan, nharm) of DC + the sum of evolved Gaussian
    components."""
    locs, wids, amps = evolved_components(params, freqs, nu_ref, code)
    nbin = 2 * (nharm - 1)
    gFT = gaussian_profile_FT(nharm, locs[..., None], wids[..., None],
                              amps[..., None])
    pFT = torch.sum(gFT, dim=1)
    pFT[..., 0] += params["dc"] * nbin
    return pFT


def gen_gaussian_portrait_FT(params, freqs, nu_ref, nharm, P=None,
                             code="000", scattered=True):
    """rFFT (nchan, nharm) of the model portrait, optionally times the
    per-channel scattering kernel (tau in seconds needs P)."""
    pFT = gaussian_components_FT(params, freqs, nu_ref, nharm, code)
    if scattered and P is not None:
        taus = scattering_times(params["tau"] / P, params["alpha"], freqs,
                                nu_ref)
        pFT = pFT * scattering_portrait_FT(taus, nharm)
    return pFT


def gen_gaussian_portrait(params, freqs, nu_ref, nbin, P=None, code="000",
                          scattered=True):
    """Model portrait (nchan, nbin) in the phase domain; params is a
    dict of tensors (GaussianModel.params) and freqs a tensor on the
    same device."""
    nharm = nbin // 2 + 1
    pFT = gen_gaussian_portrait_FT(params, freqs, nu_ref, nharm, P, code,
                                   scattered)
    return torch.fft.irfft(pFT, n=nbin, dim=-1)


def gen_gaussian_profile(params, nbin, nu_ref=None, code="000", P=None,
                         scattered=True, device=None):
    """Single-frequency profile (nbin,) at nu_ref (1.0 when None): DC +
    components + scattering.  params is a dict of numbers, numpy arrays
    or tensors (those made float64 tensors on ``device``, default
    cuda), with the keys of GaussianModel.params."""
    dev = resolve_device(device)
    params = {k: v.to(dev) if isinstance(v, torch.Tensor) else
              torch.as_tensor(np.asarray(v, float), dtype=torch.float64,
                              device=dev) for k, v in params.items()}
    nu = 1.0 if nu_ref is None else nu_ref
    freqs = torch.tensor([nu], dtype=params["locs"].dtype, device=dev)
    return gen_gaussian_portrait(params, freqs, nu, nbin, P, code,
                                 scattered)[0]
