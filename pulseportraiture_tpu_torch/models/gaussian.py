"""Frequency-evolving Gaussian-component portrait models (counterpart of
pulseportraiture_tpu/models/gaussian.py).

A model is ngauss Gaussian components whose (loc, wid, amp) each evolve
with frequency by a power law ('0') or a linear law ('1'), selected by
a three-digit code string, plus a DC offset and a scattering (tau,
alpha) pair — the .gmodel format's semantics.  The model itself is
host data (a dataclass of numpy arrays); generation runs in torch on
the device the caller names.

Every function broadcasts over leading batch axes: parameters (...,
ngauss), freqs (..., nchan) and nu_ref a number or a tensor that
broadcasts against (..., nchan, ngauss), which the batched template
fits (fit/gauss.py) use.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..ops.gaussian import gaussian_profile_FT, gaussian_profile_FT_jac
from ..ops.scattering import scattering_portrait_FT, scattering_times

__all__ = ["GaussianModel", "evolve_parameter", "evolved_components",
           "gaussian_components_FT", "gaussian_components_FT_jac",
           "apply_scattering_FT", "gen_gaussian_portrait",
           "gen_gaussian_portrait_FT", "gen_gaussian_profile",
           "model_from_params"]


def power_law_evolution(value, mod_index, freqs, nu_ref):
    """param(nu) = value * (nu/nu_ref)**mod_index."""
    return value * (freqs / nu_ref) ** mod_index


def linear_evolution(value, slope, freqs, nu_ref):
    """param(nu) = value + slope * (nu - nu_ref)."""
    return value + slope * (freqs - nu_ref)


_EVOLUTION = {"0": power_law_evolution, "1": linear_evolution}


def power_law_evolution_grads(value, mod_index, freqs, nu_ref):
    """(dp/dvalue, dp/dmod) of power_law_evolution:
    p = v r^m, r = nu/nu_ref  =>  (r^m, v r^m ln r)."""
    r = freqs / nu_ref
    rm = r ** mod_index
    return rm, value * rm * torch.log(r)


def linear_evolution_grads(value, mod_index, freqs, nu_ref):
    """(dp/dvalue, dp/dmod) of linear_evolution: (1, nu - nu_ref),
    broadcast to the shape of value, mod_index and freqs together."""
    shape = torch.broadcast_shapes(value.shape, mod_index.shape,
                                   freqs.shape)
    one = torch.ones(shape, dtype=torch.result_type(value, freqs),
                     device=freqs.device)
    return one, torch.broadcast_to(freqs - nu_ref, shape)


_EVOLUTION_GRADS = {"0": power_law_evolution_grads,
                    "1": linear_evolution_grads}


def evolve_parameter(value, mod, freqs, nu_ref, code_digit="0"):
    """A parameter at freqs by its .gmodel CODE digit ('0' power law,
    '1' linear)."""
    return _EVOLUTION[code_digit](value, mod, freqs, nu_ref)


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

    def params_pytree(self, device=None, dtype=torch.float64):
        """The JAX package's name for params(): the parameters as a dict
        of tensors (the counterpart of its pytree of jnp arrays)."""
        return self.params(device, dtype)


def _family(params, name):
    return params[name][..., None, :]


def evolved_components(params, freqs, nu_ref, code="000"):
    """(locs, wids, amps) each (..., nchan, ngauss) at the given freqs."""
    f = freqs[..., :, None]
    return tuple(
        _EVOLUTION[code[i]](_family(params, v), _family(params, "m" + v),
                            f, nu_ref)
        for i, v in enumerate(("locs", "wids", "amps")))


def harmonic0(like):
    """The unit vector of harmonic 0 along like's last axis, real: a
    multiple of it added to a spectrum changes the k = 0 bin alone
    (exactly: the other bins gain zeros), out of place, so torch.func
    can trace it."""
    e0 = torch.zeros(like.shape[-1], dtype=like.real.dtype,
                     device=like.device)
    e0[0] = 1.0
    return e0


def _dc_harmonic(dc, nbin, like):
    """The DC term dc * nbin of a (..., nchan, nharm) spectrum."""
    return (torch.as_tensor(dc, device=like.device) * nbin)[
        ..., None, None] * harmonic0(like)


def gaussian_components_FT(params, freqs, nu_ref, nharm, code="000"):
    """rFFT (..., nchan, nharm) of DC + the sum of evolved Gaussian
    components."""
    locs, wids, amps = evolved_components(params, freqs, nu_ref, code)
    nbin = 2 * (nharm - 1)
    gFT = gaussian_profile_FT(nharm, locs[..., None], wids[..., None],
                              amps[..., None])
    pFT = torch.sum(gFT, dim=-2)
    return pFT + _dc_harmonic(params["dc"], nbin, pFT)


def gaussian_components_FT_jac(params, freqs, nu_ref, nharm, code="000"):
    """Closed-form derivatives of gaussian_components_FT: (pFT, derivs)
    with pFT the (..., nchan, nharm) model rFFT and derivs mapping 'dc'
    to a (..., nchan, nharm) column and each of 'locs', 'mlocs',
    'wids', 'mwids', 'amps', 'mamps' to (..., nchan, ngauss, nharm),
    d pFT / d(that parameter of component g).  The evolution laws chain
    through _EVOLUTION_GRADS, the Gaussian block through
    ops.gaussian.gaussian_profile_FT_jac."""
    locs, wids, amps = evolved_components(params, freqs, nu_ref, code)
    f = freqs[..., :, None]
    vgrad = [_EVOLUTION_GRADS[code[i]](_family(params, v),
                                       _family(params, "m" + v), f, nu_ref)
             for i, v in enumerate(("locs", "wids", "amps"))]
    nbin = 2 * (nharm - 1)
    G, dloc, dwid, damp = gaussian_profile_FT_jac(
        nharm, locs[..., None], wids[..., None], amps[..., None])
    pFT = torch.sum(G, dim=-2)
    pFT = pFT + _dc_harmonic(params["dc"], nbin, pFT)
    dc_col = _dc_harmonic(torch.ones_like(torch.as_tensor(params["dc"])),
                          nbin, pFT).to(pFT.dtype).expand(pFT.shape)
    derivs = {"dc": dc_col}
    for (name, block), (dv, dm) in zip(
            (("locs", dloc), ("wids", dwid), ("amps", damp)), vgrad):
        derivs[name] = block * dv[..., None]
        derivs["m" + name] = block * dm[..., None]
    return pFT, derivs


def apply_scattering_FT(pFT, tau_rot, alpha, freqs, nu_ref):
    """A model rFFT times the per-channel scattering kernel, tau in
    rotations at nu_ref (tau_rot, alpha broadcast against freqs)."""
    taus = scattering_times(tau_rot, alpha, freqs, nu_ref)
    return pFT * scattering_portrait_FT(taus, pFT.shape[-1])


def gen_gaussian_portrait_FT(params, freqs, nu_ref, nharm, P=None,
                             code="000", scattered=True):
    """rFFT (nchan, nharm) of the model portrait, optionally times the
    per-channel scattering kernel (tau in seconds needs P)."""
    pFT = gaussian_components_FT(params, freqs, nu_ref, nharm, code)
    if scattered and P is not None:
        pFT = apply_scattering_FT(pFT, params["tau"] / P, params["alpha"],
                                  freqs, nu_ref)
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


def model_from_params(model, freqs, nbin, P=None, scattered=True,
                      device=None):
    """The (nchan, nbin) float64 portrait of a GaussianModel at freqs on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    return gen_gaussian_portrait(
        model.params(dev), torch.as_tensor(np.asarray(freqs, float),
                                           dtype=torch.float64, device=dev),
        model.nu_ref, nbin, P=P, code=model.code, scattered=scattered)
