"""Gaussian profile kernels (counterpart of pulseportraiture_tpu/ops/gaussian.py).

Phase-domain periodic Gaussians (FWHM parameterization) and their
analytic Fourier transform (the Gaussian template generator) with its
closed-form Jacobian (the LM template engine's), and the
instrumental-response kernels the scattering fits fold into the
template spectrum (boxcar or Gaussian smearing, per-channel DM
smearing).
"""

import math

import torch

__all__ = ["FWHM2SIGMA", "gaussian_profile", "gaussian_profile_FT",
           "gaussian_profile_FT_jac", "instrumental_response_FT",
           "dm_smearing_width", "instrumental_response_port_FT",
           "gaussian_function"]

FWHM2SIGMA = 1.0 / (8.0 * math.log(2.0)) ** 0.5  # sigma = FWHM * this


def gaussian_profile(nbin, loc, wid, amp=1.0, dtype=torch.float64,
                     device=None):
    """Periodic Gaussian profile amp * exp(-4 ln2 d^2 / wid^2), d the
    phase distance to loc through the nearer edge; wid is the FWHM
    [rot], its magnitude floored at sqrt(tiny).  loc/wid/amp are numbers
    or tensors that broadcast against the trailing bin axis."""
    if device is None and isinstance(loc, torch.Tensor):
        device = loc.device
    phases = torch.arange(nbin, dtype=dtype, device=device) / nbin
    d = torch.remainder(phases - loc + 0.5, 1.0) - 0.5
    wid = torch.clamp(torch.abs(torch.as_tensor(wid, dtype=dtype,
                                                device=device)),
                      min=torch.finfo(dtype).tiny ** 0.5)
    return amp * torch.exp(-4.0 * math.log(2.0) * (d / wid) ** 2.0)


def gaussian_profile_FT(nharm, loc, wid, amp=1.0):
    """Analytic rFFT coefficients (unnormalized, numpy convention) of
    the periodic Gaussian with unit-peak amplitude ``amp``, sampled on
    nbin = 2*(nharm-1) bins:

    G(k) = amp * nbin * sigma sqrt(2 pi) * exp(-2 (pi k sigma)^2)
           * exp(-2 pi i k loc),   sigma = |wid| * FWHM2SIGMA

    loc/wid/amp are real tensors that broadcast against the trailing
    harmonic axis; the result is complex."""
    nbin = 2 * (nharm - 1)
    k = torch.arange(nharm, dtype=loc.dtype, device=loc.device)
    sigma = torch.abs(wid) * FWHM2SIGMA
    mag = (amp * nbin * sigma * math.sqrt(2.0 * math.pi)
           * torch.exp(-2.0 * (math.pi * k * sigma) ** 2.0))
    ang = -2.0 * math.pi * k * loc
    return torch.complex(mag * torch.cos(ang), mag * torch.sin(ang))


def gaussian_profile_FT_jac(nharm, loc, wid, amp):
    """Closed-form (G, dG/dloc, dG/dwid, dG/damp) of gaussian_profile_FT,
    broadcasting the same way.  With U(k) = nbin sqrt(2 pi)
    exp(-2 (pi k sigma)^2) e^{-2 pi i k loc} and sigma = |wid| FWHM2SIGMA:

        G = amp sigma U,  dG/dloc = -2 pi i k G,  dG/damp = sigma U,
        dG/dwid = amp U (1 - (2 pi k sigma)^2) FWHM2SIGMA sign(wid).

    The dwid form multiplies by sigma instead of dividing, so a
    zero-width or zero-amplitude component gives finite zeros.
    sign(wid) is +1 at exactly 0, the JAX package's autodiff convention
    for |.| (grad(abs)(0) == 1 there; torch's autograd gives 0), so these
    columns equal the JAX package's in every case."""
    nbin = 2 * (nharm - 1)
    k = torch.arange(nharm, dtype=loc.dtype, device=loc.device)
    sigma = torch.abs(wid) * FWHM2SIGMA
    mag = nbin * math.sqrt(2.0 * math.pi) * torch.exp(
        -2.0 * (math.pi * k * sigma) ** 2.0)
    ang = -2.0 * math.pi * k * loc
    U = torch.complex(mag * torch.cos(ang), mag * torch.sin(ang))
    G = amp * sigma * U
    two_pi_k = 2.0 * math.pi * k
    dloc = G * torch.complex(torch.zeros_like(two_pi_k), -two_pi_k)
    sign = torch.where(wid >= 0.0, 1.0, -1.0).to(loc.dtype)
    dwid = (amp * U * (1.0 - (two_pi_k * sigma) ** 2.0)
            * FWHM2SIGMA * sign)
    damp = sigma * U
    return G, dloc, dwid, damp


def instrumental_response_FT(width, nharm, kind="rect"):
    """FT of a channel's instrumental smearing kernel of ``width`` [rot]
    at harmonics 0..nharm-1: kind='rect' (boxcar) -> sinc(k width),
    kind='gauss' (FWHM ``width``) -> exp(-2 (pi k sigma)^2).  width 0
    is the identity."""
    width = torch.as_tensor(width)
    dt = torch.float64 if width.dtype == torch.float64 else torch.float32
    k = torch.arange(nharm, dtype=dt, device=width.device)
    if kind == "rect":
        return torch.sinc(k * width)
    if kind == "gauss":
        sigma = width * FWHM2SIGMA
        return torch.exp(-2.0 * (math.pi * k * sigma) ** 2.0)
    raise ValueError(f"unknown instrumental response kind {kind!r}")


def dm_smearing_width(DM, chan_bw, freqs, P):
    """Per-channel DM-smearing width [rot]:
    8.3e-6 s * DM * BW_MHz / nu_GHz^3 / P."""
    return 8.3e-6 * DM * chan_bw / (freqs / 1.0e3) ** 3.0 / P


def instrumental_response_port_FT(nharm, freqs, widths=(), kinds=(),
                                  DM_smear=None, chan_bw=None, P=None):
    """Product of instrumental response FTs per channel: a real
    (nchan, nharm) tensor in freqs' dtype.  widths/kinds pair up as
    achromatic kernels; DM_smear (a DM value) adds a per-channel rect
    kernel of the DM-smearing width."""
    freqs = torch.as_tensor(freqs)
    out = torch.ones((freqs.shape[0], nharm), dtype=freqs.dtype,
                     device=freqs.device)
    for width, kind in zip(widths, kinds):
        out = out * instrumental_response_FT(
            torch.as_tensor(width, dtype=freqs.dtype,
                            device=freqs.device), nharm, kind)[None, :]
    if DM_smear is not None:
        w = dm_smearing_width(DM_smear, chan_bw, freqs, P)
        k = torch.arange(nharm, dtype=freqs.dtype, device=freqs.device)
        out = out * torch.sinc(k[None, :] * w[:, None])
    return out


def gaussian_function(xs, loc, wid, norm=False):
    """Plain (non-wrapped) Gaussian of FWHM ``wid`` at xs: peak 1, or
    unit area with norm=True.  xs a tensor (or array, made float64)."""
    xs = xs if isinstance(xs, torch.Tensor) else torch.as_tensor(
        xs, dtype=torch.float64)
    sigma = wid * FWHM2SIGMA
    y = torch.exp(-0.5 * ((xs - loc) / sigma) ** 2.0)
    if norm:
        y = y / (sigma * math.sqrt(2.0 * math.pi))
    return y
