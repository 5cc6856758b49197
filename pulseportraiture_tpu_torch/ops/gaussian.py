"""Gaussian profile kernels (counterpart of pulseportraiture_tpu/ops/gaussian.py).

The analytic Fourier transform of a periodic Gaussian in the FWHM
parameterization (the Gaussian template generator), and the
instrumental-response kernels the scattering fits fold into the
template spectrum (boxcar or Gaussian smearing, per-channel DM
smearing).
"""

import math

import torch

__all__ = ["FWHM2SIGMA", "gaussian_profile_FT", "instrumental_response_FT",
           "dm_smearing_width", "instrumental_response_port_FT"]

FWHM2SIGMA = 1.0 / (8.0 * math.log(2.0)) ** 0.5  # sigma = FWHM * this


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
