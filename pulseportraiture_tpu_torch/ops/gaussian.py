"""Gaussian profile kernels (counterpart of pulseportraiture_tpu/ops/gaussian.py).

Only what the Gaussian template generator needs: the analytic Fourier
transform of a periodic Gaussian in the FWHM parameterization.
"""

import math

import torch

__all__ = ["FWHM2SIGMA", "gaussian_profile_FT"]

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
