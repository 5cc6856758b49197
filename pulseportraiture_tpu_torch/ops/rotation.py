"""FFT rotation of profiles and portraits (counterpart of pulseportraiture_tpu/ops/rotation.py).

One set of broadcasting functions covers profiles (nbin,), portraits
(nchan, nbin) and cubes (nsub, npol, nchan, nbin).  Positive (phi, DM)
rotate to earlier phase: rotating data by a fit's result aligns it with
the template, and rotating with the data's own DM dedisperses it.
"""

import math

import torch

from ..config import Dconst
from .fourier import irfft_c, rfft_c
from .phasor import cexp, phase_shifts, phasor

__all__ = ["fft_shift_bins", "rotate_profile", "rotate_portrait",
           "rotate_full", "add_DM_nu", "fft_rotate"]


def fft_shift_bins(profile, shift_bins):
    """Shift a profile to earlier phase by ``shift_bins`` bins (any real
    number) by the FFT shift theorem."""
    nbin = profile.shape[-1]
    pFT = rfft_c(profile)
    k = torch.arange(pFT.shape[-1], dtype=profile.dtype,
                     device=profile.device)
    return irfft_c(pFT * cexp(2.0 * math.pi * k * (shift_bins / nbin)),
                   n=nbin)


def rotate_profile(profile, phi):
    """Rotate a profile to earlier phase by phi [rot]."""
    return fft_shift_bins(profile, phi * profile.shape[-1])


def rotate_portrait(port, phi, DM=0.0, P=None, freqs=None,
                    nu_ref=math.inf):
    """Rotate a (..., nchan, nbin) portrait by phi [rot] and, given the
    channel frequencies and period, DM [pc cm^-3] referenced to nu_ref
    (the data's own DM at nu_ref = inf dedisperses)."""
    nbin = port.shape[-1]
    pFT = rfft_c(port)
    rdt = pFT.real.dtype
    if freqs is None:
        delays = torch.as_tensor(phi, dtype=rdt, device=port.device)[
            ..., None] * torch.ones(port.shape[-2], dtype=rdt,
                                    device=port.device)
    else:
        delays = phase_shifts(phi, DM, 0.0, freqs, P, nu_ref, 1.0)
    return irfft_c(pFT * phasor(delays, pFT.shape[-1]), n=nbin)


def rotate_full(cube, phi, DM, Ps, freqs, nu_ref=math.inf):
    """Rotate a (nsub, npol, nchan, nbin) cube with per-subint periods
    Ps (nsub,) and frequencies freqs (nsub, nchan)."""
    nbin = cube.shape[-1]
    cFT = rfft_c(cube)
    delays = phase_shifts(phi, DM, 0.0, freqs, Ps[:, None], nu_ref, 1.0)
    ph = phasor(delays, cFT.shape[-1])
    return irfft_c(cFT * ph[:, None, :, :], n=nbin)


def add_DM_nu(port, phi, DM_coeffs, powers, P, freqs, nu_ref):
    """Rotate a portrait by a sum of power-law dispersion terms:
    t_n = phi + (Dconst / P) sum_j C_j (nu_n^x_j - nu_ref^x_j)."""
    nbin = port.shape[-1]
    dt = port.dtype
    C = torch.as_tensor(DM_coeffs, dtype=dt, device=port.device)
    x = torch.as_tensor(powers, dtype=dt, device=port.device)
    terms = C[:, None] * (freqs[None, :] ** x[:, None]
                          - nu_ref ** x[:, None])
    delays = phi + (Dconst / P) * torch.sum(terms, dim=0)
    pFT = rfft_c(port)
    return irfft_c(pFT * phasor(delays, pFT.shape[-1]), n=nbin)


def fft_rotate(arr, bins):
    """Rotate a series LEFT by ``bins`` places (fractional allowed):
    y(n) = x(n + bins), np.roll(x, -bins) for integers.  Its own phase
    ramp, so it is an independent oracle for the rotations above:
    fft_rotate(x, b) == rotate_profile(x, b / nbin)."""
    if not arr.is_floating_point():
        arr = arr.float()
    nbin = arr.shape[-1]
    dt = arr.dtype
    k = torch.arange(nbin // 2 + 1, dtype=dt, device=arr.device)
    b = torch.as_tensor(bins, dtype=dt, device=arr.device)
    return irfft_c(rfft_c(arr) * cexp(2.0 * math.pi * k * b / nbin), n=nbin)
