"""Scattering kernels (counterpart of pulseportraiture_tpu/ops/scattering.py).

Only what the Gaussian template generator and the synthetic archive
writer need.  A thin-screen scattered pulse is the intrinsic profile
convolved with a one-sided exponential of timescale tau (rotations);
its analytic FT is H(k) = 1 / (1 + 2 pi i k tau), and the timescale
follows tau_n = tau (nu_n / nu_tau)^alpha.
"""

import math

import torch

__all__ = ["scattering_portrait_FT", "scattering_times"]


def scattering_times(tau, alpha, freqs, nu_tau):
    """Per-channel scattering timescales tau_n = tau*(nu_n/nu_tau)**alpha."""
    return tau * (freqs / nu_tau) ** alpha


def scattering_portrait_FT(taus, nharm):
    """Per-channel scattering kernels; taus (..., nchan) in rotations ->
    (..., nchan, nharm) complex."""
    k = torch.arange(nharm, dtype=taus.dtype, device=taus.device)
    t = 2.0 * math.pi * taus[..., None] * k
    return 1.0 / torch.complex(torch.ones_like(t), t)
