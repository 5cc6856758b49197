"""Scattering kernels (counterpart of pulseportraiture_tpu/ops/scattering.py).

A thin-screen scattered pulse is the intrinsic profile convolved with a
one-sided exponential of timescale tau (rotations); its analytic FT is
H(k) = 1 / (1 + 2 pi i k tau), and the timescale follows
tau_n = tau (nu_n / nu_tau)^alpha.  Everything works in the harmonic
domain with tau in rotations (tau_rot = tau_sec / P at the I/O
boundary).
"""

import math

import torch

from .fourier import irfft_c, rfft_c

__all__ = ["scattering_times", "scattering_profile_FT",
           "scattering_profile_FT_dtau", "scattering_portrait_FT",
           "scattering_portrait_FT_dtau", "scattering_kernel_time",
           "add_scattering"]


def _real_dtype(x):
    """The harmonic index dtype of a kernel: the tau tensor's floating
    dtype, float32 for anything narrower (the JAX package's
    result_type(tau, float32))."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.float64:
        return torch.float64
    return torch.float32


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def scattering_times(tau, alpha, freqs, nu_tau):
    """Per-channel scattering timescales tau_n = tau*(nu_n/nu_tau)**alpha."""
    return tau * (freqs / nu_tau) ** alpha


def scattering_profile_FT(tau, nharm):
    """FT of the unit-area one-sided exponential exp(-t/tau)/tau, t>=0,
    at harmonics k = 0..nharm-1 (tau in rotations; 0 is the identity)."""
    tau = _as_tensor(tau)
    k = torch.arange(nharm, dtype=_real_dtype(tau), device=tau.device)
    t = 2.0 * math.pi * k * tau
    return 1.0 / torch.complex(torch.ones_like(t), t)


def scattering_profile_FT_dtau(tau, nharm):
    """Analytic dH/dtau of scattering_profile_FT: -2 pi i k H^2."""
    tau = _as_tensor(tau)
    k = torch.arange(nharm, dtype=_real_dtype(tau), device=tau.device)
    H = scattering_profile_FT(tau, nharm)
    two_pi_k = 2.0 * math.pi * k
    return torch.complex(torch.zeros_like(two_pi_k), -two_pi_k) * H * H


def scattering_portrait_FT(taus, nharm):
    """Per-channel scattering kernels; taus (..., nchan) in rotations ->
    (..., nchan, nharm) complex."""
    taus = _as_tensor(taus)
    k = torch.arange(nharm, dtype=_real_dtype(taus), device=taus.device)
    t = 2.0 * math.pi * taus[..., None] * k
    return 1.0 / torch.complex(torch.ones_like(t), t)


def scattering_portrait_FT_dtau(taus, nharm):
    """Per-channel dH/dtau_n of scattering_portrait_FT; taus
    (..., nchan) -> (..., nchan, nharm) complex."""
    taus = _as_tensor(taus)
    k = torch.arange(nharm, dtype=_real_dtype(taus), device=taus.device)
    H = scattering_portrait_FT(taus, nharm)
    two_pi_k = 2.0 * math.pi * k
    return torch.complex(torch.zeros_like(two_pi_k), -two_pi_k) * H * H


def scattering_kernel_time(tau, nbin, dtype=torch.float64, device=None):
    """Time-domain one-sided exponential kernel over one rotation,
    normalized to unit sum; tau in rotations.  tau <= 0 gives a delta."""
    tau = torch.as_tensor(tau, dtype=dtype, device=device)
    t = torch.arange(nbin, dtype=dtype, device=tau.device) / nbin
    pos = tau > 0.0
    kern = torch.where(pos, torch.exp(-t / torch.where(pos, tau, 1.0)),
                       torch.zeros_like(t))
    delta = torch.zeros(nbin, dtype=dtype, device=tau.device)
    delta[0] = 1.0
    kern = torch.where(pos, kern, delta)
    return kern / torch.sum(kern)


def add_scattering(port, taus, wrap=True):
    """Circularly convolve each channel of a (..., nchan, nbin) portrait
    with its one-sided exponential kernel (taus in rotations), through
    the analytic FT the fits use."""
    port = _as_tensor(port)
    nbin = port.shape[-1]
    pFT = rfft_c(port)
    H = scattering_portrait_FT(_as_tensor(taus).to(port.device),
                               pFT.shape[-1])
    return irfft_c(pFT * H, n=nbin)
