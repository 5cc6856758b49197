"""Rotation and dispersion phase models (counterpart of pulseportraiture_tpu/ops/phasor.py).

Frequencies in MHz, periods in seconds, phases in rotations, DM in
pc cm^-3, GM in pc^2 cm^-6.  The per-channel phase delay of a
(phi, DM, GM) fit is

    t_n = phi + (Dconst DM / P)(nu_n^-2 - nu_DM^-2)
              + (Dconst^2 GM / P)(nu_n^-4 - nu_GM^-4),

and rotating data by positive t_n moves features to earlier phase.
Every function computes in the dtype of its tensor input.
"""

import math

import torch

from ..config import Dconst

__all__ = ["cexp", "DM_delay", "dispersion_phases", "phase_shifts", "phasor", "phase_transform",
           "guess_fit_freq", "doppler_correct_freqs"]


def cexp(x):
    """exp(i x) with the complex dtype matching x (float32 -> complex64)."""
    return torch.complex(torch.cos(x), torch.sin(x))


def DM_delay(DM, freq, freq_ref=math.inf, P=None):
    """Dispersion delay [s] of ``freq`` relative to ``freq_ref`` [MHz],
    positive below freq_ref; in rotations when ``P`` is given."""
    delay = Dconst * DM * (freq**-2.0 - freq_ref**-2.0)
    if P is not None:
        delay = delay / P
    return delay


def dispersion_phases(freqs, DM, P, nu_ref):
    """Per-channel dispersive phase offsets [rot] relative to nu_ref."""
    return (Dconst * DM / P) * (freqs**-2.0 - nu_ref**-2.0)


def phase_shifts(phi, DM, GM, freqs, P, nu_DM, nu_GM):
    """Per-channel total phase delays t_n [rot] of a portrait fit."""
    return (phi + (Dconst * DM / P) * (freqs**-2.0 - nu_DM**-2.0)
            + (Dconst**2.0 * GM / P) * (freqs**-4.0 - nu_GM**-4.0))


def phasor(delays, nharm):
    """exp(2 pi i outer(delays, k)) for harmonics k = 0..nharm-1: a
    channel's rfft times its phasor row rotates the channel to earlier
    phase by ``delays`` rotations."""
    k = torch.arange(nharm, dtype=delays.dtype, device=delays.device)
    return cexp(2.0 * math.pi * delays[..., None] * k)


def phase_transform(phi, DM, nu_ref1, nu_ref2, P, mod=True):
    """Re-reference a fitted phase from nu_ref1 to nu_ref2 [MHz] (inf for
    the infinite-frequency phase), wrapped to [-0.5, 0.5) with mod."""
    phi2 = phi + (Dconst * DM / P) * (nu_ref2**-2.0 - nu_ref1**-2.0)
    if mod:
        phi2 = torch.remainder(phi2 + 0.5, 1.0) - 0.5
    return phi2


def guess_fit_freq(freqs, SNRs=None):
    """The S/N- and nu^-2-weighted centre of mass frequency, the seed of
    a (phi, DM) fit's zero-covariance frequency: (sum w / sum w nu^-2)^0.5
    with w = SNR nu^-2."""
    if SNRs is None:
        SNRs = torch.ones_like(freqs)
    w = SNRs * freqs**-2.0
    return (torch.sum(w) / torch.sum(w * freqs**-2.0)) ** 0.5


def doppler_correct_freqs(freqs, doppler_factor):
    """Barycentre topocentric frequencies: nu_bary = nu_topo * df."""
    return freqs * doppler_factor
