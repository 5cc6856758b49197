"""1-D FFTFIT: the phase shift (and scale) between two profiles in the
Fourier domain (counterpart of pulseportraiture_tpu/fit/phase_shift.py).

The dense cross-correlation over nbin * oversamp lags comes from one
zero-padded inverse FFT; its first maximum seeds a fixed number of
Newton steps on the harmonic-domain objective

    C(phi) = sum_k Re(x_k e^{2 pi i k phi}),  x_k = d_k conj(m_k) / sig_F^2

(the DC term weighted by F0_fact).  The JAX package differentiates C
with jax.grad; here its derivatives are written out:

    dC/dphi   = -sum_k 2 pi k     Im(x_k e^{2 pi i k phi})
    d2C/dphi2 = -sum_k (2 pi k)^2 Re(x_k e^{2 pi i k phi}).

Everything is batched over the leading dimensions of the profiles.
Plain PyTorch: the JAX package runs this in XLA, outside any Pallas
kernel, and the dense CCF is the library inverse FFT there.  On CUDA the
spectra and the CCF go through the batch-invariant matmul DFT
(ops.fourier.rfft_c_rows / irfft_c_rows): cuFFT's plan, and its
rounding, follows the batch count, which moved a profile's phase by
4e-4 sigma between a subint fitted alone and in a batch of 8 (ROADMAP
C8).  The CPU keeps torch.fft.
"""

import math

import torch

from ..config import F0_fact
from ..device import resolve_device
from ..ops.fourier import CHANNEL_ROW_BLOCK, irfft_c_rows, rfft_c_rows
from ..ops.noise import fourier_noise, get_noise_PS
from ..ops.phasor import cexp
from ..utils.bunch import DataBunch
from .portrait import _as_tensor, _canonical_real_dtype

__all__ = ["fit_phase_shift", "fit_phase_shift_batch"]


def _ccf_terms(dFT, mFT, errs_F):
    """x_k = dFT_k conj(mFT_k) / sig_F^2 per profile (errs_F holds one
    sig_F per profile), the DC term multiplied by F0_fact."""
    x = dFT * torch.conj(mFT) / errs_F[..., None] ** 2.0
    x[..., 0] = x[..., 0] * F0_fact
    return x


def _objective(x, k2pi, phi):
    """(C, dC/dphi, d2C/dphi2) at phi (...,) of the weighted
    cross-spectrum x (..., nharm); k2pi = 2 pi k."""
    xe = x * cexp(k2pi * phi[..., None])
    return (torch.sum(xe.real, dim=-1),
            -torch.sum(k2pi * xe.imag, dim=-1),
            -torch.sum(k2pi**2.0 * xe.real, dim=-1))


def _fit_phase_shift_core(dFT, mFT, errs_F, oversamp=8, newton_iters=5):
    """The fit of every profile: dFT (..., nharm), mFT broadcastable to
    it, errs_F (...).  Returns (phi, phi_err, scale, scale_err, chi2,
    dof, snr); dof is the int nbin - 2."""
    nharm = dFT.shape[-1]
    nbin = 2 * (nharm - 1)
    rdt = errs_F.dtype
    x = _ccf_terms(dFT, mFT, errs_F)
    k = torch.arange(nharm, dtype=rdt, device=dFT.device)
    k2pi = 2.0 * math.pi * k

    # dense CCF: C(phi_j) at phi_j = j / nlag, its first maximum the seed
    nlag = nbin * oversamp
    ccf = irfft_c_rows(x, n=nlag, block=CHANNEL_ROW_BLOCK) * nlag
    phi = torch.argmax(ccf, dim=-1).to(rdt) / nlag
    del ccf
    for _ in range(newton_iters):
        _, g, h = _objective(x, k2pi, phi)
        step = torch.where(h < 0.0, -g / h, torch.zeros_like(h))
        # at most one bin a step: the Newton walk stays on the seed's peak
        phi = phi + torch.clamp(step, -1.0 / nbin, 1.0 / nbin)

    w0 = torch.where(k == 0, F0_fact, 1.0).to(rdt)
    S = torch.sum(torch.abs(mFT) ** 2.0 / errs_F[..., None] ** 2.0 * w0,
                  dim=-1)
    Sd = torch.sum(torch.abs(dFT) ** 2.0 / errs_F[..., None] ** 2.0 * w0,
                   dim=-1)
    C, _, curv = _objective(x, k2pi, phi)
    scale = C / S
    # chi2(phi) = Sd - C^2 / S with the scale profiled out;
    # Var(phi) = (0.5 d2chi2/dphi2)^-1
    phi_err = torch.where((C > 0) & (curv < 0), (-scale * curv) ** -0.5,
                          torch.full_like(C, math.inf))
    scale_err = S**-0.5
    chi2 = Sd - C**2.0 / S
    snr = torch.sqrt(torch.maximum(scale**2.0 * S, torch.zeros_like(S)))
    phi = torch.remainder(phi + 0.5, 1.0) - 0.5
    return phi, phi_err, scale, scale_err, chi2, nbin - 2, snr


def _bunch(phi, phi_err, scale, scale_err, chi2, dof, snr):
    return DataBunch(phase=phi, phase_err=phi_err, scale=scale,
                     scale_err=scale_err, chi2=chi2, dof=dof,
                     red_chi2=chi2 / dof, snr=snr)


def fit_phase_shift(data, model, noise_std=None, oversamp=8, newton_iters=5,
                    device=None):
    """The phase shift of ``data`` relative to ``model``, both (nbin,)
    profiles, on ``device`` (default cuda) in the data's dtype.  Rotating
    data by ``phase`` aligns it with model; ``scale * model`` matches the
    aligned data.  noise_std None -> the power-spectrum estimate of the
    data.  Returns a DataBunch(phase, phase_err, scale, scale_err, chi2,
    dof, red_chi2, snr) of 0-d tensors (dof an int)."""
    dev = resolve_device(device)
    data = _as_tensor(data, None, dev)
    model = _as_tensor(model, data.dtype, dev)
    nbin = data.shape[-1]
    if noise_std is None:
        noise_std = get_noise_PS(data)
    errs_F = fourier_noise(_as_tensor(noise_std, data.dtype, dev), nbin)
    return _bunch(*_fit_phase_shift_core(
        rfft_c_rows(data), rfft_c_rows(model), errs_F, oversamp=oversamp,
        newton_iters=newton_iters))


def fit_phase_shift_batch(data, model, noise_std, oversamp=8, newton_iters=5,
                          device=None):
    """The fit of every (..., nbin) profile of ``data`` against ``model``
    (any shape that broadcasts to data's, e.g. one (nchan, nbin) template
    for (nsub, nchan, nbin) data) with per-profile noise_std (...), on
    ``device`` (default cuda).  float64 data run as float32 where
    config's device_f32 knob resolves on (CUDA), as the JAX package runs
    them as float32 on the TPU.  Returns fit_phase_shift's DataBunch of
    (...) tensors."""
    dev = resolve_device(device)
    data = _canonical_real_dtype(_as_tensor(data, None, dev), dev)
    model = _as_tensor(model, data.dtype, dev)
    nbin = data.shape[-1]
    errs_F = fourier_noise(_as_tensor(noise_std, data.dtype, dev), nbin)
    return _bunch(*_fit_phase_shift_core(
        rfft_c_rows(data), rfft_c_rows(model), errs_F, oversamp=oversamp,
        newton_iters=newton_iters))
