"""Noise and S/N estimates of the streaming lane (counterpart of pulseportraiture_tpu/ops/noise.py).

These are XLA ops in the JAX package, not Pallas kernels, so plain
PyTorch is the port.  Two differences in idiom, none in semantics:

- the median has ``jnp.median`` semantics (the mean of the two middle
  values when n is even), where ``torch.median`` returns the lower one.
  It is two ``torch.kthvalue`` order statistics: ``torch.quantile``
  refuses inputs above 16M elements, and a campaign bucket holds 268M;
- ``min_window_baseline`` takes its cumulative sums with
  ``torch.cumsum``, in float64 (see there); the JAX package's
  triangular-matmul form is a TPU workaround.
"""

import torch

__all__ = ["median_lastaxis", "exact_median_lastaxis", "get_noise",
           "get_noise_PS", "BASELINE_FRAC", "baseline_window",
           "min_window_baseline", "get_SNR", "fourier_noise",
           "channel_SNRs_FT", "get_scales"]

# the min-window baseline's window, as a fraction of the profile length;
# the decode-fused kernel (ops.fused) reads the same window
BASELINE_FRAC = 0.15


def baseline_window(nbin, frac=BASELINE_FRAC):
    """Length in bins of the min-window baseline's circular window."""
    return max(1, int(round(frac * nbin)))


def median_lastaxis(x):
    """Median over the last axis, the mean of the two middle order
    statistics when the length is even (``jnp.median`` semantics)."""
    n = x.shape[-1]
    lo = torch.kthvalue(x, (n - 1) // 2 + 1, dim=-1).values
    if n % 2 == 1:
        return lo
    hi = torch.kthvalue(x, n // 2 + 1, dim=-1).values
    return (lo + hi) / 2


def exact_median_lastaxis(x):
    """The JAX package's name for the median over the last axis, equal to
    ``jnp.median`` bit for bit.  There it is a sort-free 32-trip bisection
    (an XLA workaround for the sort); two ``torch.kthvalue`` order
    statistics give the same values in every dtype, so this is
    median_lastaxis.  Assumes finite inputs."""
    return median_lastaxis(x)


def get_noise_PS(data, frac=0.25):
    """Off-pulse noise std per profile from the power spectrum: the mean
    power in the top ``frac`` of rFFT frequencies, converted to a
    time-domain std, sqrt(mean_power / nbin).  (..., nbin) -> (...)."""
    nbin = data.shape[-1]
    X = torch.fft.rfft(data, dim=-1)
    nharm = X.shape[-1]
    kc = int((1.0 - frac) * nharm)
    power = torch.abs(X[..., kc:]) ** 2.0
    return torch.sqrt(torch.mean(power, dim=-1) / nbin)


def get_noise(data, method="PS", **kwargs):
    """Noise estimator by name: 'PS' (get_noise_PS, torch on the data's
    device) or 'fit' (ops.filters.get_noise_fit, NumPy on the host,
    per channel for input of 2 or more dimensions; it returns NumPy)."""
    if method == "PS":
        return get_noise_PS(data, **kwargs)
    if method == "fit":
        import numpy as np

        from .filters import get_noise_fit

        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        data = np.asarray(data)
        kwargs.setdefault("chans", data.ndim >= 2)
        return get_noise_fit(data, **kwargs)
    raise ValueError(f"unknown noise method {method!r}")


def _CS(dFT, mFT, errs_F, harm_weights):
    """Per-channel C_n = sum_k Re(d conj m) w and S_n = sum_k |m|^2 w with
    w = harm_weights / errs_F^2."""
    if harm_weights is None:
        harm_weights = torch.ones(dFT.shape[-1], dtype=errs_F.dtype,
                                  device=errs_F.device)
    w = harm_weights / errs_F[..., None] ** 2.0
    S = torch.sum(torch.abs(mFT) ** 2.0 * w, dim=-1)
    C = torch.sum((dFT * torch.conj(mFT)).real * w, dim=-1)
    return C, torch.clamp(S, min=torch.finfo(S.dtype).tiny)


def channel_SNRs_FT(dFT, mFT, errs_F, harm_weights=None):
    """Matched-filter S/N of each channel of a data portrait against an
    aligned model portrait, from their rffts: C_n / sqrt(S_n)."""
    C, S = _CS(dFT, mFT, errs_F, harm_weights)
    return C / torch.sqrt(S)


def get_scales(dFT, mFT, errs_F, harm_weights=None):
    """Maximum-likelihood per-channel amplitudes a_n = C_n / S_n (eq. 11
    of Pennucci+ 2014).  dFT, mFT: (..., nchan, nharm) rffts of aligned
    data and model; errs_F: (..., nchan) Fourier-domain noise."""
    C, S = _CS(dFT, mFT, errs_F, harm_weights)
    return C / S


def fourier_noise(noise_std, nbin):
    """Std of the real and imaginary parts of the unnormalised rfft
    coefficients of white noise of time-domain std ``noise_std``:
    noise_std * sqrt(nbin / 2).  The phase-shift fit's chi2 is
    calibrated only with exactly this scaling."""
    return noise_std * (nbin / 2.0) ** 0.5


def min_window_baseline(profiles, frac=BASELINE_FRAC):
    """Mean of the quietest circular window of round(frac * nbin) bins
    of each (..., nbin) profile: the cumulative sums give every circular
    window mean, and the least of them, cast to the input dtype, is the
    baseline.  The sums are taken in float64 whatever the input dtype: a
    float32 scan over 2048 bins loses ~1e-6 of the data scale in the
    baseline, and a channel sum of the baselined profile nbin times
    that (the JAX package accumulates in the input dtype)."""
    p = profiles
    nbin = p.shape[-1]
    w = baseline_window(nbin, frac)
    cs = torch.cumsum(p, dim=-1, dtype=torch.float64)
    total = cs[..., -1:]
    first = cs[..., w - 1:w]
    direct = cs[..., w:] - cs[..., :nbin - w]
    wrapped = total - cs[..., nbin - w:nbin - 1] + cs[..., :w - 1]
    means = torch.cat([first, direct, wrapped], dim=-1) / w
    return torch.amin(means, dim=-1).to(p.dtype)


def get_SNR(profile, noise_std=None, fudge=3.25):
    """Equivalent-width S/N of each (..., nbin) profile:
    weq = sum(p) / max|p|, SNR = |sum(p)| / (noise sqrt(weq)) / fudge,
    with p the profile minus its median."""
    p = profile - median_lastaxis(profile)[..., None]
    if noise_std is None:
        noise_std = get_noise_PS(profile)
    tiny = torch.finfo(p.dtype).tiny
    peak = torch.clamp(torch.amax(torch.abs(p), dim=-1), min=tiny)
    s = torch.abs(torch.sum(p, dim=-1))
    weq = torch.clamp(s / peak, min=1.0)
    return s / (noise_std * torch.sqrt(weq)) / fudge
