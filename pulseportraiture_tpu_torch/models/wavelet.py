"""Stationary (translation-invariant) wavelet denoising (counterpart of
pulseportraiture_tpu/models/wavelet.py).

The undecimated transform is an FFT-domain circular correlation /
convolution with a-trous (upsampled) Daubechies filters, batched over
every leading axis: the JAX package's ``vmap``s over channels and over
the smart_smooth fact grid are broadcasting here.  The scaling filters
come from a host spectral factorization (no table, no pywt), copied
from the JAX package.

Every function takes numpy arrays or tensors; numpy input is put on
``device`` (default cuda), a tensor stays on its own device.  The
filters' spectra are host float64, cast to the input's complex dtype.
"""

import math
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..ops.noise import get_noise_PS, median_lastaxis

__all__ = [
    "daubechies",
    "swt",
    "iswt",
    "wavelet_smooth",
    "smart_smooth",
    "get_red_chi2",
]


@lru_cache(maxsize=None)
def daubechies(N=8):
    """Orthonormal Daubechies scaling filter with N vanishing moments
    (length 2N), by spectral factorization of the half-band polynomial.

    Returns (dec_lo, dec_hi) as float64 numpy arrays with sum(dec_lo)
    = sqrt(2) and the usual quadrature-mirror relation.
    """
    if N < 1:
        raise ValueError("N >= 1 required")
    if N == 1:  # Haar
        lo = np.array([1.0, 1.0]) / np.sqrt(2.0)
    else:
        # P(y) = sum_{k<N} C(N-1+k, k) y^k ; y = (2 - z - 1/z)/4.
        # Build the Laurent polynomial z^{N-1} P(y(z)) and keep the
        # roots inside the unit circle (minimum-phase factor).
        from math import comb

        py = np.array([comb(N - 1 + k, k) for k in range(N - 1, -1, -1)],
                      dtype=float)
        # y(z) as a polynomial in z (times z^-1): y = (-z^2 + 2z - 1)/(4z)
        yz = np.array([-1.0, 2.0, -1.0]) / 4.0
        total = np.zeros(2 * N - 1)
        for k in range(N):  # coefficient of y^{N-1-k} is py[k]
            term = np.array([1.0])
            for _ in range(N - 1 - k):
                term = np.convolve(term, yz)
            # multiply by z^{k} to bring everything to degree 2N-2
            padded = np.zeros(2 * N - 1)
            padded[k:k + len(term)] += py[k] * term
            total += padded
        roots = np.roots(total)
        keep = roots[np.abs(roots) < 1.0]
        # h(z) ~ (1+z)^N * prod (z - r_i), normalized
        h = np.array([1.0])
        for _ in range(N):
            h = np.convolve(h, [1.0, 1.0])
        for r in keep:
            h = np.convolve(h, [1.0, -r])
        h = np.real(h)
        lo = h * (np.sqrt(2.0) / h.sum())
    hi = lo[::-1].copy()
    hi[1::2] *= -1.0
    return lo, hi


@lru_cache(maxsize=None)
def _filter_ffts(nbin, nlevel, N=8):
    """rfft of the a-trous upsampled (lo, hi) filters at each level,
    zero-padded to nbin: two host complex128 (nlevel, nbin//2+1)
    arrays."""
    lo, hi = daubechies(N)
    los, his = [], []
    for j in range(nlevel):
        step = 2 ** j
        for f, out in ((lo, los), (hi, his)):
            up = np.zeros(nbin)
            idx = (np.arange(len(f)) * step) % nbin
            np.add.at(up, idx, f)
            out.append(np.fft.rfft(up))
    return np.stack(los), np.stack(his)


def _filters(nbin, nlevel, N, x):
    """_filter_ffts as tensors on x's device in x's complex dtype."""
    cdt = torch.complex128 if x.dtype == torch.float64 else torch.complex64
    return tuple(torch.from_numpy(f).to(device=x.device, dtype=cdt)
                 for f in _filter_ffts(nbin, nlevel, N))


def _tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(np.asarray(x), device=resolve_device(device))


def swt(x, nlevel=5, N=8, device=None):
    """Stationary wavelet transform with periodic boundary.

    x: (..., nbin).  Returns (cA, cD), each (..., nlevel, nbin), finest
    level first (index 0 = level-1 detail), the convention the
    thresholding code expects.
    """
    x = _tensor(x, device)
    nbin = x.shape[-1]
    loF, hiF = _filters(nbin, nlevel, N, x)
    cAs, cDs = [], []
    a = x
    for j in range(nlevel):
        aF = torch.fft.rfft(a, dim=-1)
        # circular correlation = multiply by conj(filter fft)
        a_next = torch.fft.irfft(aF * torch.conj(loF[j]), n=nbin, dim=-1)
        cDs.append(torch.fft.irfft(aF * torch.conj(hiF[j]), n=nbin,
                                   dim=-1))
        cAs.append(a_next)
        a = a_next
    return torch.stack(cAs, dim=-2), torch.stack(cDs, dim=-2)


def iswt(cA, cD, N=8, device=None):
    """Inverse of swt: reconstruct from the coarsest approximation and
    all detail levels.  cA, cD: (..., nlevel, nbin)."""
    cA = _tensor(cA, device)
    cD = _tensor(cD, cA.device)
    nlevel, nbin = cA.shape[-2], cA.shape[-1]
    loF, hiF = _filters(nbin, nlevel, N, cA)
    a = cA[..., -1, :]
    for j in range(nlevel - 1, -1, -1):
        aF = torch.fft.rfft(a, dim=-1)
        dF = torch.fft.rfft(cD[..., j, :], dim=-1)
        # synthesis: circular convolution with the same filters, halved
        a = 0.5 * torch.fft.irfft(aF * loF[j] + dF * hiF[j], n=nbin,
                                  dim=-1)
    return a


def _universal_threshold(cD1, nbin, fact):
    """fact * (MAD/0.6745) * sqrt(2 ln nbin), from the coefficients
    cD1 (..., n) (reference pplib.py:1725-1727)."""
    mad = median_lastaxis(torch.abs(cD1))
    return fact * (mad / 0.6745) * math.sqrt(2.0 * math.log(nbin))


def _threshold(c, t, threshtype):
    if threshtype == "hard":
        return torch.where(torch.abs(c) > t, c, torch.zeros_like(c))
    elif threshtype == "soft":
        return torch.sign(c) * torch.clamp(torch.abs(c) - t, min=0.0)
    raise ValueError(f"unknown threshtype {threshtype!r}")


def _coarsest(cA, cD):
    """The coarsest (approximation, detail) pair side by side: the
    reference thresholds every coefficient by the MAD of pywt.swt's
    coeffs[0], the coarsest level pair (pplib.py:1728-1729)."""
    return torch.cat([cA[..., -1, :], cD[..., -1, :]], dim=-1)


def wavelet_smooth(port, nlevel=5, threshtype="hard", fact=1.0, N=8,
                   device=None):
    """Wavelet-denoise a profile (nbin,) or portrait (nchan, nbin):
    swt -> universal threshold (hard or soft) of every coefficient ->
    iswt (reference pplib.py:1692-1737), every channel at once."""
    port = _tensor(port, device)
    nbin = port.shape[-1]
    cA, cD = swt(port, nlevel=nlevel, N=N)
    t = _universal_threshold(_coarsest(cA, cD), nbin, fact)[..., None, None]
    return iswt(_threshold(cA, t, threshtype), _threshold(cD, t, threshtype),
                N=N)


def get_red_chi2(data, model, errs=None, dof=None, device=None):
    """Reduced chi^2 between data and model (reference pplib.py:754-779).

    1-D or 2-D; errs estimated per profile from the power spectrum if
    not given; dof defaults to sum(shape) as in the reference.
    """
    data = _tensor(data, device)
    model = _tensor(model, data.device).to(data.dtype)
    if errs is None:
        errs = get_noise_PS(data)
    errs = torch.as_tensor(errs, dtype=data.dtype, device=data.device)
    if dof is None:
        dof = sum(data.shape)
    resids = (data - model) / (errs[..., None] if data.dim() == 2 else errs)
    return torch.sum(resids ** 2.0) / dof


def _smooth_score_grid(prof, nlevel, threshtype="hard", N=8, nfact=30,
                       fact_max=3.0, rchi2_tol=0.1):
    """For each (..., nbin) profile and one nlevel, the smart_smooth
    score on a fact grid.  Returns (scores (..., nfact), facts (nfact,),
    smoothed (..., nfact, nbin), rchi2s (..., nfact)).

    Score = pseudo-S/N (Fourier signal power / Fourier noise), zeroed
    when |red_chi2 - 1| > rchi2_tol (reference pplib.py:1814-1838).
    """
    nbin = prof.shape[-1]
    facts = torch.linspace(0.0, fact_max, nfact, dtype=prof.dtype,
                           device=prof.device)
    cA, cD = swt(prof, nlevel=nlevel, N=N)
    t0 = _universal_threshold(_coarsest(cA, cD), nbin, 1.0)
    t = (t0[..., None] * facts)[..., None, None]     # (..., nfact, 1, 1)
    sm = iswt(_threshold(cA[..., None, :, :], t, threshtype),
              _threshold(cD[..., None, :, :], t, threshtype), N=N)
    sig = torch.sum(torch.abs(torch.fft.rfft(sm, dim=-1)[..., 1:]) ** 2.0,
                    dim=-1)
    noise = get_noise_PS(sm) * math.sqrt(nbin / 2.0)
    pos = noise > 0.0
    snr = torch.where(pos, sig / torch.where(pos, noise,
                                             torch.ones_like(noise)),
                      torch.full_like(noise, math.inf))
    snr = torch.where(sig > 0.0, snr, torch.zeros_like(snr))
    # red chi2 of data vs smooth, noise from the data profile; a zero
    # noise estimate means the gate cannot be evaluated -> treat as
    # failed (inf), never NaN (NaN comparisons would silently PASS it)
    dnoise = get_noise_PS(prof)[..., None]
    good = dnoise > 0.0
    rchi2 = torch.where(
        good,
        torch.sum(((prof[..., None, :] - sm)
                   / torch.where(good, dnoise, torch.ones_like(dnoise))
                   [..., None]) ** 2.0, dim=-1) / nbin,
        torch.full_like(sig, math.inf))
    snr = torch.where(torch.abs(rchi2 - 1.0) > rchi2_tol,
                      torch.zeros_like(snr), snr)
    return snr, facts, sm, rchi2


def smart_smooth(port, try_nlevels=None, rchi2_tol=0.1, threshtype="hard",
                 N=8, nfact=30, fact_max=3.0, device=None):
    """Auto-tuned wavelet smoothing (reference pplib.py:1740-1811).

    For each profile, maximize pseudo-S/N over (nlevel, fact) subject to
    reduced-chi2 within rchi2_tol of 1; profiles with no acceptable
    smoothing are zeroed.  The reference brute-forces fact per (profile,
    nlevel) on the host; here each nlevel's whole (profile x fact) grid
    is one set of batched ops, which holds nprof x nfact x nlevel x nbin
    coefficients at once.
    """
    port = _tensor(port, device)
    one_prof = port.dim() == 1
    if one_prof:
        port = port[None]
    nchan, nbin = port.shape
    if nbin % 2 != 0 or try_nlevels == 0:
        return port[0] if one_prof else port
    if np.modf(np.log2(nbin))[0] != 0.0:
        try_nlevels = 1
    elif try_nlevels is None:
        try_nlevels = int(np.log2(nbin))
    try_nlevels = min(try_nlevels, int(np.log2(nbin)))

    best_score = torch.full((nchan,), -math.inf, dtype=port.dtype,
                            device=port.device)
    best_sm = torch.zeros_like(port)
    for ilevel in range(try_nlevels):
        scores, _, smoothed, _ = _smooth_score_grid(
            port, ilevel + 1, threshtype, N, nfact, fact_max, rchi2_tol)
        i = torch.argmax(scores, dim=-1)
        sc = torch.gather(scores, -1, i[:, None])[:, 0]
        sm = torch.gather(smoothed, 1,
                          i[:, None, None].expand(-1, 1, nbin))[:, 0, :]
        better = sc > best_score
        best_score = torch.where(better, sc, best_score)
        best_sm = torch.where(better[:, None], sm, best_sm)

    # zero out profiles whose best smoothing never met the chi2 gate,
    # and all-zero inputs (the reference skips them / zeroes them)
    ok = (best_score > 0.0) & torch.any(port != 0.0, dim=-1)
    best_sm = torch.where(ok[:, None], best_sm, torch.zeros_like(best_sm))
    return best_sm[0] if one_prof else best_sm
