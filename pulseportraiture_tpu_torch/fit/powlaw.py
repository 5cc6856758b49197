"""Power-law and linear frequency fits (counterpart of
pulseportraiture_tpu/fit/powlaw.py).

fit_powlaw is a weighted log-space seed followed by the LM engine
(fit/lm.py, autodiff Jacobian), fit_DM_to_freq_resids a closed-form
weighted linear solve; both in float64 on the caller's device.
"""

import numpy as np
import torch

from ..config import Dconst
from ..device import resolve_device
from ..utils.bunch import DataBunch

__all__ = ["powlaw", "powlaw_integral", "powlaw_freqs", "fit_powlaw",
           "fit_powlaw_function", "fit_DM_to_freq_resids"]


def _t(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.array(x, float), dtype=torch.float64,
                           device=device)


def powlaw(nu, nu_ref, A, alpha):
    """A * (nu/nu_ref)**alpha."""
    return A * (nu / nu_ref) ** alpha


def powlaw_integral(nu2, nu1, nu_ref, A, alpha):
    """Integral of powlaw from nu1 to nu2 (tensors or numbers, float64
    on the CPU unless a tensor argument says otherwise)."""
    alpha = torch.as_tensor(alpha, dtype=torch.float64)
    A = torch.as_tensor(A, dtype=torch.float64)
    C = A * (nu_ref ** -alpha)
    return torch.where(
        alpha == -1.0,
        A * nu_ref * torch.log(torch.as_tensor(nu2 / nu1,
                                               dtype=torch.float64)),
        (C / (1.0 + alpha)) * (nu2 ** (1.0 + alpha)
                               - nu1 ** (1.0 + alpha)))


def powlaw_freqs(lo, hi, N, alpha):
    """N+1 channel edges between lo and hi with equal flux per channel
    for a spectral index alpha (host numpy)."""
    alpha = float(alpha)
    if alpha == -1.0:
        return np.exp(np.linspace(np.log(lo), np.log(hi), N + 1))
    a1 = 1.0 + alpha
    return (np.linspace(lo**a1, hi**a1, N + 1)) ** (1.0 / a1)


def _powlaw_resid(theta, ys, sqrtw, x):
    """Batched residual: theta (B, 2), ys/sqrtw/x (B, nchan)."""
    return (ys - theta[..., :1] * torch.exp(theta[..., 1:2] * x)) * sqrtw


def _fit_powlaw_core(ys, errs, nu_ref, freqs):
    """Weighted log-space seed + damped LM.  The LM scales the
    covariance by reduced chi^2 (lmfit's scale_covar)."""
    from .lm import levenberg_marquardt

    w = torch.where(errs > 0, errs**-2.0, torch.zeros_like(errs))
    x = torch.log(freqs / nu_ref)
    pos = ys > 0
    ly = torch.log(torch.where(pos, ys, torch.ones_like(ys)))
    wp = torch.where(pos, w, torch.zeros_like(w))
    Sw = wp.sum()
    Sx = (wp * x).sum()
    Sy = (wp * ly).sum()
    Sxx = (wp * x * x).sum()
    Sxy = (wp * x * ly).sum()
    det = Sw * Sxx - Sx**2.0
    det = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    alpha0 = (Sw * Sxy - Sx * Sy) / det
    lnA0 = torch.clamp((Sxx * Sy - Sx * Sxy) / det, -300.0, 300.0)
    theta0 = torch.stack([torch.exp(lnA0), alpha0])
    res = levenberg_marquardt(_powlaw_resid, theta0,
                              aux=(ys, torch.sqrt(w), x), max_iter=100)
    return res.x, res.cov, res.chi2


def fit_powlaw(data, init_params=None, errs=None, nu_ref=None, freqs=None,
               device=None):
    """Fit A*(nu/nu_ref)**alpha to data(freqs) on ``device`` (default
    cuda).  Returns DataBunch(amp, amp_err, alpha, alpha_err, chi2, dof,
    red_chi2, residuals, nu_ref, freqs); init_params is accepted for API
    compatibility (the seed is a weighted log-space fit)."""
    dev = resolve_device(device)
    ys = _t(data, dev)
    freqs = _t(freqs, dev)
    errs = torch.ones_like(ys) if errs is None else _t(errs, dev)
    if nu_ref is None:
        nu_ref = float(freqs.mean())
    theta, cov, chi2 = _fit_powlaw_core(ys, errs, nu_ref, freqs)
    dof = ys.shape[0] - 2
    resids = ys - theta[0] * (freqs / nu_ref) ** theta[1]
    return DataBunch(
        amp=float(theta[0]),
        amp_err=float(torch.sqrt(torch.clamp(cov[0, 0], min=0.0))),
        alpha=float(theta[1]),
        alpha_err=float(torch.sqrt(torch.clamp(cov[1, 1], min=0.0))),
        chi2=float(chi2), dof=int(dof), red_chi2=float(chi2 / max(dof, 1)),
        residuals=resids.cpu().numpy(), nu_ref=nu_ref,
        freqs=freqs.cpu().numpy())


def fit_DM_to_freq_resids(freqs, frequency_residuals, errs):
    """Weighted linear fit of residuals [s] against nu^-2 -> (DM, offset,
    nu_ref) and their uncertainties, minimizing sum((resid/errs)^2) (the
    JAX package's deliberate departure from the reference's polyfit
    weighting); the covariance is scaled by reduced chi^2 as
    polyfit(cov=True) does.  Host float64."""
    x = torch.as_tensor(np.asarray(freqs, float)) ** -2.0
    y = torch.as_tensor(np.asarray(frequency_residuals, float))
    w = torch.as_tensor(np.asarray(errs, float)) ** -2.0
    Sw, Sx, Sy = w.sum(), (w * x).sum(), (w * y).sum()
    Sxx, Sxy = (w * x * x).sum(), (w * x * y).sum()
    det = Sw * Sxx - Sx**2.0
    a = (Sw * Sxy - Sx * Sy) / det
    b = (Sxx * Sy - Sx * Sxy) / det
    resids = y - (a * x + b)
    chi2 = float(torch.sum(w * resids**2.0))
    dof = int(y.shape[0] - 2)
    red = chi2 / max(dof, 1)
    va = Sw / det * red
    vb = Sxx / det * red
    vab = -Sx / det * red
    DM = float(a / Dconst)
    DM_err = float(torch.sqrt(torch.clamp(va, min=0.0)) / Dconst)
    offset = float(b)
    offset_err = float(torch.sqrt(torch.clamp(vb, min=0.0)))
    nu_ref = float((-b / a) ** -0.5) if (b / a) < 0 else float("nan")
    if nu_ref == nu_ref:  # not NaN
        nu_ref_err = float(torch.sqrt(torch.clamp(
            (nu_ref**2.0 / 4.0) * ((va / a**2.0) + (vb / b**2.0)
                                   - (2.0 * vab / (a * b))), min=0.0)))
    else:
        nu_ref_err = float("nan")
    return DataBunch(
        DM=DM, DM_err=DM_err, offset=offset, offset_err=offset_err,
        nu_ref=nu_ref, nu_ref_err=nu_ref_err, ab_cov=float(vab),
        residuals=resids.numpy(), chi2=chi2, dof=dof, red_chi2=red)


def fit_powlaw_function(params, freqs, nu_ref, data, errs=None):
    """Weighted residuals of a power-law model, params = (A, alpha): the
    reference's objective callable."""
    A, alpha = params[0], params[1]
    resid = data - powlaw(freqs, nu_ref, A, alpha)
    if errs is not None:
        resid = resid / errs
    return resid
