"""PCA + B-spline profile-evolution models (counterpart of pulseportraiture_tpu/models/spline.py).

What reads and evaluates a spline template runs in torch, in float64 on
the caller's device: the weighted PCA (``torch.linalg.eigh``), the
reconstruction, the B-spline basis (Cox-de Boor, clamped to the knot
range) and the Fourier resample.  The one-off knot selection
(``fit_spline_curve``, scipy's splprep) stays on the host, as in the
JAX package.  The eigenvector selection of template building
(``find_significant_eigvec``) smooths its candidates in one batched
``smart_smooth`` on the device and runs its accept/veto loop on the
host, as there.
"""

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["pca", "reconstruct_portrait", "count_crossings",
           "find_significant_eigvec", "bspline_eval", "gen_spline_portrait", "fit_spline_curve",
           "fft_resample"]


def _f64(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.array(x, np.float64), device=device)


def pca(port, mean_prof=None, weights=None):
    """Weighted principal component analysis of an (nchan, nbin)
    portrait tensor: (eigval, eigvec) sorted by descending eigenvalue,
    eigvec as columns (nbin, nbin).  The weighted mean profile is
    subtracted and the covariance normalised as np.cov(..., aweights=w,
    ddof=1).  Each eigenvector's sign is whatever eigh returns."""
    nchan = port.shape[0]
    if weights is None:
        weights = torch.ones(nchan, dtype=port.dtype, device=port.device)
    weights = weights.to(port.dtype)
    if mean_prof is None:
        mean_prof = (port * weights[:, None]).sum(0) / weights.sum()
    delta = port - mean_prof
    wsum = weights.sum()
    denom = wsum - (weights**2.0).sum() / wsum
    cov = (delta.T * weights) @ delta / denom
    eigval, eigvec = torch.linalg.eigh(cov)
    return torch.flip(eigval, (0,)), torch.flip(eigvec, (1,))


def reconstruct_portrait(port, mean_prof, eigvec):
    """Project (port - mean_prof) onto the eigvec columns and rebuild."""
    delta = port - mean_prof
    return (delta @ eigvec) @ eigvec.T + mean_prof


def count_crossings(x, threshold):
    """Number of sign changes of (x - threshold): crossings in either
    direction."""
    x = np.asarray(x)
    return int(np.sum(np.diff(np.sign(x - threshold)) != 0))


def find_significant_eigvec(eigvec, check_max=10, return_max=10,
                            snr_cutoff=150.0, check_crossings=True,
                            check_acorr=False, return_smooth=True,
                            device=None, **kwargs):
    """Select "significant" eigenvectors by smoothed Fourier S/N with a
    crossing-count veto (reference pplib.py:1625-1689).  eigvec: (nbin,
    ncomp) column eigenvectors (array or tensor).  The first check_max
    candidates are smoothed at once by models.wavelet.smart_smooth
    (kwargs) on ``device`` (default: eigvec's if a tensor, else cuda);
    check_acorr enables the reference's unreachable autocorrelation veto
    (off by default, as in the JAX package).  Returns (ieig,
    smooth_eigvec) when return_smooth, else ieig; smooth_eigvec is host
    numpy."""
    from ..ops.noise import get_noise_PS
    from .wavelet import smart_smooth

    if device is None and isinstance(eigvec, torch.Tensor):
        device = eigvec.device
    dev = resolve_device(device)
    eigvec = (eigvec.detach().cpu().numpy() if isinstance(
        eigvec, torch.Tensor) else np.asarray(eigvec))
    nbin = eigvec.shape[0]
    # the loop never examines candidates past check_max: smooth only those
    ncheck = min(check_max, eigvec.shape[1])
    cands = _f64(np.ascontiguousarray(eigvec.T[:ncheck]), dev)
    smoothed = smart_smooth(cands, device=dev, **kwargs).cpu().numpy()
    noises = (get_noise_PS(cands) * np.sqrt(nbin / 2.0)).cpu().numpy()
    smooth_eigvec = np.zeros_like(eigvec)
    ieig = []
    for ivec in range(ncheck):
        ev = smoothed[ivec]
        ev_noise = float(noises[ivec])
        if ev_noise <= 0.0:
            continue
        ev_snr = float(np.sum(np.abs(np.fft.rfft(ev)[1:]) ** 2.0)) / ev_noise
        add = False
        if ev_snr >= snr_cutoff:
            add = True
            if check_crossings and ev_snr < 3.0 * snr_cutoff:
                ncross = count_crossings(np.abs(ev), 0.1 * np.abs(ev).max())
                add = ncross < int(0.02 * nbin)
            if add and check_acorr and ev_snr < 3.0 * snr_cutoff:
                acorr = np.correlate(ev, ev, "same")
                half = np.where(acorr > acorr.max() / 2.0)[0]
                fwhm = acorr.argmax() - half.min() if len(half) else 0
                add = fwhm > 5
        if add:
            ieig.append(ivec)
            smooth_eigvec[:, ivec] = ev
        if ivec + 1 == check_max or len(ieig) == return_max:
            break
    ieig = np.array(ieig, dtype=int)
    return (ieig, smooth_eigvec) if return_smooth else ieig


def _bspline_basis(x, t, k):
    """Every B-spline basis function B_{i,k}(x) on knot vector t: x (nx,),
    t (nknot,) -> (nx, nknot - k - 1).  Cox-de Boor from degree 0 up with
    0/0 := 0.  x is clamped into the knot range [t_k, t_{n-k-1}] (the
    clamp-to-edge rule, where scipy's splev would extrapolate the end
    polynomials), and the last non-empty interval is closed on the
    right."""
    nknot = t.shape[0]
    lo = t[k]
    hi = t[nknot - k - 1]
    eps = torch.finfo(x.dtype).eps
    xc = torch.minimum(torch.maximum(x, lo), hi * (1.0 - eps) + lo * eps)
    B = ((xc[:, None] >= t[None, :-1])
         & (xc[:, None] < t[None, 1:])).to(x.dtype)
    idx = torch.arange(nknot - 1, device=x.device)
    last = int(torch.argmax(torch.where(t[1:] > t[:-1], idx, -1)))
    B[:, last] = torch.where(
        xc >= t[last], ((xc >= t[last]) & (xc <= t[last + 1])).to(x.dtype),
        (B[:, last] > 0).to(x.dtype))
    for d in range(1, k + 1):
        left = t[d:nknot - 1] - t[0:nknot - 1 - d]
        right = t[d + 1:nknot] - t[1:nknot - d]
        wl = (xc[:, None] - t[None, 0:nknot - 1 - d]) / torch.where(
            left > 0, left, 1.0)
        wl = torch.where(left > 0, wl, 0.0)
        wr = (t[None, d + 1:nknot] - xc[:, None]) / torch.where(
            right > 0, right, 1.0)
        wr = torch.where(right > 0, wr, 0.0)
        B = wl * B[:, :nknot - 1 - d] + wr * B[:, 1:nknot - d]
    return B


def bspline_eval(x, tck, device=None):
    """Evaluate a (vector-valued) B-spline at x: tck = (t, c, k) as from
    scipy's splprep, c (ncomp, ncoef).  Returns (nx, ncomp) float64 on
    ``device`` (default: x's device if x is a tensor, else cuda), the
    counterpart of si.splev(x, tck).T clamped to the knot range."""
    t, c, k = tck
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    dev = resolve_device(device)
    x = torch.atleast_1d(_f64(x, dev))
    c = torch.atleast_2d(_f64(c, dev))
    B = _bspline_basis(x, _f64(t, dev), int(k))
    return B @ c.T[:B.shape[1]]


def fft_resample(port, nbin):
    """Fourier resample along the last axis to nbin bins (scipy.signal
    .resample's convention): the spectrum cut or zero-padded, the
    amplitude scaled by nbin / n_in."""
    n_in = port.shape[-1]
    F = torch.fft.rfft(port, dim=-1)
    nh_out = nbin // 2 + 1
    if nh_out > F.shape[-1]:
        F = torch.nn.functional.pad(F, (0, nh_out - F.shape[-1]))
    else:
        F = F[..., :nh_out]
    return torch.fft.irfft(F, n=nbin, dim=-1) * (nbin / n_in)


def gen_spline_portrait(mean_prof, freqs, eigvec, tck, nbin=None,
                        device=None):
    """The model portrait mean_prof + B-spline(freqs) . eigvec^T, as a
    float64 (nchan, nbin) tensor on ``device`` (default cuda).  mean_prof
    (nbin_model,), eigvec (nbin_model, ncomp), tck from
    fit_spline_curve.  A different nbin is reached by Fourier resampling
    and the half-bin rotation that keeps bin centres aligned."""
    from ..ops.rotation import rotate_portrait

    dev = resolve_device(device)
    mean_prof = _f64(mean_prof, dev)
    freqs = torch.atleast_1d(_f64(freqs, dev))
    eigvec = _f64(eigvec, dev)
    if eigvec.shape[1] == 0:
        port = mean_prof.repeat(freqs.shape[0], 1)
    else:
        port = bspline_eval(freqs, tck, device=dev) @ eigvec.T + mean_prof
    nbin_model = mean_prof.shape[-1]
    if nbin is not None and nbin != nbin_model:
        shift = 0.5 * (nbin**-1.0 - nbin_model**-1.0)
        port = rotate_portrait(fft_resample(port, nbin), shift)
    return port


def fit_spline_curve(proj, freqs, flux_errs=None, snrs=None, sfac=1.0,
                     max_nbreak=None, k=3):
    """Fit a parametric B-spline curve to the projected PCA coordinates
    proj (nchan, ncomp) against strictly increasing freqs (nchan,), on
    the host with scipy's splprep: weights w_i = snr_i / sum(snr) and
    smoothing condition s = sfac nchan sum((snr err)^2) / (sum snr)^2.
    Returns tck = (t, c, k) with c shaped (ncomp, ncoef)."""
    import scipy.interpolate as si

    proj = np.asarray(proj)
    freqs = np.asarray(freqs)
    nchan, ncomp = proj.shape
    if ncomp == 0:
        return (np.array([freqs[0], freqs[-1]]), np.zeros((0, 2)), 1)
    snrs = np.ones(nchan) if snrs is None else np.asarray(snrs, float)
    flux_errs = (np.ones(nchan) if flux_errs is None
                 else np.asarray(flux_errs, float))
    w = snrs / snrs.sum()
    s = sfac * nchan * np.sum((snrs * flux_errs) ** 2.0) / (snrs.sum() ** 2.0)
    kwargs = {}
    if max_nbreak is not None:
        kwargs["nest"] = max_nbreak + 2 * k
    (t, c, kk), _ = si.splprep(proj.T, w=w, u=freqs, s=s, k=k, **kwargs)
    return (np.asarray(t), np.asarray(c), int(kk))
