"""The wideband portrait fit, fast lane (counterpart of pulseportraiture_tpu/fit/portrait.py).

(phi, DM[, GM]) per subint in the Fourier domain with per-channel
amplitudes profiled out analytically:

    t_n(theta)  = phi + (Dconst DM / P)(nu_n^-2 - nu_fit^-2)
                      + (Dconst^2 GM / P)(nu_n^-4 - nu_fit^-4)
    C_n         = Re sum_k d_nk conj(m_nk) e^{2 pi i k t_n} w_nk
    S_n         = sum_k |m_nk|^2 w_nk
    chi2        = sum_nk |d_nk|^2 w_nk - sum_n C_n^2 / S_n

This is the complex-free fast lane only (the JAX package's
fit_portrait_batch_fast -> fast_fit_one): matmul DFTs or the fused
DFT -> cross-spectrum kernel, the CCF phase seed, a damped Newton loop
over the three harmonic moments, and the covariance / zero-covariance
frequency / chi2 packaging.  The scattering lane and the complex engine
are not ported yet (ROADMAP A6) and raise NotImplementedError.

Batching: the subint batch is a leading tensor dimension (the JAX
package vmaps a per-element function).  A shared template stays 2-D.
The Newton loop keeps a per-element ``done`` mask: finished elements
keep their state while the others iterate, exactly like a vmapped
``lax.while_loop``, at the cost of one host sync per trip.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..config import Dconst, F0_fact
from ..device import resolve_auto, resolve_device
from ..ops.fourier import irfft_mm, rfft_mm, use_dft_fold

__all__ = ["FitFlags", "FitResult", "fit_portrait_batch_fast",
           "fast_fit_batched", "prepare_portrait_fit_real",
           "fast_fit_batched_packed", "prepare_portrait_fit_real_packed",
           "make_weights",
           "model_harmonic_window", "resolve_harmonic_window",
           "use_fast_fit_default", "use_bf16_cross_spectrum",
           "resolve_fit_fused", "warn_bf16_high_snr"]

# Per-iteration step bound for (phi, DM, GM, theta3, alpha); only the
# scattering parameters are capped, and they are never free here.
_STEP_CAP = (float("inf"), float("inf"), float("inf"), 1.0, 2.0)


def _tiny(dtype):
    return torch.finfo(dtype).tiny


class FitFlags(NamedTuple):
    """Which of (phi, DM, GM, tau, alpha) are free."""

    phi: bool = True
    DM: bool = True
    GM: bool = False
    tau: bool = False
    alpha: bool = False

    def as_tensor(self, dtype, device):
        return torch.tensor([float(f) for f in self], dtype=dtype,
                            device=device)


class FitResult(NamedTuple):
    """Per-fit outputs, each a tensor with the batch as leading axis.
    tau is in rotations; phi is referenced to nu_DM."""

    phi: torch.Tensor
    phi_err: torch.Tensor
    DM: torch.Tensor
    DM_err: torch.Tensor
    GM: torch.Tensor
    GM_err: torch.Tensor
    tau: torch.Tensor
    tau_err: torch.Tensor
    alpha: torch.Tensor
    alpha_err: torch.Tensor
    nu_DM: torch.Tensor
    nu_GM: torch.Tensor
    nu_tau: torch.Tensor
    scales: torch.Tensor
    scale_errs: torch.Tensor
    channel_snrs: torch.Tensor
    snr: torch.Tensor
    covariance: torch.Tensor
    chi2: torch.Tensor
    dof: torch.Tensor
    nfeval: torch.Tensor
    return_code: torch.Tensor

    @property
    def red_chi2(self):
        return self.chi2 / self.dof


def _t_coeffs(freqs, P, nu_fit):
    """t_n = phi + cvec_n * DM + gvec_n * GM; freqs (nchan,) or
    (B, nchan), P and nu_fit (B,) -> (B, nchan) each."""
    P = P[..., None]
    nu_fit = nu_fit[..., None]
    cvec = (Dconst / P) * (freqs**-2.0 - nu_fit**-2.0)
    gvec = (Dconst**2.0 / P) * (freqs**-4.0 - nu_fit**-4.0)
    return cvec, gvec


# ---------------------------------------------------------------------------
# knobs

def use_bf16_cross_spectrum():
    """Whether the fast fit stores Xr/Xi in bfloat16
    (config.cross_spectrum_dtype)."""
    return str(config.cross_spectrum_dtype) == "bfloat16"


def use_fit_fused(device):
    """config.fit_fused resolved for ``device`` ('auto' = CUDA)."""
    return resolve_auto("fit_fused", config.fit_fused, device)


def resolve_fit_fused(nharm_eff, device):
    """Whether the fit takes the fused lane: config.fit_fused is on for
    ``device`` and a harmonic window is active.  The plain version's
    channel tiling reads config.fused_block itself."""
    return bool(use_fit_fused(device) and nharm_eff is not None)


def use_fast_fit_default(device):
    """config.use_fast_fit resolved for ``device`` ('auto' = CUDA; like
    the JAX package, any value other than True/False means 'auto')."""
    setting = config.use_fast_fit
    if setting is True or setting is False:
        return setting
    return resolve_auto("fast_fit", "auto", device)


# Calibrated channel-S/N envelope of the bf16 cross-spectrum default.
BF16_CALIBRATED_CHANNEL_SNR = 3.0e3
_bf16_snr_warned = [False]


def warn_bf16_high_snr(max_channel_snr, quiet=False):
    """One-line, once-per-process warning when the bf16 cross-spectrum
    storage default is active and a fit's channel S/N exceeds the
    calibrated regime.  Returns True when the warning applies."""
    if (_bf16_snr_warned[0] or not use_bf16_cross_spectrum()
            or not math.isfinite(max_channel_snr)
            or max_channel_snr <= BF16_CALIBRATED_CHANNEL_SNR):
        return False
    if quiet:
        return True
    _bf16_snr_warned[0] = True
    print(f"Warning: channel S/N {max_channel_snr:.0f} exceeds the "
          f"bf16 cross-spectrum calibrated regime "
          f"(~{BF16_CALIBRATED_CHANNEL_SNR:.0f}); consider "
          "config.cross_spectrum_dtype = None for this data")
    return True


# ---------------------------------------------------------------------------
# harmonic window (host numpy, copied from the JAX package)

def model_harmonic_window(model, nbin, tail=None, floor_sigma=None):
    """Static harmonic count K for the band-limited fast fit, derived
    from a HOST model portrait (numpy (nchan, nbin) or (nb, nchan,
    nbin)): the smallest K such that every channel keeps all but `tail`
    of its (noise-floor-subtracted) spectral power below K, plus one
    128-harmonic guard block, rounded up to a multiple of 128.  None
    when no truncation is worthwhile.  See the JAX package's docstring
    for the noise-floor criterion."""
    if tail is None:
        tail = float(config.harmonic_window_tail)
    if floor_sigma is None:
        floor_sigma = config.harmonic_window_floor_sigma
    floor_sigma = 0.0 if floor_sigma is None else float(floor_sigma)
    nharm = nbin // 2 + 1
    m = np.asarray(model).reshape(-1, nbin)
    if m.dtype not in (np.float32, np.float64):
        m = m.astype(np.float32)
    ntail = np.maximum(nharm - np.arange(nharm), 0).astype(np.float64)
    ntail[0] = nharm - 1.0
    K = 0
    any_good = False
    for lo in range(0, m.shape[0], 256):
        spec = np.abs(np.fft.rfft(m[lo:lo + 256], axis=-1)) ** 2.0
        spec = spec.astype(np.float64)
        spec[:, 0] = 0.0
        tot = spec.sum(axis=-1)
        good = tot > 0.0
        if not np.any(good):
            continue
        any_good = True
        spec = spec[good]
        tot = tot[good]
        if floor_sigma > 0.0 and nharm >= 64:
            q = nharm // 4
            mu = np.median(spec[:, -q:], axis=-1) / np.log(2.0)
            q8 = nharm // 8
            med_hi = np.median(spec[:, -q8:], axis=-1)
            med_lo = np.median(spec[:, -2 * q8:-q8], axis=-1)
            flat = (med_lo <= 2.0 * med_hi) & (med_hi <= 2.0 * med_lo)
            mu = np.where(flat & (mu * (nharm - 1) <= 0.1 * tot), mu, 0.0)
        else:
            mu = np.zeros(spec.shape[0])
        rev_cum = spec[:, ::-1].cumsum(axis=-1)[:, ::-1]
        excess = rev_cum - mu[:, None] * ntail
        budget = floor_sigma * np.sqrt(ntail) * mu[:, None]
        tot_sig = np.maximum(tot - mu * (nharm - 1), tot * 1e-30)
        needed = (excess > tail * tot_sig[:, None]) & (excess > budget)
        any_needed = needed.any(axis=-1)
        if any_needed.any():
            last = nharm - 1 - needed[:, ::-1].argmax(axis=-1)
            K = max(K, int((last[any_needed] + 1).max()))
    if not any_good:
        return None
    K = (K + 128 + 127) // 128 * 128  # +1 guard block, tile-rounded
    if K >= nharm:
        return None
    return K


def resolve_harmonic_window(harmonic_window, models, nbin):
    """Parse the harmonic-window knob: explicit int wins (tile-rounded);
    None -> config.fit_harmonic_window; True or 'auto' derives from the
    model ONLY when it is host-resident numpy (never a device pull).
    Unknown strings raise."""
    if harmonic_window is None:
        harmonic_window = config.fit_harmonic_window
    if harmonic_window is None or harmonic_window is False:
        return None
    if harmonic_window is True or harmonic_window == "auto":
        if isinstance(models, np.ndarray):
            return model_harmonic_window(models, nbin)
        return None
    if isinstance(harmonic_window, str):
        raise ValueError(
            f"fit_harmonic_window must be 'auto', True/False/None, or "
            f"a positive int; got {harmonic_window!r}")
    K = int(harmonic_window)
    if K <= 0:
        raise ValueError(
            f"fit_harmonic_window must be positive (got {K}); use "
            f"None or False to disable the window")
    K = (K + 127) // 128 * 128
    return K if K < nbin // 2 + 1 else None


# ---------------------------------------------------------------------------
# prepare stage

def make_weights(noise_stds, nbin, chan_mask=None, dtype=None, nharm=None):
    """w_nk = chan_mask_n / sigma_F,n^2, DC harmonic scaled by F0_fact,
    for k < nharm (default: the full nbin//2+1).  noise_stds are
    time-domain per-channel stds; sigma_F = noise_std * sqrt(nbin/2)."""
    dtype = dtype or noise_stds.dtype
    if nharm is None:
        nharm = nbin // 2 + 1
    errs_F = (noise_stds * math.sqrt(nbin / 2.0)).to(dtype)
    good = errs_F > 0.0
    inv = torch.where(good, 1.0 / torch.where(good, errs_F, 1.0) ** 2.0,
                      0.0)
    kfac = torch.ones(nharm, dtype=dtype, device=inv.device)
    kfac[0] = F0_fact
    w = inv[..., None] * kfac
    if chan_mask is not None:
        w = w * chan_mask.to(dtype)[..., None]
    return w


def _parseval_Sd(port, w_full):
    """Weighted one-sided data power over ALL harmonics from the time
    domain (exact Parseval; DC per F0_fact), per batch element.
    w_full needs columns 0 (DC) and 1 (every k >= 1)."""
    nbin = port.shape[-1]
    x0 = torch.sum(port, dim=-1)
    mu = x0 / nbin
    pwr = nbin * torch.sum((port - mu[..., None]) ** 2, dim=-1)
    if nbin % 2 == 0:
        sgn = torch.tensor((-1.0) ** np.arange(nbin), dtype=w_full.dtype,
                           device=port.device)
        xn = torch.sum(port * sgn, dim=-1)
        pwr = pwr + xn**2
    Sd = torch.sum(w_full[..., 1] * (0.5 * pwr), dim=-1)
    if float(F0_fact) != 0.0:
        Sd = Sd + torch.sum(w_full[..., 0] * x0**2, dim=-1)
    return Sd


def _initial_phase_guess_real(Xr, Xi, cvec, DM0, oversamp=2,
                              derotate=True, nbin=None):
    """Dense-CCF phase seed: derotate by DM0, sum channels, inverse
    matmul DFT onto a 2x oversampled lag grid, first argmax."""
    nharm = Xr.shape[-1]
    if nbin is None:
        nbin = 2 * (nharm - 1)
    dt = cvec.dtype
    if derotate:
        k = torch.arange(nharm, dtype=dt, device=cvec.device)
        ang = 2.0 * math.pi * (cvec * DM0[..., None])[..., None] * k
        c = torch.cos(ang)
        s = torch.sin(ang)
        xr = torch.sum(Xr * c - Xi * s, dim=-2)
        xi = torch.sum(Xr * s + Xi * c, dim=-2)
    else:
        xr = torch.sum(Xr, dim=-2)
        xi = torch.sum(Xi, dim=-2)
    nlag = nbin * oversamp
    ccf = irfft_mm(xr, xi, n=nlag)
    j0 = torch.argmax(ccf, dim=-1)
    phi0 = j0.to(dt) / nlag
    return torch.remainder(phi0 + 0.5, 1.0) - 0.5


def prepare_portrait_fit_real(port, model, w, freqs, P, nu_fit, theta0,
                              seed_phi=True, seed_derotate=True,
                              x_dtype=None, nharm_eff=None, dft_fold=None,
                              fit_fused=None):
    """Everything before the Newton loop, batched, in real arithmetic:
    the windowed DFT -> cross-spectrum (fused kernel or two rfft_mm
    matmuls), model/data powers, and the CCF phase seed.

    port (B, nchan, nbin); model (nchan, nbin) shared or (B, nchan,
    nbin); w (B, nchan, nharm_w) with nharm_w >= nharm_eff (only
    columns < nharm_eff and the two Parseval columns are read when the
    window is active).  Returns (Xr, Xi, S0, Sd, theta0_seeded)."""
    dt = w.dtype
    if fit_fused is None:
        fit_fused = resolve_fit_fused(nharm_eff, port.device)
    cvec, _ = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    if fit_fused and nharm_eff is not None:
        from ..ops.fused import fused_cross_spectrum

        Xr, Xi, S0 = fused_cross_spectrum(
            port, model, w[..., :nharm_eff].contiguous(), nharm_eff,
            fold=dft_fold)
        Sd = _parseval_Sd(port, w)
    else:
        dr, di = rfft_mm(port, nharm=nharm_eff, fold=dft_fold)
        mr, mi = rfft_mm(model, nharm=nharm_eff, fold=dft_fold)
        w_full = w
        if nharm_eff is not None:
            w = w[..., :nharm_eff]
        Xr = (dr * mr + di * mi) * w
        Xi = (di * mr - dr * mi) * w
        S0 = torch.sum((mr**2 + mi**2) * w, dim=-1)
        if nharm_eff is None:
            Sd = torch.sum((dr**2 + di**2) * w, dim=(-2, -1))
        else:
            Sd = _parseval_Sd(port, w_full)
    theta0 = theta0.to(dt)
    if seed_phi:
        phi0 = _initial_phase_guess_real(Xr, Xi, cvec, theta0[:, 1],
                                         derotate=seed_derotate,
                                         nbin=port.shape[-1])
        theta0 = theta0.clone()
        theta0[:, 0] = phi0
    xdt = x_dtype or dt
    return Xr.to(xdt), Xi.to(xdt), S0, Sd, theta0


def prepare_portrait_fit_real_packed(raw, scl, offs, model, w, freqs, P,
                                     nu_fit, theta0, *, raw_code, nbin,
                                     nharm_eff, seed_phi=True,
                                     seed_derotate=True, x_dtype=None,
                                     dft_fold=None):
    """prepare_portrait_fit_real for sub-byte PACKED raw rows: the
    decode (bit-plane unpack, affine decode, min-window baseline) and
    the windowed DFT -> cross-spectrum run in one fused stage
    (ops.fused.fused_decode_cross_spectrum, kernel B2 on a CUDA device),
    so the decoded portrait is never materialized for the fit.

    raw (B, nchan, bpc) uint8; scl/offs (B, nchan); model (nchan, nbin)
    shared; w (B, nchan, nharm_w) with nharm_w >= nharm_eff (columns 0
    and 1 carry the Parseval weights).  The full-spectrum Sd comes from
    the stage's per-channel Parseval rows with _parseval_Sd's outer
    reductions.  Windowed lanes only: nharm_eff must be set."""
    from ..ops.fused import fused_decode_cross_spectrum

    dt = w.dtype
    cvec, _ = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    Xr, Xi, S0, pwr, x0 = fused_decode_cross_spectrum(
        raw, scl, offs, model, w[..., :nharm_eff].contiguous(), nharm_eff,
        code=raw_code, nbin=nbin, fold=dft_fold)
    Sd = torch.sum(w[..., 1] * (0.5 * pwr), dim=-1)
    if float(F0_fact) != 0.0:
        Sd = Sd + torch.sum(w[..., 0] * x0**2, dim=-1)
    theta0 = theta0.to(dt)
    if seed_phi:
        phi0 = _initial_phase_guess_real(Xr, Xi, cvec, theta0[:, 1],
                                         derotate=seed_derotate, nbin=nbin)
        theta0 = theta0.clone()
        theta0[:, 0] = phi0
    xdt = x_dtype or dt
    return Xr.to(xdt), Xi.to(xdt), S0, Sd, theta0


# ---------------------------------------------------------------------------
# Newton loop

def _moments_real(t_n, Xr, Xi):
    """Harmonic moments (C, C1, C2), each (B, nchan), of the split
    cross-spectrum under rotation t_n (B, nchan)."""
    nharm = Xr.shape[-1]
    dt = t_n.dtype
    k2pi = 2.0 * math.pi * torch.arange(nharm, dtype=dt, device=t_n.device)
    ang = t_n[..., None] * k2pi
    c = torch.cos(ang)
    s = torch.sin(ang)
    wr = Xr * c - Xi * s
    wi = Xr * s + Xi * c
    return (torch.sum(wr, dim=-1),
            -torch.sum(wi * k2pi, dim=-1),
            -torch.sum(wr * k2pi**2, dim=-1))


def _cgh_tail(C, C1, C2, S0inv, cvec, gvec):
    """(f (B,), grad (B, 5), hess (B, 5, 5)) from the harmonic moments."""
    f = -torch.sum(C**2.0 * S0inv, dim=-1)
    base1 = 2.0 * C * C1 * S0inv
    base2 = 2.0 * (C1**2.0 + C * C2) * S0inv
    J = torch.stack([torch.ones_like(cvec), cvec, gvec], dim=-2)
    g3 = -torch.matmul(J, base1[..., None])[..., 0]
    H3 = -torch.matmul(J * base2[..., None, :], J.transpose(-1, -2))
    B = C.shape[0]
    g5 = C.new_zeros((B, 5))
    g5[:, :3] = g3
    H5 = C.new_zeros((B, 5, 5))
    H5[:, :3, :3] = H3
    return f, g5, H5


def _newton_loop(cgh, theta0, flags_arr, max_iter, ftol, lam0=1.0e-3,
                 stall_max=4, bounds=None):
    """Levenberg-damped Newton minimization over a batch, given a fused
    (f, grad, hess, aux) evaluator — one cgh() call per trip.

    Semantics are the JAX package's _newton_loop under vmap: damping
    H + lam diag|H|, convergence when 0.5 g^T diag(H)^-1 g < ftol
    (|f| + 1), flat-rejection stall exit after stall_max trips, a
    bootstrap trip that evaluates theta0 inside the loop, projected box
    bounds with TNC-vocabulary return codes, and NaN poisoning when no
    trip was ever accepted.  Return codes: 0 converged, 1 converged in
    the interior with bounds active, 2 stall, 3 max-iterations.

    Batching: an element is active while it < max_iter + 1 and not
    done; every trip evaluates all elements and commits the new state
    only to the active ones, so each element's state, nfev and code are
    what the vmapped while_loop gives.  The loop ends when no element is
    active: one host sync (``active.any()``) per trip.  Singular damped
    Hessians go through solve_ex, which like jnp.linalg.solve returns
    non-finite values instead of raising."""
    B = theta0.shape[0]
    dt = theta0.dtype
    dev = theta0.device
    flags = flags_arr
    nfix = 1.0 - flags
    fmask = torch.outer(flags, flags)
    dfix = torch.diag(nfix)
    eps = torch.finfo(dt).eps
    tiny = _tiny(dt)
    if bounds is not None:
        blo = bounds[..., 0]
        bhi = bounds[..., 1]
        theta0 = torch.where(flags > 0.0,
                             torch.clamp(theta0, blo, bhi), theta0)
    cap = torch.tensor(_STEP_CAP, dtype=dt, device=dev)

    def mask_gH(g, H):
        return g * flags, H * fmask + dfix

    def project_active(theta, g, H):
        if bounds is None:
            return g, H
        out = ((torch.isfinite(blo) & (theta <= blo) & (g > 0.0))
               | (torch.isfinite(bhi) & (theta >= bhi) & (g < 0.0)))
        free = 1.0 - out.to(dt)
        return (g * free, H * (free[:, :, None] * free[:, None, :])
                + torch.diag_embed(1.0 - free))

    def _pred(g, H):
        dH = torch.abs(torch.diagonal(H, dim1=-2, dim2=-1))
        dH = torch.maximum(dH, 1e-12 * torch.amax(dH, dim=-1,
                                                   keepdim=True))
        return (0.5 * torch.sum(g**2.0 / torch.clamp(dH, min=tiny),
                                dim=-1), dH)

    theta = theta0
    f = torch.full((B,), math.inf, dtype=dt, device=dev)
    g = torch.zeros((B, 5), dtype=dt, device=dev)
    H = torch.eye(5, dtype=dt, device=dev).expand(B, 5, 5).clone()
    aux = None
    lam = torch.full((B,), lam0 / 0.33, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    nfev = torch.zeros(B, dtype=torch.int32, device=dev)
    rej = torch.zeros(B, dtype=torch.int32, device=dev)
    code = torch.full((B,), 3, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    while True:
        active = (it < max_iter + 1) & ~done
        if not bool(active.any()):
            break
        gm0, Hm0 = mask_gH(g, H)
        gm0, Hm0 = project_active(theta, gm0, Hm0)
        pred_cur, dH = _pred(gm0, Hm0)
        fin = torch.isfinite(f)
        conv_now = (pred_cur < ftol * (torch.abs(f) + 1.0)) & fin
        A = Hm0 + lam[:, None, None] * torch.diag_embed(dH)
        step = -torch.linalg.solve_ex(A, gm0)[0]
        step = torch.clamp(step, -cap, cap)
        theta_new = theta + step * flags
        if bounds is not None:
            theta_new = torch.where(flags > 0.0,
                                    torch.clamp(theta_new, blo, bhi),
                                    theta_new)
        f_new, g_new, H_new, aux_new = cgh(theta_new)
        if aux is None:  # bootstrap placeholder, never committed
            aux = torch.zeros_like(aux_new)
        accept_f = (f_new < f) & ~conv_now
        gm, Hm = mask_gH(g_new, H_new)
        gm, _ = project_active(theta_new, gm, Hm)
        pred_new, _ = _pred(gm, Hm0)
        f_flat = f_new <= f + 64.0 * eps * (torch.abs(f) + 1.0)
        accept_g = (f_flat & ~accept_f & (pred_new < 0.25 * pred_cur)
                    & fin & ~conv_now)
        accept = accept_f | accept_g
        done_conv = conv_now | (accept & fin & (
            pred_new < ftol * (torch.abs(f_new) + 1.0)))
        flat = ~accept & f_flat
        rej_new = torch.where(flat, rej + 1, torch.zeros_like(rej))
        done_stall = (rej_new >= stall_max) & ~done_conv
        code_new = torch.where(done_conv, torch.zeros_like(code),
                               torch.where(done_stall,
                                           torch.full_like(code, 2), code))
        lam_new = torch.where(accept_f, lam * 0.33,
                              torch.where(accept_g, lam, lam * 8.0)
                              ).clamp(1e-14, 1e14)
        acc = accept & active
        theta = torch.where(acc[:, None], theta_new, theta)
        f = torch.where(acc, f_new, f)
        g = torch.where(acc[:, None], g_new, g)
        H = torch.where(acc[:, None, None], H_new, H)
        aux = torch.where(acc[:, None], aux_new, aux)
        lam = torch.where(active, lam_new, lam)
        it = it + active.to(it.dtype)
        nfev = nfev + active.to(nfev.dtype)
        rej = torch.where(active, rej_new, rej)
        code = torch.where(active, code_new, code)
        done = torch.where(active, done_conv | done_stall, done)

    if bounds is not None:
        at_b = torch.any(
            (flags > 0.0)
            & ((torch.isfinite(blo) & (theta <= blo))
               | (torch.isfinite(bhi) & (theta >= bhi))), dim=-1)
        code = torch.where(code == 0,
                           torch.where(at_b, torch.zeros_like(code),
                                       torch.ones_like(code)), code)
    bad = ~torch.isfinite(f)
    H = torch.where(bad[:, None, None], math.nan, H)
    aux = torch.where(bad[:, None], math.nan, aux)
    return theta, f, H, aux, nfev, code


def _finalize_fit(theta, f, H, C, S, Sd, nharm, flags_arr, fit_flags, P,
                  nu_fit, nu_out, nfev, code):
    """Covariance, zero-covariance frequencies, re-referencing, scales,
    S/N and chi2 packaging (no log10-tau: the fast lane never scatters).
    Every input carries the batch as its leading axis."""
    dt = theta.dtype
    dev = theta.device
    tiny = _tiny(dt)
    B = theta.shape[0]
    fo = torch.outer(flags_arr, flags_arr)
    Hm = H * fo + torch.diag(1.0 - flags_arr)
    cov = 2.0 * torch.linalg.inv_ex(Hm)[0] * fo

    cD_fit = (Dconst / P) * nu_fit**-2.0
    cG_fit = (Dconst**2.0 / P) * nu_fit**-4.0
    J = torch.eye(5, dtype=dt, device=dev).expand(B, 5, 5).clone()
    J[:, 0, 1] = -cD_fit
    J[:, 0, 2] = -cG_fit
    covI = J @ cov @ J.transpose(-1, -2)

    vD, vG, vDG = covI[:, 1, 1], covI[:, 2, 2], covI[:, 1, 2]
    cpD, cpG = covI[:, 0, 1], covI[:, 0, 2]
    if fit_flags[1] and fit_flags[2]:
        det = vD * vG - vDG**2.0
        det_safe = torch.where(torch.abs(det) > tiny, det, 1.0)
        cD0 = (-cpD * vG + cpG * vDG) / det_safe
        cG0 = (-cpG * vD + cpD * vDG) / det_safe
    else:
        cD0 = -cpD / torch.clamp(vD, min=tiny)
        cG0 = -cpG / torch.clamp(vG, min=tiny)
    nu_zero_DM = torch.where(
        cD0 > 0.0,
        (Dconst / (P * torch.where(cD0 > 0, cD0, 1.0))) ** 0.5, nu_fit)
    nu_zero_GM = torch.where(
        cG0 > 0.0,
        (Dconst**2.0 / (P * torch.where(cG0 > 0, cG0, 1.0))) ** 0.25,
        nu_fit)
    if not fit_flags[1]:
        nu_zero_DM = nu_fit
    if not fit_flags[2]:
        nu_zero_GM = nu_fit

    # tau/alpha zero-covariance frequency (only when both are fitted,
    # which the fast lane never does: dlog is then 0)
    vA = covI[:, 4, 4]
    cTA = covI[:, 3, 4]
    tau_fit = theta[:, 3]
    dlog = -cTA / torch.clamp(tau_fit * vA * math.log(10.0), min=tiny)
    if not (fit_flags[3] and fit_flags[4]):
        dlog = torch.zeros_like(dlog)
    dlog = torch.clamp(dlog, -1.0, 1.0)
    nu_zero_tau = nu_fit * 10.0**dlog

    nu_DM_out = torch.where(nu_out > 0.0, nu_out, nu_zero_DM)
    nu_GM_out = torch.where(nu_out > 0.0, nu_out, nu_zero_GM)
    nu_tau_out = torch.where(nu_out > 0.0, nu_out, nu_zero_tau)

    cD_out = (Dconst / P) * nu_DM_out**-2.0
    cG_out = (Dconst**2.0 / P) * nu_GM_out**-4.0
    phi_inf = theta[:, 0] - cD_fit * theta[:, 1] - cG_fit * theta[:, 2]
    phi_out = phi_inf + cD_out * theta[:, 1] + cG_out * theta[:, 2]
    phi_out = torch.remainder(phi_out + 0.5, 1.0) - 0.5
    zero = torch.zeros_like(cD_out)
    u = torch.stack([torch.ones_like(cD_out), cD_out, cG_out, zero, zero],
                    dim=-1)
    phi_var = torch.einsum("bi,bij,bj->b", u, covI, u)
    phi_var = torch.where(torch.isfinite(phi_var), phi_var, math.inf)
    if fit_flags[0]:
        phi_err = torch.sqrt(torch.clamp(phi_var, min=0.0))
    else:
        phi_err = torch.zeros_like(phi_var)

    r_tau = (nu_tau_out / nu_fit) ** theta[:, 4]
    tau_out = tau_fit * r_tau
    ut = torch.stack([zero, zero, zero, r_tau,
                      tau_out * torch.log(nu_tau_out / nu_fit)], dim=-1)
    tau_err = torch.sqrt(torch.clamp(
        torch.einsum("bi,bij,bj->b", ut, covI, ut), min=0.0))

    DM_err = torch.sqrt(torch.clamp(cov[:, 1, 1], min=0.0))
    GM_err = torch.sqrt(torch.clamp(cov[:, 2, 2], min=0.0))
    alpha_err = torch.sqrt(torch.clamp(cov[:, 4, 4], min=0.0))

    S_safe = torch.clamp(S, min=tiny)
    scales = C / S_safe
    scale_errs = S_safe**-0.5
    mask = (S > 0.0).to(dt)
    channel_snrs = C / torch.sqrt(S_safe) * mask
    snr = torch.sqrt(torch.clamp(torch.sum(channel_snrs**2.0, dim=-1),
                                 min=0.0))
    chi2 = Sd + f
    nbin = 2 * (nharm - 1)
    nfit = torch.sum(flags_arr)
    nmask = torch.sum(mask, dim=-1)
    dof = nmask * (nbin - 1.0) - nfit - nmask

    return FitResult(
        phi=phi_out, phi_err=phi_err, DM=theta[:, 1], DM_err=DM_err,
        GM=theta[:, 2], GM_err=GM_err, tau=tau_out, tau_err=tau_err,
        alpha=theta[:, 4], alpha_err=alpha_err, nu_DM=nu_DM_out,
        nu_GM=nu_GM_out, nu_tau=nu_tau_out, scales=scales,
        scale_errs=scale_errs, channel_snrs=channel_snrs, snr=snr,
        covariance=cov, chi2=chi2, dof=dof, nfeval=nfev, return_code=code)


def _fit_portrait_core_real(Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out,
                            theta0, fit_flags=FitFlags(), max_iter=40,
                            ftol=None, nharm_total=None, bounds=None):
    """Stage 2 of the split fit, batched: the (phi, DM, GM) Newton loop
    over the three harmonic moments and the result packaging.
    nharm_total: the full spectrum's harmonic count when Xr/Xi are
    band-limited (dof counts every data harmonic)."""
    if fit_flags[3] or fit_flags[4]:
        raise ValueError("the real core handles the no-scattering path "
                         "only")
    dt = S0.dtype
    nharm = nharm_total if nharm_total is not None else Xr.shape[-1]
    flags_arr = FitFlags(*fit_flags).as_tensor(dt, S0.device)
    if ftol is None:
        ftol = 50.0 * float(torch.finfo(dt).eps)
    good0 = S0 > 0.0
    S0inv = torch.where(good0, 1.0 / torch.where(good0, S0, 1.0), 0.0)
    cvec, gvec = _t_coeffs(freqs, P, nu_fit)
    cvec = cvec.to(dt)
    gvec = gvec.to(dt)

    def cgh(theta):
        t_n = (theta[:, 0:1] + cvec * theta[:, 1:2]
               + gvec * theta[:, 2:3])
        C, C1, C2 = _moments_real(t_n, Xr, Xi)
        f, g, H = _cgh_tail(C, C1, C2, S0inv, cvec, gvec)
        return f, g, H, C

    theta, f, H, C, nfev, code = _newton_loop(
        cgh, theta0.to(dt), flags_arr, max_iter, ftol, bounds=bounds)
    return _finalize_fit(theta, f, H, C, S0, Sd, nharm, flags_arr,
                         fit_flags, P, nu_fit, nu_out, nfev, code)


def fast_fit_batched(ports, model, noise_stds, chan_masks, freqs, P,
                     nu_fit, nu_out, theta0, bounds=None, *, fit_flags,
                     max_iter, seed_derotate=True, x_bf16=None,
                     nharm_eff=None, dft_fold=None, fit_fused=None):
    """The JAX package's fast_fit_one with the batch as a leading
    dimension: weights, DFT -> cross-spectrum + CCF seed, real Newton
    core.  nharm_eff band-limits the DFTs and moment passes; chi2/dof
    stay full-spectrum (Parseval Sd, nharm_total)."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    nbin = ports.shape[-1]
    w = make_weights(noise_stds, nbin, chan_masks, dtype=ports.dtype,
                     nharm=nharm_eff)
    # float64 runs never narrow: bf16 storage is a float32 optimization
    x_dtype = (torch.bfloat16
               if (x_bf16 and ports.dtype == torch.float32) else None)
    Xr, Xi, S0, Sd, th0 = prepare_portrait_fit_real(
        ports, model.to(ports.dtype), w, freqs, P, nu_fit, theta0,
        seed_phi=bool(fit_flags[0]), seed_derotate=seed_derotate,
        x_dtype=x_dtype, nharm_eff=nharm_eff, dft_fold=dft_fold,
        fit_fused=fit_fused)
    return _fit_portrait_core_real(
        Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out, th0,
        fit_flags=fit_flags, max_iter=max_iter,
        nharm_total=nbin // 2 + 1 if nharm_eff is not None else None,
        bounds=bounds)


def fast_fit_batched_packed(raw, scl, offs, model, noise_stds, chan_masks,
                            freqs, P, nu_fit, nu_out, theta0, *, raw_code,
                            nbin, fit_flags, max_iter, nharm_eff,
                            seed_derotate=True, x_bf16=None, dft_fold=None):
    """fast_fit_batched for sub-byte packed raw rows (the JAX package's
    fast_fit_one_packed with the batch as a leading dimension): weights
    from the noise levels, the decode-fused prepare
    (prepare_portrait_fit_real_packed), then the same real Newton core.
    noise_stds' dtype is the working dtype; model and freqs are shared
    across the batch, everything else is per element."""
    if x_bf16 is None:
        x_bf16 = use_bf16_cross_spectrum()
    dt = noise_stds.dtype
    w = make_weights(noise_stds, nbin, chan_masks, dtype=dt,
                     nharm=nharm_eff)
    x_dtype = torch.bfloat16 if (x_bf16 and dt == torch.float32) else None
    Xr, Xi, S0, Sd, th0 = prepare_portrait_fit_real_packed(
        raw, scl, offs, model.to(dt), w, freqs, P, nu_fit, theta0,
        raw_code=raw_code, nbin=nbin, nharm_eff=nharm_eff,
        seed_phi=bool(fit_flags[0]), seed_derotate=seed_derotate,
        x_dtype=x_dtype, dft_fold=dft_fold)
    return _fit_portrait_core_real(
        Xr, Xi, S0, Sd, freqs, P, nu_fit, nu_out, th0,
        fit_flags=fit_flags, max_iter=max_iter, nharm_total=nbin // 2 + 1)


def _as_tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def fit_portrait_batch_fast(ports, models, noise_stds, freqs, P, nu_fit,
                            nu_out=None, theta0=None, fit_flags=FitFlags(),
                            chan_masks=None, max_iter=40, log10_tau=False,
                            ir_FT=None, use_scatter=None, compensated=None,
                            harmonic_window=None, bounds=None,
                            device=None):
    """Batched (phi, DM[, GM]) fit through the complex-free fast lane.

    ports (nb, nchan, nbin) numpy or tensor (its dtype is the working
    dtype); models (nb, nchan, nbin) or a shared (nchan, nbin) template
    (kept 2-D); noise_stds/chan_masks (nb, nchan); freqs (nchan,) or
    (nb, nchan); P and nu_fit scalars or (nb,).  harmonic_window: None
    -> config.fit_harmonic_window; 'auto' derives K from the model only
    when it is host numpy.  bounds: (5, 2) or (nb, 5, 2) [lo, hi] box.
    Runs on ``device`` (default cuda).  Scattering (tau/alpha fitted,
    log10_tau, a nonzero tau seed, an instrumental response) is the
    unported ROADMAP A6 lane and raises NotImplementedError."""
    dev = resolve_device(device)
    scatter = (bool(use_scatter) or bool(fit_flags[3]) or bool(fit_flags[4])
               or log10_tau or ir_FT is not None
               or (theta0 is not None
                   and bool(np.any(np.asarray(_host(theta0))[..., 3]
                                   != 0.0))))
    if scatter:
        raise NotImplementedError(
            "fit_portrait_batch_fast: the scattering lane (tau/alpha, "
            "log10_tau, fixed tau seeds, instrumental response) is not "
            "ported yet (ROADMAP A6)")
    ports_t = ports if isinstance(ports, torch.Tensor) else \
        torch.as_tensor(np.asarray(ports))
    dt = ports_t.dtype
    ports_t = ports_t.to(dev)
    nb, nchan, nbin = ports_t.shape
    nharm_eff = resolve_harmonic_window(harmonic_window, models, nbin)
    models_t = _as_tensor(models, dt, dev).contiguous()
    freqs_t = _as_tensor(freqs, dt, dev)
    P_t = _as_tensor(P, dt, dev).expand(nb).contiguous()
    nu_fit_t = _as_tensor(nu_fit, dt, dev).expand(nb).contiguous()
    if theta0 is None:
        theta0_t = torch.zeros((nb, 5), dtype=dt, device=dev)
        seed_derotate = False
    else:
        theta0_t = _as_tensor(theta0, dt, dev)
        # an all-zero DM guess makes the seed's derotation the identity
        seed_derotate = bool(np.any(np.asarray(_host(theta0))[..., 1]
                                    != 0.0))
    nu_out_t = torch.full((nb,), -1.0 if nu_out is None else float(nu_out),
                          dtype=dt, device=dev)
    masks_t = (torch.ones((nb, nchan), dtype=dt, device=dev)
               if chan_masks is None else _as_tensor(chan_masks, dt, dev))
    if bounds is not None:
        bounds = _as_tensor(bounds, dt, dev)
        if bounds.shape[-2:] != (5, 2) or bounds.dim() not in (2, 3):
            raise ValueError(f"bounds must be (5, 2) or (nb, 5, 2); got "
                             f"{tuple(bounds.shape)}")
    return fast_fit_batched(
        ports_t.contiguous(), models_t, _as_tensor(noise_stds, dt, dev),
        masks_t, freqs_t, P_t, nu_fit_t, nu_out_t, theta0_t, bounds,
        fit_flags=FitFlags(*[bool(f) for f in fit_flags]),
        max_iter=int(max_iter), seed_derotate=seed_derotate,
        x_bf16=use_bf16_cross_spectrum(), nharm_eff=nharm_eff,
        dft_fold=use_dft_fold(dev),
        fit_fused=resolve_fit_fused(nharm_eff, dev))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
