"""Gaussian template fitting: profile and evolving-portrait fits
(counterpart of pulseportraiture_tpu/fit/gauss.py).

The template builders' fits, driven by the LM engine of fit/lm.py.
Models are the analytic-FT Gaussians of models/gaussian.py, and every
residual function has a closed-form Jacobian companion (config.
lm_jacobian 'ad' swaps in torch.func.jacfwd, the oracle lane).  All of
it runs in float64 on the caller's ``device``: the JAX package runs
this path on the host CPU (utils/device.on_host) only because some TPU
runtimes cannot compile complex FFTs, which the card can; and the LM's
ftol = 1e-10 on the relative chi^2 improvement cannot be resolved in
float32.  The trial seeding and selection are host numpy, as there.

Flat parameter layouts (the .gmodel's, so a fit round-trips):

profile:  [dc, tau_bins, (loc, wid, amp) * ngauss]
portrait: [dc, tau_bins, (loc, mloc, wid, mwid, amp, mamp) * ngauss]
          (+ per-join (phase, DM) pairs, + the scattering index)

Every residual function is batched: parameters (B, n) and aux tensors
with a leading B axis.  The JAX package caches its residual closures by
layout so that jit and vmap caches key on function identity; eager
torch compiles nothing, so plain closures stand in for them.
"""

import math

import numpy as np
import torch

from ..config import Dconst, wid_max
from ..device import resolve_auto, resolve_device
from ..models.gaussian import (apply_scattering_FT, gaussian_components_FT,
                               gaussian_components_FT_jac, harmonic0)
from ..ops.gaussian import gaussian_profile_FT, gaussian_profile_FT_jac
from ..ops.phasor import cexp
from ..ops.scattering import (scattering_portrait_FT,
                              scattering_portrait_FT_dtau,
                              scattering_profile_FT,
                              scattering_profile_FT_dtau)
from ..utils.bunch import DataBunch
from .lm import (COMPACT_EVERY_CONFIG, LMResult, levenberg_marquardt,
                 levenberg_marquardt_batched, resolve_compact_every)

__all__ = ["fit_gaussian_profile", "fit_gaussian_portrait",
           "gen_gaussian_profile_flat", "gen_gaussian_portrait_flat",
           "use_gauss_device", "profile_trial_seeds", "select_best_trial",
           "fit_profile_trials",
           "pad_profile_params", "profile_bounds", "profile_vary",
           "fit_gaussian_profiles_batched", "pad_portrait_params",
           "portrait_bounds", "portrait_vary",
           "fit_gaussian_portraits_batched"]


def use_gauss_device(setting=None, device=None):
    """Whether template building runs its Gaussian LM fits through the
    BATCHED engine: config.gauss_device (True/False force; 'auto' = on
    for a CUDA ``device``), strict like the other tri-states.
    setting: an explicit override (the CLIs' --gauss-device)."""
    if setting is None:
        from .. import config

        setting = getattr(config, "gauss_device", "auto")
    return resolve_auto("gauss_device", setting,
                        resolve_device(device), label="gauss_device")


def _t(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.array(x, float), dtype=torch.float64,
                           device=device)


# --------------------------------------------------------------------------
# Profile fit
# --------------------------------------------------------------------------


def _profile_FT_flat(theta, nbin):
    """rFFT (..., nharm) of DC + ngauss Gaussians + scattering, theta
    (..., n) in the profile layout (tau in bins)."""
    nharm = nbin // 2 + 1
    dc, tau = theta[..., 0], theta[..., 1]
    gFT = gaussian_profile_FT(nharm, theta[..., 2::3, None],
                              theta[..., 3::3, None],
                              theta[..., 4::3, None])
    pFT = torch.sum(gFT, dim=-2)
    pFT = pFT + (dc * nbin)[..., None] * harmonic0(pFT)
    return pFT * scattering_profile_FT((tau / nbin)[..., None], nharm)


def gen_gaussian_profile_flat(theta, nbin, device=None):
    """Phase-domain profile(s) (..., nbin) from the flat layout (tau in
    bins), float64 on ``device`` (default: theta's if a tensor, else
    cuda)."""
    if device is None and isinstance(theta, torch.Tensor):
        device = theta.device
    theta = _t(theta, resolve_device(device))
    return torch.fft.irfft(_profile_FT_flat(theta, nbin), n=nbin, dim=-1)


def _profile_resid(theta, data, errs):
    nbin = data.shape[-1]
    return (data - torch.fft.irfft(_profile_FT_flat(theta, nbin), n=nbin,
                                   dim=-1)) / errs


def _profile_FT_flat_jac(theta, nbin):
    """Closed-form d(_profile_FT_flat)/dtheta -> (..., n, nharm) complex:
    component blocks from ops.gaussian.gaussian_profile_FT_jac, the
    scattering chain from scattering_profile_FT_dtau (tau in bins, hence
    the /nbin)."""
    nharm = nbin // 2 + 1
    dc, tau = theta[..., 0], theta[..., 1]
    G, dloc, dwid, damp = gaussian_profile_FT_jac(
        nharm, theta[..., 2::3, None], theta[..., 3::3, None],
        theta[..., 4::3, None])
    A = torch.sum(G, dim=-2)
    e0 = harmonic0(A)
    A = A + (dc * nbin)[..., None] * e0
    t = (tau / nbin)[..., None]
    Bk = scattering_profile_FT(t, nharm)
    dB_dbins = scattering_profile_FT_dtau(t, nharm) / nbin
    comp = torch.stack([dloc, dwid, damp], dim=-2) * Bk[..., None, None, :]
    comp = comp.reshape(comp.shape[:-3] + (-1, nharm))
    col0 = (nbin * Bk[..., :1]) * e0     # B(0) = 1 exactly
    return torch.cat([col0[..., None, :], (A * dB_dbins)[..., None, :],
                      comp], dim=-2)


def _profile_resid_jac(theta, data, errs):
    """Analytic companion of _profile_resid: (B, nbin, n).  The irfft is
    linear, so each column is -irfft(dpFT_j)/errs."""
    nbin = data.shape[-1]
    dmodel = torch.fft.irfft(_profile_FT_flat_jac(theta, nbin), n=nbin,
                             dim=-1)          # (B, n, nbin)
    return -(dmodel / errs[..., None, :]).transpose(-1, -2)


def fit_gaussian_profile(data, init_params, errs, fit_flags=None,
                         fit_scattering=False, quiet=True, device=None):
    """Fit DC + ngauss Gaussians (+ scattering tau) to a profile on
    ``device`` (default cuda), float64.

    init_params: [dc, tau_bins, (loc, wid, amp)*ngauss].  Bounds: tau >=
    0, half a bin <= wid <= wid_max, amp >= 0.  fit_flags covers the
    non-scattering params (dc + 3*ngauss); fit_scattering toggles tau.
    Returns DataBunch(fitted_params, fit_errs, residuals, chi2, dof,
    red_chi2) of host numpy values."""
    dev = resolve_device(device)
    data = _t(data, dev)
    errs_arr = torch.broadcast_to(_t(errs, dev), data.shape)
    x0 = np.asarray(init_params, float)
    n = len(x0)
    ngauss = (n - 2) // 3
    vary = np.ones(n, bool)
    if fit_flags is not None:
        ff = [bool(f) for f in fit_flags]
        vary[0] = ff[0]
        vary[2:] = ff[1:]
    vary[1] = bool(fit_scattering)
    nbin = data.shape[-1]
    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    lower[1] = 0.0
    # an exactly-zero width is a stationary trap (every derivative
    # vanishes); a half-bin floor is below anything resolvable
    lower[3::3] = 0.5 / nbin
    upper[3::3] = wid_max
    lower[4::3] = 0.0
    res = levenberg_marquardt(_profile_resid, x0, aux=(data, errs_arr),
                              lower=lower, upper=upper, vary=vary,
                              jacobian=_profile_resid_jac, device=dev)
    residuals = (_profile_resid(res.x[None], data[None], errs_arr[None])[0]
                 * errs_arr)
    dof = int(res.dof)
    out = DataBunch(
        fitted_params=res.x.cpu().numpy(),
        fit_errs=res.x_err.cpu().numpy(),
        residuals=residuals.cpu().numpy(),
        chi2=float(res.chi2), dof=dof,
        red_chi2=float(res.chi2) / max(dof, 1))
    if not quiet:
        print(f"Gaussians: {ngauss}  DoF: {dof}  "
              f"reduced chi-sq: {out.red_chi2:.2f}")
    return out


# --------------------------------------------------------------------------
# Portrait fit
# --------------------------------------------------------------------------


def _portrait_params(theta):
    return {"dc": theta[..., 0],
            "locs": theta[..., 2::6], "mlocs": theta[..., 3::6],
            "wids": theta[..., 4::6], "mwids": theta[..., 5::6],
            "amps": theta[..., 6::6], "mamps": theta[..., 7::6]}


def _join_rotation(join_theta, ij, freqs, nu_ref, P, k):
    """conj(exp(2 pi i delay_n k)) of join ij: (B, nchan, nharm)."""
    phi, DM = join_theta[..., ij, 0], join_theta[..., ij, 1]
    delays = phi[..., None] + (Dconst * DM / P)[..., None] * (
        freqs**-2.0 - nu_ref[..., None]**-2.0)
    return torch.conj(cexp(2.0 * math.pi * delays[..., None] * k))


def _portrait_FT_flat(theta, join_theta, alpha_s, freqs, nu_ref, P,
                      join_mask, code, nbin, njoin):
    """(B, nchan, nharm) model rFFT from the flat portrait layout:
    theta (B, nmain), join_theta (B, njoin, 2) of (phase, DM) applied to
    the channels of join_mask (B, njoin, nchan), alpha_s (B,), freqs
    (B, nchan), nu_ref and P (B,)."""
    nharm = nbin // 2 + 1
    pFT = gaussian_components_FT(_portrait_params(theta), freqs,
                                 nu_ref[..., None, None], nharm, code)
    # tau in this layout is in bins (the fitter's unit): /nbin -> rot
    pFT = apply_scattering_FT(pFT, (theta[..., 1] / nbin)[..., None],
                              alpha_s[..., None], freqs, nu_ref[..., None])
    if njoin:
        k = torch.arange(nharm, dtype=freqs.dtype, device=freqs.device)
        for ij in range(njoin):
            rot = _join_rotation(join_theta, ij, freqs, nu_ref, P, k)
            pFT = torch.where(join_mask[..., ij, :, None], pFT * rot, pFT)
    return pFT


def gen_gaussian_portrait_flat(theta, freqs, nu_ref, nbin, alpha_s,
                               code="000", join_theta=None, join_mask=None,
                               P=None, device=None):
    """Phase-domain (nchan, nbin) portrait from the flat layout, JOIN
    rotations included, float64 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    theta = _t(theta, dev)
    freqs = _t(freqs, dev)
    njoin = 0 if join_theta is None else int(np.shape(join_theta)[0])
    if join_theta is None:
        join_theta = np.zeros((0, 2))
        join_mask = np.zeros((0, freqs.shape[0]), bool)
    pFT = _portrait_FT_flat(
        theta[None], _t(join_theta, dev)[None], _t(alpha_s, dev)[None],
        freqs[None], _t(nu_ref, dev)[None],
        _t(1.0 if P is None else P, dev)[None],
        torch.as_tensor(np.asarray(join_mask, bool), device=dev)[None],
        code, nbin, njoin)[0]
    return torch.fft.irfft(pFT, n=nbin, dim=-1)


def _make_portrait_resid(code, nbin, njoin, nmain):
    """Residual (B, nchan*nbin) over x = [theta, join.flat, alpha_s]."""

    def resid(x, data, errs, freqs, nu_ref, P, join_mask):
        join_theta = x[..., nmain:nmain + 2 * njoin].reshape(
            x.shape[:-1] + (njoin, 2))
        pFT = _portrait_FT_flat(x[..., :nmain], join_theta, x[..., -1],
                                freqs, nu_ref, P, join_mask, code, nbin,
                                njoin)
        model = torch.fft.irfft(pFT, n=nbin, dim=-1)
        return ((data - model) / errs[..., None]).reshape(
            x.shape[:-1] + (-1,))

    return resid


def _make_portrait_resid_jac(code, nbin, njoin, nmain):
    """Analytic companion of _make_portrait_resid, (B, nres, nx): the
    component blocks from models.gaussian.gaussian_components_FT_jac,
    the per-channel scattering chain tau_n = (tau_bins/nbin)
    (nu/nu_ref)^alpha through scattering_portrait_FT_dtau, and the JOIN
    rotations exactly: every base column is rotated on the masked
    channels, and the (phase, DM) columns come from the rotated model
    itself (d rot/dphi = -2 pi i k rot)."""

    def resid_jac(x, data, errs, freqs, nu_ref, P, join_mask):
        nharm = nbin // 2 + 1
        theta = x[..., :nmain]
        join_theta = x[..., nmain:nmain + 2 * njoin].reshape(
            x.shape[:-1] + (njoin, 2))
        alpha_s = x[..., -1]
        pFT_u, d = gaussian_components_FT_jac(
            _portrait_params(theta), freqs, nu_ref[..., None, None], nharm,
            code)
        r = freqs / nu_ref[..., None]
        ra = r ** alpha_s[..., None]
        taus = (theta[..., 1] / nbin)[..., None] * ra
        Bs = scattering_portrait_FT(taus, nharm)
        dB = scattering_portrait_FT_dtau(taus, nharm)
        # (B, nchan, ngauss, 6, nharm) -> (B, 6*ngauss, nchan, nharm) in
        # the layout's per-component (loc, mloc, wid, mwid, amp, mamp)
        comp = torch.stack([d["locs"], d["mlocs"], d["wids"], d["mwids"],
                            d["amps"], d["mamps"]], dim=-2)
        nb, nchan, ngauss = comp.shape[:3]
        comp = comp.permute(0, 2, 3, 1, 4).reshape(nb, 6 * ngauss, nchan,
                                                   nharm)
        # base columns in [theta..., alpha] order: alpha rides at the
        # end so one masked-rotate pass covers every pre-join column
        base = torch.cat([
            (d["dc"] * Bs)[:, None],
            (pFT_u * dB * (ra / nbin)[..., None])[:, None],
            comp * Bs[:, None],
            (pFT_u * dB * (taus * torch.log(r))[..., None])[:, None],
        ], dim=1)                               # (B, nmain + 1, nchan, nharm)
        full = pFT_u * Bs
        k = torch.arange(nharm, dtype=freqs.dtype, device=freqs.device)
        for ij in range(njoin):
            rot = _join_rotation(join_theta, ij, freqs, nu_ref, P, k)
            m = join_mask[:, ij]
            base = torch.where(m[:, None, :, None], base * rot[:, None],
                               base)
            full = torch.where(m[..., None], full * rot, full)
        mk = torch.complex(torch.zeros_like(k), -2.0 * math.pi * k)
        jcols = []
        for ij in range(njoin):
            m = join_mask[:, ij]
            dphi = torch.where(m[..., None], full * mk,
                               torch.zeros_like(full))
            ddm = dphi * ((Dconst / P)[..., None] * (
                freqs**-2.0 - nu_ref[..., None]**-2.0))[..., None]
            jcols += [dphi[:, None], ddm[:, None]]
        dpFT = torch.cat([base[:, :nmain]] + jcols + [base[:, nmain:]],
                         dim=1)
        dmodel = torch.fft.irfft(dpFT, n=nbin, dim=-1)
        nx = dmodel.shape[1]
        return -(dmodel / errs[:, None, :, None]).reshape(
            nb, nx, -1).transpose(1, 2)

    return resid_jac


def _portrait_fns(code, nbin, njoin, nmain):
    """(resid, resid_jac) closures of a portrait layout."""
    return (_make_portrait_resid(code, nbin, njoin, nmain),
            _make_portrait_resid_jac(code, nbin, njoin, nmain))


def fit_gaussian_portrait(data, init_params, scattering_index, errs,
                          fit_flags, fit_scattering_index, freqs, nu_ref,
                          model_code="000", join_params=None, P=None,
                          quiet=True, device=None):
    """Fit evolving Gaussian components to an (nchan, nbin) portrait on
    ``device`` (default cuda), float64.

    init_params: [dc, tau_bins, (loc, mloc, wid, mwid, amp, mamp)*g];
    fit_flags: the same length; join_params = (join_ichans, values,
    flags) with values/flags = [phase1, DM1, phase2, DM2, ...].  Bounds:
    tau >= 0, half a bin <= wid <= wid_max, amp >= 0.  Returns
    DataBunch(fitted_params, fit_errs, join_fit, join_fit_errs,
    scattering_index, scattering_index_err, residuals, chi2, dof,
    red_chi2, nfev) of host values."""
    dev = resolve_device(device)
    data = _t(data, dev)
    nchan, nbin = data.shape
    errs = torch.broadcast_to(_t(errs, dev), (nchan,))
    freqs = _t(freqs, dev)
    x0_main = np.asarray(init_params, float)
    nmain = len(x0_main)
    vary_main = np.asarray(fit_flags, bool)

    if join_params:
        join_ichans, join_vals, join_flags = join_params
        njoin = len(join_ichans)
        join_mask = np.zeros((njoin, nchan), bool)
        for ij, ichans in enumerate(join_ichans):
            join_mask[ij, np.asarray(ichans)] = True
        x0_join = np.asarray(join_vals, float)
        vary_join = np.asarray(join_flags, bool)
    else:
        njoin = 0
        join_mask = np.zeros((0, nchan), bool)
        x0_join = np.zeros(0)
        vary_join = np.zeros(0, bool)

    x0 = np.concatenate([x0_main, x0_join, [float(scattering_index)]])
    vary = np.concatenate([vary_main, vary_join,
                           [bool(fit_scattering_index)]])
    n = len(x0)
    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    lower[1] = 0.0
    lower[4:nmain:6] = 0.5 / nbin  # wids: half-bin floor (profile fit)
    upper[4:nmain:6] = wid_max
    lower[6:nmain:6] = 0.0         # amps

    resid, resid_jac = _portrait_fns(model_code, nbin, njoin, nmain)
    aux = (data, errs, freqs, _t(nu_ref, dev),
           _t(1.0 if P is None else P, dev),
           torch.as_tensor(join_mask, device=dev))
    # the portrait fit allows 200 iterations, the JAX package's bound
    res = levenberg_marquardt(resid, x0, aux=aux, lower=lower, upper=upper,
                              vary=vary, max_iter=200, jacobian=resid_jac,
                              device=dev)
    x = res.x.cpu().numpy()
    x_err = res.x_err.cpu().numpy()
    residuals = (resid(res.x[None], *[a[None] for a in aux])[0]
                 .reshape(nchan, nbin) * errs[:, None]).cpu().numpy()
    dof = int(res.dof)
    out = DataBunch(
        fitted_params=x[:nmain],
        fit_errs=x_err[:nmain],
        join_fit=x[nmain:nmain + 2 * njoin],
        join_fit_errs=x_err[nmain:nmain + 2 * njoin],
        scattering_index=float(x[-1]),
        scattering_index_err=float(x_err[-1]),
        residuals=residuals,
        chi2=float(res.chi2),
        dof=dof,
        red_chi2=float(res.chi2) / max(dof, 1),
        nfev=int(res.nfev))
    if not quiet:
        print(f"Gaussian portrait fit: ngauss={(nmain - 2) // 6} "
              f"DoF={dof} reduced chi-sq: {out.red_chi2:.2f}")
    return out


def _serial_lm(resid_fn, aux_of, x0s, lower, upper, varys, max_iter,
               nres_valid=None, jacobian=None, device=None):
    """The serial oracle lane of both batched front-ends: the SAME
    padded problems through the single-problem engine one at a time,
    stacked into an LMResult with a leading B axis.  The Jacobian source
    follows config.lm_jacobian as in the batched lane, so serial-vs-
    batched A/Bs compare engines, not derivative sources."""
    outs = [levenberg_marquardt(
        resid_fn, x0s[b], aux=aux_of(b), lower=lower, upper=upper,
        vary=varys[b], max_iter=max_iter,
        nres_valid=(None if nres_valid is None else int(nres_valid[b])),
        jacobian=jacobian, device=device)
        for b in range(len(x0s))]
    return LMResult(*[torch.stack([getattr(o, f) for o in outs])
                      for f in LMResult._fields])


# --------------------------------------------------------------------------
# Breadth-first trial seeding + batched dispatch
#
# The breadth-first auto_fit_profile fits many flat-layout problems at
# once: the helpers here build the trial problems (matching-pursuit
# seeds, padded layouts, shared bounds and vary masks) and run them
# either batched (the device lane) or serially through the single-
# problem engine on the SAME padded problems (the oracle).
# --------------------------------------------------------------------------


def profile_trial_seeds(profile, max_ngauss, wid0=0.02, tau=0.0,
                        noise=None):
    """Matching-pursuit seeds: greedily place a component of width wid0
    at the running residual peak and subtract its analytic profile.
    Returns [trial_1, ..., trial_max_ngauss], trial_g the flat profile
    layout [0, tau, (loc, wid, amp) * g] (host numpy)."""
    profile = np.asarray(profile, float)
    nbin = len(profile)
    if noise is None:
        noise = float(profile.std())
    grid = np.arange(nbin) / nbin
    resid = profile.copy()
    comps = []
    seeds = []
    for _ in range(int(max_ngauss)):
        ipeak = int(np.argmax(resid))
        loc = (ipeak + 0.5) / nbin
        amp = max(float(resid[ipeak]), float(noise))
        comps.append((loc, wid0, amp))
        d = np.mod(grid - loc + 0.5, 1.0) - 0.5
        resid = resid - amp * np.exp(-4.0 * np.log(2.0)
                                     * (d / wid0) ** 2.0)
        seeds.append(np.concatenate([[0.0, tau], np.ravel(comps)]))
    return seeds


def select_best_trial(red_chi2s, rchi2_tol=0.1, success=None,
                      stalled=None):
    """Host-side selection over ascending-ngauss trial results, the
    serial add-refit loop's rule: a trial must improve the best reduced
    chi2 to be kept; the scan stops once within rchi2_tol of 1 or when
    adding a component stopped helping.  A converged trial must improve
    by 1 %; one that burned max_iter or stopped on the STALL exit (its
    chi2 not reproducible to the last digits across program variants)
    by 5 %, so a lane-dependent wobble cannot flip the selected count.
    Returns the selected index, or None when every trial failed."""
    reds = np.asarray(red_chi2s, float)
    n = len(reds)
    conv = np.ones(n, bool)
    if success is not None:
        conv &= np.asarray(success, bool)
    if stalled is not None:
        conv &= ~np.asarray(stalled, bool)
    best = None
    for i, red in enumerate(reds):
        if not np.isfinite(red):
            continue
        margin = 0.99 if conv[i] else 0.95
        if best is None or red < reds[best] * margin:
            best = i
            if red < 1.0 + rchi2_tol:
                break
        else:  # adding components stopped helping
            break
    return best


def fit_profile_trials(profile, max_ngauss, noise, wid0=0.02, tau=0.0,
                       fit_scattering=False, rchi2_tol=0.1,
                       max_iter=100, serial=True, device=None):
    """The breadth-first trial pipeline of GaussPortrait.auto_fit_profile:
    matching-pursuit seeds for every ngauss in 1..max_ngauss, padded to
    max_ngauss, fit at once (serial=False) or one at a time through the
    single-problem oracle (serial=True) on ``device``, selected on the
    host.  Returns DataBunch(index, ngauss, params, param_errs,
    red_chi2s, success, stalled) with params/param_errs trimmed to the
    selected count, or None when every trial failed."""
    profile = np.asarray(profile, float)
    max_ngauss = int(max_ngauss)
    if max_ngauss < 1:
        raise ValueError(
            f"fit_profile_trials needs max_ngauss >= 1 (got "
            f"{max_ngauss}): no trial component counts to fit")
    seeds = profile_trial_seeds(profile, max_ngauss, wid0=wid0,
                                tau=tau, noise=noise)
    x0s, varys = [], []
    for s in seeds:
        padded, g = pad_profile_params(s, max_ngauss)
        x0s.append(padded)
        varys.append(profile_vary(g, max_ngauss,
                                  fit_scattering=fit_scattering))
    res = fit_gaussian_profiles_batched(
        np.broadcast_to(profile, (max_ngauss, len(profile))),
        np.stack(x0s), np.full(max_ngauss, float(noise)),
        np.stack(varys), max_iter=max_iter, serial=serial, device=device)
    red = (res.chi2.cpu().numpy()
           / np.maximum(res.dof.cpu().numpy(), 1.0))
    success = res.success.cpu().numpy()
    stalled = res.stalled.cpu().numpy()
    ibest = select_best_trial(red, rchi2_tol=rchi2_tol, success=success,
                              stalled=stalled)
    if ibest is None:
        return None
    nsel = 2 + 3 * (ibest + 1)
    return DataBunch(
        index=ibest, ngauss=ibest + 1,
        params=res.x[ibest][:nsel].cpu().numpy().copy(),
        param_errs=res.x_err[ibest][:nsel].cpu().numpy().copy(),
        red_chi2s=red, success=success, stalled=stalled)


def pad_profile_params(params, ngauss_pad):
    """Pad a flat profile layout to ngauss_pad components: pad
    components get amp=0 (they add exactly nothing) and are frozen by
    profile_vary, so the padded fit equals the unpadded one.  Returns
    (padded_params, ngauss)."""
    params = np.asarray(params, float)
    ngauss = (len(params) - 2) // 3
    if ngauss > ngauss_pad:
        raise ValueError(f"cannot pad {ngauss} components into "
                         f"{ngauss_pad}")
    out = np.zeros(2 + 3 * ngauss_pad)
    out[:len(params)] = params
    for ig in range(ngauss, ngauss_pad):
        out[2 + 3 * ig: 5 + 3 * ig] = [0.5, 0.02, 0.0]
    return out, ngauss


def profile_bounds(ngauss_pad, nbin):
    """(lower, upper) of the padded profile layout: fit_gaussian_profile's
    bounds."""
    n = 2 + 3 * ngauss_pad
    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    lower[1] = 0.0
    lower[3::3] = 0.5 / nbin
    upper[3::3] = wid_max
    lower[4::3] = 0.0
    return lower, upper


def profile_vary(ngauss, ngauss_pad, fit_flags=None,
                 fit_scattering=False):
    """vary mask of a padded profile problem: pad components frozen;
    fit_flags covers the non-scattering params of the real components
    (dc + 3*ngauss)."""
    n = 2 + 3 * ngauss_pad
    vary = np.zeros(n, bool)
    vary[0] = True
    vary[1] = bool(fit_scattering)
    vary[2:2 + 3 * ngauss] = True
    if fit_flags is not None:
        ff = [bool(f) for f in fit_flags]
        vary[0] = ff[0]
        vary[2:2 + 3 * ngauss] = ff[1:1 + 3 * ngauss]
    return vary


def fit_gaussian_profiles_batched(data, x0s, errs, varys, nbin=None,
                                  max_iter=100, serial=False,
                                  compact_every=COMPACT_EVERY_CONFIG,
                                  device=None):
    """Fit B padded profile problems on ``device`` (default cuda): data
    (B, nbin), x0s (B, n) padded flat layouts, errs (B,) or (B, nbin),
    varys (B, n).  serial=False: the batched engine, compacting
    stragglers every ``compact_every`` iterations; serial=True: the same
    problems one at a time through the single-problem engine.  Returns
    an LMResult of tensors with a leading B axis."""
    dev = resolve_device(device)
    data = np.asarray(data, float)
    B, nbin_d = data.shape
    nbin = nbin_d if nbin is None else nbin
    x0s = np.asarray(x0s, float)
    ngauss_pad = (x0s.shape[1] - 2) // 3
    lower, upper = profile_bounds(ngauss_pad, nbin)
    errs = np.asarray(errs, float)
    if errs.ndim == 1:
        errs = np.broadcast_to(errs[:, None], data.shape)
    data_t, errs_t = _t(data, dev), _t(errs, dev)
    if serial:
        return _serial_lm(_profile_resid,
                          lambda b: (data_t[b], errs_t[b]),
                          x0s, lower, upper, varys, max_iter,
                          jacobian=_profile_resid_jac, device=dev)
    return levenberg_marquardt_batched(
        _profile_resid, x0s, aux=(data_t, errs_t), lower=lower,
        upper=upper, vary=np.asarray(varys), max_iter=max_iter,
        jacobian=_profile_resid_jac,
        # min_rows=1: an underfit trial routinely runs alone for many
        # chunks
        compact_every=resolve_compact_every(compact_every),
        compact_min_rows=1, device=dev)


def pad_portrait_params(params, ngauss_pad):
    """Pad a flat portrait layout to ngauss_pad frozen zero-amplitude
    components.  Returns (padded_params, ngauss)."""
    params = np.asarray(params, float)
    ngauss = (len(params) - 2) // 6
    if ngauss > ngauss_pad:
        raise ValueError(f"cannot pad {ngauss} components into "
                         f"{ngauss_pad}")
    out = np.zeros(2 + 6 * ngauss_pad)
    out[:len(params)] = params
    for ig in range(ngauss, ngauss_pad):
        out[2 + 6 * ig: 8 + 6 * ig] = [0.5, 0.0, 0.02, 0.0, 0.0, 0.0]
    return out, ngauss


def portrait_bounds(ngauss_pad, nbin):
    """(lower, upper) over [theta, alpha_s] of a padded joinless
    portrait problem (fit_gaussian_portrait's bounds; alpha free)."""
    nmain = 2 + 6 * ngauss_pad
    n = nmain + 1
    lower = np.full(n, -np.inf)
    upper = np.full(n, np.inf)
    lower[1] = 0.0
    lower[4:nmain:6] = 0.5 / nbin
    upper[4:nmain:6] = wid_max
    lower[6:nmain:6] = 0.0
    return lower, upper


def portrait_vary(fit_flags, ngauss_pad, fit_scattering_index=False):
    """vary mask over [theta_padded, alpha_s]: the portrait-layout
    fit_flags (2 + 6*ngauss entries) for the real components, pad
    components frozen."""
    fit_flags = np.asarray(fit_flags, bool)
    nmain = 2 + 6 * ngauss_pad
    vary = np.zeros(nmain + 1, bool)
    vary[:len(fit_flags)] = fit_flags
    vary[-1] = bool(fit_scattering_index)
    return vary


def fit_gaussian_portraits_batched(data, x0s, errs, varys, freqs,
                                   nu_refs, Ps, model_code="000",
                                   nchan_valid=None, max_iter=200,
                                   serial=False,
                                   compact_every=COMPACT_EVERY_CONFIG,
                                   device=None):
    """Fit B padded joinless portrait problems on ``device``.

    data (B, nchan, nbin) with pad channels zero; errs (B, nchan) with
    pad channels +inf (an infinite error makes the padded residual row
    and its Jacobian exactly zero); x0s (B, nmain+1) [theta_padded,
    alpha_s]; varys (B, nmain+1); freqs (B, nchan) with pad channels
    edge-replicated; nchan_valid (B,) true channel counts (restores the
    dof).  serial=True runs the same problems through the single-
    problem engine."""
    dev = resolve_device(device)
    data = np.asarray(data, float)
    B, nchan, nbin = data.shape
    x0s = np.asarray(x0s, float)
    nmain = x0s.shape[1] - 1
    ngauss_pad = (nmain - 2) // 6
    lower, upper = portrait_bounds(ngauss_pad, nbin)
    nres_valid = (None if nchan_valid is None
                  else np.asarray(nchan_valid, int) * nbin)
    resid, resid_jac = _portrait_fns(model_code, nbin, 0, nmain)
    aux = (_t(data, dev), _t(errs, dev), _t(freqs, dev),
           _t(np.broadcast_to(np.asarray(nu_refs, float), (B,)), dev),
           _t(np.broadcast_to(np.asarray(Ps, float), (B,)), dev),
           torch.zeros((B, 0, nchan), dtype=torch.bool, device=dev))
    if serial:
        return _serial_lm(resid, lambda b: tuple(a[b] for a in aux),
                          x0s, lower, upper, varys, max_iter,
                          nres_valid=nres_valid, jacobian=resid_jac,
                          device=dev)
    return levenberg_marquardt_batched(
        resid, x0s, aux=aux, lower=lower, upper=upper,
        vary=np.asarray(varys), max_iter=max_iter, nres_valid=nres_valid,
        jacobian=resid_jac,
        compact_every=resolve_compact_every(compact_every),
        compact_min_rows=1, device=dev)
