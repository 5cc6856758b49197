"""The plain reference of a wideband TOA: plain PyTorch in float64.

It works every TOA out again from the arrays the benchmark made (the
int16 samples with their DAT_SCL/DAT_OFFS, the channel frequencies, the
period, the epochs and the template's ``.gmodel`` file), never from
anything the program derived from them, and it imports neither JAX, the
JAX package nor anything of the program.  What it computes is the
semantics of the port's wideband fit (Pennucci, Demorest & Ransom 2014):

- decode: ``q * DAT_SCL + DAT_OFFS`` per channel;
- noise: the power-spectrum estimate, sqrt(mean |D_k|^2 / nbin) over the
  top quarter of the rfft harmonics;
- the template: the evolving Gaussian components' analytic Fourier
  transform, fitted at every harmonic the bins hold (the DC term has
  weight 0), whatever window the program chooses;
- the fit: the minimum of the amplitude-profiled chi^2,
  chi2' = -sum_n C_n^2 / S_n with C_n = sum_k Re(X_nk conj(B_nk)
  e^{2 pi i k t_n}), S_n = sum_k M2_nk |B_nk|^2, X = D conj(M) w,
  M2 = |M|^2 w, w = 1 / (sigma_n^2 nbin / 2), t_n = phi + DM Dconst / P
  (nu_n^-2 - nu_c^-2) and, on the scattering lane, B_nk = 1 / (1 + 2 pi
  i k tau_n), tau_n = 10^l (nu_n / nu_c)^alpha; Newton steps from the
  injected values with exact float64 derivatives;
- the errors: the covariance 2 H^-1 of chi2' at its minimum, the TOA
  referenced to the frequency at which its phase and DM are uncorrelated
  and the scattering time to the one at which log tau and alpha are;
- the TOA: the subint's epoch plus phase times period.

``control="lower"`` computes the fit one step below each precision the
configurations state (float32 fit, bfloat16 storage of the
cross-spectrum): the cross-spectrum stored in float8 (e4m3, one scale per
channel row), and every operand of the chi^2 evaluator (the cross-
spectrum, the model power, the phase factors, the scattering kernel and
each product) rounded to bfloat16, the sums over harmonics and channels
accumulated in float32, as bfloat16 matrix units do.  It is the control
that ``correct`` has to reject.
"""

import math

import numpy as np
import torch

# the "traditional" dispersion constant [MHz^2 s cm^3 / pc] (TEMPO's)
DCONST = 0.000241 ** -1
FWHM2SIGMA = 1.0 / (8.0 * math.log(2.0)) ** 0.5
NOISE_FRAC = 0.25


def read_gmodel(path):
    """A ``.gmodel`` file: nu_ref, code, dc and the components' (loc,
    mloc, wid, mwid, amp, mamp) rows."""
    out = {"code": "000", "dc": 0.0, "tau": 0.0, "comps": []}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "CODE":
                out["code"] = tok[1]
            elif tok[0] == "FREQ":
                out["nu_ref"] = float(tok[1])
            elif tok[0] == "DC":
                out["dc"] = float(tok[1])
            elif tok[0] == "TAU":
                out["tau"] = float(tok[1])
            elif tok[0].startswith("COMP"):
                out["comps"].append([float(x) for x in tok[1::2][:6]])
    if out["tau"] != 0.0:
        raise ValueError(f"{path}: a scattered template is not supported")
    out["comps"] = np.asarray(out["comps"], float)
    return out


def template_ft(gm, freqs, nharm, device="cpu"):
    """The template's rfft (nchan, nharm), complex128: DC plus the
    evolved Gaussian components' analytic transform, on nbin = 2 (nharm -
    1) bins."""
    f = torch.as_tensor(np.asarray(freqs, float), dtype=torch.float64,
                        device=device)[:, None]
    c = torch.as_tensor(gm["comps"], dtype=torch.float64, device=device)
    r = f / gm["nu_ref"]

    def evolve(digit, v, m):
        return v * r ** m if digit == "0" else v + m * (f - gm["nu_ref"])

    loc = evolve(gm["code"][0], c[:, 0], c[:, 1])[..., None]
    wid = evolve(gm["code"][1], c[:, 2], c[:, 3])[..., None]
    amp = evolve(gm["code"][2], c[:, 4], c[:, 5])[..., None]
    nbin = 2 * (nharm - 1)
    k = torch.arange(nharm, dtype=torch.float64, device=device)
    sig = wid.abs() * FWHM2SIGMA
    mag = (amp * nbin * sig * math.sqrt(2.0 * math.pi)
           * torch.exp(-2.0 * (math.pi * k * sig) ** 2))
    ang = -2.0 * math.pi * k * loc
    M = torch.complex(mag * torch.cos(ang), mag * torch.sin(ang)).sum(-2)
    M[:, 0] += gm["dc"] * nbin
    # sampled on nbin bins, the Nyquist harmonic keeps its real part
    M.imag[:, -1] = 0.0
    return M


def _bf16(x):
    """x rounded to bfloat16 in value, its derivative left whole, so the
    Newton steps see the rounded evaluator (complex: both parts)."""
    if x.is_complex():
        return torch.complex(_bf16(x.real), _bf16(x.imag))
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def _round_fp8(x):
    """x stored in float8 e4m3 with one scale per row (last axis)."""
    s = x.abs().amax(dim=-1, keepdim=True) / 448.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return (x / s).to(torch.float8_e4m3fn).to(torch.float64) * s


def _sum32(x, dim=-1):
    """A sum accumulated in float32."""
    return x.to(torch.float32).sum(dim).to(torch.float64)


def _cross_spectra(q, scl, offs, M):
    """X (B, nchan, nharm) complex and M2 (B, nchan, nharm) of a block."""
    x = (q.to(torch.float64) * scl.to(torch.float64)[..., None]
         + offs.to(torch.float64)[..., None])
    nbin = x.shape[-1]
    D = torch.fft.rfft(x, dim=-1)
    del x
    nharm = D.shape[-1]
    kc = int((1.0 - NOISE_FRAC) * nharm)
    sigma2 = (D[..., kc:].abs() ** 2).mean(dim=-1) / nbin
    w = torch.ones(nharm, dtype=torch.float64, device=D.device)
    w[0] = 0.0
    w = w / (sigma2 * (nbin / 2.0))[..., None]
    X = D * torch.conj(M) * w
    del D
    M2 = (M.abs() ** 2) * w
    return X, M2


def _chi2(theta, X, M2, lnr, cvec, scat, low=False):
    """chi2' (B,) at theta (B, 2) or (B, 4); ``low``: in bfloat16."""
    K = X.shape[-1]
    k = torch.arange(K, dtype=torch.float64, device=X.device)
    t = theta[:, 0:1] + cvec * theta[:, 1:2]
    ang = 2.0 * math.pi * t[..., None] * k
    e = torch.complex(torch.cos(ang), torch.sin(ang))
    r = _bf16 if low else (lambda x: x)
    total = _sum32 if low else (lambda x, dim=-1: x.sum(dim))
    if scat:
        tau = 10.0 ** theta[:, 2:3] * torch.exp(theta[:, 3:4] * lnr)
        u = 2.0 * math.pi * tau[..., None] * k
        den = 1.0 + u * u
        Bc = torch.complex(1.0 / den, u / den)   # conj(B)
        C = total(r(r(r(X) * r(Bc)) * r(e)).real)
        S = total(r(r(M2) * r(1.0 / den)))
    else:
        C = total(r(r(X) * r(e)).real)
        S = total(r(M2))
    return -total(r(C * C / S))


def _grad_hess(theta, X, M2, lnr, cvec, scat, low=False):
    th = theta.detach().requires_grad_(True)
    f = _chi2(th, X, M2, lnr, cvec, scat, low)
    g, = torch.autograd.grad(f.sum(), th, create_graph=True)
    rows = [torch.autograd.grad(g[:, i].sum(), th, retain_graph=True)[0]
            for i in range(th.shape[1])]
    return f.detach(), g.detach(), torch.stack(rows, dim=1).detach()


def _newton(theta, X, M2, lnr, cvec, scat, max_iter=80, low=False):
    """Damped Newton steps to the minimum of chi2', each subint alone.
    A subint has converged where its Hessian is positive definite and
    the Newton decrement 0.5 g^T diag(H)^-1 g is below 1e-12 (|f| + 1),
    a few 1e-4 of its errors in chi^2 units.  Returns (theta, H at
    theta, converged (B,) bool)."""
    B, npar = theta.shape
    lam = torch.full((B,), 1e-6, dtype=torch.float64, device=theta.device)
    f, g, H = _grad_hess(theta, X, M2, lnr, cvec, scat, low)
    done = torch.zeros(B, dtype=torch.bool, device=theta.device)
    for _ in range(max_iter):
        dH = torch.diagonal(H, dim1=-2, dim2=-1).abs().clamp(min=1e-300)
        pd = (torch.linalg.eigvalsh(H) > 0).all(-1)
        dec = 0.5 * (g * g / dH).sum(-1)
        done = done | (pd & (dec < 1e-12 * (f.abs() + 1.0)))
        if bool(done.all()):
            break
        A = H + lam[:, None, None] * torch.diag_embed(dH)
        step = -torch.linalg.solve(A, g[..., None])[..., 0]
        step = torch.where(done[:, None], torch.zeros_like(step), step)
        f_new = _chi2(theta + step, X, M2, lnr, cvec, scat, low).detach()
        better = (f_new < f) & ~done
        theta = torch.where(better[:, None], theta + step, theta)
        lam = torch.where(better, lam * 0.1, lam * 10.0).clamp(1e-12, 1e12)
        f, g, H = _grad_hess(theta, X, M2, lnr, cvec, scat, low)
    return theta, H, done


def fit_pool(pool, device, control=None, block=None):
    """The reference TOA of every subint of ``pool`` (pool.Pool):
    a dict of (narchive, nsub) float64 arrays, numpy.

    toa_s: arrival time in seconds after the archive's STT_IMJD day
    start; freq: its reference frequency [MHz]; toa_err_us; dm; dm_err;
    and on the scattering lane tau_us (at tau_freq [MHz]), tau_err_us,
    alpha, alpha_err; ok: the Newton steps converged."""
    scat = pool.scat
    freqs = torch.as_tensor(pool.freqs, dtype=torch.float64, device=device)
    nu_c = float(pool.centre_mhz)
    P = float(pool.period_s)
    cvec = (DCONST / P) * (freqs ** -2.0 - nu_c ** -2.0)
    lnr = torch.log(freqs / nu_c)
    K = pool.nbin // 2 + 1
    M = template_ft(pool.template, pool.freqs, K, device)
    na, ns = pool.narchive, pool.nsub
    if block is None:
        # about 25M complex elements per (subints, channels, harmonics)
        # array, so the autograd graph stays within a few GB
        block = max(1, min(ns, int(2.5e7 // (len(pool.freqs) * K))))
    keys = ["toa_s", "freq", "toa_err_us", "dm", "dm_err", "ok"]
    if scat:
        keys += ["tau_us", "tau_freq", "tau_err_us", "alpha", "alpha_err"]
    out = {k: np.zeros((na, ns)) for k in keys}
    secs0 = pool.start[1] + pool.start[2] + (np.arange(ns) + 0.5) * pool.tsub_s
    for a in range(na):
        for lo in range(0, ns, block):
            hi = min(ns, lo + block)
            sl = slice(lo, hi)
            X, M2 = _cross_spectra(
                torch.as_tensor(pool.q[a, sl], device=device),
                torch.as_tensor(pool.scl[a, sl], device=device),
                torch.as_tensor(pool.offs[a, sl], device=device), M)
            if control == "lower":
                X = torch.complex(_round_fp8(X.real), _round_fp8(X.imag))
            B = hi - lo
            th = [pool.phase[a], pool.dm[a]]
            if scat:
                # log10 tau [rot] at nu_c and alpha, injected
                th += [math.log10(pool.tau_rot_at(a, nu_c)),
                       pool.alpha[a]]
            theta0 = torch.tensor(th, dtype=torch.float64,
                                  device=device).repeat(B, 1)
            theta, H, ok = _newton(theta0, X, M2, lnr, cvec, scat,
                                   low=control == "lower")
            del X, M2
            r = _finalize(theta, H, nu_c, P, scat)
            r = {k: v.cpu().numpy() for k, v in r.items()}
            out["toa_s"][a, sl] = secs0[sl] + r["phi"] * P
            out["ok"][a, sl] = ok.cpu().numpy()
            for k in keys:
                if k in r:
                    out[k][a, sl] = r[k]
    out["ok"] = out["ok"].astype(bool)
    return out


def _finalize(theta, H, nu_c, P, scat):
    """The TOA phase and errors at the zero-covariance frequencies."""
    cov = 2.0 * torch.linalg.inv(H)
    vD, cpD = cov[:, 1, 1], cov[:, 0, 1]
    a0 = -cpD / vD  # phase-per-DM coefficient at the zero-cov frequency
    inv_nu2 = nu_c ** -2.0 + a0 * P / DCONST
    nu0 = torch.where(inv_nu2 > 0, inv_nu2.clamp(min=1e-300) ** -0.5,
                      torch.full_like(inv_nu2, nu_c))
    a0 = (DCONST / P) * (nu0 ** -2.0 - nu_c ** -2.0)
    phi = theta[:, 0] + a0 * theta[:, 1]
    phi = torch.remainder(phi + 0.5, 1.0) - 0.5
    var_phi = cov[:, 0, 0] + 2.0 * a0 * cpD + a0 * a0 * vD
    r = {"phi": phi, "freq": nu0,
         "toa_err_us": var_phi.clamp(min=0).sqrt() * P * 1e6,
         "dm": theta[:, 1], "dm_err": vD.clamp(min=0).sqrt()}
    if scat:
        vA, cLA = cov[:, 3, 3], cov[:, 2, 3]
        L0 = -cLA / vA  # log10(nu_tau / nu_c)
        l_tau = theta[:, 2] + theta[:, 3] * L0
        var_l = cov[:, 2, 2] + 2.0 * L0 * cLA + L0 * L0 * vA
        tau = 10.0 ** l_tau
        r.update({
            "tau_us": tau * P * 1e6, "tau_freq": nu_c * 10.0 ** L0,
            "tau_err_us": var_l.clamp(min=0).sqrt() * tau * math.log(10.0)
            * P * 1e6,
            "alpha": theta[:, 3], "alpha_err": vA.clamp(min=0).sqrt()})
    return r
