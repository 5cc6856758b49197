"""Single-core NumPy/SciPy reference implementation of the wideband
portrait fit (counterpart of pulseportraiture_tpu/fit/reference_numpy.py,
a NumPy copy).

This is the accuracy oracle demanded by BASELINE.md: a deliberately
straightforward, independent implementation (numpy rFFTs + scipy
trust-ncg with an analytic gradient via complex arithmetic) that the
port's fit engines must match to |dphi| < 1e-4.  It imports only numpy,
scipy and the port's config, so it runs on a box without JAX.
"""

import numpy as np
import scipy.optimize as opt

from ..config import Dconst, F0_fact


def _objective_pieces(theta, dFT, mFT, w, freqs, P, nu_fit):
    phi, DM = theta
    nharm = dFT.shape[-1]
    k = np.arange(nharm)
    t_n = phi + (Dconst * DM / P) * (freqs**-2.0 - nu_fit**-2.0)
    ph = np.exp(2.0j * np.pi * np.outer(t_n, k))
    x = dFT * np.conj(mFT) * ph * w  # (nchan, nharm)
    C = np.sum(x.real, axis=-1)
    S = np.sum(np.abs(mFT) ** 2.0 * w, axis=-1)
    S = np.maximum(S, 1e-300)
    return k, t_n, x, C, S


def chi2_prime_ref(theta, dFT, mFT, w, freqs, P, nu_fit):
    _, _, _, C, S = _objective_pieces(theta, dFT, mFT, w, freqs, P, nu_fit)
    return -np.sum(C**2.0 / S)


def chi2_prime_grad_ref(theta, dFT, mFT, w, freqs, P, nu_fit):
    k, _, x, C, S = _objective_pieces(theta, dFT, mFT, w, freqs, P, nu_fit)
    # dC_n/dt_n = -2 pi sum_k k Im(x_nk)... d/dt of Re[x e^{2pi i k t}]
    dC_dt = -2.0 * np.pi * np.sum(k * x.imag, axis=-1)
    dchi_dt = -2.0 * C / S * dC_dt
    dt_dphi = np.ones_like(freqs)
    dt_dDM = (Dconst / P) * (freqs**-2.0 - nu_fit**-2.0)
    return np.array([np.sum(dchi_dt * dt_dphi), np.sum(dchi_dt * dt_dDM)])


def fit_portrait_numpy(port, model, noise_stds, freqs, P, nu_fit, DM0=0.0):
    """(phi, DM) fit of one portrait; returns a dict with phi, DM,
    phi_err, DM_err, nu_zero, chi2, nfeval."""
    port = np.asarray(port, float)
    model = np.asarray(model, float)
    freqs = np.asarray(freqs, float)
    nbin = port.shape[-1]
    dFT = np.fft.rfft(port, axis=-1)
    mFT = np.fft.rfft(model, axis=-1)
    errs_F = np.asarray(noise_stds) * np.sqrt(nbin / 2.0)
    w = np.where(errs_F > 0, errs_F**-2.0, 0.0)[:, None] * np.ones(
        dFT.shape[-1]
    )
    w[:, 0] *= F0_fact

    # dense CCF phase seed at DM0
    k = np.arange(dFT.shape[-1])
    t_n = (Dconst * DM0 / P) * (freqs**-2.0 - nu_fit**-2.0)
    x = np.sum(dFT * np.conj(mFT) * np.exp(2.0j * np.pi * np.outer(t_n, k)) * w, axis=0)
    ccf = np.fft.irfft(x, n=2 * nbin)
    phi0 = np.argmax(ccf) / (2.0 * nbin)
    if phi0 >= 0.5:
        phi0 -= 1.0

    nfev = [0]

    def f(theta):
        nfev[0] += 1
        return chi2_prime_ref(theta, dFT, mFT, w, freqs, P, nu_fit)

    def g(theta):
        return chi2_prime_grad_ref(theta, dFT, mFT, w, freqs, P, nu_fit)

    res = opt.minimize(
        f, np.array([phi0, DM0]), jac=g, method="trust-ncg",
        hess=lambda th: _num_hess(f, th),
        options={"gtol": 1e-10, "maxiter": 200},
    )
    phi, DM = res.x
    H = _num_hess(f, res.x)
    cov = 2.0 * np.linalg.inv(H)
    phi_err, DM_err = np.sqrt(np.abs(np.diag(cov)))
    return dict(
        phi=((phi + 0.5) % 1.0) - 0.5,
        DM=DM,
        phi_err=phi_err,
        DM_err=DM_err,
        covariance=cov,
        chi2=np.sum(np.abs(dFT) ** 2 * w) + res.fun,
        nfeval=nfev[0],
    )


def _num_hess(f, x, eps=None):
    """Central finite-difference Hessian (the reference oracle does not
    need to be fast)."""
    x = np.asarray(x, float)
    n = len(x)
    if eps is None:
        eps = np.maximum(np.abs(x), [1e-6, 1e-7]) * 1e-5 + 1e-12
    H = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            ei = np.zeros(n)
            ej = np.zeros(n)
            ei[i] = eps[i]
            ej[j] = eps[j]
            H[i, j] = H[j, i] = (
                f(x + ei + ej) - f(x + ei - ej) - f(x - ei + ej) + f(x - ei - ej)
            ) / (4.0 * eps[i] * eps[j])
    return H
