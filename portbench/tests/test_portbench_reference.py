"""The reference against hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from portbench import reference as R


def _spectra(nchan=8, K=40, A=3.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    M = torch.complex(torch.randn(nchan, K, generator=g, dtype=torch.float64),
                      torch.randn(nchan, K, generator=g, dtype=torch.float64))
    w = torch.full((nchan, K), 0.5, dtype=torch.float64)
    w[:, 0] = 0.0
    return M, w, A


@pytest.mark.parametrize("phi,dm", [(0.1234, 0.0), (-0.31, 2e-3)])
def test_noiseless_fit_finds_the_shift_and_its_error(phi, dm):
    """Data = A M shifted by t_n = phi + c_n DM: the fit returns (phi, DM)
    and, at the zero-covariance frequency, the phase error 1 / (A
    sqrt(sum_nk (2 pi k)^2 |M_nk|^2 w_nk)) of Pennucci et al. 2014."""
    M, w, A = _spectra()
    freqs = torch.linspace(1100.0, 1900.0, M.shape[0], dtype=torch.float64)
    P, nu_c = 0.004, 1500.0
    cvec = (R.DCONST / P) * (freqs ** -2.0 - nu_c ** -2.0)
    k = torch.arange(M.shape[1], dtype=torch.float64)
    t = phi + cvec * dm
    ang = -2.0 * math.pi * t[:, None] * k
    D = A * M * torch.complex(torch.cos(ang), torch.sin(ang))
    X = (D * torch.conj(M) * w)[None]
    M2 = ((M.abs() ** 2) * w)[None]
    theta0 = torch.tensor([[phi + 2e-3, dm - 1e-4]], dtype=torch.float64)
    theta, H, ok = R._newton(theta0, X, M2, torch.log(freqs / nu_c), cvec,
                             scat=False)
    assert bool(ok.all())
    assert abs(float(theta[0, 0]) - phi) < 1e-10
    assert abs(float(theta[0, 1]) - dm) < 1e-12
    r = R._finalize(theta, H, nu_c, P, scat=False)
    hand = 1.0 / (A * math.sqrt(float(
        ((2 * math.pi * k) ** 2 * M.abs() ** 2 * w).sum())))
    assert abs(float(r["toa_err_us"][0]) / (hand * P * 1e6) - 1.0) < 1e-9
    # at nu0 the phase is the shift there: phi + c(nu0) DM
    c0 = (R.DCONST / P) * (float(r["freq"][0]) ** -2.0 - nu_c ** -2.0)
    assert abs(float(r["phi"][0]) - (phi + c0 * dm)) < 1e-10


def test_scattered_noiseless_fit_finds_tau_and_alpha():
    M, w, A = _spectra(nchan=16, K=64, seed=1)
    freqs = torch.linspace(856.0, 1712.0, 16, dtype=torch.float64)
    P, nu_c = 0.0023, 1284.0
    cvec = (R.DCONST / P) * (freqs ** -2.0 - nu_c ** -2.0)
    lnr = torch.log(freqs / nu_c)
    k = torch.arange(64, dtype=torch.float64)
    phi, dm, l, alpha = 0.05, 1e-3, math.log10(2e-3), -4.4
    tau = 10.0 ** l * torch.exp(alpha * lnr)
    ang = -2.0 * math.pi * (phi + cvec * dm)[:, None] * k
    u = 2.0 * math.pi * tau[:, None] * k
    D = (A * M * torch.complex(torch.cos(ang), torch.sin(ang))
         / torch.complex(torch.ones_like(u), u))
    X = (D * torch.conj(M) * w)[None]
    M2 = ((M.abs() ** 2) * w)[None]
    theta0 = torch.tensor([[phi + 1e-3, dm, l + 0.05, alpha + 0.2]],
                          dtype=torch.float64)
    theta, H, ok = R._newton(theta0, X, M2, lnr, cvec, scat=True)
    assert bool(ok.all())
    np.testing.assert_allclose(theta[0].numpy(), [phi, dm, l, alpha],
                               rtol=0, atol=1e-6)


def test_fp8_storage_rounds_to_three_mantissa_bits():
    x = torch.tensor([[448.0, 416.0, 430.0, 100.1]], dtype=torch.float64)
    y = R._round_fp8(x)
    assert float(y[0, 0]) == 448.0 and float(y[0, 1]) == 416.0
    rel = ((y - x).abs() / x).max()
    assert 0.0 < float(rel) <= 2.0 ** -4


def test_bf16_rounding_keeps_the_derivative():
    x = torch.tensor([1.0 + 2.0 ** -10, 3.0], dtype=torch.float64,
                     requires_grad=True)
    y = R._bf16(x)
    assert float(y[0].detach()) == 1.0 and float(y[1].detach()) == 3.0
    (y * y).sum().backward()
    assert torch.allclose(x.grad, 2.0 * y.detach())


def test_bf16_evaluator_moves_the_minimum_but_not_far():
    """The bfloat16 evaluator's minimum lies off the float64 one (the
    control's point) yet near it (a control is a fit, not noise)."""
    M, w, A = _spectra(nchan=16, K=64, seed=3)
    freqs = torch.linspace(1100.0, 1900.0, 16, dtype=torch.float64)
    P, nu_c = 0.004, 1500.0
    cvec = (R.DCONST / P) * (freqs ** -2.0 - nu_c ** -2.0)
    k = torch.arange(64, dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    ang = -2.0 * math.pi * (0.2 + cvec * 1e-3)[:, None] * k
    D = (A * M * torch.complex(torch.cos(ang), torch.sin(ang))
         + torch.complex(torch.randn(16, 64, generator=g,
                                     dtype=torch.float64),
                         torch.randn(16, 64, generator=g,
                                     dtype=torch.float64)))
    X = (D * torch.conj(M) * w)[None]
    M2 = ((M.abs() ** 2) * w)[None]
    th0 = torch.tensor([[0.2, 1e-3]], dtype=torch.float64)
    lnr = torch.log(freqs / nu_c)
    t64, H, _ = R._newton(th0, X, M2, lnr, cvec, scat=False)
    t16, _, _ = R._newton(th0, X, M2, lnr, cvec, scat=False, low=True)
    sig = torch.sqrt(torch.diagonal(2.0 * torch.linalg.inv(H[0])))
    dev = ((t16 - t64)[0].abs() / sig).max()
    assert 1e-6 < float(dev) < 50.0


def test_template_transform_matches_a_sampled_template():
    """The analytic transform against the rfft of the template sampled
    on the bins (wide enough that aliasing is below 1e-12)."""
    gm = {"code": "000", "nu_ref": 1500.0, "dc": 0.0,
          "comps": np.array([[0.4, 0.0, 0.08, 0.0, 2.0, 0.0]])}
    nbin = 256
    M = R.template_ft(gm, [1500.0], nbin // 2 + 1)
    ph = (np.arange(nbin) / nbin)[None, :]
    sig = 0.08 / math.sqrt(8 * math.log(2))
    prof = sum(2.0 * np.exp(-0.5 * ((ph - 0.4 - j) / sig) ** 2)
               for j in (-1, 0, 1))
    np.testing.assert_allclose(M.numpy(), np.fft.rfft(prof), atol=1e-9)
