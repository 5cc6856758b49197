"""The PyTorch port's fast fit against the JAX package in float64.

fit_portrait_batch_fast on both sides, with the JAX reference forced
onto the same path (config.use_fast_fit, config.fit_fused and an
explicit harmonic window), over a directed lattice of fit flags x
bounds x fold, with a masked channel in every portrait.

Tolerances (float64): phi within 1e-9 rot; DM, GM and their errors
within 1e-8 relative (relative to max(|ref|, ref error) for the
values, which can sit near zero); chi2 within 1e-10 relative; nfeval
and return code equal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_helpers import PAR  # noqa: F401  (pins torch threads)

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.fit.portrait import FitFlags as JFlags
from pulseportraiture_tpu.fit.portrait import \
    fit_portrait_batch_fast as jfit
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.fit.portrait import FitFlags as TFlags
from pulseportraiture_tpu_torch.fit.portrait import \
    fit_portrait_batch_fast as tfit
from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
from pulseportraiture_tpu_torch.synth import default_test_model

NB, NCHAN, NBIN, K = 3, 16, 256, 128
P0 = 0.004074
Dconst = tcfg.Dconst


def _dataset(seed=21):
    """Noisy dispersed portraits with injected (phi, DM, GM) per subint
    against a shared Gaussian template; channel 5 is masked."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1150.0, 1850.0, NCHAN)
    model = gen_gmodel_portrait(default_test_model(1500.0), np.arange(NBIN),
                                freqs, device="cpu")
    nu_fit = np.full(NB, 1450.0)
    phis = np.array([0.013, -0.21, 0.37])
    DMs = np.array([0.0021, -0.0013, 0.0008])
    GMs = np.array([0.3, -0.2, 0.1])
    k = np.arange(NBIN // 2 + 1)
    ports = np.empty((NB, NCHAN, NBIN))
    for b in range(NB):
        t = (phis[b] + Dconst * DMs[b] / P0 * (freqs**-2 - nu_fit[b]**-2)
             + Dconst**2 * GMs[b] / P0 * (freqs**-4 - nu_fit[b]**-4))
        rot = np.exp(-2j * np.pi * k[None, :] * t[:, None])
        ports[b] = np.fft.irfft(np.fft.rfft(model, axis=-1) * rot, n=NBIN,
                                axis=-1)
    noise = np.full((NB, NCHAN), 0.3)
    ports += noise[..., None] * rng.standard_normal(ports.shape)
    masks = np.ones((NB, NCHAN))
    masks[:, 5] = 0.0
    theta0 = np.zeros((NB, 5))
    theta0[:, 1] = 0.0005  # nonzero DM guess: the seed derotates
    return ports, model, noise, freqs, np.full(NB, P0), nu_fit, masks, theta0


FLAGS = {"phi": (True, False, False, False, False),
         "phi_DM": (True, True, False, False, False),
         "phi_DM_GM": (True, True, True, False, False)}


def _bounds():
    """A box whose DM bound cuts through subint 0's optimum, so one
    element converges onto the bound (return code 0) and the rest in
    the interior (return code 1)."""
    b = np.tile([-np.inf, np.inf], (5, 1))
    b[0] = (-0.5, 0.5)
    b[1] = (-0.01, 0.0015)
    return b


@pytest.fixture
def fast_path_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window",
            "dft_fold")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _close(got, ref, tol, scale=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if scale is None:
        scale = np.abs(ref)
    return np.all(np.abs(got - ref) <= tol * np.maximum(scale, 1e-300))


def _run_both(flags, bounds, fold, window=K, fused=True):
    ports, model, noise, freqs, P, nu_fit, masks, theta0 = _dataset()
    jcfg.dft_fold = tcfg.dft_fold = fold
    jcfg.fit_fused = tcfg.fit_fused = fused
    ref = jfit(jnp.asarray(ports), model, jnp.asarray(noise),
               jnp.asarray(freqs), jnp.asarray(P), jnp.asarray(nu_fit),
               theta0=jnp.asarray(theta0), fit_flags=JFlags(*flags),
               chan_masks=jnp.asarray(masks), harmonic_window=window,
               bounds=bounds)
    got = tfit(ports, model, noise, freqs, P, nu_fit, theta0=theta0,
               fit_flags=TFlags(*flags), chan_masks=masks,
               harmonic_window=window, bounds=bounds, device="cpu")
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    return got, ref


def _assert_parity(got, ref):
    assert got["phi"].dtype == np.float64
    dphi = np.abs((got["phi"] - ref["phi"] + 0.5) % 1.0 - 0.5)
    assert np.all(dphi <= 1e-9), dphi
    for k in ("DM", "GM"):
        assert _close(got[k], ref[k], 1e-8,
                      np.maximum(np.abs(ref[k]), ref[k + "_err"])), k
    for k in ("phi_err", "DM_err", "GM_err", "nu_DM", "snr"):
        assert _close(got[k], ref[k], 1e-8), k
    assert _close(got["chi2"], ref["chi2"], 1e-10)
    np.testing.assert_array_equal(got["dof"], ref["dof"])
    np.testing.assert_array_equal(got["nfeval"], ref["nfeval"])
    np.testing.assert_array_equal(got["return_code"], ref["return_code"])
    assert _close(got["scales"], ref["scales"], 1e-8,
                  np.max(np.abs(ref["scales"])))
    assert _close(got["covariance"], ref["covariance"], 1e-8,
                  np.max(np.abs(ref["covariance"])))


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_fit_parity_f64(fast_path_config, flags, bounded, fold):
    got, ref = _run_both(FLAGS[flags], _bounds() if bounded else None, fold)
    _assert_parity(got, ref)
    if bounded and flags == "phi_DM":
        # the lattice really exercises an active bound
        assert got["return_code"][0] == 0
        assert got["DM"][0] == pytest.approx(0.0015, abs=1e-15)


def test_fit_parity_unfused_and_full_spectrum(fast_path_config):
    """The unfused windowed lane and the unwindowed lane agree too."""
    for window, fused in ((K, False), (False, True)):
        got, ref = _run_both(FLAGS["phi_DM"], None, False, window=window,
                             fused=fused)
        _assert_parity(got, ref)


def test_fit_recovers_injection(fast_path_config):
    """Sanity on the data itself: the port recovers the injected DM
    and GM within 5 sigma."""
    got, _ = _run_both(FLAGS["phi_DM_GM"], None, False)
    assert np.all(np.isfinite(got["phi"]))
    assert np.all(np.abs(got["DM"] - [0.0021, -0.0013, 0.0008])
                  < 5 * got["DM_err"])
    assert np.all(np.abs(got["GM"] - [0.3, -0.2, 0.1]) < 5 * got["GM_err"])


def test_degenerate_all_masked_element(fast_path_config):
    """A fully masked subint behaves as in the JAX package: no finite
    optimum, and the same return code and eval count as the reference
    (singular Hessians give non-finite values instead of raising)."""
    ports, model, noise, freqs, P, nu_fit, masks, theta0 = _dataset()
    masks[1] = 0.0
    kw = dict(theta0=theta0, chan_masks=masks, harmonic_window=K)
    ref = jfit(jnp.asarray(ports), model, jnp.asarray(noise),
               jnp.asarray(freqs), jnp.asarray(P), jnp.asarray(nu_fit),
               fit_flags=JFlags(), **{k: jnp.asarray(v) if k != "harmonic_window"
                                      else v for k, v in kw.items()})
    got = tfit(ports, model, noise, freqs, P, nu_fit, fit_flags=TFlags(),
               device="cpu", **kw)
    np.testing.assert_array_equal(got.nfeval.numpy(), np.asarray(ref.nfeval))
    np.testing.assert_array_equal(got.return_code.numpy(),
                                  np.asarray(ref.return_code))
    assert torch.isfinite(got.phi[0]) and torch.isfinite(got.phi[2])
    np.testing.assert_array_equal(np.isfinite(got.phi_err.numpy()),
                                  np.isfinite(np.asarray(ref.phi_err)))
