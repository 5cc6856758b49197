"""The port's host numerics against the JAX package: ops/ism, ops/filters,
the rest of ops/noise and ops/phasor, fit/reference_numpy and
synth/fake's portraits.

Tolerances: the NumPy copies (ism, filters, reference_numpy, get_noise
'fit') are held equal bit for bit (np.array_equal); so is
exact_median_lastaxis, in float32 and float64.  The torch functions
(channel_SNRs_FT, get_scales, get_noise 'PS', DM_delay,
dispersion_phases) match in float64 within 1e-12 relative to max |ref|;
noiseless fake portraits within 1e-10.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import rel_err

from pulseportraiture_tpu.fit import reference_numpy as JR
from pulseportraiture_tpu.ops import filters as JF
from pulseportraiture_tpu.ops import ism as JI
from pulseportraiture_tpu.ops import noise as JN
from pulseportraiture_tpu.synth import fake as JS
from pulseportraiture_tpu_torch import ops as TO
from pulseportraiture_tpu_torch import synth as TS
from pulseportraiture_tpu_torch.fit import reference_numpy as TR
from pulseportraiture_tpu_torch.ops import filters as TF
from pulseportraiture_tpu_torch.ops import ism as TI
from pulseportraiture_tpu_torch.ops import noise as TN
from pulseportraiture_tpu_torch.ops import phasor as TP

# the JAX package's ops exports a function named phasor over the module
JP = importlib.import_module("pulseportraiture_tpu.ops.phasor")

TOL = 1e-12
P0 = 0.003


def _eq(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def _profiles(seed=1, shape=(6, 128)):
    """Noisy two-component profiles: a power spectrum with a real decay
    and a noise floor."""
    rng = np.random.default_rng(seed)
    x = np.arange(shape[-1]) / shape[-1]
    clean = (np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2)
             + 0.5 * np.exp(-0.5 * ((x - 0.55) / 0.05) ** 2))
    return clean + 0.05 * rng.standard_normal(shape)


def test_ism_bit_for_bit():
    rng = np.random.default_rng(3)
    nu = rng.uniform(300.0, 3000.0, 17)
    D = rng.uniform(0.1, 5.0, 17)
    bw = rng.uniform(1e-3, 10.0, 17)
    Ds = rng.uniform(0.01, 1.0, 17) * D
    a = rng.uniform(0.1, 10.0, 17)
    assert _eq(TI.mean_C2N(nu, D, bw), JI.mean_C2N(nu, D, bw))
    assert _eq(TI.dDM(D, Ds, nu, bw), JI.dDM(D, Ds, nu, bw))
    gm = TI.GM_from_DMc(bw, D, a)
    assert _eq(gm, JI.GM_from_DMc(bw, D, a))
    assert _eq(TI.DMc_from_GM(gm, D, a), JI.DMc_from_GM(gm, D, a))
    assert TI.mean_C2N(1400.0, 1.0, 0.5) == JI.mean_C2N(1400.0, 1.0, 0.5)


@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
def test_filters_bit_for_bit(fn):
    profs = _profiles()
    for prof in profs:
        assert _eq(TF.wiener_filter(prof, 0.05),
                   JF.wiener_filter(prof, 0.05))
        assert TF.fit_brickwall(prof, 0.05) == JF.fit_brickwall(prof, 0.05)
        X = np.fft.rfft(prof)
        pows = (X * np.conj(X)).real / len(prof)
        assert TF.find_kc(pows, fn=fn) == JF.find_kc(pows, fn=fn)
        assert TF.get_noise_fit(prof) == JF.get_noise_fit(prof)
    assert _eq(TF.brickwall_filter(33, 7.9), JF.brickwall_filter(33, 7.9))
    assert _eq(TF.half_triangle_function(5.5, 2.0, 0.3, 12),
               JF.half_triangle_function(5.5, 2.0, 0.3, 12))
    assert _eq(TF._kc_models(np.array([[3.0, 1.0, 0.2], [0.4, 2.0, -1.0]]),
                             9, fn),
               JF._kc_models(np.array([[3.0, 1.0, 0.2], [0.4, 2.0, -1.0]]),
                             9, fn))
    assert _eq(TF.get_noise_fit(profs, chans=True),
               JF.get_noise_fit(profs, chans=True))
    assert TF.find_kc(np.zeros(9)) == JF.find_kc(np.zeros(9)) == 0
    with pytest.raises(ValueError, match="unknown"):
        TF.find_kc(np.ones(9) + np.arange(9), fn="nope")


def test_get_noise_both_methods():
    profs = _profiles(seed=4, shape=(3, 5, 256))
    got = TN.get_noise(torch.from_numpy(profs), method="PS")
    ref = JN.get_noise(jnp.asarray(profs), method="PS")
    assert got.dtype == torch.float64 and rel_err(got, ref) <= TOL
    # 'fit': the NumPy copy on the host, per channel for 2-D+ input
    got = TN.get_noise(torch.from_numpy(profs), method="fit")
    ref = JN.get_noise(profs, method="fit")
    assert got.shape == (3, 5) and _eq(got, ref)
    assert TN.get_noise(profs[0, 0], method="fit") == JN.get_noise(
        profs[0, 0], method="fit")
    assert TO.get_noise is TN.get_noise
    with pytest.raises(ValueError, match="unknown noise method"):
        TN.get_noise(profs, method="median")


@pytest.mark.parametrize("weighted", [False, True])
def test_channel_snrs_and_scales(weighted):
    rng = np.random.default_rng(5)
    shape = (2, 7, 33)
    dFT = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mFT = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    mFT[0, 3] = 0.0  # an empty model channel: S clamps at tiny
    errs = rng.uniform(0.5, 2.0, shape[:2])
    hw = rng.uniform(0.0, 1.0, shape[-1]) if weighted else None
    t = [torch.from_numpy(a) for a in (dFT, mFT, errs)]
    j = [jnp.asarray(a) for a in (dFT, mFT, errs)]
    th = None if hw is None else torch.from_numpy(hw)
    jh = None if hw is None else jnp.asarray(hw)
    for tf, jf in ((TN.channel_SNRs_FT, JN.channel_SNRs_FT),
                   (TN.get_scales, JN.get_scales)):
        got, ref = tf(*t, th), jf(*j, jh)
        assert got.dtype == torch.float64
        assert rel_err(got, ref) <= TOL, tf.__name__


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 255, 256])
def test_exact_median_bit_for_bit(dtype, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)).astype(dtype)
    ties = rng.integers(-3, 4, (4, n)).astype(dtype)
    for a in (x, ties, np.abs(x)):
        got = TN.exact_median_lastaxis(torch.from_numpy(a)).numpy()
        ref = np.asarray(JN.exact_median_lastaxis(jnp.asarray(a)))
        assert got.dtype == ref.dtype == dtype
        assert _eq(got, ref), (a, got, ref)


def test_dm_delay_and_dispersion_phases():
    freqs = np.linspace(1100.0, 1900.0, 11)
    tf = torch.from_numpy(freqs)
    for kw in ({}, {"freq_ref": 1500.0}, {"P": P0},
               {"freq_ref": 1400.0, "P": P0}):
        got = TP.DM_delay(0.0123, tf, **kw)
        ref = JP.DM_delay(0.0123, jnp.asarray(freqs), **kw)
        assert got.dtype == torch.float64 and rel_err(got, ref) <= TOL, kw
    assert TP.DM_delay(10.0, 1400.0) == pytest.approx(
        float(JP.DM_delay(10.0, 1400.0)), rel=TOL)
    assert TP.DM_delay(10.0, 1400.0, freq_ref=math.inf) == TP.DM_delay(
        10.0, 1400.0)
    got = TP.dispersion_phases(tf, -0.004, P0, 1500.0)
    ref = JP.dispersion_phases(jnp.asarray(freqs), -0.004, P0, 1500.0)
    assert rel_err(got, ref) <= TOL
    assert TO.DM_delay is TP.DM_delay
    assert TO.dispersion_phases is TP.dispersion_phases


def _ref_fit_inputs(noise=0.05, seed=9):
    """A dispersed noisy portrait of the default model, as the oracle's
    inputs: (port, model, noise_stds, freqs, P, nu_fit), injected at
    phi 0.0123, DM 4e-4 (at nu_fit)."""
    model = TS.default_test_model(1500.0)
    freqs = np.linspace(1200.0, 1799.0, 32)
    d = TS.fake_portrait(torch.Generator().manual_seed(seed), model, freqs,
                         256, P0, phi=0.0123, DM=4e-4, noise_std=noise,
                         device="cpu")
    return (d.port.numpy(), d.model_port.numpy(), d.noise_stds.numpy(),
            freqs, P0, 1500.0)


def test_reference_numpy_bit_for_bit():
    port, model, stds, freqs, P, nu = _ref_fit_inputs()
    got = TR.fit_portrait_numpy(port, model, stds, freqs, P, nu)
    ref = JR.fit_portrait_numpy(port, model, stds, freqs, P, nu)
    assert got.keys() == ref.keys()
    for k in ref:
        assert _eq(got[k], ref[k]), k
    dFT, mFT = np.fft.rfft(port), np.fft.rfft(model)
    w = np.ones(dFT.shape) / stds[:, None] ** 2
    th = np.array([0.01, 3e-4])
    args = (dFT, mFT, w, freqs, P, nu)
    assert TR.chi2_prime_ref(th, *args) == JR.chi2_prime_ref(th, *args)
    assert _eq(TR.chi2_prime_grad_ref(th, *args),
               JR.chi2_prime_grad_ref(th, *args))
    f = lambda t: TR.chi2_prime_ref(t, *args)  # noqa: E731
    assert _eq(TR._num_hess(f, th), JR._num_hess(f, th))
    assert TR.Dconst == JR.Dconst and TR.F0_fact == JR.F0_fact


def test_reference_numpy_recovers_fake_portrait():
    """The port's oracle on the port's fake portrait: phi within
    BASELINE's 1e-4 rot of the injection, DM within 5 sigma."""
    port, model, stds, freqs, P, nu = _ref_fit_inputs(noise=0.2, seed=11)
    r = TR.fit_portrait_numpy(port, model, stds, freqs, P, nu)
    assert abs((r["phi"] - 0.0123 + 0.5) % 1.0 - 0.5) < 1e-4
    assert abs(r["DM"] - 4e-4) < 5 * r["DM_err"]


INJ = dict(phi=0.021, DM=6e-4, GM=2e-4, tau=2e-5, alpha=-4.2)


@pytest.mark.parametrize("case", ["plain", "scattered", "scaled_ref"])
def test_fake_portrait_noiseless_matches_jax(case):
    model = TS.default_test_model(1500.0)
    freqs = np.linspace(1150.0, 1849.0, 24)
    kw = dict(noise_std=0.0)
    if case == "plain":
        kw.update(phi=INJ["phi"], DM=INJ["DM"], GM=INJ["GM"])
    elif case == "scattered":
        kw.update(INJ)
    else:
        kw.update(INJ, nu_ref=1400.0,
                  scales=np.linspace(0.5, 1.5, len(freqs)))
    got = TS.fake_portrait(None, model, freqs, 256, P0, device="cpu", **kw)
    ref = JS.fake_portrait(jax.random.PRNGKey(0), JS.default_test_model(
        1500.0), jnp.asarray(freqs), 256, P0, **kw)
    for k in ("port", "model_port", "freqs", "weights", "noise_stds"):
        assert got[k].dtype == torch.float64
        assert rel_err(got[k], ref[k]) <= 1e-10, k
    for k in ("phi", "DM", "GM", "tau", "alpha", "nu_ref", "P", "nbin"):
        assert got[k] == ref[k], k
    assert set(got) == set(ref)


def test_fake_observation_noiseless_matches_jax():
    model = TS.default_test_model(1500.0)
    kw = dict(nsub=3, nchan=16, nbin=128, P=P0, noise_std=0.0, DM=3e-4,
              phi=0.05)
    got, gd = TS.fake_observation(None, model, device="cpu", **kw)
    ref, rd = JS.fake_observation(jax.random.PRNGKey(1),
                                  JS.default_test_model(1500.0), **kw)
    assert set(got) == set(ref)
    assert _eq(gd, rd) and _eq(got.DMs, ref.DMs)  # dDM_std 0: all zero
    for k in ("subints", "model_port", "freqs", "weights", "noise_stds"):
        assert tuple(got[k].shape) == tuple(np.shape(ref[k])), k
        assert rel_err(got[k], ref[k]) <= 1e-10, k


def test_fake_portrait_noise_zap_and_seed():
    """The random parts: white noise whose mean and std lie within 5
    sigma of (0, noise_std), a zapped-channel count within 5 sigma of
    its binomial mean, scintillation within its pattern's range; the
    same generator seed gives the same portrait twice."""
    model = TS.default_test_model(1500.0)
    nchan, nbin, sd, zf = 400, 256, 0.3, 0.25
    freqs = np.linspace(1100.0, 1900.0, nchan)

    def make(seed, **kw):
        return TS.fake_portrait(torch.Generator().manual_seed(seed), model,
                                freqs, nbin, P0, phi=0.01, device="cpu",
                                **kw)

    clean = make(1, noise_std=0.0)
    d = make(1, noise_std=sd)
    r = (d.port - clean.port).numpy()
    n = r.size
    assert abs(r.mean()) < 5 * sd / math.sqrt(n)
    # the std of a sample std of n normals is ~ sd / sqrt(2 n)
    assert abs(r.std() - sd) < 5 * sd / math.sqrt(2 * n)
    z = make(2, noise_std=sd, zap_frac=zf)
    nzap = int((z.weights == 0).sum())
    assert abs(nzap - zf * nchan) < 5 * math.sqrt(nchan * zf * (1 - zf))
    assert torch.all(z.port[z.weights == 0] == 0.0)
    s = make(3, noise_std=0.0, scint_nsin=3)
    ratio = (s.port.abs().amax(-1) / clean.port.abs().amax(-1)).numpy()
    assert np.all((ratio >= 0.1 - 1e-9) & (ratio <= 1.1 + 1e-9))
    again = make(2, noise_std=sd, zap_frac=zf)
    assert torch.equal(again.port, z.port)
    assert torch.equal(again.weights, z.weights)
    assert not torch.equal(make(4, noise_std=sd).port, d.port)
    b1, d1 = TS.fake_observation(torch.Generator().manual_seed(5), model,
                                 nsub=2, nchan=8, nbin=64, dDM_std=1e-3,
                                 device="cpu")
    b2, d2 = TS.fake_observation(torch.Generator().manual_seed(5), model,
                                 nsub=2, nchan=8, nbin=64, dDM_std=1e-3,
                                 device="cpu")
    assert _eq(d1, d2) and torch.equal(b1.subints, b2.subints)
    assert np.all(d1 != 0.0) and not torch.equal(b1.subints[0],
                                                 b1.subints[1])
