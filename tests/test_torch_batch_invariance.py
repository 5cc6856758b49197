"""A subint's fit does not depend on its bucket (ROADMAP C8), on the CPU,
and the single-subint fits and names that came with it, against the JAX
package.

- resolve_harmonic_window's CUDA rule as a pure decision: where the knob
  resolves to no window (None, False, 'auto' finding none, an int of
  nbin // 2 + 1 or more), a CUDA device with the fused lane on takes
  every harmonic (full_spectrum_window), every other device the JAX
  package's answer;
- the batch-invariant matmul DFT (ops.fourier.rfft_mm_invariant /
  irfft_mm_invariant) against rfft_mm / irfft_mm at 1e-12 x max|ref| in
  float64, and bit for bit per row at any row count;
- the Parseval Sd of the fused lanes against the harmonic sum over every
  harmonic, 1e-12 relative in float64;
- estimate_tau_batch through B1's want_m2 form (the plain version here)
  against the JAX estimate_tau_batch, 1e-10 relative in float64, and
  each subint's seed alone equal to its seed in the batch, bit for bit;
- fast_fit_one, fast_fit_one_packed and fast_scatter_fit_one against the
  JAX functions in float64 (phi, DM, tau, alpha and their errors within
  1e-8 relative or 1e-8 x the error for phi; chi2 1e-8 relative;
  nfeval and the return code equal), and each bit for bit equal to its
  row of the port's batched lane;
- utils.device.host_compute / on_host, FitFlags.as_array,
  GaussianModel.params_pytree against the JAX ones;
- enable_compile_cache routing ops.fused.BUILD_DIR, without a build.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_helpers import rel_err

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.fit import portrait as JP
from pulseportraiture_tpu.models import gaussian as JMG
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import device as TD
from pulseportraiture_tpu_torch.fit import portrait as TP
from pulseportraiture_tpu_torch.io.gmodel import gen_gmodel_portrait
from pulseportraiture_tpu_torch.models import gaussian as TMG
from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.ops import fused as TFu
from pulseportraiture_tpu_torch.synth import default_test_model
from pulseportraiture_tpu_torch.utils import device as TUD

NB, NCHAN, NBIN = 4, 16, 256
P0 = 0.004074
Dconst = tcfg.Dconst


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def data():
    """Noisy dispersed, scattered portraits of a Gaussian template
    (injected phi, DM, tau, alpha per subint), channel 3 masked, and the
    same rows as dithered 2-bit packed samples."""
    rng = np.random.default_rng(18)
    freqs = np.linspace(1150.0, 1850.0, NCHAN)
    model = gen_gmodel_portrait(default_test_model(1500.0), np.arange(NBIN),
                                freqs, device="cpu")
    nu_fit = np.full(NB, 1450.0)
    phis = np.array([0.013, -0.21, 0.37, 0.05])
    DMs = np.array([0.0021, -0.0013, 0.0008, 0.0])
    taus = np.array([0.01, 0.02, 0.006, 0.012])
    k = np.arange(NBIN // 2 + 1)
    ports = np.empty((NB, NCHAN, NBIN))
    for b in range(NB):
        t = phis[b] + Dconst * DMs[b] / P0 * (freqs**-2 - nu_fit[b]**-2)
        tn = taus[b] * (freqs / nu_fit[b]) ** -4.0
        kern = 1.0 / (1.0 + 2j * np.pi * tn[:, None] * k)
        ports[b] = np.fft.irfft(np.fft.rfft(model, axis=-1) * kern
                                * np.exp(-2j * np.pi * k * t[:, None]),
                                n=NBIN, axis=-1)
    noise = np.full((NB, NCHAN), 0.3)
    ports += noise[..., None] * rng.standard_normal(ports.shape)
    masks = np.ones((NB, NCHAN))
    masks[:, 3] = 0.0
    mu, step = ports.mean(-1), ports.std(-1)
    s = np.clip(np.floor((ports - mu[..., None]) / step[..., None] + 2.0
                         + rng.uniform(-0.5, 0.5, ports.shape)), 0, 3)
    b = s.astype(np.uint8).reshape(NB, NCHAN, -1, 4)
    raw = (b[..., 0] << 6) | (b[..., 1] << 4) | (b[..., 2] << 2) | b[..., 3]
    return dict(ports=ports, model=model, noise=noise, freqs=freqs,
                P=np.full(NB, P0), nu_fit=nu_fit, masks=masks,
                raw=raw.astype(np.uint8), scl=step, offs=mu - 1.5 * step)


@pytest.fixture
def fused_config():
    """Both packages on the fused fast lanes (their plain versions /
    the Pallas kernels interpreted on the CPU)."""
    keys = ("use_fast_fit", "fit_fused", "scatter_compensated",
            "cross_spectrum_dtype")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.scatter_compensated = tcfg.scatter_compensated = False
    jcfg.cross_spectrum_dtype = tcfg.cross_spectrum_dtype = None
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


# ---------------------------------------------------------------------
# the window rule


@pytest.mark.parametrize("knob", [None, False, "auto", 4096, 128, "full"],
                         ids=["None", "False", "auto", "int_over", "int",
                              "full"])
@pytest.mark.parametrize("fused", ["auto", True, False])
def test_resolve_window_cuda_rule(knob, fused, monkeypatch):
    """The decision alone, for device 'cuda' and 'cpu' (no card needed):
    where the JAX package resolves no window, 'cuda' with the fused lane
    on gives nbin // 2 + 1 and every other case the JAX answer; a window
    the JAX package resolves stays.  A broad template (a narrow pulse)
    finds no window at 'auto'; full_spectrum forced on the CPU (a
    rehearsal's KNOB_POLARITY) takes the CUDA rule there."""
    nbin = 512
    broad = np.zeros((4, nbin))
    broad[:, 7] = 1.0
    monkeypatch.setattr(tcfg, "fit_fused", fused)
    monkeypatch.setattr(jcfg, "fit_harmonic_window", None)
    monkeypatch.setattr(tcfg, "fit_harmonic_window", None)
    jax_knob = knob if knob != "full" else None
    ref = JP.resolve_harmonic_window(jax_knob, broad, nbin)
    fused_on = fused is not False
    for dev in ("cuda", "cpu"):
        got = TP.resolve_harmonic_window(knob, broad, nbin, device=dev)
        if knob == "full":
            want = nbin // 2 + 1 if (fused is True or (
                fused == "auto" and dev == "cuda")) else None
        elif ref is None and dev == "cuda" and fused_on:
            want = nbin // 2 + 1
        else:
            want = ref
        assert got == want, (dev, knob, fused)
        assert TP.full_spectrum_window(nbin, dev) == (
            nbin // 2 + 1 if dev == "cuda" and fused_on else None)
    # no device: the JAX answer; 'full' resolves the fused lane for the
    # port's default device, cuda
    assert TP.resolve_harmonic_window(knob, broad, nbin) == (
        ref if knob != "full" else nbin // 2 + 1 if fused_on else None)
    narrow = np.asarray(gen_gmodel_portrait(
        default_test_model(1500.0), np.arange(2048),
        np.linspace(1200.0, 1800.0, 8), device="cpu"))
    assert TP.resolve_harmonic_window("auto", narrow, 2048, device="cuda") \
        == JP.resolve_harmonic_window("auto", narrow, 2048) == 384
    monkeypatch.setitem(TD.KNOB_POLARITY, "full_spectrum", "not_cuda")
    monkeypatch.setitem(TD.KNOB_POLARITY, "fit_fused", "not_cuda")
    if fused != "auto":
        return
    assert TP.full_spectrum_window(nbin, "cpu") == nbin // 2 + 1
    assert TP.full_spectrum_window(nbin, "cuda") is None


def test_use_fit_fused_setting_keyword(monkeypatch):
    """use_fit_fused(setting=) (the JAX keyword) beside the device."""
    monkeypatch.setattr(tcfg, "fit_fused", False)
    assert TP.use_fit_fused("cuda") is False
    assert TP.use_fit_fused("cuda", setting="auto") is True
    assert TP.use_fit_fused("cpu", setting="auto") is False
    assert TP.use_fit_fused(setting=True) is True
    assert TP.use_fit_fused(device="cpu", setting=True) is True
    with pytest.raises(ValueError):
        TP.use_fit_fused("cpu", setting="maybe")


# ---------------------------------------------------------------------
# the batch-invariant matmul DFT


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("nharm", [None, 100])
@pytest.mark.parametrize("block", [1, 5, 64])
def test_invariant_dft_matches_matmul_dft(fold, nharm, block):
    """rfft_mm_invariant / irfft_mm_invariant against rfft_mm /
    irfft_mm: 1e-12 x max|ref| in float64; each row alone equals its
    row in batches of 2 and 7 (ragged against the block) bit for bit."""
    rng = np.random.default_rng(block)
    x = _t(rng.standard_normal((7, 3, NBIN)))
    ref = TF.rfft_mm(x, nharm=nharm, fold=fold)
    got = TF.rfft_mm_invariant(x, nharm=nharm, fold=fold, block=block)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == torch.float64
        assert rel_err(g, r) <= 1e-12
    Xr, Xi = ref
    n = 2 * NBIN
    iref = TF.irfft_mm(Xr, Xi, n=n)
    igot = TF.irfft_mm_invariant(Xr, Xi, n=n, block=block)
    assert igot.shape == iref.shape and rel_err(igot, iref) <= 1e-12
    for b in (2, 7):
        many = TF.rfft_mm_invariant(x[:b], nharm=nharm, fold=fold,
                                    block=block)
        many_i = TF.irfft_mm_invariant(Xr[:b], Xi[:b], n=n, block=block)
        for i in range(b):
            one = TF.rfft_mm_invariant(x[i:i + 1], nharm=nharm, fold=fold,
                                       block=block)
            for m, o in zip(many, one):
                assert torch.equal(m[i:i + 1], o), (b, i)
            one_i = TF.irfft_mm_invariant(Xr[i:i + 1], Xi[i:i + 1], n=n,
                                          block=block)
            assert torch.equal(many_i[i:i + 1], one_i), (b, i)


@pytest.mark.parametrize("n", [None, 8 * NBIN, NBIN // 2])
def test_invariant_complex_dft_matches_torch_fft(n):
    """rfft_c_invariant / irfft_c_invariant (the complex engine's and
    narrowband's DFTs on CUDA) against torch.fft's rfft / irfft (the
    spectrum zero-padded or cut to n // 2 + 1): 1e-12 x max|ref| in
    float64, each row alone equal to its row in the batch bit for bit;
    rfft_c_rows / irfft_c_rows on the CPU are torch.fft's, bit for
    bit."""
    rng = np.random.default_rng(4)
    x = _t(rng.standard_normal((5, 3, NBIN)))
    X = torch.fft.rfft(x)
    got = TF.rfft_c_invariant(x, block=4)
    assert got.dtype == torch.complex128
    assert rel_err(torch.view_as_real(got), torch.view_as_real(X)) <= 1e-12
    iref = torch.fft.irfft(X, n=n)
    igot = TF.irfft_c_invariant(X, n=n, block=4)
    assert igot.shape == iref.shape and rel_err(igot, iref) <= 1e-12
    for i in range(5):
        assert torch.equal(TF.rfft_c_invariant(x[i:i + 1], block=4),
                           got[i:i + 1])
        assert torch.equal(TF.irfft_c_invariant(X[i:i + 1], n=n, block=4),
                           igot[i:i + 1])
    assert torch.equal(TF.rfft_c_rows(x), X)
    assert torch.equal(TF.irfft_c_rows(X, n=n), iref)
    half = TF.rfft_c_invariant(x.float().to(torch.bfloat16))
    assert half.dtype == torch.complex64


def test_invariant_matmul_rows_and_refusals():
    """matmul_rows_invariant over any leading shape, a row count below
    one block, the default block, and a refused block."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 3, 5, 17)))
    W = _t(rng.standard_normal((17, 11)))
    ref = torch.matmul(x, W)
    for block in (None, 1, 4, 1000):
        got = TF.matmul_rows_invariant(x, W, block)
        assert got.shape == ref.shape and rel_err(got, ref) <= 1e-12
    assert TF.ROW_BLOCK >= 1
    with pytest.raises(ValueError, match="block"):
        TF.matmul_rows_invariant(x, W, 0)


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
def test_dft_precision_arms(prec, monkeypatch):
    """Every dft_precision is accepted on either device; on the CPU every
    arm computes full float32 products (the same bits as 'highest'), and
    the TF32 flag is left as it was; an unknown name raises."""
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((4, NBIN)).astype(np.float32))
    flag = torch.backends.cuda.matmul.allow_tf32
    ref = TF.rfft_mm(x, precision="highest")
    got = TF.rfft_mm(x, precision=prec)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert torch.equal(TF.irfft_mm(*got, precision=prec),
                       TF.irfft_mm(*ref))
    assert torch.equal(TF.rfft_c(x, precision=prec), TF.rfft_c(x))
    assert torch.equal(TF.irfft_c(TF.rfft_c(x), precision=prec),
                       TF.irfft_c(TF.rfft_c(x)))
    monkeypatch.setattr(tcfg, "dft_precision", prec)
    assert TF.check_dft_precision() == prec
    with TF.matmul_precision(None, "cpu") as name:
        assert name == prec
        assert torch.backends.cuda.matmul.allow_tf32 == flag
    assert torch.backends.cuda.matmul.allow_tf32 == flag
    with pytest.raises(ValueError, match="dft_precision"):
        TF.rfft_mm(x, precision="low")


# ---------------------------------------------------------------------
# the fused lanes' pieces


def test_parseval_sd_matches_harmonic_sum(data):
    """The full-spectrum Sd of the fused lanes (_parseval_Sd from the
    time domain, and _sd_rows from B2's per-channel rows) equals the
    weighted harmonic sum over every harmonic, the unwindowed matmul
    lane's Sd: 1e-12 relative in float64, masked channel included."""
    ports = _t(data["ports"])
    w = TP.make_weights(_t(data["noise"]), NBIN, _t(data["masks"]))
    dr, di = TF.rfft_mm(ports)
    ref = TP.chan_sum(torch.sum((dr**2 + di**2) * w, dim=-1), -1)
    got = TP._parseval_Sd(ports, w)
    assert rel_err(got, ref) <= 1e-12
    raw = _t(data["raw"])
    scl, offs = _t(data["scl"]), _t(data["offs"])
    K = NBIN // 2 + 1
    _, _, _, pwr, x0 = TFu.fused_decode_cross_spectrum(
        raw, scl, offs, _t(data["model"]), w.contiguous(), K, code="p2",
        nbin=NBIN)
    from pulseportraiture_tpu_torch.ops.decode import decode_stokes_I

    x = decode_stokes_I(raw.reshape(NB, -1), scl, offs, torch.float64,
                        code="p2", nbin=NBIN)
    ddr, ddi = TF.rfft_mm(x)
    ref2 = TP.chan_sum(torch.sum((ddr**2 + ddi**2) * w, dim=-1), -1)
    assert rel_err(TP._sd_rows(pwr, x0, w), ref2) <= 1e-12


@pytest.mark.parametrize("masked,per_element", [(False, False),
                                                (True, False), (True, True)])
def test_estimate_tau_want_m2_route(data, masked, per_element, monkeypatch):
    """estimate_tau_batch with fit_fused=True takes its three channel sums
    from B1's want_m2 form at every harmonic (the plain version on the
    CPU, spied on): 1e-10 relative to the JAX estimate_tau_batch in
    float64, and each subint's seed alone equal to its seed in the batch
    bit for bit.  fit_fused None on the CPU keeps the matmul DFT."""
    d = data
    models = (np.broadcast_to(d["model"], d["ports"].shape).copy()
              if per_element else d["model"])
    masks = d["masks"] if masked else None
    ref = np.asarray(JP.estimate_tau_batch(
        jnp.asarray(d["ports"]), jnp.asarray(models),
        jnp.asarray(d["noise"]),
        None if masks is None else jnp.asarray(masks)))
    calls = []
    orig = TFu.fused_cross_spectrum_ref

    def spy(port, model, w, nharm, *a, **kw):
        calls.append((int(nharm), bool(kw.get("want_m2"))))
        return orig(port, model, w, nharm, *a, **kw)

    monkeypatch.setattr(TFu, "fused_cross_spectrum_ref", spy)
    args = (_t(d["ports"]), _t(models), _t(d["noise"]),
            None if masks is None else _t(masks))
    got = TP.estimate_tau_batch(*args, fit_fused=True)
    assert calls == [(NBIN // 2 + 1, True)]
    assert got.dtype == torch.float64
    assert np.all(np.abs(got.numpy() - ref) <= 1e-10 * np.abs(ref))
    for i in range(NB):
        one = TP.estimate_tau_batch(
            *[None if a is None else (a if a.dim() == 2 and a is args[1]
                                      else a[i:i + 1]) for a in args],
            fit_fused=True)
        assert torch.equal(one[0], got[i]), i
    calls.clear()
    plain = TP.estimate_tau_batch(*args)
    assert calls == []
    assert np.all(np.abs(plain.numpy() - ref) <= 1e-10 * np.abs(ref))


# ---------------------------------------------------------------------
# the single-subint fits


FIELDS = ("phi", "DM", "GM", "tau", "alpha", "phi_err", "DM_err", "tau_err",
          "alpha_err", "nu_DM", "snr", "chi2", "scales", "channel_snrs")


def _assert_one_vs_jax(got, ref, fields):
    for k in fields:
        g = getattr(got, k).numpy()
        r = np.asarray(getattr(ref, k))
        assert g.shape == r.shape, k
        if k == "phi":
            err = float(np.asarray(ref.phi_err))
            assert abs((g - r + 0.5) % 1.0 - 0.5) <= 1e-8 * err, k
        else:
            assert np.all(np.abs(g - r) <= 1e-8 * np.maximum(
                np.abs(r), 1e-300)), k
    assert int(got.nfeval) == int(ref.nfeval)
    assert int(got.return_code) == int(ref.return_code)


def _assert_row(one, batch, i):
    for k in one._fields:
        assert torch.equal(getattr(one, k), getattr(batch, k)[i]), k


def _args(d, i, dt=np.float64):
    theta0 = np.zeros(5)
    theta0[1] = 0.0005
    return (d["ports"][i].astype(dt), d["model"].astype(dt),
            d["noise"][i].astype(dt), d["masks"][i].astype(dt),
            d["freqs"].astype(dt), dt(P0), dt(d["nu_fit"][i]), dt(-1.0),
            theta0.astype(dt))


@pytest.mark.parametrize("nharm_eff", [None, 128, NBIN // 2 + 1])
def test_fast_fit_one(data, fused_config, nharm_eff):
    """fast_fit_one against the JAX fast_fit_one (its unwindowed matmul
    lane, its windowed lane, and every harmonic through the fused lane)
    in float64, and bit for bit equal to its row of fast_fit_batched."""
    from pulseportraiture_tpu.fit.portrait import FitFlags as JFlags

    d = data
    flags = TP.FitFlags(True, True)
    kw = dict(max_iter=40, nharm_eff=nharm_eff,
              fit_fused=nharm_eff is not None)
    batch = TP.fast_fit_batched(
        _t(d["ports"]), _t(d["model"]), _t(d["noise"]), _t(d["masks"]),
        _t(d["freqs"]), _t(d["P"]), _t(d["nu_fit"]),
        torch.full((NB,), -1.0, dtype=torch.float64),
        torch.stack([_t(_args(d, i)[8]) for i in range(NB)]),
        fit_flags=flags, **kw)
    for i in range(NB):
        a = _args(d, i)
        ref = JP.fast_fit_one(*[jnp.asarray(v) for v in a],
                              fit_flags=JFlags(True, True), **kw)
        got = TP.fast_fit_one(*[_t(v) for v in a], fit_flags=flags, **kw)
        assert got.phi.dim() == 0 and got.covariance.shape == (5, 5)
        _assert_one_vs_jax(got, ref, FIELDS[:3] + FIELDS[5:7] + FIELDS[9:])
        _assert_row(got, batch, i)


@pytest.mark.parametrize("nharm_eff", [128, NBIN // 2 + 1])
def test_fast_fit_one_packed(data, fused_config, nharm_eff):
    """fast_fit_one_packed against the JAX one (its Pallas kernel
    interpreted on the CPU) in float64, a ragged fused_block included,
    and bit for bit equal to its row of fast_fit_batched_packed."""
    from pulseportraiture_tpu.fit.portrait import FitFlags as JFlags

    d = data
    flags = TP.FitFlags(True, True)
    kw = dict(raw_code="p2", nbin=NBIN, max_iter=40, nharm_eff=nharm_eff,
              fused_block=5)
    theta0 = np.zeros((NB, 5))
    theta0[:, 1] = 0.0005
    batch = TP.fast_fit_batched_packed(
        _t(d["raw"]), _t(d["scl"]), _t(d["offs"]), _t(d["model"]),
        _t(d["noise"]), _t(d["masks"]), _t(d["freqs"]), _t(d["P"]),
        _t(d["nu_fit"]), torch.full((NB,), -1.0, dtype=torch.float64),
        _t(theta0), fit_flags=flags, **kw)
    for i in range(NB):
        a = (d["raw"][i], d["scl"][i], d["offs"][i], d["model"],
             d["noise"][i], d["masks"][i], d["freqs"], P0, d["nu_fit"][i],
             -1.0, theta0[i])
        ref = JP.fast_fit_one_packed(*[jnp.asarray(v) for v in a],
                                     fit_flags=JFlags(True, True), **kw)
        got = TP.fast_fit_one_packed(*[_t(v) for v in a], fit_flags=flags,
                                     **kw)
        _assert_one_vs_jax(got, ref, FIELDS[:3] + FIELDS[5:7] + FIELDS[9:])
        _assert_row(got, batch, i)
    with pytest.raises(ValueError, match="harmonic window"):
        TP.fast_fit_one_packed(*[_t(v) for v in a], fit_flags=flags,
                               **dict(kw, nharm_eff=None))


@pytest.mark.parametrize("nharm_eff", [None, NBIN // 2 + 1])
def test_fast_scatter_fit_one(data, fused_config, nharm_eff):
    """fast_scatter_fit_one (phi, DM, tau, alpha free, log10 tau) against
    the JAX one in float64, and bit for bit equal to its row of
    fast_scatter_fit_batched."""
    from pulseportraiture_tpu.fit.portrait import FitFlags as JFlags

    d = data
    flags = TP.FitFlags(True, True, False, True, True)
    kw = dict(log10_tau=True, max_iter=60, nharm_eff=nharm_eff,
              fit_fused=nharm_eff is not None)
    theta0 = np.zeros((NB, 5))
    theta0[:, 1] = 0.0005
    theta0[:, 3] = math.log10(0.008)
    theta0[:, 4] = -4.0
    batch = TP.fast_scatter_fit_batched(
        _t(d["ports"]), _t(d["model"]), _t(d["noise"]), _t(d["masks"]),
        _t(d["freqs"]), _t(d["P"]), _t(d["nu_fit"]),
        torch.full((NB,), -1.0, dtype=torch.float64), _t(theta0),
        fit_flags=flags, **kw)
    for i in range(NB):
        a = _args(d, i)[:8] + (theta0[i],)
        ref = JP.fast_scatter_fit_one(
            *[jnp.asarray(v) for v in a],
            fit_flags=JFlags(True, True, False, True, True), **kw)
        got = TP.fast_scatter_fit_one(*[_t(v) for v in a], fit_flags=flags,
                                      **kw)
        _assert_one_vs_jax(got, ref, FIELDS)
        _assert_row(got, batch, i)


# ---------------------------------------------------------------------
# names


def test_host_compute_and_on_host():
    """host_compute() makes the CPU the default device of the tensors
    made inside it; on_host runs a function under it and keeps its
    name."""
    from pulseportraiture_tpu_torch.utils import host_compute

    assert host_compute is TUD.host_compute
    with TUD.host_compute():
        assert torch.zeros(3).device.type == "cpu"

    @TUD.on_host
    def made(n):
        """doc"""
        return torch.arange(n)

    assert made(4).device.type == "cpu" and made.__name__ == "made"
    assert made.__doc__ == "doc"


def test_as_array_and_params_pytree():
    """FitFlags.as_array and GaussianModel.params_pytree give the JAX
    ones' values (float64; the dict's keys and values)."""
    from pulseportraiture_tpu.fit.portrait import FitFlags as JFlags

    for f in ((True, True), (True, True, True, False, True)):
        got = TP.FitFlags(*f).as_array()
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(JFlags(*f).as_array()))
    assert TP.FitFlags().as_array(torch.float32).dtype == torch.float32
    tm = default_test_model(1500.0)
    from pulseportraiture_tpu.synth import default_test_model as jdtm

    ref = jdtm(1500.0).params_pytree()
    got = tm.params_pytree(device="cpu")
    assert isinstance(tm, TMG.GaussianModel)
    assert isinstance(jdtm(1500.0), JMG.GaussianModel)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=0)


def test_enable_compile_cache_routes_build_dir(tmp_path, monkeypatch):
    """enable_compile_cache(path) points ops.fused.BUILD_DIR at the
    directory (made on demand) and returns it; None reads
    config.compile_cache_dir; a false value unconfigures back to the
    checkout's build/torch_kernels; nothing is built.  The library's
    directory under it is named by a digest of the sources, headers,
    flags and torch's CUDA."""
    monkeypatch.setattr(TFu, "BUILD_DIR", TFu.DEFAULT_BUILD_DIR)
    monkeypatch.setattr(TUD, "_compile_cache_dir", None)
    monkeypatch.setattr(tcfg, "compile_cache_dir", None)
    monkeypatch.setattr(TFu, "_lib", None)
    assert TUD.enable_compile_cache() is None
    assert TFu.BUILD_DIR == TFu.DEFAULT_BUILD_DIR
    assert TFu.DEFAULT_BUILD_DIR.endswith(os.path.join("build",
                                                       "torch_kernels"))
    path = str(tmp_path / "k" / "cache")
    assert TUD.enable_compile_cache(path) == path
    assert TFu.BUILD_DIR == path and os.path.isdir(path)
    assert os.listdir(path) == []
    assert TUD.enable_compile_cache(path) == path
    other = str(tmp_path / "other")
    monkeypatch.setattr(tcfg, "compile_cache_dir", other)
    assert TUD.enable_compile_cache() == other and TFu.BUILD_DIR == other
    monkeypatch.setattr(tcfg, "compile_cache_dir", None)
    assert TUD.enable_compile_cache() is None
    assert TFu.BUILD_DIR == TFu.DEFAULT_BUILD_DIR
    assert TUD.enable_compile_cache("") is None
    flags = ["-O3"]
    d1 = TFu._build_digest(flags)
    assert d1 == TFu._build_digest(flags) and len(d1) == 16
    assert TFu._build_digest(flags + ["-DX"]) != d1
    assert TFu._lib is None


def test_get_channels_to_zap_device_keyword(monkeypatch):
    """get_channels_to_zap(device=) is the JAX package's name of the
    zap tri-state (the port's zap_device=): either routes the same value
    to the resolver, and the two given apart raise."""
    from pulseportraiture_tpu_torch.pipeline import toas as TT
    from pulseportraiture_tpu_torch.pipeline import zap as TZ

    seen = []
    monkeypatch.setattr(TZ, "resolve_zap_device",
                        lambda z, dev: seen.append((z, dev)) or False)
    g = object.__new__(TT.GetTOAs)
    g.order, g.device = [], torch.device("cpu")
    assert g.get_channels_to_zap(device=True) == []
    assert g.get_channels_to_zap(zap_device="auto") == []
    assert g.get_channels_to_zap(8.0, 1.3, True, False, False) == []
    assert g.get_channels_to_zap(device=True, zap_device=True) == []
    assert [z for z, _ in seen] == [True, "auto", False, True]
    with pytest.raises(ValueError, match="zap_device"):
        g.get_channels_to_zap(device=True, zap_device=False)
