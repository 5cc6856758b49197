"""The PyTorch port's align-and-average (ppalign) on the CPU, against the
JAX package: ops.fourier.rfft_sr/irfft_sr, models.gaussian.
gen_gaussian_profile, models.wavelet, parallel.batch's align programs,
pipeline.align and cli.ppalign, and pptoas with ppalign's output as the
template.

The corpus is tests/test_pipeline_align.py's: 3 epochs x 2 subints x 24
channels x 256 bins with phases (0, 0.11, -0.07) and dDM (0, 1e-4,
2e-4).  Gates, relative to max |ref|:
- the ops in float64: rfft_sr/irfft_sr, the rotation and the delays /
  weights 1e-12; the Gaussian seeds 1e-12; swt/iswt, wavelet_smooth,
  smart_smooth 1e-10;
- the accumulate + finalize against JAX's at nb below, at and above the
  chunk, and the host lane against the device lane: 1e-10;
- align_archives, niter=2: the complex engine (float64 in both) 1e-10;
  the fast route (float32 fits; JAX's Pallas kernel interpreted, the
  port's plain B1) corr > 0.99999 and max |d| < 0.02 (the JAX package's
  own float32-vs-float64 bounds, test_align_fast_routing_matches);
- the CLI: the written archives field by field, amplitudes within 1e-4
  of max |ref| (both packages write int16: one or two quantization
  steps of the channel's range);
- pptoas -m aligned.fits: .tim parity with the JAX pptoas, and the
  port's stream within 0.1 sigma of its GetTOAs.
"""

import numpy as np
import pytest
import torch

from test_torch_helpers import rel_err
from test_torch_stream import _max_sigma
from test_torch_toas import _assert_tim_parity

import jax.numpy as jnp

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.io.gmodel import gen_gmodel_portrait
from pulseportraiture_tpu.io.psrfits import load_data as jload
from pulseportraiture_tpu.models import wavelet as JW
from pulseportraiture_tpu.models.gaussian import (
    gen_gaussian_profile as j_profile)
from pulseportraiture_tpu.ops import fourier as JF
from pulseportraiture_tpu.parallel import batch as JB
from pulseportraiture_tpu.pipeline import align as JA
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.models import wavelet as TW
from pulseportraiture_tpu_torch.models.gaussian import (
    gen_gaussian_profile as t_profile)
from pulseportraiture_tpu_torch.ops import fourier as TF
from pulseportraiture_tpu_torch.parallel import batch as TB
from pulseportraiture_tpu_torch.pipeline import align as TA

# the pulsar of tests/test_pipeline_align.py
PAR = {"PSR": "J0613-0200", "RAJ": "06:13:43.9", "DECJ": "-02:00:47.2",
       "P0": 0.003062, "PEPOCH": 55000.0, "DM": 38.779}


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """tests/test_pipeline_align.py's forged epochs, written by the JAX
    package."""
    root = tmp_path_factory.mktemp("talign")
    model = default_test_model(1500.0)
    files = []
    for i, phase in enumerate([0.0, 0.11, -0.07]):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=24,
                         nbin=256, nu0=1500.0, bw=600.0, tsub=60.0,
                         phase=phase, dDM=1e-4 * i,
                         start_MJD=MJD(55100 + i, 0.2), noise_stds=0.06,
                         dedispersed=False, quiet=True, rng=i)
        files.append(path)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return str(meta), files, model


@pytest.fixture
def fast_route():
    """Both packages on the fast fit with the fused stage and an explicit
    window (JAX's Pallas kernel interpreted, the port's plain B1)."""
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_pallas = True
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _noisy_portrait(nchan=8, nbin=256, noise=0.05, seed=3):
    model = default_test_model(1500.0)
    freqs = np.linspace(1200.0, 1800.0, nchan)
    port = np.asarray(gen_gmodel_portrait(model, np.arange(nbin), freqs))
    rng = np.random.default_rng(seed)
    return port + noise * rng.standard_normal(port.shape)


def _corr(a, b):
    a = a.ravel() - a.mean()
    b = b.ravel() - b.mean()
    return float(a @ b / np.sqrt((a @ a) * (b @ b)))


# ---------------------------------------------------------------------------
# ops, float64

@pytest.mark.parametrize("n", [256, 255])
def test_rfft_sr_irfft_sr(n):
    x = np.random.default_rng(0).standard_normal((3, 5, n))
    jr, ji = JF.rfft_sr(jnp.asarray(x))
    tr, ti = TF.rfft_sr(torch.from_numpy(x))
    assert rel_err(tr, jr) < 1e-12 and rel_err(ti, ji) < 1e-12
    back_j = JF.irfft_sr(jr, ji, n=n)
    back_t = TF.irfft_sr(tr, ti, n=n)
    assert rel_err(back_t, back_j) < 1e-12
    assert rel_err(back_t, x) < 1e-12


def test_align_rotate_real():
    rng = np.random.default_rng(1)
    cr, ci = rng.standard_normal((2, 4, 2, 6, 65))
    delays = rng.uniform(-0.5, 0.5, (4, 6))
    jr, ji = JB._align_rotate_real(jnp.asarray(cr), jnp.asarray(ci),
                                   jnp.asarray(delays))
    tr, ti = TB._align_rotate_real(torch.from_numpy(cr),
                                   torch.from_numpy(ci),
                                   torch.from_numpy(delays))
    assert rel_err(tr, jr) < 1e-12 and rel_err(ti, ji) < 1e-12


def test_align_weights_nan_scales():
    """Delays wrapped to [-0.5, 0.5) and weights mask * max(scale, 0) /
    noise^2: masked channels weigh exactly 0 with NaN scales there, and a
    non-positive noise weighs 0."""
    rng = np.random.default_rng(2)
    nb, nchan = 5, 12
    phi = rng.uniform(-0.5, 0.5, nb)
    DM = rng.uniform(-0.5, 0.5, nb) + 30.0
    nu_ref = rng.uniform(1300.0, 1600.0, nb)
    P = np.full(nb, 0.003)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    noise = rng.uniform(0.5, 2.0, (nb, nchan))
    noise[1, 3] = 0.0
    masks = (rng.uniform(size=(nb, nchan)) > 0.3).astype(float)
    scales = rng.uniform(-0.2, 2.0, (nb, nchan))
    scales[masks == 0] = np.nan
    args = (phi, DM, nu_ref, P, freqs, noise, masks, scales)
    jd, jw = JB._align_weights_fn("float64")(*map(jnp.asarray, args))
    td, tw = TB._align_weights(*map(torch.from_numpy, args))
    assert rel_err(td, jd) < 1e-12 and rel_err(tw, jw) < 1e-12
    tw = tw.numpy()
    assert np.all(np.isfinite(tw)) and np.all(tw[masks == 0] == 0.0)
    assert tw[1, 3] == 0.0 and np.all(tw >= 0.0)
    assert np.all(np.abs(td.numpy()) <= 0.5)


def test_use_align_device():
    assert TB.use_align_device(True, "cpu") is True
    assert TB.use_align_device(False, "cpu") is False
    assert TB.use_align_device("auto", "cpu") is False
    with pytest.raises(ValueError):
        TB.use_align_device("ture", "cpu")


@pytest.mark.parametrize("which", ["profile", "seed", "constant"])
def test_gaussian_and_constant_seeds(which, epochs):
    if which == "profile":
        params = {"dc": 0.1, "locs": np.array([0.3, 0.55]),
                  "wids": np.array([0.05, 0.02]),
                  "amps": np.array([1.0, 2.5]), "mlocs": np.zeros(2),
                  "mwids": np.zeros(2), "mamps": np.zeros(2),
                  "tau": 0.0, "alpha": 0.0}
        ref = j_profile(params, 256, scattered=False)
        got = t_profile(params, 256, scattered=False, device="cpu")
    elif which == "seed":
        ref = JA.gaussian_seed_portrait(24, 256, fwhm=0.05)
        got = TA.gaussian_seed_portrait(24, 256, fwhm=0.05, device="cpu")
    else:
        _, files, _ = epochs
        ref = JA.make_constant_portrait(files[1], 24)
        got = TA.make_constant_portrait(files[1], 24)
        assert rel_err(TA.make_constant_portrait(ref[0], 24), ref) == 0.0
    assert np.asarray(got).shape == np.asarray(ref).shape
    assert rel_err(got, ref) < 1e-12


# ---------------------------------------------------------------------------
# wavelets, float64

def test_swt_iswt():
    x = _noisy_portrait()
    jA, jD = JW.swt(jnp.asarray(x), nlevel=5)
    tA, tD = TW.swt(x, nlevel=5, device="cpu")
    assert rel_err(tA, jA) < 1e-10 and rel_err(tD, jD) < 1e-10
    back = TW.iswt(tA, tD)
    assert rel_err(back, JW.iswt(jA, jD)) < 1e-10
    assert rel_err(back, x) < 1e-10  # perfect reconstruction
    lo, hi = TW.daubechies(8)
    jlo, jhi = JW.daubechies(8)
    assert rel_err(lo, jlo) == 0.0 and rel_err(hi, jhi) == 0.0


@pytest.mark.parametrize("threshtype,fact,one", [("hard", 1.0, False),
                                                 ("soft", 0.7, False),
                                                 ("hard", 1.3, True)])
def test_wavelet_smooth(threshtype, fact, one):
    x = _noisy_portrait()
    if one:
        x = x[3]
    ref = JW.wavelet_smooth(jnp.asarray(x), nlevel=5, threshtype=threshtype,
                            fact=fact)
    got = TW.wavelet_smooth(x, nlevel=5, threshtype=threshtype, fact=fact,
                            device="cpu")
    assert rel_err(got, ref) < 1e-10


def test_smart_smooth_and_red_chi2():
    x = _noisy_portrait(nchan=4)
    x[2] = 0.0  # an all-zero profile is zeroed, not smoothed
    ref = JW.smart_smooth(jnp.asarray(x), try_nlevels=4, nfact=12)
    got = TW.smart_smooth(x, try_nlevels=4, nfact=12, device="cpu")
    assert rel_err(got, ref) < 1e-10
    assert np.all(got[2].numpy() == 0.0) and np.any(got[0].numpy() != 0.0)
    sj = JW._smooth_score_grid(jnp.asarray(x[0]), 3, nfact=12)
    st = TW._smooth_score_grid(torch.from_numpy(x[0]), 3, nfact=12)
    for a, b in zip(st, sj):
        assert rel_err(a, b) < 1e-10
    live = np.array([0, 1, 3])
    sm = np.asarray(ref)[live]
    assert float(TW.get_red_chi2(x[live], sm, device="cpu")) == \
        pytest.approx(float(JW.get_red_chi2(x[live], sm)), rel=1e-10)
    assert float(TW.get_red_chi2(x[0], ref[0], errs=0.05, dof=100,
                                 device="cpu")) == pytest.approx(
        float(JW.get_red_chi2(x[0], ref[0], errs=0.05, dof=100)), rel=1e-10)


# ---------------------------------------------------------------------------
# the accumulate

def _archive_leaves(nb, npol=1, nchan=8, nbin=64, seed=4):
    rng = np.random.default_rng(seed)
    cube = rng.standard_normal((nb, npol, nchan, nbin))
    phi = rng.uniform(-0.5, 0.5, nb)
    DM = 3.0 + 1e-3 * rng.standard_normal(nb)
    nu_ref = rng.uniform(1300.0, 1600.0, nb)
    P = np.full(nb, 0.004)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    noise = rng.uniform(0.5, 2.0, (nb, nchan))
    masks = (rng.uniform(size=(nb, nchan)) > 0.2).astype(float)
    scales = rng.uniform(0.1, 2.0, (nb, nchan))
    return cube, (phi, DM, nu_ref, P, freqs, noise, masks, scales)


@pytest.mark.parametrize("nb", [5, 8, 19])
def test_accumulate_and_finalize(nb):
    """Two archives into one accumulator, chunk 8: below, at and above
    (not a multiple of) the chunk; the port's host lane against its
    device lane on the same leaves."""
    npol, nchan, nbin = 2, 8, 64
    archives = [_archive_leaves(nb, npol, nchan, nbin, seed=s)
                for s in (4, 5)]
    jacc = JB.align_accumulator_init(npol, nchan, nbin, jnp.float64)
    tacc = TB.align_accumulator_init(npol, nchan, nbin, torch.float64,
                                     device="cpu")
    for cube, leaves in archives:
        jacc = JB.align_accumulate_archive(jacc, cube, *leaves, chunk=8)
        TB.align_accumulate_archive(tacc, cube, *leaves, chunk=8)
    ref = np.asarray(JB.align_finalize(jacc, nbin))
    got = TB.align_finalize(tacc, nbin).numpy()
    assert rel_err(got, ref) < 1e-10
    for a, b in zip(tacc, jacc):
        assert rel_err(a, b) < 1e-10

    aligned_FT = np.zeros((npol, nchan, nbin // 2 + 1), complex)
    total_weights = np.zeros((nchan, nbin))
    for cube, (phi, DM, nu_ref, P, freqs, noise, masks, scales) in archives:
        TA._host_accumulate_archive(aligned_FT, total_weights, cube, phi, DM,
                                    nu_ref, P, freqs, noise, masks,
                                    scales * masks)
    host = np.fft.irfft(aligned_FT, n=nbin) / total_weights[None]
    assert rel_err(host, got) < 1e-10


# ---------------------------------------------------------------------------
# align_archives

def test_align_complex_engine_matches_jax(epochs, tmp_path):
    """use_fast_fit 'auto' is the complex engine off the card in both
    packages: float64 end to end."""
    meta, files, _ = epochs
    ref = JA.align_archives(meta, files[0], outfile=str(tmp_path / "j.fits"),
                            niter=2, quiet=True)
    got = TA.align_archives(meta, files[0], outfile=str(tmp_path / "t.fits"),
                            niter=2, quiet=True, device="cpu")
    assert got.shape == ref.shape == (1, 24, 256)
    assert rel_err(got, ref) < 1e-10
    dev = TA.align_archives(meta, files[0], outfile=str(tmp_path / "d.fits"),
                            niter=2, quiet=True, device="cpu",
                            align_device=True)
    assert rel_err(dev, got) < 1e-10
    st = TA.align_stats()
    assert st["skipped"] == [] and len(st["iterations"]) == 2
    assert all(it["archives"] == 3 for it in st["iterations"])
    assert all(st["walls"][k] >= 0.0 for k in ("load", "guess", "fit",
                                                "accumulate", "write"))


@pytest.mark.parametrize("seed", ["data", "gaussian"])
def test_align_fast_route_matches_jax(epochs, fast_route, tmp_path, seed):
    meta, files, _ = epochs
    init = files[0] if seed == "data" else \
        JA.gaussian_seed_portrait(24, 256, fwhm=0.05)
    ref = JA.align_archives(meta, init, outfile=str(tmp_path / "j.fits"),
                            niter=2, quiet=True)
    got = TA.align_archives(meta, init, outfile=str(tmp_path / "t.fits"),
                            niter=2, quiet=True, device="cpu")
    assert _corr(got, ref) > 0.99999
    assert np.abs(got - ref).max() < 0.02 * np.abs(ref).max()
    assert [it["K"] for it in TA.align_stats()["iterations"]] == [128, 128]


def test_align_recovers_clean_portrait(epochs, tmp_path):
    """tests/test_pipeline_align.py's recovery test on the port."""
    from pulseportraiture_tpu_torch.io.psrfits import load_data

    meta, files, model = epochs
    out = str(tmp_path / "avg.fits")
    avg = TA.align_archives(meta, files[0], outfile=out, niter=2, quiet=True,
                            device="cpu")
    d = load_data(out, quiet=True)
    assert d.DM == 0.0 and d.dmc
    clean = np.asarray(gen_gmodel_portrait(
        model, d.phases, np.asarray(d.freqs[0]), P=PAR["P0"]))
    a = avg[0] - avg[0].mean(axis=1, keepdims=True)
    c = clean - clean.mean(axis=1, keepdims=True)
    ccf = np.fft.irfft(np.fft.rfft(a, axis=1).conj()
                       * np.fft.rfft(c, axis=1), axis=1).sum(axis=0)
    assert ccf.max() / np.sqrt((a ** 2).sum() * (c ** 2).sum()) > 0.95
    resid = np.sqrt(((a - np.roll(c, np.argmax(ccf), axis=1)) ** 2).mean())
    assert resid < 0.06


def test_align_device_flip_and_skips(epochs, tmp_path, monkeypatch):
    """config.align_device is read per call; an unreadable archive is
    skipped and recorded, and the run goes on."""
    meta, files, _ = epochs
    calls = []
    real = TA.align_accumulate_archive
    monkeypatch.setattr(TA, "align_accumulate_archive",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tcfg, "align_device", True)
    bogus = str(tmp_path / "missing.fits")
    TA.align_archives(files[:1] + [bogus], files[0], niter=2, quiet=True,
                      outfile=str(tmp_path / "on.fits"), device="cpu")
    assert len(calls) == 2
    assert [p for p, _ in TA.align_stats()["skipped"]] == [bogus]
    monkeypatch.setattr(tcfg, "align_device", False)
    TA.align_archives(files[:1], files[0], niter=1, quiet=True,
                      outfile=str(tmp_path / "off.fits"), device="cpu")
    assert len(calls) == 2
    with pytest.raises(RuntimeError):
        TA.align_archives(files, files[0], SNR_cutoff=1e9, quiet=True,
                          outfile=str(tmp_path / "none.fits"), device="cpu")


# ---------------------------------------------------------------------------
# the CLI

def _assert_same_archive(ref_path, got_path):
    """The written archives field by field: layout, DM 0, dmc 1, unit
    weights, frequencies and periods equal, amplitudes within 1e-4 of
    max |ref| (int16 quantization)."""
    r = jload(ref_path, quiet=True)
    g = jload(got_path, quiet=True)
    assert g.subints.shape == r.subints.shape
    assert g.DM == r.DM == 0.0 and g.dmc and r.dmc
    assert np.all(g.weights == 1.0) and np.all(r.weights == 1.0)
    assert np.array_equal(g.freqs, r.freqs) and np.array_equal(g.Ps, r.Ps)
    assert g.state == r.state
    assert rel_err(g.subints, r.subints) < 1e-4


@pytest.mark.parametrize("args", [
    ["-P"], ["-g", "0.05"], ["-s"], ["-N", "rms"], ["-N", "prof"],
    ["--place", "0.3"], ["-r", "0.1"], ["-D"], ["-T"], ["-C", "10"],
    ["--align-device", "on"], ["--align-device", "off", "--niter", "2"],
    ["-I", "EP1"]], ids=lambda a: "_".join(a))
def test_cli_matches_jax(epochs, tmp_path, args):
    """The complex engine route (float64 in both packages)."""
    from pulseportraiture_tpu.cli.ppalign import main as jmain
    from pulseportraiture_tpu_torch.cli.ppalign import main as tmain

    meta, files, _ = epochs
    args = [files[1] if a == "EP1" else a for a in args]
    jout, tout = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    assert jmain(["-M", meta, "-o", jout] + args) == 0
    assert tmain(["-M", meta, "-o", tout, "--device", "cpu"] + args) == 0
    _assert_same_archive(jout, tout)
    if "-s" in args:
        _assert_same_archive(str(tmp_path / "j.sm.fits"),
                             str(tmp_path / "t.sm.fits"))


def test_cli_keeps_polarization(tmp_path):
    """-p: Stokes archives keep their four polarizations."""
    from pulseportraiture_tpu.cli.ppalign import main as jmain
    from pulseportraiture_tpu_torch.cli.ppalign import main as tmain

    model = default_test_model(1500.0)
    files = []
    for i, phase in enumerate([0.0, 0.11]):
        path = str(tmp_path / f"p{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, npol=4, nchan=24,
                         nbin=256, nu0=1500.0, bw=600.0, tsub=60.0,
                         phase=phase, dDM=1e-4 * i,
                         start_MJD=MJD(55100 + i, 0.2), noise_stds=0.06,
                         dedispersed=False, quiet=True, rng=10 + i)
        files.append(path)
    meta = tmp_path / "pmeta.txt"
    meta.write_text("\n".join(files) + "\n")
    jout, tout = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    assert jmain(["-M", str(meta), "-o", jout, "-p"]) == 0
    assert tmain(["-M", str(meta), "-o", tout, "-p", "--device", "cpu"]) == 0
    _assert_same_archive(jout, tout)
    assert jload(tout, quiet=True).npol == 4


# ---------------------------------------------------------------------------
# pptoas with the aligned template

def test_pptoas_with_aligned_template(epochs, tmp_path):
    """ppalign's output (DM 0, dmc 1, unit weights) as pptoas -m: the
    port's GetTOAs against the JAX pptoas (.tim parity), and the port's
    stream within 0.1 sigma of its GetTOAs, the fast lane and the fused
    stage forced with a window in both packages.  The timed archive has
    the noise of tests/test_torch_toas.py's dataset (1.0; TOA errors
    ~0.3 us): on the template's own epochs (TOA errors 0.02 us) the
    float32 fast lane's rounding is a sizeable part of sigma, and the
    JAX package's own float32 and float64 lanes differ there by 2.5
    sigma."""
    from pulseportraiture_tpu.cli.pptoas import main as jpptoas
    from pulseportraiture_tpu_torch.cli.pptoas import main as tpptoas

    meta, files, model = epochs
    tmpl = str(tmp_path / "aligned.fits")
    TA.align_archives(meta, files[0], outfile=tmpl, niter=2, quiet=True,
                      device="cpu")
    data = str(tmp_path / "data.fits")
    make_fake_pulsar(model, PAR, outfile=data, nsub=3, nchan=24, nbin=256,
                     nu0=1500.0, bw=600.0, tsub=60.0, phase=0.02, dDM=1e-4,
                     start_MJD=MJD(55200, 0.3), noise_stds=1.0,
                     dedispersed=False, quiet=True, rng=21)
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_pallas = False
    try:
        jt, tt, st = (str(tmp_path / f"{n}.tim") for n in "jts")
        assert jpptoas(["-d", data, "-m", tmpl, "-o", jt, "--quiet"]) == 0
        assert tpptoas(["-d", data, "-m", tmpl, "-o", tt, "--quiet",
                        "--device", "cpu"]) == 0
        assert tpptoas(["--stream", "-d", data, "-m", tmpl, "-o", st,
                        "--quiet", "--device", "cpu"]) == 0
    finally:
        for k, v in old_j.items():
            setattr(jcfg, k, v)
        for k, v in old_t.items():
            setattr(tcfg, k, v)
    _assert_tim_parity(jt, tt)
    assert _max_sigma(tt, st) < 0.1
