"""The PyTorch port's spline-template lane on the CPU, against the JAX
package.

- Ops (float64, 1e-12 relative to max |ref|): ops/phasor, ops/rotation,
  ops/noise.fourier_noise, models/spline.fft_resample (up, down, odd
  target nbin) and bspline_eval (knots with repeated ends, x at, below
  and above the knot range under the clamp-to-edge rule, ncomp = 0).
- Templates: the JAX package's pca and fit_spline_curve build a spline
  template from the default_test_model portrait and its
  write_spline_model writes it as .spl (pickle) and .npz; the port's
  read_spline_model and TemplateModel reproduce the JAX portrait to
  1e-12 relative at the model's nbin and at another data nbin (the
  Fourier resample plus the half-bin rotation).  The port's own pca is
  held to JAX's up to each eigenvector's sign.
- .tim parity with a .spl template (test_torch_toas._assert_tim_parity
  at its tolerances): GetTOAs' fused fast lane (window 128) on
  make_fake_pulsar archives, and stream_wideband_TOAs on forged int16
  and 2-bit archives (test_torch_stream._forge_set) with the template
  built from their tscrunched portrait.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import PAR
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.io.gmodel import gen_gmodel_portrait
from pulseportraiture_tpu.io.splmodel import SplineModel as JSplineModel
from pulseportraiture_tpu.io.splmodel import \
    write_spline_model as jwrite_spline
from pulseportraiture_tpu.models import spline as JSp
from pulseportraiture_tpu.ops import noise as JN
from pulseportraiture_tpu.ops import rotation as JR
from pulseportraiture_tpu.pipeline.models import TemplateModel as JTemplate
from pulseportraiture_tpu.synth import default_test_model
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.models import spline as TSp
from pulseportraiture_tpu_torch.ops import noise as TN
from pulseportraiture_tpu_torch.ops import phasor as TPh
from pulseportraiture_tpu_torch.ops import rotation as TR

# the JAX package's ops namespace exports a function named phasor
JPh = importlib.import_module("pulseportraiture_tpu.ops.phasor")

TOL = 1e-12


def _rel(got, ref):
    got = np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                  1e-300))


def _t(x):
    return torch.as_tensor(np.array(x, np.float64))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64))


# ---------------------------------------------------------------------
# ops

@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(61)
    return dict(freqs=np.linspace(1100.0, 1900.0, 12),
                port=rng.standard_normal((12, 64)),
                cube=rng.standard_normal((3, 2, 12, 64)),
                prof=rng.standard_normal(64),
                Ps=np.array([0.004, 0.0041, 0.0039]),
                snrs=rng.uniform(5.0, 50.0, 12),
                delays=rng.uniform(-0.5, 0.5, (3, 12)))


PHASOR_CASES = {
    "cexp": lambda m, a: m.cexp(a["cv"](a["delays"] * 7.0)),
    "phase_shifts": lambda m, a: m.phase_shifts(
        0.013, 0.002, 0.3, a["cv"](a["freqs"]), 0.004, 1400.0, 1500.0),
    "phasor": lambda m, a: m.phasor(a["cv"](a["delays"]), 33),
    "phase_transform_mod": lambda m, a: m.phase_transform(
        a["cv"](a["delays"]), 0.004, 1400.0, a["cv"](a["freqs"]), 0.004),
    "phase_transform_inf": lambda m, a: m.phase_transform(
        a["cv"](a["delays"]), 0.004, 1400.0, math.inf, 0.004, mod=False),
    "guess_fit_freq": lambda m, a: m.guess_fit_freq(a["cv"](a["freqs"])),
    "guess_fit_freq_snr": lambda m, a: m.guess_fit_freq(
        a["cv"](a["freqs"]), a["cv"](a["snrs"])),
    "doppler": lambda m, a: m.doppler_correct_freqs(a["cv"](a["freqs"]),
                                                    1.0001),
}


@pytest.mark.parametrize("case", sorted(PHASOR_CASES))
def test_phasor_f64(arrays, case):
    fn = PHASOR_CASES[case]
    ref = fn(JPh, dict(arrays, cv=_j))
    got = fn(TPh, dict(arrays, cv=_t))
    assert got.dtype in (torch.float64, torch.complex128)
    assert _rel(got, ref) <= TOL


ROTATION_CASES = {
    "fft_shift_bins": lambda m, a: m.fft_shift_bins(a["cv"](a["prof"]),
                                                    3.7),
    "rotate_profile": lambda m, a: m.rotate_profile(a["cv"](a["prof"]),
                                                    -0.123),
    "rotate_portrait_phi": lambda m, a: m.rotate_portrait(
        a["cv"](a["port"]), 0.21),
    "rotate_portrait_DM": lambda m, a: m.rotate_portrait(
        a["cv"](a["port"]), 0.21, DM=0.3, P=0.004,
        freqs=a["cv"](a["freqs"]), nu_ref=1500.0),
    "rotate_full": lambda m, a: m.rotate_full(
        a["cv"](a["cube"]), 0.05, 0.2, a["cv"](a["Ps"]),
        a["cv"](np.tile(a["freqs"], (3, 1)))),
    "add_DM_nu": lambda m, a: m.add_DM_nu(
        a["cv"](a["port"]), 0.02, [0.01, -0.003], [-2.0, -4.4], 0.004,
        a["cv"](a["freqs"]), 1500.0),
    "fft_rotate": lambda m, a: m.fft_rotate(a["cv"](a["prof"]), 5.25),
}


@pytest.mark.parametrize("case", sorted(ROTATION_CASES))
def test_rotation_f64(arrays, case):
    fn = ROTATION_CASES[case]
    ref = fn(JR, dict(arrays, cv=_j))
    got = fn(TR, dict(arrays, cv=_t))
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= TOL


def test_fft_rotate_is_rotate_profile(arrays):
    x = _t(arrays["prof"])
    assert _rel(TR.fft_rotate(x, 5.25), TR.rotate_profile(
        x, 5.25 / 64).numpy()) <= TOL
    np.testing.assert_allclose(TR.fft_rotate(x, 3).numpy(),
                               np.roll(arrays["prof"], -3), atol=1e-12)


def test_fourier_noise(arrays):
    noise = arrays["snrs"] / 10.0
    for nbin in (256, 2048, 1000):
        assert _rel(TN.fourier_noise(_t(noise), nbin),
                    JN.fourier_noise(_j(noise), nbin)) <= TOL


@pytest.mark.parametrize("nbin", [128, 100, 101, 64, 33])
def test_fft_resample_f64(arrays, nbin):
    """Up (128, 100, 101) and down (33) from 64 bins, odd targets
    included; 64 is the identity."""
    ref = JSp.fft_resample(_j(arrays["port"]), nbin)
    got = TSp.fft_resample(_t(arrays["port"]), nbin)
    assert _rel(got, ref) <= TOL


def _tck(repeated=True, ncomp=3, k=3):
    rng = np.random.default_rng(62)
    inner = np.linspace(1150.0, 1850.0, 5)
    t = (np.r_[[1100.0] * (k + 1), inner, [1900.0] * (k + 1)] if repeated
         else np.linspace(1000.0, 2000.0, 5 + 2 * (k + 1)))
    c = rng.standard_normal((ncomp, len(t) - k - 1))
    return (t, c, k)


X_CASES = {
    "inside": np.linspace(1120.0, 1880.0, 17),
    "at_knots": np.array([1100.0, 1150.0, 1325.0, 1850.0, 1900.0]),
    "below_above": np.array([900.0, 1099.999, 1900.001, 2500.0]),
}


@pytest.mark.parametrize("repeated", [True, False])
@pytest.mark.parametrize("xs", sorted(X_CASES))
def test_bspline_eval_f64(xs, repeated):
    """Against JAX's de Boor evaluation (its clamp-to-edge rule, not
    scipy's extrapolation); inside the range both equal scipy's splev."""
    tck = _tck(repeated)
    x = X_CASES[xs]
    ref = JSp.bspline_eval(_j(x), tck)
    got = TSp.bspline_eval(x, tck, device="cpu")
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= TOL
    if xs == "inside" and repeated:
        import scipy.interpolate as si

        t, c, k = tck
        sc = np.stack([si.splev(x, (t, ci, k)) for ci in c], axis=1)
        assert _rel(got, sc) <= 1e-10


def test_bspline_eval_ncomp_zero():
    """An ncomp = 0 curve (fit_spline_curve's return for no components)
    evaluates to an (nx, 0) array, and its portrait is the mean profile
    on every channel."""
    freqs = np.linspace(1100.0, 1900.0, 6)
    tck = JSp.fit_spline_curve(np.zeros((6, 0)), freqs)
    ref = np.asarray(JSp.bspline_eval(_j(freqs), tck))
    got = TSp.bspline_eval(freqs, tck, device="cpu").numpy()
    assert got.shape == ref.shape == (6, 0)
    mean = np.random.default_rng(63).standard_normal(32)
    port = TSp.gen_spline_portrait(mean, freqs, np.zeros((32, 0)), tck,
                                   device="cpu")
    np.testing.assert_array_equal(port.numpy(), np.tile(mean, (6, 1)))


# ---------------------------------------------------------------------
# spline templates

NCHAN_T, NBIN_T = 48, 512
FREQS_T = np.linspace(1100.0, 1900.0, NCHAN_T)


@pytest.fixture(scope="module")
def jax_template(tmp_path_factory):
    """A spline template built by the JAX package from the
    default_test_model portrait (48 channels x 512 bins, 3 components,
    a small smoothing factor) and written in both forms."""
    root = tmp_path_factory.mktemp("torch_spline")
    port = np.asarray(gen_gmodel_portrait(
        default_test_model(1500.0), np.arange(NBIN_T), FREQS_T))
    eigval, eigvec = JSp.pca(jnp.asarray(port))
    eigvec = np.asarray(eigvec)[:, :3]
    mean_prof = port.mean(axis=0)
    proj = (port - mean_prof) @ eigvec
    tck = JSp.fit_spline_curve(proj, FREQS_T, sfac=1e-6)
    model = JSplineModel("test", "J1744-1134", "synthetic", mean_prof,
                         eigvec, tck)
    paths = {ext: str(root / f"model.{ext}") for ext in ("spl", "npz")}
    for p in paths.values():
        jwrite_spline(model, p, quiet=True)
    return dict(root=root, port=port, eigval=np.asarray(eigval),
                eigvec=np.asarray(JSp.pca(jnp.asarray(port))[1]),
                model=model, paths=paths)


def test_pca_matches_jax_up_to_sign(jax_template):
    """Eigenvalues to 1e-10 of the largest; the leading three
    eigenvectors (eigenvalues 134, 2e-2, 4e-5: eigh's perturbation bound
    eps * lambda_max / gap is below 1e-9 for each) to 1e-8 after their
    signs are matched."""
    port = jax_template["port"]
    eigval, eigvec = TSp.pca(_t(port))
    ref_val, ref_vec = jax_template["eigval"], jax_template["eigvec"]
    assert _rel(eigval[:8], ref_val[:8]) <= 1e-10
    got = eigvec[:, :3].numpy()
    sign = np.sign(np.sum(got * ref_vec[:, :3], axis=0))
    assert np.all(np.abs(sign) == 1.0)
    assert _rel(got * sign, ref_vec[:, :3]) <= 1e-8
    rec = TSp.reconstruct_portrait(_t(port), _t(port.mean(0)),
                                   _t(ref_vec[:, :3]))
    ref_rec = JSp.reconstruct_portrait(_j(port), _j(port.mean(0)),
                                       _j(ref_vec[:, :3]))
    assert _rel(rec, ref_rec) <= TOL


@pytest.mark.parametrize("ext", ["spl", "npz"])
@pytest.mark.parametrize("nbin", [NBIN_T, 256, 1000])
def test_template_portrait_matches_jax(jax_template, ext, nbin):
    """TemplateModel (.spl pickle or .npz) at the model's nbin and at
    resampled data nbins, at frequencies inside and beyond the knots."""
    from pulseportraiture_tpu_torch.pipeline import TemplateModel

    path = jax_template["paths"][ext]
    freqs = np.r_[1050.0, np.linspace(1120.0, 1880.0, 20), 1950.0]
    ref = JTemplate(path).portrait(freqs, nbin)
    tm = TemplateModel(path, device="cpu")
    assert tm.kind == "spline" and tm.name == "test"
    assert tm.nu_ref_model == pytest.approx(1500.0)
    got = tm.portrait(freqs, nbin)
    assert got.dtype == np.float64
    assert _rel(got, ref) <= TOL


def test_spline_model_from_fields(jax_template):
    """The JAX SplineModel crosses through convert, the port's files
    round-trip, and the model coordinates agree."""
    from pulseportraiture_tpu.io.splmodel import \
        spline_model_coords as jcoords
    from pulseportraiture_tpu_torch.convert import spline_model_from_fields
    from pulseportraiture_tpu_torch.io.splmodel import (
        read_spline_model, spline_model_coords, write_spline_model)

    jm = jax_template["model"]
    tm = spline_model_from_fields(jm)
    assert _rel(tm.portrait(FREQS_T, device="cpu"),
                jm.portrait(FREQS_T)) <= TOL
    assert _rel(spline_model_coords(tm, FREQS_T, device="cpu"),
                jcoords(jm, FREQS_T)) <= TOL
    for ext in ("spl", "npz"):
        p = str(jax_template["root"] / f"port.{ext}")
        write_spline_model(tm, p, quiet=True)
        back = read_spline_model(p, quiet=True)
        np.testing.assert_array_equal(back.eigvec, tm.eigvec)
        np.testing.assert_array_equal(back.tck[1], tm.tck[1])
        assert back.freq_range() == (1100.0, 1900.0)


def test_gen_spline_portrait_recovers_model(jax_template):
    """Sanity on the template itself: the spline portrait follows the
    Gaussian model it was built from."""
    port = jax_template["port"]
    jm = jax_template["model"]
    got = TSp.gen_spline_portrait(jm.mean_prof, FREQS_T, jm.eigvec, jm.tck,
                                  device="cpu").numpy()
    assert np.max(np.abs(got - port)) < 1e-3 * np.max(port)


def test_port_builds_template_as_jax(jax_template, tmp_path):
    """The port's pca and fit_spline_curve give the JAX template's
    portrait (eigenvector signs cancel in proj . eigvec^T)."""
    port = jax_template["port"]
    _, eigvec = TSp.pca(_t(port))
    eigvec = eigvec[:, :3].numpy()
    mean_prof = port.mean(axis=0)
    tck = TSp.fit_spline_curve((port - mean_prof) @ eigvec, FREQS_T,
                               sfac=1e-6)
    got = TSp.gen_spline_portrait(mean_prof, FREQS_T, eigvec, tck,
                                  device="cpu").numpy()
    jm = jax_template["model"]
    ref = np.asarray(JSp.gen_spline_portrait(jm.mean_prof, FREQS_T,
                                             jm.eigvec, jm.tck))
    assert _rel(got, ref) <= 1e-7


# ---------------------------------------------------------------------
# .tim parity with a .spl template

@pytest.fixture
def fused_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def test_gettoas_tim_parity_spl(jax_template, fused_config, tmp_path):
    """GetTOAs' fused fast lane with the .spl template (512 bins) on
    256-bin archives: the template is resampled on both sides."""
    from pulseportraiture_tpu.io.tim import write_TOAs as jwrite
    from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
    from pulseportraiture_tpu.synth import make_fake_pulsar
    from pulseportraiture_tpu.utils.mjd import MJD
    from pulseportraiture_tpu_torch.io.tim import write_TOAs as twrite
    from pulseportraiture_tpu_torch.ops import fused as TFu
    from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs

    files = []
    for i, dDM in enumerate((2e-4, -3e-4)):
        path = str(tmp_path / f"fake-{i}.fits")
        make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path,
                         nsub=3, nchan=32, nbin=256, nu0=1500.0, bw=800.0,
                         tsub=60.0, phase=0.01 * i, dDM=dDM,
                         start_MJD=MJD(55100 + 10 * i, 0.1), noise_stds=1.0,
                         dedispersed=False, quiet=True, rng=900 + i)
        files.append(path)
    spl = jax_template["paths"]["spl"]
    jg = JGetTOAs(files, spl, quiet=True)
    jg.get_TOAs(quiet=True)
    calls = []
    orig = TFu.fused_cross_spectrum_ref

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    TFu.fused_cross_spectrum_ref = spy
    try:
        tg = TGetTOAs(files, spl, quiet=True, device="cpu")
        tg.get_TOAs(quiet=True)
    finally:
        TFu.fused_cross_spectrum_ref = orig
    assert len(calls) >= 2  # the fused lane ran (its plain version)
    ref, got = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(jg.TOA_list, outfile=ref)
    twrite(tg.TOA_list, outfile=got)
    _assert_tim_parity(ref, got)
    for i in range(2):
        np.testing.assert_array_equal(tg.nfevals[i], jg.nfevals[i])


@pytest.fixture(scope="module")
def forged_spl(tmp_path_factory):
    """Forged int16 and 2-bit archives (header DM 0) and a .spl template
    built by the JAX package from their tscrunched int16 portrait."""
    from test_torch_stream import _forge_set

    from pulseportraiture_tpu.pipeline.models import TemplateModel

    root = tmp_path_factory.mktemp("torch_spline_stream")
    meta, files, tmpl = _forge_set(root, ("int16", "nbit2"), 0.0)
    tm = TemplateModel(tmpl)
    freqs = np.asarray(tm.fits_freqs, float)
    port = np.asarray(tm.fits_port, float)
    _, eigvec = JSp.pca(jnp.asarray(port))
    eigvec = np.asarray(eigvec)[:, :2]
    mean_prof = port.mean(axis=0)
    order = np.argsort(freqs)
    tck = JSp.fit_spline_curve(((port - mean_prof) @ eigvec)[order],
                               freqs[order], sfac=1e-3, k=3)
    spl = str(root / "forged.spl")
    jwrite_spline(JSplineModel("forged", "forged", tmpl, mean_prof,
                               eigvec, tck), spl, quiet=True)
    return root, meta, files, spl


def test_stream_tim_parity_spl(forged_spl, fused_config):
    """stream_wideband_TOAs with the .spl template on the forged int16
    and 2-bit archives: the raw lane with B1's and B2's plain versions
    on the port's side."""
    from test_torch_stream import _spy_b2, _tim_lines

    from pulseportraiture_tpu.pipeline import stream as JS
    from pulseportraiture_tpu_torch.pipeline import stream as TS

    root, meta, files, spl = forged_spl
    ref, got = str(root / "jax.tim"), str(root / "torch.tim")
    JS.stream_wideband_TOAs(meta, spl, nsub_batch=4, quiet=True,
                            tim_out=ref)
    mp = pytest.MonkeyPatch()
    try:
        calls = _spy_b2(mp)
        res = TS.stream_wideband_TOAs(meta, spl, nsub_batch=4, quiet=True,
                                      tim_out=got, device="cpu")
    finally:
        mp.undo()
    # one 2-bit bucket of 2 subints, padded to nsub_batch
    assert calls == [("p2", 4)]
    assert len(res.TOA_list) == 4
    _assert_tim_parity(_tim_lines(ref, root / "jax_lines.tim"),
                       _tim_lines(got, root / "torch_lines.tim"))
