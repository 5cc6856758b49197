"""The PyTorch port's template building on the CPU, against the JAX
package: models.spline.find_significant_eigvec, pipeline.portrait.
DataPortrait (single archive and JOIN), pipeline.gauss (make_gaussian_
model, the JOIN fit), pipeline.spline (make_spline_model), cli.ppgauss
and cli.ppspline flag by flag, and pptoas with the templates they write.

The corpus is tests/test_cli.py's workspace (2 archives x 3 subints x 32
channels x 256 bins, noise 0.07) plus a JOIN pair of 16-channel
receivers (1100-1500 and 1500-1900 MHz; the second with an injected
phase of 0.05 rot and dDM 1e-4), all written by the JAX package.
Gates:
- find_significant_eigvec: the same ieig, the smoothed eigenvectors to
  1e-10 x max|ref|;
- DataPortrait: arrays to 1e-12 x max|ref|, the seeded JOIN parameters
  to 1e-10;
- .gmodel files (and error files) parsed field by field: each parameter
  within 1e-6 x its error (the error files' entries within 1e-6
  relative), names, codes and flags equal;
- make_spline_model: the same ncomp, the model portrait to 1e-8 x
  max|ref|;
- pptoas -m a built template: .tim parity with the JAX pptoas run with
  the JAX-built template (tests/test_torch_toas._assert_tim_parity), and
  the port's stream within 0.1 sigma of its GetTOAs.
"""

import os

import numpy as np
import pytest

from test_torch_helpers import image_arrays, rel_err, saved_figures
from test_torch_stream import _max_sigma
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.cli import ppgauss as jppgauss
from pulseportraiture_tpu.cli import ppspline as jppspline
from pulseportraiture_tpu.io.gmodel import read_gmodel
from pulseportraiture_tpu.io.splmodel import read_spline_model
from pulseportraiture_tpu.models.spline import (
    find_significant_eigvec as j_fse, pca as j_pca)
from pulseportraiture_tpu.pipeline.gauss import GaussPortrait as JGauss
from pulseportraiture_tpu.pipeline.portrait import DataPortrait as JDP
from pulseportraiture_tpu.pipeline.spline import SplinePortrait as JSpline
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.cli import ppgauss as tppgauss
from pulseportraiture_tpu_torch.cli import ppspline as tppspline
from pulseportraiture_tpu_torch.models.spline import (
    find_significant_eigvec as t_fse)
from pulseportraiture_tpu_torch.pipeline.gauss import GaussPortrait as TGauss
from pulseportraiture_tpu_torch.pipeline.portrait import DataPortrait as TDP
from pulseportraiture_tpu_torch.pipeline.spline import (
    SplinePortrait as TSpline)

# the pulsar of tests/test_cli.py
PAR = {"PSR": "J2145-0750", "RAJ": "21:45:50.5", "DECJ": "-07:50:18.5",
       "P0": 0.016052, "PEPOCH": 55000.0, "DM": 9.003}
JOIN_PHASE, JOIN_DDM = 0.05, 1e-4


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """tests/test_cli.py's archives and a JOIN pair, written by the JAX
    package; returns (root, files, join_meta)."""
    root = tmp_path_factory.mktemp("ttemplate")
    model = default_test_model(1500.0)
    files = []
    for i, dDM in enumerate([4e-4, -2e-4]):
        path = str(root / f"example-{i + 1}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=3, nchan=32,
                         nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                         dDM=dDM, start_MJD=MJD(55150 + 10 * i, 0.3),
                         noise_stds=0.07, dedispersed=False, quiet=True,
                         rng=50 + i)
        files.append(path)
    joins = []
    for i, (nu0, phase, dDM) in enumerate(((1300.0, 0.0, 0.0),
                                           (1700.0, JOIN_PHASE, JOIN_DDM))):
        path = str(root / f"rcvr-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=16,
                         nbin=256, nu0=nu0, bw=400.0, tsub=60.0,
                         phase=phase, dDM=dDM, start_MJD=MJD(55300, 0.3),
                         noise_stds=0.07, dedispersed=False, quiet=True,
                         rng=70 + i)
        joins.append(path)
    meta = root / "join.meta"
    meta.write_text("\n".join(joins) + "\n")
    return root, files, str(meta)


def _gmodel_close(got_path, ref_path, err_path, errfile=False):
    """Parse two .gmodel files and hold each parameter within 1e-6 x its
    error (from the JAX run's error file); an error file is held to 1e-6
    relative."""
    got, ref = read_gmodel(got_path, quiet=True), read_gmodel(ref_path,
                                                             quiet=True)
    err = read_gmodel(err_path, quiet=True)
    assert (got.name, got.code, got.ngauss) == (ref.name, ref.code,
                                                ref.ngauss)
    assert got.nu_ref == pytest.approx(ref.nu_ref, abs=1e-5)
    for k in ("dc", "tau", "alpha", "locs", "wids", "amps", "mlocs",
              "mwids", "mamps"):
        g, r = np.asarray(getattr(got, k)), np.asarray(getattr(ref, k))
        e = np.abs(np.asarray(getattr(err, k), float))
        # the file prints 8 decimals (3 for alpha): two values a hair
        # apart can print one unit of the last digit apart, the floor of
        # any comparison of the files
        floor = 1e-3 if k == "alpha" else 1e-8
        tol = (1e-6 * np.maximum(np.abs(r), 1e-300) if errfile
               else 1e-6 * e)
        assert np.all(np.abs(g - r) <= tol + floor), k
    for k, v in ref.fit_flags.items():
        assert np.array_equal(np.asarray(got.fit_flags[k]), np.asarray(v)), k


# --------------------------------------------------------------------------
# find_significant_eigvec

@pytest.mark.parametrize("snr_cutoff", [20.0, 150.0])
def test_find_significant_eigvec(ws, snr_cutoff):
    root, files, _ = ws
    dp = JDP(files[0], quiet=True)
    eigval, eigvec = j_pca(dp.portx)
    ref_i, ref_s = j_fse(np.asarray(eigvec), snr_cutoff=snr_cutoff)
    got_i, got_s = t_fse(np.asarray(eigvec), snr_cutoff=snr_cutoff,
                         device="cpu")
    assert np.array_equal(got_i, ref_i)
    assert rel_err(got_s, np.asarray(ref_s)) <= 1e-10 or not ref_s.any()
    if snr_cutoff == 20.0:
        assert len(ref_i) >= 1


# --------------------------------------------------------------------------
# DataPortrait

_ARRAYS = ("port", "freqs", "weights", "noise_stds", "SNRs", "portx")


def test_dataportrait_single(ws, tmp_path):
    root, files, _ = ws
    ref = JDP(files[0], quiet=True)
    got = TDP(files[0], quiet=True, device="cpu")
    for k in _ARRAYS:
        assert rel_err(getattr(got, k), getattr(ref, k)) <= 1e-12, k
    assert np.array_equal(got.ok_ichans, ref.ok_ichans)
    assert (got.nbin, got.nu0, got.bw) == (ref.nbin, ref.nu0, ref.bw)
    for method in ("prof", "rms", "mean", "max", "abs"):
        nr = ref.normalize_portrait(method)
        ng = got.normalize_portrait(method)
        assert rel_err(ng, nr) <= 1e-10, method
        assert rel_err(got.port, ref.port) <= 1e-10, method
        ref.unnormalize_portrait()
        got.unnormalize_portrait()
    ref.rotate_stuff(phase=0.03, DM=1e-3, ichans=np.arange(5, 20))
    got.rotate_stuff(phase=0.03, DM=1e-3, ichans=np.arange(5, 20))
    assert rel_err(got.port, ref.port) <= 1e-12
    ref.smooth_portrait()
    got.smooth_portrait()
    assert rel_err(got.port, ref.port) <= 1e-10
    fr, fg = ref.fit_flux_profile(), got.fit_flux_profile()
    for k in ("amp", "alpha"):
        assert abs(fg[k] - fr[k]) <= 1e-6 * fr[k + "_err"], k
    # show_data_portrait draws the JAX package's image (the data itself)
    import matplotlib.pyplot as plt

    with saved_figures():
        ref.show_data_portrait(show=False)
        want = image_arrays(plt.gcf())
        got.show_data_portrait(show=False)
        have = image_arrays(plt.gcf())
    plt.close("all")
    assert len(have) == len(want) == 1
    assert rel_err(have[0], want[0]) <= 1e-12
    # unload_archive: both packages' archives read back by the JAX one
    outs = [str(tmp_path / f"unloaded-{i}.fits") for i in range(2)]
    ref.unload_archive(outs[0], quiet=True)
    got.unload_archive(outs[1], quiet=True)
    a, b = (JDP(o, quiet=True) for o in outs)
    assert rel_err(b.port, a.port) <= 1e-4  # int16 quantization


def test_dataportrait_join(ws, tmp_path):
    root, files, meta = ws
    ref = JDP(meta, quiet=True)
    got = TDP(meta, quiet=True, device="cpu")
    for k in _ARRAYS:
        assert rel_err(getattr(got, k), getattr(ref, k)) <= 1e-12, k
    for a, b in zip(got.join_ichans, ref.join_ichans):
        assert np.array_equal(a, b)
    assert got.join_fit_flags == ref.join_fit_flags
    assert got.joins == ref.joins
    assert np.max(np.abs(np.subtract(got.join_params,
                                     ref.join_params))) <= 1e-10
    # the joinfile round trip: the port writes, both packages apply
    jf = str(tmp_path / "join.txt")
    got.join_params = [0.0, 0.0, 0.031, 2e-4]
    got.write_join_parameters(jf, quiet=True)
    ref2 = JDP(meta, joinfile=jf, quiet=True)
    got2 = TDP(meta, joinfile=jf, quiet=True, device="cpu")
    assert rel_err(got2.port, ref2.port) <= 1e-12
    assert np.allclose(got2.join_params, ref2.join_params, atol=0)


# --------------------------------------------------------------------------
# make_gaussian_model and make_spline_model, library calls

@pytest.mark.parametrize("join", [False, True])
def test_make_gaussian_model(ws, tmp_path, join):
    """niter=2 on one archive with --fitloc's flags, niter=1 on the JOIN
    pair without them (with the loc evolution free, the JOIN portrait
    fit at these widths burns its 200 iterations, and the stop point of
    a capped fit is not reproducible across two programs): .gmodel and
    error file field by field; the JOIN fit recovers the injected
    (phase, dDM) of the second receiver within 5 sigma, in the JAX
    package's convention."""
    root, files, meta = ws
    src = meta if join else files[0]
    kw = dict(niter=1 if join else 2, fixloc=join, quiet=True)
    paths = {}
    for name, cls, extra in (("jax", JGauss, {}),
                             ("torch", TGauss, {"device": "cpu"})):
        dp = cls(src, quiet=True, **extra)
        dp.make_gaussian_model(**kw)
        paths[name] = (str(tmp_path / f"{name}.gmodel"),
                       str(tmp_path / f"{name}.errs"))
        dp.write_model(paths[name][0], quiet=True)
        dp.write_errfile(paths[name][1], quiet=True)
        if name == "jax":
            jdp = dp
        else:
            tdp = dp
    _gmodel_close(paths["torch"][0], paths["jax"][0], paths["jax"][1])
    _gmodel_close(paths["torch"][1], paths["jax"][1], paths["jax"][1],
                  errfile=True)
    assert tdp.ngauss == jdp.ngauss
    assert len(tdp.iterations) >= 1
    assert rel_err(tdp.model, jdp.model) <= 1e-6
    if join:
        jerr = np.asarray(tdp.join_fit_errs)
        assert np.all(np.abs(np.subtract(tdp.join_params, jdp.join_params))
                      <= 1e-6 * np.where(jerr > 0, jerr, 1e-12))
        phi, ddm = tdp.join_params[2], tdp.join_params[3]
        # the JAX package's convention: the JOIN phase is the receiver's
        # delay at the model's nu_ref, so the injected dDM (referenced to
        # infinite frequency once the header DM is removed) adds to it
        phi_inj = JOIN_PHASE + tcfg.Dconst * JOIN_DDM \
            * tdp.nu_ref ** -2.0 / PAR["P0"]
        assert abs(phi - phi_inj) < 5 * jerr[2], (phi, phi_inj, jerr[2])
        assert abs(ddm - JOIN_DDM) < 5 * jerr[3], (ddm, jerr[3])


@pytest.mark.parametrize("smooth", [False, True])
def test_make_spline_model(ws, smooth):
    root, files, _ = ws
    kw = dict(max_ncomp=4, smooth=smooth, snr_cutoff=50.0, quiet=True)
    jdp = JSpline(files[0], quiet=True)
    jdp.normalize_portrait("prof")
    jdp.make_spline_model(**kw)
    tdp = TSpline(files[0], quiet=True, device="cpu")
    tdp.normalize_portrait("prof")
    tdp.make_spline_model(**kw)
    assert tdp.ncomp == jdp.ncomp
    assert np.array_equal(tdp.ieig, jdp.ieig)
    assert rel_err(tdp.model, jdp.model) <= 1e-8
    assert rel_err(tdp.modelx, jdp.modelx) <= 1e-8


# --------------------------------------------------------------------------
# the CLIs, port against JAX

PPGAUSS_CASES = {
    "fitloc_errfile": ["--niter", "2", "--fitloc", "-m", "CLI_MODEL"],
    "fix_fgauss_mcode": ["--fixwid", "--fixamp", "--fgauss", "--mcode",
                         "111", "--autogauss", "0.03", "--norm", "rms",
                         "--max-ngauss", "3"],
    "fitscat": ["--fitscat", "--niter", "1", "--nu_ref", "1500",
                "--bw", "400"],
    "serial_ad": ["--gauss-device", "off", "--lm-jacobian", "ad",
                  "--max-ngauss", "3"],
    "batched_analytic": ["--gauss-device", "on", "--lm-jacobian",
                         "analytic", "--norm", "prof"],
}


@pytest.fixture
def lm_knobs():
    saved = (jcfg.lm_jacobian, tcfg.lm_jacobian)
    yield
    jcfg.lm_jacobian, tcfg.lm_jacobian = saved


@pytest.mark.parametrize("case", sorted(PPGAUSS_CASES))
def test_ppgauss_cli(ws, tmp_path, case, lm_knobs):
    root, files, _ = ws
    argv = PPGAUSS_CASES[case]
    outs = {}
    for name, main, extra in (("jax", jppgauss.main, []),
                              ("torch", tppgauss.main,
                               ["--device", "cpu"])):
        o = str(tmp_path / f"{name}.gmodel")
        e = str(tmp_path / f"{name}.errs")
        assert main(["-d", files[0], "-o", o, "-e", e] + argv + extra) == 0
        outs[name] = (o, e)
    _gmodel_close(outs["torch"][0], outs["jax"][0], outs["jax"][1])
    _gmodel_close(outs["torch"][1], outs["jax"][1], outs["jax"][1],
                  errfile=True)


@pytest.mark.parametrize("mode", ["join", "improve", "joinfile"])
def test_ppgauss_cli_join_and_improve(ws, tmp_path, mode):
    """-M (the JOIN fit), -I (improve a .gmodel) and -j (a joinfile)."""
    root, files, meta = ws
    if mode == "improve":
        start = str(tmp_path / "start.gmodel")
        assert jppgauss.main(["-d", files[1], "-o", start]) == 0
        base = ["-d", files[0], "-I", start, "--niter", "1"]
    elif mode == "joinfile":
        jf = str(tmp_path / "joins.txt")
        with open(jf, "w") as f:
            rc = _read_lines(meta)
            f.write(f"{rc[0]} +0.00000000 +0.00000000\n"
                    f"{rc[1]} {JOIN_PHASE:+.8f} {JOIN_DDM:+.8f}\n")
        # at 4 and more trial components the trials here burn max_iter,
        # and the stop point of a capped fit is not reproducible across
        # two programs (fit.gauss.select_best_trial): a 4-component
        # model from either package is a different local optimum
        base = ["-M", meta, "-j", jf, "--max-ngauss", "3"]
    else:
        base = ["-M", meta, "--niter", "1"]
    outs = {}
    for name, main, extra in (("jax", jppgauss.main, []),
                              ("torch", tppgauss.main,
                               ["--device", "cpu"])):
        o = str(tmp_path / f"{name}.gmodel")
        e = str(tmp_path / f"{name}.errs")
        assert main(base + ["-o", o, "-e", e] + extra) == 0
        outs[name] = (o, e)
    _gmodel_close(outs["torch"][0], outs["jax"][0], outs["jax"][1])


def _read_lines(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


PPSPLINE_CASES = {
    "default_prof": [],
    "smooth": ["-s", "-S", "50"],
    "options": ["-N", "rms", "-n", "2", "-S", "40", "-T", "0.2", "-k", "2",
                "-f", "0.5", "-t", "6", "-l", "SPL"],
    "none_archive": ["-N", "None", "-S", "60", "-a", "ARCHIVE"],
}


@pytest.mark.parametrize("case", sorted(PPSPLINE_CASES))
def test_ppspline_cli(ws, tmp_path, case):
    root, files, _ = ws
    outs = {}
    for name, main, extra in (("jax", jppspline.main, []),
                              ("torch", tppspline.main,
                               ["--device", "cpu"])):
        argv = [a.replace("ARCHIVE", str(tmp_path / f"{name}.fits"))
                for a in PPSPLINE_CASES[case]]
        o = str(tmp_path / f"{name}.spl")
        assert main(["-d", files[0], "-o", o, "--quiet"] + argv
                    + extra) == 0
        outs[name] = o
    ref = read_spline_model(outs["jax"], quiet=True)
    got = read_spline_model(outs["torch"], quiet=True)
    assert (got.modelname, got.source, got.ncomp) == (ref.modelname,
                                                      ref.source, ref.ncomp)
    freqs = np.linspace(1150.0, 1850.0, 16)
    assert rel_err(got.portrait(freqs), ref.portrait(freqs)) <= 1e-8
    if "-a" in PPSPLINE_CASES[case]:
        a = JDP(str(tmp_path / "jax.fits"), quiet=True)
        b = JDP(str(tmp_path / "torch.fits"), quiet=True)
        assert rel_err(b.port, a.port) <= 1e-4  # int16 quantization


@pytest.mark.parametrize("argv,label", [
    # --batch runs the template factory; without -M it exits
    pytest.param(["--batch", "-d", "x.fits"], "requires -M",
                 id="argv0-A9b"),
])
def test_ppgauss_refusals(argv, label):
    with pytest.raises(SystemExit, match=label):
        tppgauss.main(argv + ["--device", "cpu"])


def test_ppgauss_figure(ws, tmp_path):
    """ppgauss --figure saves the JAX CLI's data / model / residual
    figure under Agg: the same panels, titles and labels, the images
    within 1e-6 x max|ref| (the two fits' own agreement), the model
    panel on the data panel's color limits."""
    root, files, _ = ws
    figs = {}
    for name, main, extra in (("jax", jppgauss.main, []),
                              ("torch", tppgauss.main,
                               ["--device", "cpu"])):
        png = str(tmp_path / f"{name}.png")
        with saved_figures() as saved:
            assert main(["-d", files[0], "-o", str(tmp_path / f"{name}.g"),
                         "--figure", png] + extra) == 0
        assert os.path.getsize(png) > 0 and len(saved) == 1
        figs[name] = saved[0]
    fj, ft = figs["jax"], figs["torch"]
    assert [a.get_title() for a in ft.axes] == \
        [a.get_title() for a in fj.axes]
    assert [a.get_ylabel() for a in ft.axes] == \
        [a.get_ylabel() for a in fj.axes]
    ij, it = image_arrays(fj), image_arrays(ft)
    assert len(it) == len(ij) == 3
    for got, ref in zip(it[:2], ij[:2]):
        assert rel_err(got, ref) <= 1e-6
    # the residual panel is a difference of the two: held to the data's scale
    assert np.max(np.abs(it[2] - ij[2])) <= 1e-6 * np.max(np.abs(ij[0]))
    ims = [a.get_images()[0] for a in ft.axes if a.get_images()]
    assert ims[1].get_clim() == ims[0].get_clim()


@pytest.mark.parametrize("argv,label", [
    # --gauss-device smooths the mean through the factory, under -s only
    pytest.param(["--gauss-device", "on"], "requires -s", id="argv0-A9b"),
])
def test_ppspline_refusals(argv, label):
    with pytest.raises(SystemExit, match=label):
        tppspline.main(["-d", "x.fits"] + argv + ["--device", "cpu"])


def test_ppspline_plots(ws, tmp_path):
    """ppspline --plots saves the JAX CLI's figures (.eigen.png,
    .freq.png and, from two components on, .proj.png) under Agg: the same axes and labels, every
    line's data within 1e-6 x max|ref| of the JAX figure's (the two
    PCAs agree to that; an eigenvector's sign is the PCA's choice, so a
    line is compared up to its sign)."""
    root, files, _ = ws
    figs = {}
    for name, main, extra in (("jax", jppspline.main, []),
                              ("torch", tppspline.main,
                               ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.spl")
        with saved_figures() as saved:
            assert main(["-d", files[0], "-o", out, "--plots", "--quiet"]
                        + extra) == 0
        # the pair grid (.proj.png) exists from two components on
        figs[name] = (saved, sorted(
            ext for ext in (".eigen.png", ".proj.png", ".freq.png")
            if os.path.exists(out + ext) and os.path.getsize(out + ext)))
    assert figs["torch"][1] == figs["jax"][1]
    assert {".eigen.png", ".freq.png"} <= set(figs["torch"][1])
    figs = {k: v[0] for k, v in figs.items()}
    assert len(figs["torch"]) == len(figs["jax"]) >= 2
    for fj, ft in zip(figs["jax"], figs["torch"]):
        assert [a.get_ylabel() for a in ft.axes] == \
            [a.get_ylabel() for a in fj.axes]
        for aj, at in zip(fj.axes, ft.axes):
            assert len(at.lines) == len(aj.lines)
            for lj, lt in zip(aj.lines, at.lines):
                xj, yj = (np.asarray(v, np.float64) for v in lj.get_data())
                xt, yt = (np.asarray(v, np.float64) for v in lt.get_data())
                assert rel_err(xt, xj) <= 1e-12
                scale = max(np.max(np.abs(yj)), 1e-300)
                assert min(np.max(np.abs(yt - yj)),
                           np.max(np.abs(yt + yj))) <= 1e-6 * scale


def test_library_refusals(ws, tmp_path):
    """The option checks of the library and the CLI; the GaussianSelector
    (no auto_gauss) and residplot run under Agg."""
    import matplotlib.pyplot as plt

    root, files, _ = ws
    dp = TGauss(files[0], quiet=True, device="cpu")
    with saved_figures():
        # the selector opens with no component: [dc, tau], ngauss 0,
        # as the JAX package's
        ref = JGauss(files[0], quiet=True).fit_profile(show=False)
        got = dp.fit_profile(show=False)
        assert dp.ngauss == 0 and np.array_equal(got, ref)
        plt.close("all")
        r = str(tmp_path / "r.png")
        dp.make_gaussian_model(residplot=r, quiet=True)
        assert os.path.getsize(r) > 0
    with pytest.raises(SystemExit, match="gauss-device"):
        tppgauss.main(["-d", files[0], "--gauss-device", "maybe",
                       "--device", "cpu"])
    with pytest.raises(SystemExit, match="lm-jacobian"):
        tppgauss.main(["-d", files[0], "--lm-jacobian", "numeric",
                       "--device", "cpu"])
    with pytest.raises(SystemExit):
        tppgauss.main(["--device", "cpu"])


# --------------------------------------------------------------------------
# pptoas -m the built templates

@pytest.mark.parametrize("kind", ["gmodel", "spl"])
def test_pptoas_with_built_template(ws, tmp_path, kind):
    """The JAX pptoas with the JAX-built template against the port's
    pptoas with the port-built one (.tim parity), and the port's stream
    within 0.1 sigma of its GetTOAs; the fast lane and the fused stage
    forced with a window in both packages.  The timed archive has noise
    1.0, as tests/test_torch_toas.py's."""
    from pulseportraiture_tpu.cli.pptoas import main as jpptoas
    from pulseportraiture_tpu_torch.cli.pptoas import main as tpptoas

    root, files, _ = ws
    tm = {}
    for name, g, s, extra in (("jax", jppgauss.main, jppspline.main, []),
                              ("torch", tppgauss.main, tppspline.main,
                               ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.{kind}")
        if kind == "gmodel":
            assert g(["-d", files[0], "--niter", "1", "-o", out]
                     + extra) == 0
        else:
            assert s(["-d", files[0], "-S", "50", "-o", out, "--quiet"]
                     + extra) == 0
        tm[name] = out
    data = str(tmp_path / "data.fits")
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=data, nsub=3,
                     nchan=32, nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                     phase=0.02, dDM=1e-4, start_MJD=MJD(55200, 0.3),
                     noise_stds=1.0, dedispersed=False, quiet=True, rng=21)
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_pallas = False
    try:
        jt, tt, st = (str(tmp_path / f"{n}.tim") for n in "jts")
        assert jpptoas(["-d", data, "-m", tm["jax"], "-o", jt,
                        "--quiet"]) == 0
        assert tpptoas(["-d", data, "-m", tm["torch"], "-o", tt, "--quiet",
                        "--device", "cpu"]) == 0
        assert tpptoas(["--stream", "-d", data, "-m", tm["torch"], "-o",
                        st, "--quiet", "--device", "cpu"]) == 0
    finally:
        for k, v in old_j.items():
            setattr(jcfg, k, v)
        for k, v in old_t.items():
            setattr(tcfg, k, v)
    _assert_tim_parity(jt, tt)
    assert _max_sigma(tt, st) < 0.1
    assert os.path.getsize(tt) > 0


def test_stage_walls_recorded(ws):
    from pulseportraiture_tpu_torch.fit.lm import lm_stats, reset_lm_stats
    from pulseportraiture_tpu_torch.pipeline.portrait import (
        reset_template_stats, template_stats)

    root, files, _ = ws
    reset_template_stats()
    reset_lm_stats()
    dp = TGauss(files[0], quiet=True, device="cpu")
    dp.make_gaussian_model(niter=0, max_ngauss=2, quiet=True)
    walls = template_stats()
    assert {"load", "profile trials", "portrait LM 0",
            "convergence fit 0"} <= set(walls)
    st = lm_stats()
    # the serial lane on the CPU: one call per trial, then the portrait
    assert [s["B"] for s in st] == [1] * len(st) and len(st) == 3
    assert all(1 <= s["host_reads"] <= s["it"] // 4 + 2 for s in st)
