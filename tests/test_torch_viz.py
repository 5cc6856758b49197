"""The PyTorch port's diagnostic plots (pulseportraiture_tpu_torch/viz/)
against the JAX package's, case for case with tests/test_viz.py.

Each case draws its figure with both packages on the same seeded input
under Agg and compares what was drawn, axes by axes: every line's x/y
data, image array, extent and color limits, scatter offsets and sizes,
patch outlines, axis limits, scales and every text (titles, labels,
annotations, legend and tick labels).  Numbers agree to 1e-12 x max|ref|
(float64; the port's fits, noise estimates and spline evaluations run on
the CPU in float64, the JAX package's in float64 under x64).

One more case hides matplotlib: the package and the pipelines import
without it, and a plot call raises ImportError naming matplotlib.
"""

import importlib
import inspect
import sys

import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from pulseportraiture_tpu.viz import plots as JV  # noqa: E402
from pulseportraiture_tpu_torch.viz import plots as TV  # noqa: E402

TOL = 1e-12


@pytest.fixture(autouse=True)
def _close_all():
    yield
    plt.close("all")


def _port(nchan=16, nbin=64):
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.3) / 0.04) ** 2)
    scales = 1.0 + 0.5 * np.linspace(-1, 1, nchan)
    return scales[:, None] * prof[None, :]


def _draw(name, *args, **kwargs):
    """The figure(s) of viz.plots.<name> in both packages (the port's on
    device='cpu')."""
    jf = getattr(JV, name)(*args, **kwargs)
    fn = getattr(TV, name)
    if "device" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, device="cpu")
    return jf, fn(*args, **kwargs)


def _close(got, ref, what):
    got = np.ma.filled(np.ma.asarray(got, np.float64), np.nan)
    ref = np.ma.filled(np.ma.asarray(ref, np.float64), np.nan)
    assert got.shape == ref.shape, what
    # non-finite entries (a histogram's overflow edge at inf) exactly
    ok = np.isfinite(ref)
    assert np.array_equal(got[~ok], ref[~ok], equal_nan=True), what
    assert np.isfinite(got[ok]).all(), what
    if ok.any():
        scale = max(float(np.max(np.abs(ref[ok]))), 1e-300)
        assert float(np.max(np.abs(got[ok] - ref[ok]))) <= TOL * scale, what


def _texts(ax):
    legend = ax.get_legend()
    return (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
            ax.get_xscale(), ax.get_yscale(), ax.axison,
            [t.get_text() for t in ax.texts],
            [t.get_text() for t in ax.get_yticklabels()],
            [t.get_text() for t in legend.get_texts()] if legend else None)


def _assert_same_figure(ft, fj):
    """Every drawn artist's data of two figures (module docstring)."""
    assert [t.get_text() for t in ft.texts] == \
        [t.get_text() for t in fj.texts]
    assert len(ft.axes) == len(fj.axes)
    for i, (at, aj) in enumerate(zip(ft.axes, fj.axes)):
        w = f"axes {i}"
        assert _texts(at) == _texts(aj), w
        _close(at.get_xlim(), aj.get_xlim(), w + " xlim")
        _close(at.get_ylim(), aj.get_ylim(), w + " ylim")
        assert len(at.lines) == len(aj.lines), w
        for lt, lj in zip(at.lines, aj.lines):
            assert (lt.get_linestyle(), lt.get_marker()) == \
                (lj.get_linestyle(), lj.get_marker()), w
            _close(lt.get_xdata(), lj.get_xdata(), w + " line x")
            _close(lt.get_ydata(), lj.get_ydata(), w + " line y")
        assert len(at.get_images()) == len(aj.get_images()), w
        for it, ij in zip(at.get_images(), aj.get_images()):
            _close(it.get_array(), ij.get_array(), w + " image")
            _close(it.get_extent(), ij.get_extent(), w + " extent")
            _close(it.get_clim(), ij.get_clim(), w + " clim")
        assert len(at.collections) == len(aj.collections), w
        for ct, cj in zip(at.collections, aj.collections):
            _close(ct.get_offsets(), cj.get_offsets(), w + " offsets")
            if hasattr(cj, "get_sizes"):
                _close(ct.get_sizes(), cj.get_sizes(), w + " sizes")
            for pt, pj in zip(ct.get_paths(), cj.get_paths()):
                _close(pt.vertices, pj.vertices, w + " collection path")
        assert len(at.patches) == len(aj.patches), w
        for pt, pj in zip(at.patches, aj.patches):
            _close(pt.get_path().vertices, pj.get_path().vertices,
                   w + " patch")


def test_show_portrait_panels_and_zap_compression():
    port = _port()
    port[3] = 0.0  # zapped channel
    freqs = np.linspace(1300.0, 1500.0, len(port))
    phases = (np.arange(port.shape[1]) + 0.5) / port.shape[1]
    fj, ft = _draw("show_portrait", port, phases, freqs, title="t",
                   show=False)
    _assert_same_figure(ft, fj)
    assert len(ft.axes) == 4
    ax_f = next(a for a in ft.axes if a.get_xlabel() == "Flux Units"
                and a.get_ylabel())
    assert len(ax_f.lines[0].get_ydata()) == len(port) - 1


def test_show_portrait_rvrsd_and_kwargs():
    port = _port()
    freqs = np.linspace(1300.0, 1500.0, len(port))
    fj, ft = _draw("show_portrait", port, None, freqs, rvrsd=True,
                   colorbar=False, prof=False, fluxprof=False, show=False,
                   vmin=0.0, vmax=2.0)
    _assert_same_figure(ft, fj)
    (ax,) = ft.axes
    assert ax.get_images()[0].get_clim() == (0.0, 2.0)


def test_show_stacked_profiles_model_overlay_and_fit():
    """fit=True aligns and scales each model by the port's
    fit_phase_shift and rotate_profile (float64 on the CPU)."""
    port = _port(nchan=12)
    rng = np.random.default_rng(0)
    data = np.roll(port, 3, axis=-1) * 1.7 + \
        0.01 * rng.standard_normal(port.shape)
    fj, ft = _draw("show_stacked_profiles", data, model_profiles=port,
                   fit=True, freqs=np.linspace(1300., 1500., 12),
                   show=False)
    _assert_same_figure(ft, fj)
    (ax,) = ft.axes
    assert len(ax.lines) == 2 * 12
    assert ax.get_yticklabels()[0].get_text() == "1300"


def test_show_portrait_fully_zapped_no_degenerate_limits():
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fj, ft = _draw("show_portrait", np.zeros((8, 32)), show=False)
    _assert_same_figure(ft, fj)
    assert len(ft.axes) == 4


def test_show_profiles_and_residual_smoke():
    port = _port()
    fj, ft = _draw("show_profiles", [port[0], port[1]], labels=["a", "b"],
                   show=False)
    _assert_same_figure(ft, fj)
    assert ft.axes[0].get_legend() is not None
    fj, ft = _draw("show_residual_plot", port, port * 1.01,
                   noise_stds=np.full(len(port), 0.01), colorbar=False,
                   show=False)
    _assert_same_figure(ft, fj)
    assert len(ft.axes) == 4


@pytest.mark.parametrize("noise", ["given", "estimated"])
def test_show_residual_plot_reference_behaviors(noise):
    """The given-noise case of tests/test_viz.py, and the noise
    estimated by the port's get_noise_PS on the CPU."""
    rng = np.random.default_rng(1)
    port = _port() + 0.05 * rng.standard_normal((16, 64))
    model = 0.9 * _port()
    w = np.ones(len(port))
    w[2] = 0.0
    kw = {"noise_stds": np.full(len(port), 0.05)} \
        if noise == "given" else {}
    fj, ft = _draw("show_residual_plot", port, model, weights=w,
                   show=False, **kw)
    _assert_same_figure(ft, fj)
    assert len(ft.axes) == 7
    ax_h = next(a for a in ft.axes if "# chans." in a.get_ylabel())
    assert f"total = {len(port) - 1}" in ax_h.get_ylabel()


def test_show_residual_plot_rvrsd_and_clim_override():
    port = _port()
    freqs = np.linspace(1300.0, 1500.0, len(port))
    phases = (np.arange(port.shape[1]) + 0.5) / port.shape[1]
    fj, ft = _draw("show_residual_plot", port, port * 0.5, phases, freqs,
                   noise_stds=np.full(len(port), 0.05), rvrsd=True,
                   colorbar=False, show=False, vmin=0.0, vmax=3.0)
    _assert_same_figure(ft, fj)
    img_axes = [a for a in ft.axes if a.get_images()]
    assert img_axes[1].get_images()[0].get_clim() == (0.0, 3.0)


def test_show_eigenprofiles_reference_behaviors():
    """The S/N annotations come from the port's get_noise_PS."""
    nbin = 128
    rng = np.random.default_rng(0)
    x = (np.arange(nbin) + 0.5) / nbin
    ev = np.stack([np.sin(2 * np.pi * x), np.cos(2 * np.pi * x)], -1)
    ev_noisy = ev + 0.05 * rng.standard_normal(ev.shape)
    mean = np.exp(-0.5 * ((x - 0.5) / 0.05) ** 2)
    fj, ft = _draw("show_eigenprofiles", ev_noisy, smooth_eigvec=ev,
                   mean_prof=mean, smooth_mean_prof=mean, show=False,
                   show_snrs=True, xlim=(0.1, 0.9), title="t")
    _assert_same_figure(ft, fj)
    texts = [t.get_text() for ax in ft.axes[1:] for t in ax.texts]
    assert len(texts) == 2 and all(t.startswith("S/N") for t in texts)


def test_show_spline_curve_projections_reference_behaviors(tmp_path):
    """The spline curve and knot values come from the port's
    bspline_eval; both figures, the icoord mode and the save convention."""
    from scipy.interpolate import splprep

    nchan = 24
    freqs = np.linspace(1500.0, 1300.0, nchan)  # descending band
    t = np.linspace(0, 1, nchan)
    proj = np.stack([t, t ** 2, np.sin(3 * t)], -1)
    tck, _ = splprep(list(proj.T), u=freqs[::-1], k=3, s=0.0)
    w = np.linspace(1.0, 3.0, nchan)
    (pj, qj), (pt, qt) = _draw("show_spline_curve_projections", proj, freqs,
                               tck=tck, weights=w, show=False)
    _assert_same_figure(pt, pj)
    _assert_same_figure(qt, qj)
    (pj, qj), (pt, qt) = _draw("show_spline_curve_projections", proj, freqs,
                               tck=tck, icoord=2, show=False)
    assert pt is None and pj is None
    _assert_same_figure(qt, qj)
    base = str(tmp_path / "spl")
    TV.show_spline_curve_projections(proj, freqs, tck=tck, savefig=base,
                                     device="cpu")
    import os

    assert os.path.getsize(base + ".proj.png") > 0
    assert os.path.getsize(base + ".freq.png") > 0


def test_import_without_matplotlib(monkeypatch):
    """With matplotlib hidden, the viz package and the pipelines that
    draw import; a plot call raises ImportError naming matplotlib."""
    for name in [m for m in sys.modules
                 if m.startswith("pulseportraiture_tpu_torch.viz")
                 or m.startswith("pulseportraiture_tpu_torch.pipeline")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    viz = importlib.import_module("pulseportraiture_tpu_torch.viz")
    importlib.import_module("pulseportraiture_tpu_torch.viz.selector")
    importlib.import_module("pulseportraiture_tpu_torch.pipeline.gauss")
    with pytest.raises(ImportError, match="matplotlib"):
        viz.show_profiles([np.ones(8)], show=False)
    with pytest.raises(ImportError, match="matplotlib"):
        viz.set_colormap("magma")


def test_pipeline_plots(tmp_path):
    """The pipelines' plot methods against the JAX package's on one
    small archive: DataPortrait.show_data_portrait (the data itself,
    1e-12), fit_flux_profile(plot=True) and GetTOAs.show_subint /
    show_fit (the fitted power law, the fitted template and its
    residuals: the two packages' fits agree to 1e-6 x max|ref|, the
    figure's texts and layout exactly)."""
    from test_torch_helpers import PAR, image_arrays, rel_err, saved_figures

    from pulseportraiture_tpu.io import write_gmodel
    from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
    from pulseportraiture_tpu.pipeline.portrait import DataPortrait as JDP
    from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
    from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs
    from pulseportraiture_tpu_torch.pipeline.portrait import \
        DataPortrait as TDP

    model = default_test_model(1500.0)
    gmodel, arch = str(tmp_path / "m.gmodel"), str(tmp_path / "a.fits")
    write_gmodel(model, gmodel, quiet=True)
    make_fake_pulsar(model, PAR, outfile=arch, nsub=2, nchan=16, nbin=128,
                     nu0=1500.0, bw=800.0, tsub=60.0, noise_stds=0.5,
                     dedispersed=False, quiet=True, rng=11)
    fj, ft = [], []
    for figs, dp in ((fj, JDP(arch, quiet=True)),
                     (ft, TDP(arch, quiet=True, device="cpu"))):
        dp.show_data_portrait(show=False)
        figs.append(plt.gcf())
        with saved_figures() as saved:
            dp.fit_flux_profile(plot=True, savefig=str(tmp_path / "f.png"))
        figs += saved
    _assert_same_figure(ft[0], fj[0])
    (aj,), (at,) = fj[1].axes, ft[1].axes
    assert _texts(at)[1:3] == _texts(aj)[1:3]
    for lt, lj in zip(at.lines, aj.lines):
        assert rel_err(lt.get_ydata(), lj.get_ydata()) <= 1e-6
    jg = JGetTOAs(arch, gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    tg = TGetTOAs(arch, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    _assert_same_figure(tg.show_subint(isub=1, show=False),
                        jg.show_subint(isub=1, show=False))
    fj, ft = jg.show_fit(isub=1, show=False), tg.show_fit(isub=1, show=False)
    assert [_texts(a)[:3] for a in ft.axes] == \
        [_texts(a)[:3] for a in fj.axes]
    ij, it = image_arrays(fj), image_arrays(ft)
    assert rel_err(it[0], ij[0]) <= 1e-12
    assert rel_err(it[1], ij[1]) <= 1e-6
    assert np.max(np.abs(it[2] - ij[2])) <= 1e-6 * np.max(np.abs(ij[1]))
