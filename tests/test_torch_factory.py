"""The PyTorch port's template factory on the CPU, against the JAX
package: pipeline.factory (build_templates for Gaussian and spline jobs,
gauss_smooth_mean, the bucket padding), cli.ppfactory flag by flag and
its refusals, ppgauss --batch and ppspline -s --gauss-device.

The corpus: four averaged archives (1 subint x 16-24 channels x 256
bins, noise 0.05) of tests/test_factory.py's fleet recipe, written by
the JAX package; one has 3 of its 16 channels zapped (13 usable) and
one has 24 channels, so the portrait buckets pad channels (+inf errors)
and rows (frozen duplicates).  Gates:
- .gmodel files parsed field by field: each parameter within 1e-6 x its
  error (tests/test_torch_template.py's ppgauss gate, with its floor of
  one unit of the files' 8th decimal), ngauss equal;
- .spl: the same ncomp, the model portrait within 1e-8 x max|ref|
  (test_torch_template.py's ppspline gate);
- the port's batched lane against its serial lane: 1e-10 x err on
  every job whose LM fits converged;
- a bucket of 3 rows padded to 4: the real rows' results equal to the
  unpadded run's, bit for bit.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_helpers import event_counts, rel_err, trace_events

from pulseportraiture_tpu.cli import ppfactory as jppfactory
from pulseportraiture_tpu.cli import ppgauss as jppgauss
from pulseportraiture_tpu.cli import ppspline as jppspline
from pulseportraiture_tpu.io.gmodel import model_to_flat, read_gmodel
from pulseportraiture_tpu.io.splmodel import read_spline_model
from pulseportraiture_tpu.pipeline import factory as JFAC
from pulseportraiture_tpu.pipeline.spline import SplinePortrait as JSpline
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch.cli import ppfactory as tppfactory
from pulseportraiture_tpu_torch.cli import ppgauss as tppgauss
from pulseportraiture_tpu_torch.cli import ppspline as tppspline
from pulseportraiture_tpu_torch.fit import gauss as TFG
from pulseportraiture_tpu_torch.fit.lm import lm_stats, reset_lm_stats
from pulseportraiture_tpu_torch.pipeline import factory as TFAC
from pulseportraiture_tpu_torch.pipeline.gauss import GaussPortrait as TGauss
from pulseportraiture_tpu_torch.pipeline.spline import (
    SplinePortrait as TSpline)

NBIN, MAX_NG = 256, 3
FLAGS = ["--max-ngauss", str(MAX_NG), "--niter", "1", "--fitloc"]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """tests/test_factory.py's fleet at 16-24 channels x 256 bins: four
    pulsars, one with 3 zapped channels, one with 24 channels; returns
    (root, archives, metafile)."""
    root = tmp_path_factory.mktemp("tfactory")
    files = []
    for i, nchan in enumerate((16, 16, 24, 16)):
        p = str(root / f"psr{i}.fits")
        weights = np.ones((1, nchan))
        if i == 1:
            weights[0, [2, 7, 11]] = 0.0
        make_fake_pulsar(default_test_model(1500.0),
                         {"PSR": f"FAKE{i}", "P0": 0.003 + 0.001 * i,
                          "DM": 20.0 + i, "PEPOCH": 56000.0},
                         outfile=p, nsub=1, nchan=nchan, nbin=NBIN,
                         nu0=1500.0, bw=600.0, tsub=60.0,
                         start_MJD=MJD(55100 + i, 0.3), weights=weights,
                         noise_stds=0.05, dedispersed=False, quiet=True,
                         rng=30 + i)
        files.append(p)
    meta = root / "fleet.txt"
    meta.write_text("\n".join(files) + "\n")
    return root, files, str(meta)


@pytest.fixture(scope="module")
def port_lanes(fleet):
    """build_templates on the port's batched and serial lanes, from
    preloaded portraits (so their fit errors can be read)."""
    root, files, _ = fleet
    out = {}
    for lane in (True, False):
        dps = [(TGauss(f, quiet=True, device="cpu"), f) for f in files]
        res = TFAC.build_templates(
            dps, outdir=str(root / f"lib-{lane}"), max_ngauss=MAX_NG,
            niter=1, fixloc=False, gauss_device=lane, device="cpu")
        out[lane] = (res, [d for d, _ in dps], dict(TFAC.factory_stats()))
    return out


def _gmodel_close(got_path, ref_path, errs):
    """Two .gmodel files field by field: each parameter within 1e-6 x its
    error (flat layout, tau in bins converted) plus one unit of the
    files' 8th decimal."""
    got, ref = read_gmodel(got_path, quiet=True), read_gmodel(ref_path,
                                                             quiet=True)
    # the factory names each model by its output path
    assert os.path.basename(got.name) == os.path.basename(ref.name)
    assert (got.code, got.ngauss) == (ref.code, ref.ngauss)
    assert got.nu_ref == pytest.approx(ref.nu_ref, abs=1e-5)
    g, r = model_to_flat(got)[0], model_to_flat(ref)[0]
    assert len(g) == len(r) == len(errs)
    e = np.abs(np.asarray(errs))
    e[1] = 0.0  # tau, fixed and in seconds on disk
    assert np.all(np.abs(g - r) <= 1e-6 * e + 1.01e-8)
    assert abs(got.alpha - ref.alpha) <= 1e-3
    for k, v in ref.fit_flags.items():
        assert np.array_equal(np.asarray(got.fit_flags[k]), np.asarray(v))


def _cli(main, argv):
    assert main(argv) in (0, None)


# --------------------------------------------------------------------------
# build_templates: the port's lanes

def test_lanes_agree(port_lanes):
    """Batched vs serial: the same ngauss, iterations and convergence;
    the parameters of every job whose LM fits all converged within 1e-10
    x their errors; fewer LM calls batched (one per bucket) than serial
    (one per problem)."""
    (rb, db, sb), (rs, ds, ss) = port_lanes[True], port_lanes[False]
    ncmp = 0
    for a, b, pa, pb in zip(rb, rs, db, ds):
        assert (a.ngauss, a.iters, a.converged, a.fit_converged) == \
            (b.ngauss, b.iters, b.converged, b.fit_converged)
        assert np.all(np.isfinite(pa.fitted_params))
        if a.fit_converged:
            ncmp += 1
            err = np.where(pa.fit_errs > 0, pa.fit_errs, np.inf)
            assert np.max(np.abs(pa.fitted_params - pb.fitted_params)
                          / err) <= 1e-10
    assert ncmp >= 2
    assert sb["lm_calls"] == len(sb["buckets"]) < ss["lm_calls"]
    # the 13- and 24-channel pulsars sit in padded channel classes
    assert {k[1][1] for k in sb["buckets"] if k[0] == "portrait"} >= {16,
                                                                      32}


# --------------------------------------------------------------------------
# the CLIs against the JAX CLIs

@pytest.mark.parametrize("kind", ["gauss", "spline"])
def test_ppfactory_cli(fleet, port_lanes, tmp_path, kind):
    """ppfactory -M fleet.txt -O dir --max-ngauss 3 --niter 1 --fitloc
    [--kind spline] --gauss-device on in both packages: every template
    within the gates of the module docstring."""
    root, files, meta = fleet
    argv = ["-M", meta] + FLAGS + ["--kind", kind, "--gauss-device", "on"]
    _cli(jppfactory.main, argv + ["-O", str(tmp_path / "jax")])
    _cli(tppfactory.main, argv + ["-O", str(tmp_path / "torch"),
                                  "--device", "cpu"])
    ext = ".gmodel" if kind == "gauss" else ".spl"
    _, dps, _ = port_lanes[True]
    for f, dp in zip(files, dps):
        name = os.path.basename(f) + ext
        got, ref = (str(tmp_path / pkg / name) for pkg in ("torch", "jax"))
        if kind == "gauss":
            _gmodel_close(got, ref, dp.fit_errs)
            continue
        g, r = read_spline_model(got, quiet=True), read_spline_model(
            ref, quiet=True)
        assert (g.modelname, g.ncomp) == (r.modelname, r.ncomp)
        freqs = np.linspace(1250.0, 1750.0, 16)
        assert rel_err(g.portrait(freqs), r.portrait(freqs)) <= 1e-8


def test_ppgauss_batch(fleet, port_lanes, tmp_path):
    """ppgauss --batch -M fleet.txt (one template next to each archive)
    in both packages, each on its own copy of the fleet."""
    root, files, _ = fleet
    metas = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        copies = [shutil.copy(f, d) for f in files]
        metas[pkg] = d / "fleet.txt"
        metas[pkg].write_text("\n".join(copies) + "\n")
    argv = ["--batch", "--niter", "1", "--fitloc", "--max-ngauss",
            str(MAX_NG), "--gauss-device", "on"]
    _cli(jppgauss.main, argv + ["-M", str(metas["jax"])])
    _cli(tppgauss.main, argv + ["-M", str(metas["torch"]), "--device",
                                "cpu"])
    _, dps, _ = port_lanes[True]
    for f, dp in zip(files, dps):
        b = os.path.basename(f) + ".gmodel"
        _gmodel_close(str(tmp_path / "torch" / b),
                      str(tmp_path / "jax" / b), dp.fit_errs)


def test_ppspline_gauss_device(fleet, tmp_path):
    """ppspline -s --gauss-device on (the mean smoothed by the factory's
    Gaussian fit) in both packages, and gauss_smooth_mean itself."""
    root, files, _ = fleet
    outs = {}
    for pkg, main, extra in (("jax", jppspline.main, []),
                             ("torch", tppspline.main, ["--device", "cpu"])):
        outs[pkg] = str(tmp_path / f"{pkg}.spl")
        _cli(main, ["-d", files[0], "-o", outs[pkg], "-s", "-S", "50",
                    "--gauss-device", "on", "--quiet"] + extra)
    g, r = (read_spline_model(outs[p], quiet=True) for p in ("torch", "jax"))
    assert (g.modelname, g.ncomp) == (r.modelname, r.ncomp)
    freqs = np.linspace(1250.0, 1750.0, 16)
    assert rel_err(g.portrait(freqs), r.portrait(freqs)) <= 1e-8
    jdp, tdp = JSpline(files[0], quiet=True), TSpline(files[0], quiet=True,
                                                      device="cpu")
    ref = JFAC.gauss_smooth_mean(jdp, gauss_device=True)
    for lane in (True, False):
        got = TFAC.gauss_smooth_mean(tdp, gauss_device=lane)
        assert rel_err(got, np.asarray(ref)) <= 1e-8, lane


# --------------------------------------------------------------------------
# the bucket padding

def _portrait_rows(files, ok):
    """Portrait-bucket rows (as build_templates makes them) of the
    archives ``ok``, seeded with default_test_model at 3 components in
    a 4-component class; nchan class 16."""
    from pulseportraiture_tpu_torch.pipeline.gauss import (
        portrait_fit_flags)

    from pulseportraiture_tpu.io.gmodel import model_to_flat as flat

    theta = flat(default_test_model(1500.0))[0].copy()
    theta[2::6] += 0.002  # a start just off the truth
    rows = []
    for i in ok:
        dp = TGauss(files[i], quiet=True, device="cpu")
        okc = dp.ok_ichans
        n = len(okc)
        data = np.zeros((16, NBIN))
        data[:n] = dp.port[okc]
        errs = np.full(16, np.inf)
        errs[:n] = dp.noise_stds[okc]
        freqs = np.full(16, dp.freqsxs[0][-1])
        freqs[:n] = dp.freqsxs[0]
        xp, _ = TFG.pad_portrait_params(theta, 4)
        vary = TFG.portrait_vary(portrait_fit_flags(3), 4)
        rows.append((None, np.concatenate([xp, [-4.0]]), vary, data, errs,
                     freqs, 1500.0, float(dp.Ps[0]), n))
    return rows


def test_pad_rows_bit_for_bit(fleet):
    """A portrait bucket of 3 rows (one with 13 usable channels) padded
    to 4 with a fully frozen duplicate of row 0: the real rows' results
    equal the unpadded B = 3 run's bit for bit, and every later chunk's
    compaction class is the unpadded run's (the pad row, done after its
    first iteration, never counts as alive); the pad row is done on its
    first iteration (nfev 2), finite, with zero errors."""
    root, files, _ = fleet
    rows = _portrait_rows(files, (0, 1, 3))
    arrays = [np.stack([r[k] for r in rows]) for k in (3, 4, 5)]
    x0s = np.stack([r[1] for r in rows])
    vary = np.stack([r[2] for r in rows])
    scal = [np.asarray([r[k] for r in rows]) for k in (6, 7, 8)]
    out = {}
    for B_pad in (3, 4):
        (d, e, f, nu, P, ncv, x0), v = TFAC._pad_rows(
            arrays + scal + [x0s], vary, B_pad)
        reset_lm_stats()
        res = TFG.fit_gaussian_portraits_batched(
            d, x0, e, v, f, nu, P, nchan_valid=ncv, device="cpu")
        out[B_pad] = (res, lm_stats()[-1]["classes"])
    (r3, c3), (r4, c4) = out[3], out[4]
    for fld in ("x", "x_err", "chi2", "dof", "nfev", "success", "cov"):
        assert torch.equal(getattr(r4, fld)[:3], getattr(r3, fld)), fld
    assert [min(c, 3) for c in c4[1:]] == c3[1:]
    assert int(r4.nfev[3]) == 2 and bool(r4.success[3])
    assert torch.isfinite(r4.x[3]).all() and not r4.x_err[3].any()
    # the dispatch helper pads to 4 and returns the real rows only
    got = TFAC._dispatch_portraits((NBIN, 16, 4, "000"), rows, True, 200,
                                   torch.device("cpu"))
    assert np.array_equal(got["x"], r3.x.numpy())


def test_profile_pad_rows_bit_for_bit(fleet):
    """The same invariance for a profile bucket of 3 trials padded to 4."""
    root, files, _ = fleet
    dp = TGauss(files[0], quiet=True, device="cpu")
    profile, _ = dp.select_ref_profile()
    seeds = TFG.profile_trial_seeds(profile, 3, noise=0.05)
    x0s = np.stack([TFG.pad_profile_params(s, 4)[0] for s in seeds])
    vary = np.stack([TFG.profile_vary(g, 4) for g in (1, 2, 3)])
    data = np.stack([profile] * 3)
    errs = np.full(3, 0.05)
    out = {}
    for B_pad in (3, 4):
        (d, e, x0), v = TFAC._pad_rows([data, errs, x0s], vary, B_pad)
        out[B_pad] = TFG.fit_gaussian_profiles_batched(d, x0, e, v,
                                                       device="cpu")
    for fld in ("x", "x_err", "chi2", "nfev", "success", "stalled"):
        assert torch.equal(getattr(out[4], fld)[:3],
                           getattr(out[3], fld)), fld
    assert int(out[4].nfev[3]) == 2


def test_non_pow2_bucket_against_jax(fleet):
    """A portrait bucket of the 13-channel and the 24-channel pulsars'
    class neighbours (n_ok 13 and 16 in class 16), through both
    packages' _dispatch_portraits: every parameter within 1e-6 x its
    error, chi2 within 1e-8, the dof counted from the usable channels
    (the +inf pad channels add exact zeros, no NaN)."""
    from pulseportraiture_tpu.telemetry import resolve_tracer

    root, files, _ = fleet
    rows = _portrait_rows(files, (1, 0, 3))
    got = TFAC._dispatch_portraits((NBIN, 16, 4, "000"), rows, True, 200,
                                   torch.device("cpu"))
    tracer, _ = resolve_tracer(None)
    ref = JFAC._dispatch_portraits((NBIN, 16, 4, "000"), rows, True, 200,
                                   tracer)[0]
    for k in ("x", "x_err", "chi2"):
        assert np.all(np.isfinite(got[k])), k
    err = np.where(ref["x_err"] > 0, ref["x_err"], np.inf)
    assert np.max(np.abs(got["x"] - ref["x"]) / err) <= 1e-6
    assert rel_err(got["chi2"], ref["chi2"]) <= 1e-8
    assert np.array_equal(got["dof"], np.asarray(ref["dof"]))
    assert got["dof"][0] == 13 * NBIN - int(rows[0][2].sum())


# --------------------------------------------------------------------------
# flags and refusals

def test_ppfactory_flags(fleet, tmp_path):
    """The remaining flags route as in the JAX CLI (--norm, --mcode,
    --fixwid, --fixamp, --lm-jacobian, --gauss-device off, --verbose,
    the cache flags at values that keep the cache off): the .gmodel of
    the first pulsar within the gates."""
    from pulseportraiture_tpu import config as jcfg
    from pulseportraiture_tpu_torch import config as tcfg

    root, files, _ = fleet
    meta = tmp_path / "one.txt"
    meta.write_text(files[0] + "\n")
    argv = ["-M", str(meta), "--max-ngauss", "2", "--norm", "max",
            "--mcode", "000", "--fixwid", "--fixamp", "--lm-jacobian",
            "analytic", "--gauss-device", "off", "--result-cache", "off",
            "--cache-dir", str(tmp_path / "cache"), "--cache-max-mb", "64"]
    saved = [(c, k, getattr(c, k)) for c in (jcfg, tcfg)
             for k in ("lm_jacobian", "result_cache", "cache_dir",
                       "cache_max_mb")]
    try:
        _cli(jppfactory.main, argv + ["-O", str(tmp_path / "jax")])
        _cli(tppfactory.main, argv + ["-O", str(tmp_path / "torch"),
                                      "--device", "cpu", "--verbose"])
        assert tcfg.lm_jacobian == "analytic"
    finally:
        for c, k, v in saved:
            setattr(c, k, v)
    b = os.path.basename(files[0]) + ".gmodel"
    dp = TGauss(files[0], quiet=True, device="cpu")
    dp.normalize_portrait("max")
    TFAC.build_templates([(dp, files[0])], write=False, max_ngauss=2,
                         fixwid=True, fixamp=True, gauss_device=False,
                         device="cpu")
    _gmodel_close(str(tmp_path / "torch" / b), str(tmp_path / "jax" / b),
                  dp.fit_errs)
    assert not (tmp_path / "cache").exists()


@pytest.mark.parametrize("argv,match", [
    # --telemetry is ported: the case holds the JAX CLI's trace
    pytest.param(["--telemetry", "TRACE"], None, id="argv0-A13"),
    # the result cache is ported: these cases hold the JAX CLI's runs
    pytest.param(["--result-cache", "on"], "CACHE", id="argv1-A13"),
    pytest.param(["--cache-dir", "CACHE"], "CACHE", id="argv2-A13"),
    pytest.param(["--result-cache", "auto", "--cache-dir", "CACHE"],
                 "CACHE", id="argv3-A13"),
    (["--result-cache", "sometimes"], "expected 'off', 'auto' or 'on'"),
    (["--cache-max-mb", "0"], "must be > 0"),
    (["--gauss-device", "maybe"], "gauss-device"),
    (["--lm-jacobian", "numeric"], "lm-jacobian"),
    (["--max-ngauss", "0"], "max-ngauss"),
    (["--niter", "-1"], "niter"),
])
def test_ppfactory_refusals(fleet, tmp_path, argv, match):
    root, files, meta = fleet
    if match is None:
        # ppfactory --telemetry: the JAX CLI's events, one job, serial
        one = tmp_path / "one.txt"
        one.write_text(files[0] + "\n")
        traces = {}
        for name, main, extra in (("jax", jppfactory.main, []),
                                  ("torch", tppfactory.main,
                                   ["--device", "cpu"])):
            traces[name] = str(tmp_path / f"{name}.jsonl")
            _cli(main, ["-M", str(one), "-O", str(tmp_path / name),
                        "--max-ngauss", "2", "--gauss-device", "off",
                        "--telemetry", traces[name]] + extra)
        assert event_counts(traces["torch"]) == event_counts(traces["jax"])

        def fits(path):
            return [(e["stage"], e["bucket"], e["rows"], e["pad"],
                     e["batched"], e["jac"]) for e in trace_events(path)
                    if e["type"] == "template_fit"]

        assert fits(traces["torch"]) == fits(traces["jax"])
        assert len(fits(traces["torch"])) >= 2
        return
    if match == "CACHE":
        _cache_case(files, argv, tmp_path)
        return
    argv = [str(tmp_path / "c") if a == "CACHE" else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        tppfactory.main(["-M", meta, "-O", str(tmp_path / "o"), "--device",
                         "cpu"] + argv)
    assert not (tmp_path / "c").exists()


def _cache_case(files, argv, tmp_path):
    """One ppfactory cache-flag case in both packages, with a store of
    each's own.  '--result-cache on' without a directory exits as the
    JAX CLI does, then runs with config.cache_dir set; every run builds
    the one archive's template on a miss, serves it on the repeat (the
    same bytes) and stores the blob under the JAX package's key."""
    from pulseportraiture_tpu import config as jcfg
    from pulseportraiture_tpu_torch import config as tcfg

    one = tmp_path / "one.txt"
    one.write_text(files[0] + "\n")
    saved = [(c, k, getattr(c, k)) for c in (jcfg, tcfg)
             for k in ("result_cache", "cache_dir", "cache_max_mb")]
    try:
        if "CACHE" not in argv:
            msgs = []
            for main, extra in ((jppfactory.main, []),
                                (tppfactory.main, ["--device", "cpu"])):
                with pytest.raises(SystemExit) as e:
                    main(["-M", str(one), "--max-ngauss", "1"] + argv
                         + extra)
                msgs.append(str(e.value))
            assert msgs[1] == msgs[0] and "requires --cache-dir" in msgs[0]
        names = {}
        for tag, main, cfg, extra in (
                ("jax", jppfactory.main, jcfg, []),
                ("torch", tppfactory.main, tcfg, ["--device", "cpu"])):
            store = tmp_path / f"store-{tag}"
            cfg.cache_dir = str(store) if "CACHE" not in argv else None
            av = [str(store) if a == "CACHE" else a for a in argv]
            for run in (1, 2):
                _cli(main, ["-M", str(one), "--max-ngauss", "1", "-O",
                            str(tmp_path / f"{tag}{run}")] + av + extra)
            b = os.path.basename(files[0]) + ".gmodel"
            assert (tmp_path / f"{tag}1" / b).read_bytes() == \
                (tmp_path / f"{tag}2" / b).read_bytes()
            names[tag] = sorted(os.listdir(store))
        assert names["torch"] == names["jax"] and len(names["jax"]) == 1
        assert names["jax"][0].endswith(".blob")
        dp = TGauss(files[0], quiet=True, device="cpu")
        TFAC.build_templates([(dp, files[0])], write=False, max_ngauss=1,
                             fixloc=True, device="cpu")
        _gmodel_close(str(tmp_path / "torch1" / b),
                      str(tmp_path / "jax1" / b), dp.fit_errs)
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


def test_factory_input_refusals(fleet, tmp_path):
    """A JOIN metafile among the archives, an empty or missing metafile,
    and the library's own checks, as in the JAX package."""
    root, files, meta = fleet
    nested = tmp_path / "nested.txt"
    nested.write_text(meta + "\n")
    with pytest.raises(ValueError, match="metafile"):
        tppfactory.main(["-M", str(nested), "--device", "cpu"])
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    with pytest.raises(SystemExit, match="no archives"):
        tppfactory.main(["-M", str(empty), "--device", "cpu"])
    with pytest.raises(SystemExit, match="not found"):
        tppfactory.main(["-M", str(tmp_path / "none.txt"), "--device",
                         "cpu"])
    for kw, match in ((dict(datafiles=[]), "no datafiles"),
                      (dict(datafiles=files, max_ngauss=0), "max_ngauss"),
                      (dict(datafiles=files, kind="wavelet"), "kind"),
                      (dict(datafiles=files, kind=["gauss"]),
                       "one entry per")):
        with pytest.raises(ValueError, match=match):
            TFAC.build_templates(device="cpu", **kw)
    # telemetry= is ported (ROADMAP A13's trace plane): build_templates
    # writes the JAX package's template_fit/template_job/factory_end
    traces = {n: str(tmp_path / f"{n}.jsonl") for n in ("jax", "torch")}
    rj = JFAC.build_templates(files[:2], kind=["gauss", "spline"],
                              max_ngauss=2, gauss_device=True, write=False,
                              telemetry=traces["jax"])
    rt = TFAC.build_templates(files[:2], kind=["gauss", "spline"],
                              max_ngauss=2, gauss_device=True, write=False,
                              telemetry=traces["torch"], device="cpu")
    assert event_counts(traces["torch"]) == event_counts(traces["jax"])
    jobs = {n: [(e["datafile"], e["kind"], e["ngauss"])
                for e in trace_events(traces[n])
                if e["type"] == "template_job"] for n in traces}
    assert jobs["torch"] == jobs["jax"]
    assert [r.ngauss for r in rt] == [r.ngauss for r in rj]
    end = [e for e in trace_events(traces["torch"])
           if e["type"] == "factory_end"]
    assert len(end) == 1 and end[0]["n_jobs"] == 2


@pytest.mark.parametrize("argv,match", [
    (["--batch", "-d", "x.fits"], "requires -M"),
    (["--batch", "-M", "META", "-o", "a.gmodel"], "not supported with"),
    (["--batch", "-M", "META", "--nu_ref", "1500"], "not supported with"),
])
def test_ppgauss_batch_refusals(fleet, argv, match):
    root, _, meta = fleet
    argv = [meta if a == "META" else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        tppgauss.main(argv + ["--device", "cpu"])
