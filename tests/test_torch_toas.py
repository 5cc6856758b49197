"""The PyTorch port end to end: GetTOAs and the pptoas CLI against the
JAX package's GetTOAs on synthetic archives.

Archives: make_fake_pulsar at 32 channels x 256 bins (the sizes of
tests/test_pipeline_toas.py), noise_stds=1.0 (channel S/N ~30).  The
JAX reference runs with config.use_fast_fit=True, as
test_fast_fit_routing_matches_reference does; both sides store the
cross-spectrum in bfloat16 (the default).

.tim lines are parsed and compared field by field:
- TOA: |dTOA| <= 0.05 x TOA error, after referencing the port's TOA to
  the reference's frequency with the port's own DM (each side reports
  at its own zero-covariance frequency, which agree to ~1e-7); TOAs
  without a DM (fit_DM=False, narrowband TOAs) are compared as they
  stand;
- DM: |dDM| <= 0.05 x DM error, where the TOAs carry one;
- flags: equal, except -tmplt (the model path) and the fit-derived
  numbers -snr, -gof, -phi_DM_cov, which are float32 results printed
  to a fixed number of digits and agree to within one unit of the last
  printed digit (plus 1e-5 relative).

The scattering runs (fit_scat) take the complex engine on both sides,
in float64 on the CPU; their -scat_* flags are fit-derived numbers too
and held to the same last-digit rule.
"""

import numpy as np
import pytest

from test_torch_helpers import PAR

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.io import write_gmodel
from pulseportraiture_tpu.io.tim import write_TOAs as jwrite
from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.io.tim import write_TOAs as twrite
from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs

DDMS = [2e-4, -3e-4]
FIT_DERIVED = {"snr", "gof", "phi_DM_cov"}
SCAT_DERIVED = FIT_DERIVED | {
    "scat_time", "scat_time_err", "log10_scat_time", "log10_scat_time_err",
    "scat_ref_freq", "scat_ind", "scat_ind_err"}
# per-channel (narrowband) TOAs: -chan is an integer and stays exact
NB_DERIVED = FIT_DERIVED | {"phs", "phs_err"}
NB_SCAT_DERIVED = NB_DERIVED | SCAT_DERIVED


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_toas")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i, dDM in enumerate(DDMS):
        path = str(root / f"fake-{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=3, nchan=32,
                         nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.0, dDM=dDM,
                         start_MJD=MJD(55100 + 10 * i, 0.1),
                         noise_stds=1.0, dedispersed=False, quiet=True,
                         rng=300 + i)
        files.append(path)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return str(meta), gmodel, files


@pytest.fixture
def fast_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _parse_tim(path):
    """.tim lines -> list of (archive, freq, (day, frac), err, code,
    flags dict of raw strings)."""
    out = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            day, _, frac = tok[2].partition(".")
            flags = dict(zip(tok[5::2], tok[6::2]))
            out.append((tok[0], float(tok[1]), (int(day), float("0." + frac)),
                        float(tok[3]), tok[4], flags))
    return out


def _last_digit(s):
    """One unit in the last printed digit of a formatted number."""
    mant = s.lower().split("e")[0]
    dec = len(mant.split(".")[1]) if "." in mant else 0
    exp = int(s.lower().split("e")[1]) if "e" in s.lower() else 0
    return 10.0 ** (exp - dec)


def _assert_tim_parity(ref_path, got_path, derived=FIT_DERIVED,
                       rel_tol=None):
    """Field-by-field .tim parity (module docstring); rel_tol: {flag name:
    relative tolerance} for fit-derived flags held to that instead of
    the last-digit rule."""
    rel_tol = rel_tol or {}
    ref = _parse_tim(ref_path)
    got = _parse_tim(got_path)
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        assert g[0] == r[0] and g[4] == r[4]
        assert g[1] == pytest.approx(r[1], rel=1e-5)
        # TOA difference [s]; with a DM, the port's TOA moved to the
        # reference's frequency along its own dispersion law
        dt = ((g[2][0] - r[2][0]) + (g[2][1] - r[2][1])) * 86400.0
        assert ("-pp_dm" in g[5]) == ("-pp_dm" in r[5])
        if "-pp_dm" in r[5]:
            dm_g = float(g[5]["-pp_dm"])
            dm_r = float(r[5]["-pp_dm"])
            dme_r = float(r[5]["-pp_dme"])
            assert abs(dm_g - dm_r) <= 0.05 * dme_r
            assert float(g[5]["-pp_dme"]) == pytest.approx(dme_r, rel=1e-3)
            dt += tcfg.Dconst * dm_g * (r[1] ** -2.0 - g[1] ** -2.0)
        assert abs(dt) * 1e6 <= 0.05 * r[3], (dt, r[3])
        assert g[3] == pytest.approx(r[3], rel=1e-3)
        assert set(g[5]) == set(r[5])
        for key, val in r[5].items():
            name = key.lstrip("-")
            if name in ("tmplt", "pp_dm", "pp_dme"):
                continue
            if name in derived:
                tol = _last_digit(val) + 1e-5 * abs(float(val))
                if name in rel_tol:
                    tol = rel_tol[name] * abs(float(val))
                assert abs(float(g[5][key]) - float(val)) <= tol, key
            else:
                assert g[5][key] == val, key


@pytest.mark.parametrize("window,fused", [("auto", "auto"), (128, True)])
def test_tim_parity(dataset, fast_config, tmp_path, window, fused):
    """'auto' derives no window at 256 bins (the unfused full-spectrum
    lane); 128 with fit_fused=True runs the fused DFT -> cross-spectrum
    lane (its plain version on the CPU) end to end."""
    meta, gmodel, files = dataset
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = window
    jcfg.fit_fused = tcfg.fit_fused = fused
    jg = JGetTOAs(meta, gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    tg = TGetTOAs(meta, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    ref_tim, got_tim = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(jg.TOA_list, outfile=ref_tim)
    twrite(tg.TOA_list, outfile=got_tim)
    _assert_tim_parity(ref_tim, got_tim)
    for i in range(len(files)):
        np.testing.assert_array_equal(tg.nfevals[i], jg.nfevals[i])
        np.testing.assert_array_equal(tg.rcs[i], jg.rcs[i])
        assert tg.DeltaDM_means[i] == pytest.approx(
            DDMS[i], abs=max(4 * tg.DeltaDM_errs[i], 2e-4))


@pytest.fixture(scope="module")
def prime_dataset(tmp_path_factory):
    """One archive of 4 subints x 16 channels x 1032 bins (2^3 3 43: a
    prime factor above 5, the shape the kernels' GEMM arm takes on the
    card)."""
    root = tmp_path_factory.mktemp("torch_toas_prime")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    path = str(root / "fake-1032.fits")
    make_fake_pulsar(model, PAR, outfile=path, nsub=4, nchan=16, nbin=1032,
                     nu0=1500.0, bw=800.0, tsub=60.0, phase=0.01,
                     dDM=DDMS[0], start_MJD=MJD(55200, 0.1), noise_stds=1.0,
                     dedispersed=False, quiet=True, rng=310)
    return path, gmodel


def test_tim_parity_prime_nbin(prime_dataset, fast_config, tmp_path):
    """GetTOAs at 1032 bins on the fused lane (use_fast_fit, fit_fused, an
    explicit window of 128 harmonics; the plain version of B1 here, the
    GEMM arm on the card) against the JAX package's GetTOAs on the same
    path: the .tim fields as _assert_tim_parity holds them (TOAs and DMs
    within 0.05 of their errors, flags equal or within a unit of their
    last printed digit)."""
    path, gmodel = prime_dataset
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_fused = tcfg.fit_fused = True
    jg = JGetTOAs(path, gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    tg = TGetTOAs(path, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    ref_tim, got_tim = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(jg.TOA_list, outfile=ref_tim)
    twrite(tg.TOA_list, outfile=got_tim)
    _assert_tim_parity(ref_tim, got_tim)
    np.testing.assert_array_equal(tg.rcs[0], jg.rcs[0])


def test_cli_writes_tim(dataset, fast_config, tmp_path):
    """python -m pulseportraiture_tpu_torch.cli.pptoas on the CPU writes
    the same TOAs as the library call."""
    from pulseportraiture_tpu_torch.cli.pptoas import main

    meta, gmodel, files = dataset
    out = str(tmp_path / "cli.tim")
    assert main(["-d", files[0], "-m", gmodel, "-o", out, "--device", "cpu",
                 "--quiet", "--quality_flags", "--print_phase"]) == 0
    toas = _parse_tim(out)
    assert len(toas) == 3
    assert all("-nfev" in t[5] and "-phs" in t[5] for t in toas)
    tg = TGetTOAs(files[0], gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    lib = str(tmp_path / "lib.tim")
    twrite(tg.TOA_list, outfile=lib)
    assert [t[:5] for t in _parse_tim(lib)] == [t[:5] for t in toas]


def test_one_DM_and_princeton(dataset, fast_config, tmp_path):
    from pulseportraiture_tpu_torch.cli.pptoas import main

    meta, gmodel, files = dataset
    out = str(tmp_path / "one.tim")
    main(["-d", files[1], "-m", gmodel, "-o", out, "--device", "cpu",
          "--quiet", "--one_DM"])
    dms = {float(t[5]["-pp_dm"]) for t in _parse_tim(out)}
    assert len(dms) == 1
    pr = str(tmp_path / "p.tim")
    main(["-d", files[1], "-m", gmodel, "-o", pr, "--device", "cpu",
          "--quiet", "-f", "princeton"])
    with open(pr) as f:
        assert len(f.read().splitlines()) == 3


# ROADMAP C2: options the port and the JAX package agree on, as cases of
# one test.  GetTOAs cases on the dataset through the fused lane
# (window 128); stream cases through stream_wideband_TOAs' raw lane.
C2_CASES = {
    "fit_DM_off": ("gettoas", dict(fit_DM=False)),
    "tscrunch": ("gettoas", dict(tscrunch=True)),
    "DM0": ("gettoas", dict(DM0=3.0)),
    "no_bary": ("gettoas", dict(bary=False)),
    "nu_refs": ("gettoas", dict(nu_refs=(1400.0, None))),
    "nsub_batch_3": ("stream", dict(nsub_batch=3)),
    "max_inflight_1": ("stream", dict(max_inflight=1)),
    "no_prefetch": ("stream", dict(prefetch=False)),
    # the 14 options of ROADMAP C2's probe
    "print_phase": ("gettoas", dict(print_phase=True)),
    "print_flux": ("gettoas", dict(print_flux=True)),
    "print_parangle": ("gettoas", dict(print_parangle=True)),
    "addtnl_toa_flags": ("gettoas", dict(addtnl_toa_flags={
        "pta": "TEST", "grp": "c2"})),
    "nu_fits": ("gettoas", dict(nu_fits=(1400.0,))),
    "quality_flags": ("gettoas", dict(quality_flags=True)),
    "fit_GM": ("gettoas", dict(fit_GM=True)),
    "stream_tscrunch": ("stream", dict(tscrunch=True)),
    "stream_DM0": ("stream", dict(DM0=3.0)),
    "stream_no_bary": ("stream", dict(bary=False)),
    "stream_fit_DM_off": ("stream", dict(fit_DM=False)),
    "stream_print_phase_flux": ("stream", dict(print_phase=True,
                                               print_flux=True)),
    "stream_nu_ref_DM": ("stream", dict(nu_ref_DM=1400.0)),
    "stream_quality_flags": ("stream", dict(quality_flags=True)),
}
# -phs, -flux*, -chi2: float32 results printed to fixed digits, held to
# the last-digit rule of the other fit-derived flags
C2_DERIVED = FIT_DERIVED | {"phs", "phs_err", "flux", "flux_err",
                            "flux_ref_freq", "chi2"}


@pytest.mark.parametrize("case", sorted(C2_CASES))
def test_options_tim_parity(dataset, fast_config, tmp_path, case):
    from pulseportraiture_tpu.pipeline import stream as JS
    from pulseportraiture_tpu_torch.pipeline import stream as TS

    meta, gmodel, files = dataset
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    jcfg.fit_fused = tcfg.fit_fused = True
    lane, kw = C2_CASES[case]
    if lane == "gettoas":
        jg = JGetTOAs(meta, gmodel, quiet=True)
        jg.get_TOAs(quiet=True, **kw)
        tg = TGetTOAs(meta, gmodel, quiet=True, device="cpu")
        tg.get_TOAs(quiet=True, **kw)
        ref_toas, got_toas = jg.TOA_list, tg.TOA_list
    else:
        ref_toas = JS.stream_wideband_TOAs(meta, gmodel, quiet=True,
                                           **kw).TOA_list
        got_toas = TS.stream_wideband_TOAs(meta, gmodel, quiet=True,
                                           device="cpu", **kw).TOA_list
    ref_tim, got_tim = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(ref_toas, outfile=ref_tim)
    twrite(got_toas, outfile=got_tim)
    _assert_tim_parity(ref_tim, got_tim, derived=C2_DERIVED)
    nsub = 1 if kw.get("tscrunch") else 3
    assert len(got_toas) == nsub * len(files)
    assert all((t.DM is None) == (kw.get("fit_DM") is False)
               for t in got_toas)


def _rel_dist(errs, ref):
    return max(abs(errs[k] / ref[k] - 1.0) for k in errs)


def test_fit_GM_float32_toa_errors(tmp_path, fast_config):
    """ROADMAP C1: float32 (phi, DM, GM) fits on the forged 8-channel x
    256-bin int16 and 4-bit archives (header DM 0), fast lane, fused,
    window 128.  The TOA errors of GetTOAs and of the stream, in each
    package, against the float64 complex engine's on the same subints:
    the port's largest relative distance may exceed the JAX package's
    own float32 one by at most 1e-3."""
    import os

    from test_torch_stream import _forge_set

    from pulseportraiture_tpu.pipeline import stream as JS
    from pulseportraiture_tpu_torch.pipeline import stream as TS

    meta, files, tmpl = _forge_set(tmp_path, ("int16", "nbit4"), 0.0)

    def errs(toas, lane):
        return {(lane, os.path.basename(t.archive), t.flags["subint"]):
                t.TOA_error for t in toas}

    jcfg.use_fast_fit = tcfg.use_fast_fit = False
    ref = {}
    for f in files:
        jg = JGetTOAs(f, tmpl, quiet=True)
        jg.get_TOAs(quiet=True, fit_GM=True)
        for lane in ("gettoas", "stream"):
            ref.update(errs(jg.TOA_list, lane))
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 128
    dist = {}
    for name, G, S, kw in (("jax", JGetTOAs, JS, {}),
                           ("port", TGetTOAs, TS, {"device": "cpu"})):
        e = {}
        for f in files:
            g = G(f, tmpl, quiet=True, **kw)
            g.get_TOAs(quiet=True, fit_GM=True)
            e.update(errs(g.TOA_list, "gettoas"))
        e.update(errs(S.stream_wideband_TOAs(
            files, tmpl, nsub_batch=4, quiet=True, fit_GM=True,
            **kw).TOA_list, "stream"))
        assert set(e) == set(ref)
        dist[name] = _rel_dist(e, ref)
    assert dist["port"] <= dist["jax"] + 1e-3, dist


class TestUnportedOptionsRaise:
    """Options whose lanes are not ported are refused, never ignored;
    the ported ones (telemetry, the transport codec) agree with the JAX
    package."""

    def _gt(self, dataset):
        meta, gmodel, files = dataset
        return TGetTOAs(files[0], gmodel, quiet=True, device="cpu")

    def test_telemetry(self, dataset, fast_config, tmp_path):
        """get_TOAs(telemetry=): the JAX driver's events (archive_load,
        archive_fit, quality, run_end) in the same counts, with the same
        nfit; the port's trace passes the JAX validate_trace."""
        from collections import Counter

        from pulseportraiture_tpu import telemetry as JT

        meta, gmodel, files = dataset
        jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
        JGetTOAs(meta, gmodel, quiet=True).get_TOAs(quiet=True, telemetry=jt)
        TGetTOAs(meta, gmodel, quiet=True, device="cpu").get_TOAs(
            quiet=True, telemetry=tt)
        ej, et = JT.load_trace(jt)[1], JT.validate_trace(tt)[1]
        assert Counter(e["type"] for e in et) == \
            Counter(e["type"] for e in ej)
        ends = [[e for e in ev if e["type"] == "run_end"][0]
                for ev in (ej, et)]
        for k in ("driver", "n_toas", "n_archives", "nfit"):
            assert ends[1][k] == ends[0][k], k
        assert ends[1]["nfit"] == len(files)

    @pytest.mark.parametrize("flag,item", [
        pytest.param("--narrowband", None, id="--narrowband-A8"),
        pytest.param("--stream", "A7", id="--stream-A7")])
    def test_cli_lanes(self, dataset, tmp_path, monkeypatch, flag, item):
        """--narrowband and --stream run (tests/test_torch_narrowband.py,
        tests/test_torch_stream.py).  The transport codec (ROADMAP A7) is
        ported: pptoas --stream --transport-compress on writes the JAX
        CLI's .tim.  The narrowband stream's inline zapping (ROADMAP A8)
        is ported: it agrees with the JAX driver."""
        from pulseportraiture_tpu.pipeline.stream import \
            stream_narrowband_TOAs as jstream
        from pulseportraiture_tpu_torch.cli.pptoas import main
        from pulseportraiture_tpu_torch.pipeline.stream import \
            stream_narrowband_TOAs

        meta, gmodel, files = dataset
        if flag == "--stream":
            from pulseportraiture_tpu.cli.pptoas import main as jmain

            # the CLIs set config.transport_compress: restore it after
            monkeypatch.setattr(tcfg, "transport_compress",
                                tcfg.transport_compress)
            monkeypatch.setattr(jcfg, "transport_compress",
                                jcfg.transport_compress)
            ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
            args = ["-d", files[0], "-m", gmodel, flag, "--quiet",
                    "--transport-compress", "on"]
            jmain(args + ["-o", ref])
            assert main(args + ["-o", got, "--device", "cpu"]) == 0
            assert tcfg.transport_compress is True
            _assert_tim_parity(ref, got)
            return
        ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
        rj = jstream(files[0], gmodel, quiet=True, zap_inline=True)
        rt = stream_narrowband_TOAs(files[0], gmodel, device="cpu",
                                    quiet=True, zap_inline=True)
        jwrite(rj.TOA_list, outfile=ref)
        twrite(rt.TOA_list, outfile=got)
        _assert_tim_parity(ref, got, derived=NB_DERIVED)

    def test_spline_template(self, tmp_path):
        """Spline templates are read (tests/test_torch_spline.py holds
        their portraits); a .npz that is no spline model raises."""
        from pulseportraiture_tpu_torch.io.splmodel import (
            SplineModel, write_spline_model)
        from pulseportraiture_tpu_torch.pipeline import TemplateModel

        p = tmp_path / "m.npz"
        np.savez(p, x=np.zeros(3))
        with pytest.raises(KeyError):
            TemplateModel(str(p), device="cpu")
        good = tmp_path / "flat.npz"
        write_spline_model(SplineModel(
            "flat", "src", "data", np.linspace(0.0, 1.0, 16),
            np.zeros((16, 0)), (np.array([1000.0, 2000.0]),
                                np.zeros((0, 2)), 1)), str(good), quiet=True)
        tm = TemplateModel(str(good), device="cpu")
        assert tm.kind == "spline" and tm.nu_ref_model == 1500.0
        np.testing.assert_array_equal(
            tm.portrait([1100.0, 1900.0], 16),
            np.tile(np.linspace(0.0, 1.0, 16), (2, 1)))


# ---------------------------------------------------------------------
# the scattering lane: GetTOAs(fit_scat=True) through the complex engine

@pytest.fixture(scope="module")
def scat_dataset(tmp_path_factory):
    """A scattered archive (t_scat 0.3 ms at 1500 MHz, alpha -4) with a
    one-channel subint (the degenerate phase-only group, whose fixed
    tau seed still scatters the model)."""
    root = tmp_path_factory.mktemp("torch_scat_toas")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    w = np.ones((3, 32))
    w[2, 1:] = 0.0
    path = str(root / "scat.fits")
    make_fake_pulsar(model, PAR, outfile=path, nsub=3, nchan=32, nbin=256,
                     nu0=1500.0, bw=800.0, tsub=60.0, phase=0.01, dDM=2e-4,
                     t_scat=3e-4, alpha=-4.0, start_MJD=MJD(55100, 0.1),
                     noise_stds=0.05, weights=w, dedispersed=False,
                     quiet=True, rng=5)
    return path, gmodel


SCAT_RUNS = {
    "neutral_seed": dict(fit_scat=True),
    "auto_seed": dict(fit_scat=True, scat_guess="auto"),
    "triple_fix_alpha": dict(fit_scat=True, scat_guess=(3e-4, 1500.0, -4.0),
                             fix_alpha=True),
    "linear_tau": dict(fit_scat=True, log10_tau=False,
                       scat_guess=(3e-4, 1500.0, -4.0)),
    "nu_tau": dict(fit_scat=True, scat_guess="auto",
                   nu_refs=(None, 1400.0)),
    "ir_dm_smear": dict(fit_scat=True, scat_guess="auto"),
}


@pytest.mark.parametrize("run", sorted(SCAT_RUNS))
def test_tim_parity_fit_scat(scat_dataset, fast_config, tmp_path, run):
    """GetTOAs(fit_scat=True) .tim files, field by field, against the JAX
    GetTOAs: both take the complex engine for every group (the
    degenerate subint's phase-only group included) even with the fast
    fit on, as the JAX package routes them."""
    path, gmodel = scat_dataset
    kw = SCAT_RUNS[run]
    jg = JGetTOAs(path, gmodel, quiet=True)
    tg = TGetTOAs(path, gmodel, quiet=True, device="cpu")
    if run == "ir_dm_smear":
        for gt in (jg, tg):
            gt.instrumental_response_dict.update(
                {"DM-smear": True, "wids": [0.002], "irf_types": ["rect"]})
    jg.get_TOAs(quiet=True, **kw)
    tg.get_TOAs(quiet=True, **kw)
    ref_tim, got_tim = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(jg.TOA_list, outfile=ref_tim)
    twrite(tg.TOA_list, outfile=got_tim)
    _assert_tim_parity(ref_tim, got_tim, derived=SCAT_DERIVED)
    np.testing.assert_array_equal(tg.nfevals[0], jg.nfevals[0])
    np.testing.assert_array_equal(tg.rcs[0], jg.rcs[0])
    toas = _parse_tim(got_tim)
    assert all("-scat_time" in t[5] for t in toas)
    assert ("-scat_ind_err" in toas[0][5]) == (not kw.get("fix_alpha"))
    if "nu_refs" in kw:
        assert all(t[5]["-scat_ref_freq"] == "1400.000" for t in toas)
    # the degenerate subint reports its fixed seed, phase only
    assert toas[2][5]["-nchx"] == "1" and toas[2][5]["-pp_dme"] == \
        "0.0000000"


def test_complex_engine_without_scattering(dataset, fast_config, tmp_path):
    """config.use_fast_fit=False sends every group through the complex
    engine, in float64 on both sides."""
    meta, gmodel, files = dataset
    jcfg.use_fast_fit = tcfg.use_fast_fit = False
    jg = JGetTOAs(files[0], gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    tg = TGetTOAs(files[0], gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    ref_tim, got_tim = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(jg.TOA_list, outfile=ref_tim)
    twrite(tg.TOA_list, outfile=got_tim)
    _assert_tim_parity(ref_tim, got_tim)
    np.testing.assert_array_equal(tg.nfevals[0], jg.nfevals[0])


def test_cli_fit_scat(scat_dataset, fast_config, tmp_path):
    """pptoas --fit_scat --scat_guess auto --nu_tau on the CPU writes the
    library call's scattering TOAs; a bad --scat_guess string raises."""
    from pulseportraiture_tpu_torch.cli.pptoas import main

    path, gmodel = scat_dataset
    out = str(tmp_path / "cli.tim")
    assert main(["-d", path, "-m", gmodel, "-o", out, "--device", "cpu",
                 "--quiet", "--fit_scat", "--scat_guess", "auto",
                 "--nu_tau", "1400"]) == 0
    tg = TGetTOAs(path, gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True, fit_scat=True, scat_guess="auto",
                nu_refs=(None, 1400.0))
    lib = str(tmp_path / "lib.tim")
    twrite(tg.TOA_list, outfile=lib)
    with open(out) as f, open(lib) as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="auto"):
        main(["-d", path, "-m", gmodel, "--device", "cpu", "--quiet",
              "--scat_guess", "auto"])
