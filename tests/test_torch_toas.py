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
  at its own zero-covariance frequency, which agree to ~1e-7);
- DM: |dDM| <= 0.05 x DM error;
- flags: equal, except -tmplt (the model path) and the fit-derived
  numbers -snr, -gof, -phi_DM_cov, which are float32 results printed
  to a fixed number of digits and agree to within one unit of the last
  printed digit.
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
FIT_DERIVED = {"snr": 1e-3, "gof": 1e-3, "phi_DM_cov": None}


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


def _assert_tim_parity(ref_path, got_path):
    ref = _parse_tim(ref_path)
    got = _parse_tim(got_path)
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        assert g[0] == r[0] and g[4] == r[4]
        assert g[1] == pytest.approx(r[1], rel=1e-5)
        dm_g = float(g[5]["-pp_dm"])
        dm_r = float(r[5]["-pp_dm"])
        dme_r = float(r[5]["-pp_dme"])
        assert abs(dm_g - dm_r) <= 0.05 * dme_r
        assert float(g[5]["-pp_dme"]) == pytest.approx(dme_r, rel=1e-3)
        # TOA difference [s], the port's TOA moved to the reference's
        # frequency along its own dispersion law
        dt = ((g[2][0] - r[2][0]) + (g[2][1] - r[2][1])) * 86400.0
        dt += tcfg.Dconst * dm_g * (r[1] ** -2.0 - g[1] ** -2.0)
        assert abs(dt) * 1e6 <= 0.05 * r[3], (dt, r[3])
        assert g[3] == pytest.approx(r[3], rel=1e-3)
        assert set(g[5]) == set(r[5])
        for key, val in r[5].items():
            name = key.lstrip("-")
            if name in ("tmplt", "pp_dm", "pp_dme"):
                continue
            if name in FIT_DERIVED:
                tol = _last_digit(val) + 1e-5 * abs(float(val))
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


class TestUnportedOptionsRaise:
    """Options whose lanes are not ported are refused, never ignored."""

    def _gt(self, dataset):
        meta, gmodel, files = dataset
        return TGetTOAs(files[0], gmodel, quiet=True, device="cpu")

    def test_fit_scat(self, dataset, fast_config):
        with pytest.raises(NotImplementedError, match="A6"):
            self._gt(dataset).get_TOAs(fit_scat=True, quiet=True)

    def test_instrumental_response(self, dataset, fast_config):
        gt = self._gt(dataset)
        gt.instrumental_response_dict["wids"].append(0.05)
        gt.instrumental_response_dict["irf_types"].append("rect")
        with pytest.raises(NotImplementedError, match="A6"):
            gt.get_TOAs(quiet=True)

    def test_telemetry(self, dataset, fast_config, tmp_path):
        with pytest.raises(NotImplementedError, match="A13"):
            self._gt(dataset).get_TOAs(quiet=True,
                                       telemetry=str(tmp_path / "t.jsonl"))

    def test_complex_engine(self, dataset, fast_config):
        tcfg.use_fast_fit = False
        with pytest.raises(NotImplementedError, match="A6"):
            self._gt(dataset).get_TOAs(quiet=True)

    @pytest.mark.parametrize("flag,item", [("--narrowband", "A8"),
                                           ("--stream", "A7")])
    def test_cli_lanes(self, dataset, flag, item):
        """--narrowband is refused; --stream runs (tests/
        test_torch_stream.py), and what it still refuses is its
        transport codec."""
        from pulseportraiture_tpu_torch.cli.pptoas import main

        meta, gmodel, files = dataset
        extra = ["--transport-compress", "on"] if flag == "--stream" else []
        with pytest.raises(NotImplementedError, match=item):
            main(["-d", files[0], "-m", gmodel, "--device", "cpu", flag]
                 + extra)

    def test_spline_template(self, tmp_path):
        from pulseportraiture_tpu_torch.pipeline import TemplateModel

        p = tmp_path / "m.npz"
        np.savez(p, x=np.zeros(3))
        with pytest.raises(NotImplementedError, match="A3"):
            TemplateModel(str(p), device="cpu")
