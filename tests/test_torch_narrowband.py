"""The PyTorch port's narrowband lane on the CPU, against the JAX package.

- Phase-shift fit (fit/phase_shift): fit_phase_shift_batch and
  fit_phase_shift against the JAX functions.  float64: phi within
  1e-10 rot, phi_err, scale, scale_err, chi2 and S/N within 1e-9
  relative; float32: phi within 1e-5 rot.  Zero-noise rows (zapped
  channels) give the same non-finite values, and an all-zero CCF (a
  tie over every lag) resolves to the first lag on both sides.
- Narrowband TOAs, .tim parity (test_torch_toas._assert_tim_parity:
  TOAs within 0.05 sigma, -chan exact, fit-derived flags within one
  unit of their last printed digit): GetTOAs.get_narrowband_TOAs (plain,
  print_phase, fit_scat with scat_guess 'auto'), stream_narrowband_TOAs
  on forged int16, NBIT=2 and NBIT=4 archives (plain and fit_scat), and
  pptoas --narrowband / --psrchive / --stream --narrowband, each
  against the JAX package.  Both packages run float64 here (use_fast_fit
  'auto' resolves off on the CPU) unless a case says float32.
- Within the port, the stream against GetTOAs to the JAX package's own
  limits (tests/test_stream.py): 1e-3 us, 1e-6 relative in TOA error
  and S/N, 1e-9 rot in -phs; with fit_scat 1e-2 us and 1e-3 in
  log10_scat_time.
- get_crosscheck_TOAs / get_psrchive_TOAs against the JAX package's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import PAR
from test_torch_toas import (NB_DERIVED, NB_SCAT_DERIVED, _assert_tim_parity,
                             _parse_tim)

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu.io import write_gmodel
from pulseportraiture_tpu.io.tim import write_TOAs as jwrite
from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
from pulseportraiture_tpu.pipeline import stream as JS
from pulseportraiture_tpu.synth import default_test_model, make_fake_pulsar
from pulseportraiture_tpu.utils.mjd import MJD
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.fit import phase_shift as TPS
from pulseportraiture_tpu_torch.io.tim import write_TOAs as twrite
from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs
from pulseportraiture_tpu_torch.pipeline import stream as TS

JPS = importlib.import_module("pulseportraiture_tpu.fit.phase_shift")


# ---------------------------------------------------------------------
# the phase-shift fit

def _profiles():
    """(2, 4, 256) shifted, scaled noisy copies of a two-component
    profile, one zero-noise row and one all-zero data row."""
    rng = np.random.default_rng(71)
    nbin = 256
    x = np.arange(nbin) / nbin
    model = (np.exp(-0.5 * ((x - 0.5) / 0.03) ** 2)
             + 0.3 * np.exp(-0.5 * ((x - 0.56) / 0.02) ** 2))
    rows = [np.roll(model, s) * a + 0.05 * rng.standard_normal(nbin)
            for s, a in ((3, 1.0), (-40, 0.5), (100, 2.0), (0, 1.0))]
    data = np.stack([np.stack(rows), 0.7 * np.stack(rows)])
    noise = np.full((2, 4), 0.05)
    noise[0, 3] = 0.0
    data[1, 2] = 0.0
    return data, model, noise


FIELDS = ("phase", "phase_err", "scale", "scale_err", "chi2", "snr",
          "red_chi2")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("oversamp,iters", [(8, 5), (16, 2), (4, 0)])
def test_fit_phase_shift_batch(dtype, oversamp, iters):
    data, model, noise = _profiles()
    dt = np.dtype(dtype)
    ref = JPS.fit_phase_shift_batch(
        jnp.asarray(data.astype(dt)),
        jnp.asarray(np.broadcast_to(model, data.shape).astype(dt)),
        jnp.asarray(noise.astype(dt)), oversamp=oversamp,
        newton_iters=iters)
    got = TPS.fit_phase_shift_batch(data.astype(dt), model.astype(dt),
                                    noise.astype(dt), oversamp=oversamp,
                                    newton_iters=iters, device="cpu")
    assert got.phase.dtype == getattr(torch, dtype)
    assert got.dof == 254 and np.all(np.asarray(ref.dof) == 254)
    for k in FIELDS:
        r = np.asarray(ref[k], np.float64)
        g = got[k].numpy().astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(r), k)
    fin = np.isfinite(np.asarray(ref.phase_err))
    dphi = np.abs(got.phase.numpy() - np.asarray(ref.phase))
    if dtype == "float64":
        assert np.all(dphi <= 1e-10), dphi
        for k in FIELDS[1:]:
            r = np.asarray(ref[k])[fin]
            g = got[k].numpy()[fin]
            assert np.all(np.abs(g - r) <= 1e-9 * np.abs(r)), k
    else:
        assert np.all(dphi <= 1e-5), dphi
    # the zero-noise row gives no finite error, S/N or scale; the
    # all-zero data row's CCF ties at every lag and resolves to lag 0
    assert not torch.isfinite(got.phase_err[0, 3])
    assert torch.isnan(got.snr[0, 3])
    assert got.phase[1, 2] == 0.0 == float(ref.phase[1, 2])


def test_fit_phase_shift_single():
    """The scalar fit with the power-spectrum noise estimate, and with
    an explicit noise, in float64 (the JAX function is host-pinned)."""
    data, model, _ = _profiles()
    for noise in (None, 0.05):
        ref = JPS.fit_phase_shift(jnp.asarray(data[0, 1]),
                                  jnp.asarray(model), noise_std=noise)
        got = TPS.fit_phase_shift(data[0, 1], model, noise_std=noise,
                                  device="cpu")
        assert abs(float(got.phase) - float(ref.phase)) <= 1e-10
        for k in FIELDS[1:]:
            assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-9)
        # the injected shift: data rolled by -40 bins of 256
        assert abs(float(got.phase) + 40.0 / 256) < 5 * float(got.phase_err)


# ---------------------------------------------------------------------
# narrowband TOAs

@pytest.fixture(scope="module")
def nb_dataset(tmp_path_factory):
    """Two 16-channel x 256-bin archives of 2 subints (noise 0.03, the
    JAX package's own narrowband parity archives), one 2-bit, with a
    zapped channel in the first."""
    root = tmp_path_factory.mktemp("torch_nb")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    w = np.ones((2, 16))
    w[1, 5] = 0.0
    files = []
    for i, nbit in enumerate((16, 2)):
        path = str(root / f"nb{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=16,
                         nbin=256, nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.02 * i, dDM=1e-4,
                         start_MJD=MJD(55700 + i, 0.2),
                         noise_stds=0.03 if nbit == 16 else 0.5,
                         weights=w if i == 0 else None, dedispersed=False,
                         quiet=True, rng=800 + i, nbit=nbit)
        files.append(path)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return root, str(meta), files, gmodel


@pytest.fixture
def nb_config():
    """Restores the knobs a case sets."""
    keys = ("use_fast_fit", "raw_subbyte")
    old_j = {k: getattr(jcfg, k) for k in keys}
    old_t = {k: getattr(tcfg, k) for k in keys}
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _write_pair(tmp_path, ref_toas, got_toas):
    ref, got = str(tmp_path / "ref.tim"), str(tmp_path / "got.tim")
    jwrite(ref_toas, outfile=ref)
    twrite(got_toas, outfile=got)
    return ref, got


NB_RUNS = {
    "plain": dict(),
    "print_phase": dict(print_phase=True, addtnl_toa_flags={"pta": "X"}),
    "fit_scat_auto": dict(fit_scat=True, scat_guess="auto",
                          print_phase=True),
    "fit_scat_triple_linear": dict(fit_scat=True, log10_tau=False,
                                   scat_guess=(3e-4, 1500.0, -4.0)),
}


@pytest.mark.parametrize("run", sorted(NB_RUNS))
def test_get_narrowband_tim_parity(nb_dataset, nb_config, tmp_path, run):
    root, meta, files, gmodel = nb_dataset
    kw = NB_RUNS[run]
    jg = JGetTOAs(meta, gmodel, quiet=True)
    jg.get_narrowband_TOAs(quiet=True, **kw)
    tg = TGetTOAs(meta, gmodel, quiet=True, device="cpu")
    tg.get_narrowband_TOAs(quiet=True, **kw)
    assert len(tg.TOA_list) == 2 * 2 * 16 - 1
    assert tg.order == files
    ref, got = _write_pair(tmp_path, jg.TOA_list, tg.TOA_list)
    _assert_tim_parity(ref, got, derived=NB_SCAT_DERIVED
                       if kw.get("fit_scat") else NB_DERIVED)
    toas = _parse_tim(got)
    assert all(t[1] == pytest.approx(float(
        tg.TOA_list[i].frequency)) for i, t in enumerate(toas))
    assert ("-phs" in toas[0][5]) == bool(kw.get("print_phase"))
    if kw.get("fit_scat"):
        # each channel's tau is referenced to its own frequency
        assert all(float(t[5]["-scat_ref_freq"]) == pytest.approx(t[1])
                   for t in toas)
    if kw.get("addtnl_toa_flags"):
        assert all(t[5]["-pta"] == "X" for t in toas)


def test_narrowband_linear_tau_needs_guess(nb_dataset):
    root, meta, files, gmodel = nb_dataset
    tg = TGetTOAs(files[0], gmodel, quiet=True, device="cpu")
    with pytest.raises(ValueError, match="scat_guess"):
        tg.get_narrowband_TOAs(fit_scat=True, log10_tau=False)
    with pytest.raises(ValueError, match="scat_guess"):
        TS.stream_narrowband_TOAs(files, gmodel, fit_scat=True,
                                  log10_tau=False, device="cpu")


def test_narrowband_recovers_injection(nb_dataset):
    """Sanity on the data: the int16 archive's per-channel phases sit
    on the injected dispersion law within 5 sigma."""
    root, meta, files, gmodel = nb_dataset
    tg = TGetTOAs(files[0], gmodel, quiet=True, device="cpu")
    tg.get_narrowband_TOAs(quiet=True, print_phase=True)
    Dc = tcfg.Dconst
    for t in tg.TOA_list:
        nu = t.frequency
        exp = (Dc * (PAR["DM"] + 1e-4) * nu ** -2.0
               - Dc * PAR["DM"] * 1500.0 ** -2.0) / PAR["P0"]
        d = (t.flags["phs"] - exp + 0.5) % 1.0 - 0.5
        assert abs(d) < 5 * t.flags["phs_err"], (nu, d)


def test_crosscheck_tim_parity(nb_dataset, tmp_path):
    """get_crosscheck_TOAs (host NumPy, one TOA per subint) and the
    get_psrchive_TOAs shim give the JAX package's TOAs."""
    root, meta, files, gmodel = nb_dataset
    jg = JGetTOAs(meta, gmodel, quiet=True)
    tg = TGetTOAs(meta, gmodel, quiet=True, device="cpu")
    ref_toas = jg.get_crosscheck_TOAs(quiet=True)
    got_toas = tg.get_crosscheck_TOAs(quiet=True)
    assert len(got_toas) == 4 and tg.TOA_list == []
    ref, got = _write_pair(tmp_path, ref_toas, got_toas)
    _assert_tim_parity(ref, got)
    shim = tg.get_psrchive_TOAs(quiet=True, algorithm="FDM")
    assert [t.MJD.frac for t in shim] == [t.MJD.frac for t in got_toas]
    assert all(t.flags["alg"] == "ccf-parabolic" for t in shim)


# ---------------------------------------------------------------------
# the narrowband stream

@pytest.fixture(scope="module")
def forged_nb(tmp_path_factory):
    """Forged int16, NBIT=2 and NBIT=4 archives (2 subints x 8 channels
    x 256 bins, header DM 0) and their tscrunched int16 template."""
    from test_torch_stream import _forge_set

    root = tmp_path_factory.mktemp("torch_nb_stream")
    return (root,) + _forge_set(root, ("int16", "nbit2", "nbit4"), 0.0)


STREAM_RUNS = {
    "plain": dict(print_phase=True),
    "fit_scat_auto": dict(fit_scat=True, scat_guess="auto"),
    "fit_scat_neutral": dict(fit_scat=True, print_phase=True),
}


@pytest.mark.parametrize("run", sorted(STREAM_RUNS))
def test_stream_narrowband_tim_parity(forged_nb, nb_config, run):
    """The port's stream against the JAX package's on every forged wire
    format (raw buckets, one per format)."""
    from test_torch_stream import _tim_lines

    root, meta, files, tmpl = forged_nb
    kw = STREAM_RUNS[run]
    ref, got = str(root / f"jax_{run}.tim"), str(root / f"torch_{run}.tim")
    jres = JS.stream_narrowband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                                     tim_out=ref, **kw)
    res = TS.stream_narrowband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                                    tim_out=got, device="cpu", **kw)
    assert res.dispatch_shapes == {f"8x256:raw:{c}": 1
                                   for c in ("i16", "p2", "p4")}
    # the forge zaps channel 0 of every subint
    assert len(res.TOA_list) == len(jres.TOA_list) == 3 * (2 * 8 - 2)
    assert res.order == files
    _assert_tim_parity(_tim_lines(ref, ref + ".lines"),
                       _tim_lines(got, got + ".lines"),
                       derived=NB_SCAT_DERIVED if kw.get("fit_scat")
                       else NB_DERIVED)


def test_stream_narrowband_float32(forged_nb, nb_config):
    """use_fast_fit on: both packages' raw lanes run float32."""
    from test_torch_stream import _tim_lines

    root, meta, files, tmpl = forged_nb
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    ref, got = str(root / "jax_f32.tim"), str(root / "torch_f32.tim")
    JS.stream_narrowband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                              tim_out=ref, print_phase=True)
    TS.stream_narrowband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                              tim_out=got, device="cpu", print_phase=True)
    _assert_tim_parity(_tim_lines(ref, ref + ".lines"),
                       _tim_lines(got, got + ".lines"), derived=NB_DERIVED)


def _by_key(toas):
    return {(t.archive, t.flags["subint"], t.flags["chan"]): t for t in toas}


def _dt_us(a, b):
    return abs(((a.MJD.day - b.MJD.day) + (a.MJD.frac - b.MJD.frac))
               * 86400.0e6)


@pytest.mark.parametrize("fit_scat", [False, True])
def test_stream_matches_gettoas(nb_dataset, fit_scat):
    """Within the port, float64: the stream (raw lane, max_iter 25)
    against GetTOAs (host-decoded, the same max_iter) to the JAX
    package's own stream-vs-GetTOAs limits."""
    root, meta, files, gmodel = nb_dataset
    kw = dict(fit_scat=True, scat_guess="auto") if fit_scat else {}
    res = TS.stream_narrowband_TOAs(files, gmodel, nsub_batch=3,
                                    print_phase=True, quiet=True,
                                    device="cpu", **kw)
    tg = TGetTOAs(files, gmodel, quiet=True, device="cpu")
    tg.get_narrowband_TOAs(print_phase=True, quiet=True, max_iter=25, **kw)
    got = _by_key(res.TOA_list)
    assert len(got) == len(tg.TOA_list) == 2 * 2 * 16 - 1
    for r in tg.TOA_list:
        t = got[(r.archive, r.flags["subint"], r.flags["chan"])]
        assert t.frequency == r.frequency
        if fit_scat:
            assert _dt_us(t, r) < 1e-2
            assert t.flags["log10_scat_time"] == pytest.approx(
                r.flags["log10_scat_time"], abs=1e-3)
        else:
            assert _dt_us(t, r) < 1e-3
            assert t.TOA_error == pytest.approx(r.TOA_error, rel=1e-6)
            assert t.flags["snr"] == pytest.approx(r.flags["snr"], rel=1e-6)
            assert t.flags["phs"] == pytest.approx(r.flags["phs"], abs=1e-9)


def test_decoded_lane_and_raw_subbyte(nb_dataset, nb_config, tmp_path):
    """config.raw_subbyte = False refuses the packed 2-bit payload in
    read_archive(decode=False): the archive takes the host-decoded lane
    with the same per-channel fits."""
    root, meta, files, gmodel = nb_dataset
    raw = TS.stream_narrowband_TOAs(files[1:], gmodel, quiet=True,
                                    device="cpu", print_phase=True)
    tcfg.raw_subbyte = False
    with pytest.raises(ValueError, match="raw_subbyte"):
        TS._load_raw(files[1], torch.device("cpu"))
    dec = TS.stream_narrowband_TOAs(files[1:], gmodel, quiet=True,
                                    device="cpu", print_phase=True)
    assert raw.dispatch_shapes == {"16x256:raw:p2": 1}
    assert dec.dispatch_shapes == {"16x256:dec": 1}
    ref, got = _write_pair(tmp_path, raw.TOA_list, dec.TOA_list)
    _assert_tim_parity(ref, got, derived=NB_DERIVED)


def test_stream_narrowband_resume(nb_dataset, tmp_path):
    """The executor's checkpoints carry over: a resumed run skips the
    completed archive and ends with the uninterrupted run's file."""
    root, meta, files, gmodel = nb_dataset
    full = tmp_path / "full.tim"
    TS.stream_narrowband_TOAs(files, gmodel, device="cpu", quiet=True,
                              tim_out=str(full))
    lines = full.read_text().splitlines(keepends=True)
    first_done = next(i for i, ln in enumerate(lines)
                      if ln.startswith("C ppt-done "))
    part = tmp_path / "part.tim"
    part.write_text("".join(lines[:first_done + 1]) + "torn 1400.0")
    res = TS.stream_narrowband_TOAs(files, gmodel, device="cpu", quiet=True,
                                    tim_out=str(part), resume=True)
    assert {t.archive for t in res.TOA_list} == {files[1]}
    assert part.read_bytes() == full.read_bytes()


def test_no_card(nb_dataset, monkeypatch):
    """The entry points default to CUDA and raise without a card."""
    root, meta, files, gmodel = nb_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, model, noise = _profiles()
    with pytest.raises(RuntimeError):
        TPS.fit_phase_shift_batch(data, model, noise)
    with pytest.raises(RuntimeError):
        TPS.fit_phase_shift(data[0, 0], model)
    with pytest.raises(RuntimeError):
        TGetTOAs(files[0], gmodel, quiet=True)
    with pytest.raises(RuntimeError):
        TS.stream_narrowband_TOAs(files, gmodel, quiet=True)


# ---------------------------------------------------------------------
# the CLI

def _cli_pair(tmp_path, args, name):
    from pulseportraiture_tpu.cli.pptoas import main as jmain
    from pulseportraiture_tpu_torch.cli.pptoas import main as tmain

    ref, got = str(tmp_path / f"{name}_jax.tim"), str(
        tmp_path / f"{name}_torch.tim")
    assert jmain(args + ["-o", ref, "--quiet"]) == 0
    assert tmain(args + ["-o", got, "--quiet", "--device", "cpu"]) == 0
    return ref, got


@pytest.mark.parametrize("flags", [["--narrowband"], ["--psrchive"],
                                   ["--stream", "--narrowband"],
                                   ["--narrowband", "--fit_scat",
                                    "--scat_guess", "auto"]])
def test_cli_narrowband(nb_dataset, nb_config, tmp_path, flags):
    """pptoas per-channel routes against the JAX CLI's: --psrchive
    routes to the narrowband TOAs, as in the JAX package."""
    root, meta, files, gmodel = nb_dataset
    ref, got = _cli_pair(tmp_path, ["-d", meta, "-m", gmodel,
                                    "--print_phase"] + flags, "cli")
    _assert_tim_parity(ref, got, derived=NB_SCAT_DERIVED
                       if "--fit_scat" in flags else NB_DERIVED)
    assert len(_parse_tim(got)) == 2 * 2 * 16 - 1


def test_cli_princeton_zero_dDMs(nb_dataset, tmp_path):
    from pulseportraiture_tpu_torch.cli.pptoas import main

    root, meta, files, gmodel = nb_dataset
    for extra in ([], ["--stream"]):
        out = tmp_path / f"p{len(extra)}.tim"
        assert main(["-d", meta, "-m", gmodel, "--narrowband", "-f",
                     "princeton", "-o", str(out), "--quiet", "--device",
                     "cpu"] + extra) == 0
        lines = out.read_text().splitlines()
        assert len(lines) == 2 * 2 * 16 - 1


REFUSALS = {
    "quality_flags": (["--narrowband", "--quality_flags"], SystemExit),
    "bound": (["--narrowband", "--bound", "phi:-0.1,0.1"], SystemExit),
    "stream_one_DM": (["--stream", "--narrowband", "--one_DM"], SystemExit),
    "stream_flux": (["--stream", "--narrowband", "--print_flux"],
                    SystemExit),
    "stream_parangle": (["--stream", "--narrowband", "--print_parangle"],
                        SystemExit),
    "stream_GM": (["--stream", "--narrowband", "--fit_dt4"], SystemExit),
    "stream_psrchive": (["--stream", "--narrowband", "--psrchive"],
                        SystemExit),
    "wideband_stream_psrchive": (["--stream", "--psrchive"], SystemExit),
    # the trace covers GetTOAs' wideband path and the --stream drivers:
    # the JAX CLI exits on a traced non-stream narrowband run
    "telemetry": (["--narrowband", "--telemetry", "t.jsonl"], SystemExit),
    # the transport codec (ported) rides the stream: the narrowband
    # stream takes the flag and, as in the JAX package, ships plainly
    "transport": (["--stream", "--narrowband", "--transport-compress",
                   "on"], None),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_cli_refusals(nb_dataset, case, tmp_path, monkeypatch):
    """The JAX CLI's refusals, raised by both CLIs; the flags that run
    ("transport") write the JAX CLI's .tim."""
    from pulseportraiture_tpu.cli.pptoas import main as jmain
    from pulseportraiture_tpu_torch.cli.pptoas import main

    root, meta, files, gmodel = nb_dataset
    args, exc = REFUSALS[case]
    if exc is None:
        for cfg in (tcfg, jcfg):
            monkeypatch.setattr(cfg, "transport_compress",
                                cfg.transport_compress)
        ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
        jmain(["-d", files[0], "-m", gmodel, "--quiet", "-o", ref] + args)
        assert main(["-d", files[0], "-m", gmodel, "--device", "cpu",
                     "--quiet", "-o", got] + args) == 0
        _assert_tim_parity(ref, got, derived=NB_DERIVED)
        return
    with pytest.raises(exc):
        main(["-d", files[0], "-m", gmodel, "--device", "cpu",
              "--quiet"] + args)
    with pytest.raises(exc):
        jmain(["-d", files[0], "-m", gmodel, "--quiet"] + args)
