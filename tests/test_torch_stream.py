"""The PyTorch port's streaming campaign lane (pipeline/stream.py) on the
CPU, against the JAX package's stream_wideband_TOAs.

End to end: archives forged as in tests/test_pallas_interpret.py
(2 subints x 8 channels x 256 bins; int16 and NBIT=1/2/4 packed
samples) in one metafile, streamed by both packages with the fast fit,
the fused lane and a 128-harmonic window.  The JAX side runs
fit_pallas=False, whose .tim equals its Pallas run byte for byte
(test_pallas_interpret.py's own gates).  Both run the raw lane in
float32.  .tim lines are compared with test_torch_toas's tolerances:
TOA and DM within 0.05 sigma, flags equal (fit-derived numbers within
one unit of their last printed digit).

Spies on the plain B2 version show which buckets took the decode-fused
branch.  The scattering runs (fit_scat) compare the port's stream with
the JAX package's on scattered int16 and 2-bit archives, with the
limits of tests/test_stream.py's fast-lane scattering parity or
tighter; a spy on the plain B1 version shows the scatter lane ran its
want_m2 form and B2 never ran.  The executor tests (resume after a torn tail, a degenerate
one-channel subint, the exact in-flight bound, one device vs two) run
the port alone on make_fake_pulsar archives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_helpers import PAR
from test_torch_toas import _assert_tim_parity, _parse_tim

from fits_forge import forge_archive, gaussian_portrait

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch.ops import fused as TFu
from pulseportraiture_tpu_torch.pipeline import stream as TS

_NSUB, _NCHAN, _NBIN = 2, 8, 256
_HWIN = 128
_CODES = {"int16": "i16", "nbit1": "p1", "nbit2": "p2", "nbit4": "p4"}


def _noisy_maker(nchan, nbin, nsub, seed=3, sigma=0.08):
    """test_pallas_interpret._noisy_maker, single pol."""
    base = gaussian_portrait(nchan, nbin)
    rng = np.random.default_rng(seed)
    noise = {s: rng.normal(0.0, sigma, (nchan, nbin)) for s in range(nsub)}
    return lambda s, p: base + 0.1 * s + noise[s]


def _forge_set(root, dtypes, dm):
    """One forged archive per wire format in a metafile, and the first
    archive tscrunched as the template: (metafile, archives, template)."""
    from pulseportraiture_tpu.io.psrfits import (read_archive,
                                                 unload_new_archive)

    files = []
    for dtype in dtypes:
        f = str(root / f"{dtype}.fits")
        forge_archive(f, nsub=_NSUB, nchan=_NCHAN, nbin=_NBIN, dedisp=0,
                      dm=dm, data_dtype=dtype,
                      data_maker=_noisy_maker(_NCHAN, _NBIN, _NSUB,
                                              seed=3 + list(_CODES).index(
                                                  dtype)))
        files.append(f)
    arch = read_archive(files[0])
    arch.tscrunch()
    tmpl = str(root / "tmpl.fits")
    unload_new_archive(np.asarray(arch.amps), arch, tmpl, DM=0.0, dmc=1,
                       quiet=True)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return str(meta), files, tmpl


@pytest.fixture(scope="module")
def forged(tmp_path_factory):
    """Every wire format, forged with header DM 0: the forged data carry
    no dispersion, and at the forge's default of 12.5 the packed
    archives' fits start among several minima
    (test_stream_parity_at_header_dm)."""
    root = tmp_path_factory.mktemp("torch_stream")
    return (root,) + _forge_set(root, _CODES, 0.0)


@pytest.fixture(scope="module")
def forged_dm(tmp_path_factory):
    """The int16 and 1-bit archives with the forge's header DM of 12.5."""
    root = tmp_path_factory.mktemp("torch_stream_dm")
    return (root,) + _forge_set(root, ("int16", "nbit1"), 12.5)


@pytest.fixture
def stream_config():
    """Fast fit forced on (its 'auto' is the accelerator only), the
    fused lane on, the window engaged; restored afterwards."""
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = _HWIN
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


def _spy_b2(monkeypatch):
    """Record (raw code, subints) of every call of the plain B2 version."""
    calls = []
    orig = TFu.fused_decode_cross_spectrum_ref

    def spy(*a, **k):
        calls.append((k["code"], a[0].shape[0]))
        return orig(*a, **k)

    monkeypatch.setattr(TFu, "fused_decode_cross_spectrum_ref", spy)
    return calls


def test_stream_tim_parity_with_jax(forged, stream_config, monkeypatch):
    """The port's stream .tim against the JAX package's, every wire
    format; the spy shows the packed buckets took the decode-fused
    branch and the int16 bucket did not."""
    from pulseportraiture_tpu.pipeline import stream as JS

    root, meta, files, tmpl = forged
    for f, code in zip(files, _CODES.values()):
        assert TS._load_raw(f, torch.device("cpu")).raw_code == code
    ref = str(root / "jax.tim")
    got = str(root / "torch.tim")
    JS.stream_wideband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                            tim_out=ref)
    calls = _spy_b2(monkeypatch)
    res = TS.stream_wideband_TOAs(meta, tmpl, nsub_batch=4, quiet=True,
                                  tim_out=got, device="cpu")
    # one call per packed bucket, none for i16; a partial bucket pads to
    # nsub_batch rows, as in the JAX package
    assert sorted(calls) == [("p1", 4), ("p2", 4), ("p4", 4)]
    assert res.nfit == 4 and len(res.TOA_list) == 4 * _NSUB
    assert res.dispatch_shapes == {
        f"{_NCHAN}x{_NBIN}:raw:{c}:11000": 1 for c in _CODES.values()}
    assert res.order == files
    _assert_tim_parity(_tim_lines(ref, root / "jax_lines.tim"),
                       _tim_lines(got, root / "torch_lines.tim"))


def _tim_lines(path, out):
    """The TOA lines of a checkpoint, without its sentinel comments."""
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() and not ln.startswith("C ")]
    with open(out, "w") as f:
        f.writelines(lines)
    return str(out)


def _max_sigma(ref_path, got_path):
    """The largest TOA or DM difference of two .tim files, line by line,
    in units of the first file's errors."""
    worst = 0.0
    for r, g in zip(_parse_tim(ref_path), _parse_tim(got_path)):
        dm_r, dm_g = float(r[5]["-pp_dm"]), float(g[5]["-pp_dm"])
        dt = ((g[2][0] - r[2][0]) + (g[2][1] - r[2][1])) * 86400.0
        dt += tcfg.Dconst * dm_g * (r[1] ** -2.0 - g[1] ** -2.0)
        worst = max(worst, abs(dm_g - dm_r) / float(r[5]["-pp_dme"]),
                    abs(dt) * 1e6 / r[3])
    return worst


def test_stream_parity_at_header_dm(forged_dm, stream_config, monkeypatch):
    """Header DM 12.5, the forge's default: every fit starts 12.5 pc
    cm^-3 from the truth.  The int16 archive's TOAs still agree with the
    JAX package's within 0.05 sigma.  The 1-bit archive's need not, and
    the cause is the fit's conditioning, not the port: the JAX package's
    own TOAs move by more than 100 sigma when only its min-window
    baseline is summed in float64 (as the port sums it) where it sums
    in float32."""
    from pulseportraiture_tpu.ops import decode as JD
    from pulseportraiture_tpu.pipeline import stream as JS

    root, meta, files, tmpl = forged_dm
    out = {k: str(root / f"{k}.tim") for k in ("jax", "torch", "jax_p1",
                                               "jax_p1_f64")}
    JS.stream_wideband_TOAs([files[0]], tmpl, nsub_batch=4, quiet=True,
                            tim_out=out["jax"])
    TS.stream_wideband_TOAs([files[0]], tmpl, nsub_batch=4, quiet=True,
                            tim_out=out["torch"], device="cpu")
    _assert_tim_parity(_tim_lines(out["jax"], root / "jax_lines.tim"),
                       _tim_lines(out["torch"], root / "torch_lines.tim"))

    JS.stream_wideband_TOAs([files[1]], tmpl, nsub_batch=4, quiet=True,
                            tim_out=out["jax_p1"])
    f32_baseline = JD.min_window_baseline

    def f64_baseline(p, frac=0.15):
        return f32_baseline(p.astype(jnp.float64), frac).astype(p.dtype)

    monkeypatch.setattr(JD, "min_window_baseline", f64_baseline)
    JS._raw_fit_fn_cached.cache_clear()
    try:
        JS.stream_wideband_TOAs([files[1]], tmpl, nsub_batch=4, quiet=True,
                                tim_out=out["jax_p1_f64"])
    finally:
        # no later test may reuse the program traced with the patch
        monkeypatch.undo()
        JS._raw_fit_fn_cached.cache_clear()
    assert _max_sigma(
        _tim_lines(out["jax_p1"], root / "jax_p1_lines.tim"),
        _tim_lines(out["jax_p1_f64"], root / "jax_p1_f64_lines.tim")) > 100


def test_decoded_lane_matches_raw_lane(forged, stream_config, monkeypatch):
    """An archive the raw lane refuses falls back to the host-decoded
    lane (no B2 there), with the same TOAs within 0.05 sigma."""
    root, meta, files, tmpl = forged
    raw_tim, dec_tim = str(root / "raw.tim"), str(root / "dec.tim")
    TS.stream_wideband_TOAs([files[2]], tmpl, nsub_batch=4, quiet=True,
                            tim_out=raw_tim, device="cpu")

    def refuse(f, device):
        raise ValueError("forced decoded lane")

    monkeypatch.setattr(TS, "_load_raw", refuse)
    calls = _spy_b2(monkeypatch)
    TS.stream_wideband_TOAs([files[2]], tmpl, nsub_batch=4, quiet=True,
                            tim_out=dec_tim, device="cpu")
    assert calls == []
    _assert_tim_parity(_tim_lines(raw_tim, root / "raw_lines.tim"),
                       _tim_lines(dec_tim, root / "dec_lines.tim"))


def test_fit_fused_off_skips_b2(forged, stream_config, monkeypatch):
    """With the fused lane off the packed bucket fits the decoded
    portrait: the decode-fused gate reads the resolved knob."""
    root, meta, files, tmpl = forged
    tcfg.fit_fused = False
    calls = _spy_b2(monkeypatch)
    res = TS.stream_wideband_TOAs([files[2]], tmpl, nsub_batch=4,
                                  quiet=True, device="cpu")
    assert calls == [] and len(res.TOA_list) == _NSUB


# ---------------------------------------------------------------------
# executor behaviour, the port alone

DDMS = [2e-4, -3e-4, 1e-4]


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """Three small archives (one 2-bit packed, one a different channel
    count) for the executor tests."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_campaign")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i, dDM in enumerate(DDMS):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=3,
                         nchan=12 if i == 2 else 16, nbin=256, nu0=1500.0,
                         bw=800.0, tsub=60.0, phase=0.05 * i, dDM=dDM,
                         start_MJD=MJD(55100 + 10 * i, 0.1),
                         noise_stds=0.1, dedispersed=False, quiet=True,
                         rng=400 + i, nbit=2 if i == 1 else 16,
                         device="cpu")
        files.append(path)
    return root, files, gmodel


def test_resume_drops_torn_tail(campaign, stream_config, tmp_path):
    """resume=True truncates after the last completion sentinel, skips
    completed archives, and ends with the uninterrupted run's lines."""
    root, files, gmodel = campaign
    full = tmp_path / "full.tim"
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=4, device="cpu",
                            tim_out=str(full), quiet=True)
    lines = full.read_text().splitlines(keepends=True)
    first_done = next(i for i, ln in enumerate(lines)
                      if ln.startswith("C ppt-done "))
    part = tmp_path / "part.tim"
    part.write_text("".join(lines[:first_done + 1]) + "torn 1400.0 55100.12")
    done_arch = lines[first_done].split("C ppt-done ", 1)[1].strip()
    assert TS.checkpoint_completed(str(part)) == {done_arch}
    res = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=4,
                                  device="cpu", tim_out=str(part),
                                  quiet=True, resume=True)
    assert done_arch not in [t.archive for t in res.TOA_list]
    assert len(res.TOA_list) == 6
    assert part.read_bytes() == full.read_bytes()


def test_degenerate_one_channel_subint(campaign, stream_config, tmp_path):
    """A subint with one usable channel is demoted to a phase-only
    bucket and reports the header DM."""
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)

    root, files, gmodel = campaign
    w = np.ones((2, 16))
    w[0, 1:] = 0.0
    path = str(tmp_path / "degen.fits")
    make_fake_pulsar(default_test_model(1500.0), PAR, outfile=path, nsub=2,
                     nchan=16, nbin=256, tsub=60.0, noise_stds=0.1,
                     weights=w, dedispersed=False, quiet=True, rng=9,
                     nbit=2, device="cpu")
    res = TS.stream_wideband_TOAs([path], gmodel, nsub_batch=8,
                                  device="cpu", quiet=True)
    assert len(res.TOA_list) == 2
    assert res.nfit == 2  # one full bucket + one phase-only bucket
    assert all(np.isfinite(t.TOA_error) for t in res.TOA_list)
    t0 = [t for t in res.TOA_list if t.flags["subint"] == 0][0]
    # the header DM as the float32 lane holds it
    assert t0.DM == float(np.float32(PAR["DM"]))


def test_inflight_bound_is_exact(campaign, stream_config):
    """With max_inflight=1 no device queue ever holds two dispatches."""
    root, files, gmodel = campaign
    res = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=2,
                                  max_inflight=1,
                                  stream_devices=["cpu", "cpu"], quiet=True)
    assert res.nfit >= 4
    assert res.peak_inflight == 1
    assert len(res.TOA_list) == 9


def test_two_devices_identical_to_one(campaign, stream_config, tmp_path):
    """Buckets dealt across two devices give the one-device .tim byte
    for byte (archive-order checkpoints)."""
    root, files, gmodel = campaign
    t1, t2 = tmp_path / "d1.tim", tmp_path / "d2.tim"
    a = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=2,
                                stream_devices=["cpu"], tim_out=str(t1),
                                quiet=True)
    b = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=2,
                                stream_devices=["cpu", "cpu"],
                                tim_out=str(t2), quiet=True)
    assert b.devices_used == 2 and a.devices_used == 1
    assert a.nfit == b.nfit
    assert t1.read_bytes() == t2.read_bytes()
    assert a.DeltaDM_means == b.DeltaDM_means


def test_campaign_recovers_injection(campaign, stream_config):
    """Per-archive DeltaDM recovers the injected dDM, int16 and 2-bit."""
    root, files, gmodel = campaign
    res = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=4,
                                  device="cpu", quiet=True)
    for i, dDM in enumerate(DDMS):
        assert res.DeltaDM_means[i] == pytest.approx(
            dDM, abs=max(4 * res.DeltaDM_errs[i], 2e-4))


def test_cli_stream(campaign, stream_config, tmp_path):
    """pptoas --stream --device cpu writes the library call's TOAs."""
    from pulseportraiture_tpu_torch.cli.pptoas import main

    root, files, gmodel = campaign
    meta = tmp_path / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    out = str(tmp_path / "cli.tim")
    assert main(["--stream", "-d", str(meta), "-m", gmodel, "-o", out,
                 "--device", "cpu", "--quiet", "--print_phase",
                 "--pipeline-depth", "1"]) == 0
    lib = TS.stream_wideband_TOAs(files, gmodel, device="cpu", quiet=True,
                                  print_phase=True)
    got = _parse_tim(out)
    assert len(got) == len(lib.TOA_list) == 9
    for g, t in zip(got, lib.TOA_list):
        assert g[0] == t.archive and g[5]["-subint"] == str(
            t.flags["subint"])
        # -phs is printed to 8 decimals
        assert float(g[5]["-phs"]) == pytest.approx(t.flags["phs"],
                                                    abs=1e-8)


class TestRefusals:
    """Unported options raise NotImplementedError naming their ROADMAP
    item; the CUDA default raises without a card.  The zap options
    (ROADMAP A8, the cases named A8) and telemetry (A13, the trace plane)
    are ported: they run on the CPU and agree with the JAX driver."""

    @pytest.mark.parametrize("kw,item", [
        pytest.param({"telemetry": "t.jsonl"}, None, id="kw0-A13"),
        pytest.param({"zap_inline": True}, None, id="kw1-A8"),
        pytest.param({"zap_channels": {}}, None, id="kw2-A8"),
        pytest.param({"postfit_cut": True}, None, id="kw3-A8")])
    def test_options(self, campaign, tmp_path, kw, item):
        from pulseportraiture_tpu.pipeline import stream as JS

        root, files, gmodel = campaign
        if item is not None:
            with pytest.raises(NotImplementedError, match=item):
                TS.stream_wideband_TOAs(files, gmodel, device="cpu", **kw)
            return
        if "telemetry" in kw:
            kw_j = {"telemetry": str(tmp_path / "jax.jsonl"),
                    "stream_devices": 1}
            kw = {"telemetry": str(tmp_path / "torch.jsonl")}
        else:
            kw_j = kw
        ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
        rj = JS.stream_wideband_TOAs(files, gmodel, nsub_batch=4,
                                     quiet=True, tim_out=ref, **kw_j)
        rt = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=4,
                                     quiet=True, tim_out=got, device="cpu",
                                     **kw)
        _assert_tim_parity(_tim_lines(ref, tmp_path / "jax_lines.tim"),
                           _tim_lines(got, tmp_path / "torch_lines.tim"))
        if "telemetry" in kw:
            # the trace: the JAX driver's event counts and counters
            from collections import Counter

            from pulseportraiture_tpu import telemetry as JT

            ej = JT.load_trace(kw_j["telemetry"])[1]
            et = JT.validate_trace(kw["telemetry"])[1]
            assert Counter(e["type"] for e in et) == \
                Counter(e["type"] for e in ej)
            assert et[-1]["counters"] == ej[-1]["counters"]
        assert rt.postfit_zaps == rj.postfit_zaps
        assert bool(rt.postfit_zaps) == bool(kw.get("postfit_cut"))

    def test_narrowband_and_service_mode(self, campaign, stream_config,
                                         tmp_path):
        """The narrowband zap options against the JAX driver, and the
        executor's service mode against the JAX executor's."""
        from pulseportraiture_tpu.pipeline import stream as JS
        from test_torch_toas import NB_DERIVED

        root, files, gmodel = campaign
        for i, kw in enumerate(({"zap_inline": True}, {"zap_nstd": 3.0})):
            ref = str(tmp_path / f"jax{i}.tim")
            got = str(tmp_path / f"torch{i}.tim")
            JS.stream_narrowband_TOAs(files, gmodel, quiet=True,
                                      tim_out=ref, **kw)
            TS.stream_narrowband_TOAs(files, gmodel, device="cpu",
                                      quiet=True, tim_out=got, **kw)
            _assert_tim_parity(
                _tim_lines(ref, tmp_path / f"jax{i}_lines.tim"),
                _tim_lines(got, tmp_path / f"torch{i}_lines.tim"),
                derived=NB_DERIVED)
        # the executor's service mode (ported): the same archives fed
        # one by one through admit(lane=) with the owner hooks, a
        # deadline flush after the first, then flush_all/drain_all; the
        # hooks see what the JAX executor's see
        from pulseportraiture_tpu.io.tim import write_TOAs as jwrite
        from pulseportraiture_tpu_torch.io.tim import write_TOAs as twrite

        seen = {}
        for tag, mod, kw in (("jax", JS, {"stream_devices": 1}),
                             ("torch", TS, {"stream_devices": ["cpu"]})):
            lane, loader = mod.make_wideband_lane(
                gmodel, nsub_batch=4, quiet=True,
                **({"device": "cpu"} if mod is TS else {}))
            ex = mod._StreamExecutor(None, [], None, 4, quiet=True,
                                     service=True, **kw)
            launches, done = [], []
            ex.on_launch = lambda seq, owners, pad: launches.append(
                (list(owners), pad))

            def on_done(ia, m, out, ex=ex, done=done):
                done.append((ia, m.datafile, out))
                ex.forget(ia)

            ex.on_archive_done = on_done
            assert ex.oldest_bucket_age() is None
            for ia, f in enumerate(files):
                d = loader(f)
                assert ex.admit(ia, f, d, np.asarray(d.ok_isubs, int),
                                lane=lane) == d.nsub
                if ia == 0:
                    assert ex.oldest_bucket_age() >= 0.0
                    assert ex.flush_stale(0.0) == 1
                    assert ex.oldest_bucket_age() is None
            ex.flush_all()
            ex.drain_all()
            ex._shutdown(wait=True)
            # nothing per archive is kept once the owner forgot it
            assert not ex.meta and not ex._ckpt_order
            assert not ex.meta_by_iarch and not ex.assembled
            tim = str(tmp_path / f"svc_{tag}.tim")
            open(tim, "w").close()
            for _, _, out in sorted(done, key=lambda r: r[0]):
                (jwrite if mod is JS else twrite)(out[0], outfile=tim,
                                                  append=True)
            seen[tag] = (launches, [(ia, f) for ia, f, _ in done], tim)
        (lj, dj, tj), (lt, dt, tt) = seen["jax"], seen["torch"]
        assert lt == lj and dt == dj
        assert [pad for _, pad in lt] == [1, 1, 1]
        _assert_tim_parity(tj, tt)

    def test_cli_transport_compress(self, campaign, tmp_path, monkeypatch):
        """--transport-compress (ROADMAP A7, ported) runs with --stream
        and writes the JAX CLI's .tim; without --stream it exits, as in
        the JAX CLI, and so does --stream-devices."""
        from pulseportraiture_tpu.cli.pptoas import main as jmain
        from pulseportraiture_tpu_torch.cli.pptoas import main

        root, files, gmodel = campaign
        for cfg in (tcfg, jcfg):
            monkeypatch.setattr(cfg, "transport_compress",
                                cfg.transport_compress)
        ref, got = str(tmp_path / "jax.tim"), str(tmp_path / "torch.tim")
        args = ["--stream", "-d", files[1], "-m", gmodel, "--quiet",
                "--transport-compress", "on"]
        jmain(args + ["-o", ref, "--stream-devices", "1"])
        assert main(args + ["-o", got, "--device", "cpu"]) == 0
        _assert_tim_parity(ref, got)
        no_stream = ["-d", files[0], "-m", gmodel, "--transport-compress",
                     "on"]
        with pytest.raises(SystemExit):
            main(no_stream + ["--device", "cpu"])
        with pytest.raises(SystemExit):
            jmain(no_stream)
        with pytest.raises(SystemExit):
            main(["-d", files[0], "-m", gmodel, "--device", "cpu",
                  "--stream-devices", "2"])

    def test_no_card(self, campaign, stream_config, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        root, files, gmodel = campaign
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.resolve_stream_devices("auto")
        with pytest.raises(RuntimeError):
            TS.stream_wideband_TOAs(files, gmodel, stream_devices="auto")
        with pytest.raises(RuntimeError):
            TS.stream_wideband_TOAs(files, gmodel, device="cuda")
        assert TS.resolve_stream_devices(["cpu", "cpu"]) == [
            torch.device("cpu")] * 2
        with pytest.raises(ValueError):
            TS.resolve_stream_devices(3)


# ---------------------------------------------------------------------
# the scattering lane: stream_wideband_TOAs(fit_scat=True)

@pytest.fixture(scope="module")
def scat_campaign(tmp_path_factory):
    """A scattered int16 archive and a scattered 2-bit one (t_scat 0.3 ms
    at 1500 MHz, alpha -4; 2 subints x 32 channels x 256 bins)."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_scat_stream")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i, nbit in enumerate((16, 2)):
        path = str(root / f"scat{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=32,
                         nbin=256, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.02 * i, dDM=1e-4 * i, t_scat=3e-4,
                         alpha=-4.0, start_MJD=MJD(55300 + 10 * i, 0.1),
                         noise_stds=0.02 if nbit == 16 else 0.5,
                         dedispersed=False, quiet=True, rng=700 + i,
                         nbit=nbit, device="cpu")
        files.append(path)
    return root, files, gmodel


def _spy_b1(monkeypatch):
    """Record the want_m2 flag of every call of the plain B1 version."""
    calls = []
    orig = TFu.fused_cross_spectrum_ref

    def spy(*a, **k):
        calls.append(bool(k.get("want_m2", False)))
        return orig(*a, **k)

    monkeypatch.setattr(TFu, "fused_cross_spectrum_ref", spy)
    return calls


def _assert_scat_parity(ref, got):
    """The JAX fast-lane scattering parity's limits (|dTOA| < 5e-7 s,
    |dDM| < 5e-4, scat_time within 2 %, scat_ind within 0.05, snr within
    1 %), tightened: TOA and DM within 0.05 sigma and every -scat_* flag
    within one unit of its last printed digit plus 1e-5 relative
    (test_torch_toas).  -gof (not checked there) within 1 %: chi2 =
    Sd + f cancels to ~1e-3 of its terms at these S/Ns, and both
    packages sum the terms in float32 in different orders."""
    from test_torch_toas import SCAT_DERIVED

    ref = _tim_lines(ref, ref + ".lines")
    got = _tim_lines(got, got + ".lines")
    _assert_tim_parity(ref, got, derived=SCAT_DERIVED,
                       rel_tol={"gof": 0.01})
    for r, g in zip(_parse_tim(ref), _parse_tim(got)):
        assert "-scat_time" in g[5]
        assert float(g[5]["-scat_time"]) == pytest.approx(
            float(r[5]["-scat_time"]), rel=0.02)
        assert abs(float(g[5]["-scat_ind"]) - float(r[5]["-scat_ind"])) \
            < 0.05


@pytest.mark.parametrize("run", ["auto_ir", "triple_fix_alpha_nu_tau"])
def test_stream_fit_scat_parity_with_jax(scat_campaign, stream_config,
                                         monkeypatch, run):
    """int16 and 2-bit raw buckets through the complex-free scatter lane
    on both sides (use_fast_fit on): the plain B1 ran in its want_m2
    form once per bucket, B2 never (no decode-fused bucket in a
    scattering run)."""
    from pulseportraiture_tpu.pipeline import stream as JS

    root, files, gmodel = scat_campaign
    if run == "auto_ir":
        kw = dict(fit_scat=True, scat_guess="auto",
                  instrumental_response_dict={"wids": [0.2e-3],
                                              "irf_types": ["rect"]})
    else:
        kw = dict(fit_scat=True, scat_guess=(3e-4, 1500.0, -4.0),
                  fix_alpha=True, nu_ref_tau=1400.0)
    ref, got = str(root / f"jax_{run}.tim"), str(root / f"torch_{run}.tim")
    JS.stream_wideband_TOAs(files, gmodel, nsub_batch=4, quiet=True,
                            tim_out=ref, **kw)
    b1 = _spy_b1(monkeypatch)
    b2 = _spy_b2(monkeypatch)
    res = TS.stream_wideband_TOAs(files, gmodel, nsub_batch=4, quiet=True,
                                  tim_out=got, device="cpu", **kw)
    flags = "11010" if kw.get("fix_alpha") else "11011"
    assert res.dispatch_shapes == {f"32x256:raw:i16:{flags}": 1,
                                   f"32x256:raw:p2:{flags}": 1}
    assert b1 == [True, True] and b2 == []
    _assert_scat_parity(ref, got)
    if kw.get("nu_ref_tau"):
        assert all(t.flags["scat_ref_freq"] == 1400.0
                   for t in res.TOA_list)


def test_stream_fit_scat_decoded_lane(scat_campaign, stream_config,
                                      monkeypatch):
    """Archives the raw lane refuses go through the host-decoded lane,
    whose 'auto' tau seeds come from the host data (scat_seed_tau0);
    the JAX package's decoded lane is the reference."""
    from pulseportraiture_tpu.pipeline import stream as JS

    root, files, gmodel = scat_campaign

    def refuse(f, *a):
        raise ValueError("forced decoded lane")

    monkeypatch.setattr(JS, "_load_raw", refuse)
    monkeypatch.setattr(TS, "_load_raw", refuse)
    kw = dict(fit_scat=True, scat_guess="auto")
    ref, got = str(root / "jax_dec.tim"), str(root / "torch_dec.tim")
    JS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=4, quiet=True,
                            tim_out=ref, **kw)
    b1 = _spy_b1(monkeypatch)
    res = TS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=4,
                                  quiet=True, tim_out=got, device="cpu",
                                  **kw)
    assert res.dispatch_shapes == {"32x256:dec:11011": 1}
    assert b1 == [True]
    _assert_scat_parity(ref, got)


def test_stream_complex_engine(scat_campaign, stream_config):
    """config.use_fast_fit=False: the raw buckets decode in float64 and
    fit through the complex engine, scattering and not, as the JAX
    package's stream does on the CPU."""
    from pulseportraiture_tpu.pipeline import stream as JS

    root, files, gmodel = scat_campaign
    jcfg.use_fast_fit = tcfg.use_fast_fit = False
    for kw in (dict(fit_scat=True, scat_guess="auto"), dict()):
        ref, got = str(root / "jax_cx.tim"), str(root / "torch_cx.tim")
        JS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=4,
                                quiet=True, tim_out=ref, **kw)
        TS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=4,
                                quiet=True, tim_out=got, device="cpu", **kw)
        if kw:
            _assert_scat_parity(ref, got)
        else:
            _assert_tim_parity(_tim_lines(ref, ref + ".lines"),
                               _tim_lines(got, got + ".lines"))


def test_cli_stream_fit_scat(scat_campaign, stream_config, tmp_path):
    """pptoas --stream --fit_scat on the CPU writes the library call's
    scattering TOAs."""
    from pulseportraiture_tpu_torch.cli.pptoas import main

    root, files, gmodel = scat_campaign
    meta = tmp_path / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    out = str(tmp_path / "cli.tim")
    assert main(["--stream", "-d", str(meta), "-m", gmodel, "-o", out,
                 "--device", "cpu", "--quiet", "--fit_scat",
                 "--scat_guess", "3e-4,1500,-4", "--no_logscat"]) == 0
    lib = TS.stream_wideband_TOAs(files, gmodel, device="cpu", quiet=True,
                                  fit_scat=True, log10_tau=False,
                                  scat_guess=(3e-4, 1500.0, -4.0))
    got = _parse_tim(out)
    assert len(got) == len(lib.TOA_list) == 4
    for g, t in zip(got, lib.TOA_list):
        assert g[0] == t.archive and "-scat_time_err" in g[5]
        assert float(g[5]["-scat_time"]) == pytest.approx(
            t.flags["scat_time"], abs=1e-3)
