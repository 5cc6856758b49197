"""The port's online observatory (ingest/source, ingest/alerts,
ingest/driver, cli/ppwatch) on the CPU, against the JAX package's.

Corpus: the JAX ingest suite's (tests/test_ingest.py), 3 spin-coherent
int16 archives of 2 subints x 16 channels x 128 bins, 30 days apart
(default_test_model, make_fake_pulsar(rng=100+i), noise 0.05, a common
phase and a per-epoch DM wander), written by the port.  Both packages
run the fast fit with the fused stage and a 64-harmonic window (the JAX
Pallas kernels off), the JAX package on ONE device; every port server
runs with device='cpu', so its kernels run their plain versions.

Tolerances:
- the five knobs' hooks: the same values and the same ValueErrors;
- the sources: the same admitted (path, order) sequences and pending
  lists after every folder action; the same wire replies;
- within the port, ppwatch's streamed .tim is BYTE-identical to the
  port's one-shot stream_wideband_TOAs at the same nsub_batch (with a
  truncated file deferred and with backpressure at queue_depth 1);
- against the JAX ppwatch, the .tim field by field
  (test_torch_toas._assert_tim_parity);
- the alert monitors over one fake_timing_campaign stream: the same
  alerts, kind and epoch exactly, MJD, score and amplitude within 1e-9
  relative (both packages' IncrementalGLS agree to 1e-10).
"""

import io
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import ingest as JG
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu import timing as JTM
from pulseportraiture_tpu.cli import ppwatch as jwatch
from pulseportraiture_tpu.serve import transport as JTR
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import ingest as TG
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch import timing as TTM
from pulseportraiture_tpu_torch.cli import ppwatch as twatch
from pulseportraiture_tpu_torch.pipeline import stream as TS
from pulseportraiture_tpu_torch.serve import ToaServer
from pulseportraiture_tpu_torch.serve import transport as TTR
from pulseportraiture_tpu_torch.synth import fake_timing_campaign

NB = 8  # nsub_batch of every served and one-shot run here
PAR = {"PSR": "J1744-1134", "RAJ": "17:44:29.4", "DECJ": "-11:34:54.6",
       "P0": 0.004074, "PEPOCH": 55150.0, "DM": 3.139}
FPAR = {"PSR": "FAKE", "F0": "218.8", "PEPOCH": "55500", "DM": "15.9"}
KNOBS = ("ingest_poll_ms", "ingest_stable_ms", "alert_cusum_k",
         "alert_cusum_h", "mon_interval_ms", "gls_resolve_every")


@pytest.fixture(scope="module")
def serve_config():
    """Fast fit, fused stage and a 64-harmonic window in both packages
    (the JAX Pallas kernels off, the JAX server on one device)."""
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",
                                                  "stream_devices")}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 64
    jcfg.fit_pallas = False
    jcfg.stream_devices = 1
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, serve_config):
    """(folder, archives, gmodel, parfile, one-shot .tim bytes): the JAX
    ingest suite's corpus, each archive with its .done sentinel, and the
    port's one-shot stream over it at nsub_batch NB."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_ingest")
    folder = root / "in"
    folder.mkdir()
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i in range(3):
        path = str(folder / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=16,
                         nbin=128, nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.017, dDM=2e-4 * (i - 1),
                         start_MJD=MJD(55100 + 30 * i, 0.2),
                         noise_stds=0.05, dedispersed=False, quiet=True,
                         rng=100 + i, spin_coherent=True, device="cpu")
        open(path + ".done", "w").close()
        files.append(path)
    parfile = str(root / "pulsar.par")
    with open(parfile, "w") as fh:
        for k, v in PAR.items():
            fh.write(f"{k} {v}\n")
    one = str(root / "oneshot.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=NB, tim_out=one,
                            quiet=True, device="cpu")
    with open(one, "rb") as f:
        ref = f.read()
    return str(folder), files, gmodel, parfile, ref


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------
# the knobs


def test_knob_hooks(monkeypatch):
    """The five ingest/alert/monitor hooks (and the resolve cadence's)
    set the same values in both packages, and each bad value raises the
    same ValueError in both."""
    saved = {m: {k: getattr(m, k) for k in KNOBS} for m in (jcfg, tcfg)}
    good = {"PPT_INGEST_POLL_MS": "75.5", "PPT_INGEST_STABLE_MS": "0",
            "PPT_ALERT_CUSUM_K": "0.75", "PPT_ALERT_CUSUM_H": "6.5",
            "PPT_MON_INTERVAL_MS": "250", "PPT_GLS_RESOLVE_EVERY": "17"}
    bad = (("PPT_INGEST_POLL_MS", "0"), ("PPT_INGEST_POLL_MS", "soon"),
           ("PPT_INGEST_STABLE_MS", "-1"), ("PPT_ALERT_CUSUM_K", "-0.1"),
           ("PPT_ALERT_CUSUM_H", "0"), ("PPT_ALERT_CUSUM_H", "x"),
           ("PPT_MON_INTERVAL_MS", "-5"), ("PPT_GLS_RESOLVE_EVERY", "1.5"))
    for name in list(os.environ):
        if name.startswith("PPT_"):
            monkeypatch.delenv(name)
    try:
        assert {k: getattr(tcfg, k) for k in KNOBS} == {
            k: getattr(jcfg, k) for k in KNOBS}
        for name, val in good.items():
            monkeypatch.setenv(name, val)
        assert set(tcfg.env_overrides()) >= set(KNOBS)
        jcfg.env_overrides()
        got = {k: getattr(tcfg, k) for k in KNOBS}
        assert got == {k: getattr(jcfg, k) for k in KNOBS}
        assert got == {"ingest_poll_ms": 75.5, "ingest_stable_ms": 0.0,
                       "alert_cusum_k": 0.75, "alert_cusum_h": 6.5,
                       "mon_interval_ms": 250.0, "gls_resolve_every": 17}
        for name in good:
            monkeypatch.delenv(name)
        for name, val in bad:
            monkeypatch.setenv(name, val)
            errs = []
            for cfg in (jcfg, tcfg):
                with pytest.raises(ValueError, match=name) as ei:
                    cfg.env_overrides()
                errs.append(str(ei.value))
            assert errs[1] == errs[0]
            monkeypatch.delenv(name)
        assert not set(good) & set(tcfg.UNPORTED_PPT_ENV)
        assert set(good) <= tcfg.HOOKED_PPT_ENV
    finally:
        for m, vals in saved.items():
            for k, v in vals.items():
                setattr(m, k, v)


# ---------------------------------------------------------------------
# the sources


def test_watch_folder_matches_jax(tmp_path):
    """The same folder actions seen by both packages' WatchFolderSource,
    with a long stability window (only sentinels admit) and with 0 ms:
    the same admitted (path, order) sequence and pending lists after
    every poll, defer() included."""
    d = tmp_path / "w"
    d.mkdir()
    pairs = {"slow": [m.WatchFolderSource(str(d), stable_ms=60_000)
                      for m in (JG, TG)],
             "zero": [m.WatchFolderSource(str(d), stable_ms=0)
                      for m in (JG, TG)]}
    seen = {k: [[], []] for k in pairs}

    def poll():
        for key, srcs in pairs.items():
            got = [s.poll() for s in srcs]
            assert all(w >= 0.0 for g in got for _, w in g)
            paths = [[p for p, _ in g] for g in got]
            assert paths[1] == paths[0], key
            assert srcs[1].pending() == srcs[0].pending(), key
            for i in (0, 1):
                seen[key][i].append(paths[i])
        time.sleep(0.002)

    (d / "b.fits").write_bytes(b"x" * 100)
    (d / "a.fits").write_bytes(b"y" * 100)
    (d / "notes.txt").write_bytes(b"z")
    (d / "c.fits.done").touch()  # a sentinel alone is no candidate
    poll()                        # discovery: nothing stable yet
    poll()                        # zero: a, b in name order
    (d / "b.fits").write_bytes(b"x" * 200)  # admitted: never again
    (d / "d.fits").write_bytes(b"w" * 50)
    (d / "d.fits.done").touch()   # the sentinel admits d at once
    poll()
    (d / "e.fits").write_bytes(b"v" * 10)
    poll()
    (d / "e.fits").write_bytes(b"v" * 20)  # growth restarts the clock
    poll()
    poll()
    for key, srcs in pairs.items():
        for s in srcs:
            s.defer(os.path.join(s.folder, "a.fits"))
    poll()
    (d / "a.fits.done").touch()
    poll()
    poll()
    assert seen["slow"][1] == seen["slow"][0]
    assert seen["zero"][1] == seen["zero"][0]
    flat = {k: [os.path.basename(p) for ps in v[1] for p in ps]
            for k, v in seen.items()}
    assert flat["zero"] == ["a.fits", "b.fits", "d.fits", "e.fits",
                            "a.fits"]
    assert flat["slow"] == ["d.fits", "a.fits"]
    with pytest.raises(ValueError, match="not a directory"):
        TG.WatchFolderSource(str(d / "nope"))


def test_announce_across_packages():
    """A JAX announce reaches a port SocketSource and a port announce a
    JAX one (the wire is the same, frame for frame); defer re-queues;
    an unknown op gets the same refusal from both."""
    for src_mod, ann_mod in ((TG, JG), (JG, TG)):
        with src_mod.SocketSource() as src:
            ep = f"{src.endpoint[0]}:{src.endpoint[1]}"
            assert ann_mod.announce(ep, ["/data/a.fits",
                                         "/data/b.fits"]) == 2
            assert ann_mod.announce(src.endpoint, "/data/c.fits") == 1
            got = src.poll()
            assert [p for p, _ in got] == ["/data/a.fits", "/data/b.fits",
                                           "/data/c.fits"]
            src.defer("/data/a.fits")
            assert src.pending() == ["/data/a.fits"]
            assert [p for p, _ in src.poll()] == ["/data/a.fits"]
    replies = []
    for src_mod, wire in ((JG, JTR), (TG, TTR)):
        with src_mod.SocketSource() as src:
            with socket.create_connection(src.endpoint) as s:
                wire._send_frame(s, {"op": "stat"})
                stat = wire._recv_frame(s)
                wire._send_frame(s, {"op": "nope"})
                replies.append((stat, wire._recv_frame(s)))
    assert replies[1] == replies[0]
    assert not replies[1][1]["ok"] and "unknown op" in replies[1][1]["error"]
    with pytest.raises(TTR.TransportError):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        TG.announce(f"127.0.0.1:{port}", ["/data/a.fits"])


# ---------------------------------------------------------------------
# the driver


class _FakeRequest:
    class _R:
        TOA_list = []

    def wait(self, timeout=None):
        return True

    def result(self, timeout=None):
        return self._R()


class _FakeServer:
    def __init__(self):
        self.submitted = []

    def submit(self, datafiles, modelfile, **kw):
        self.submitted.extend(datafiles)
        return _FakeRequest()


def test_driver_defers_truncated_then_admits(corpus, tmp_path):
    """Both packages' drivers in lockstep over one folder: a half-written
    archive is deferred ('truncated'), never submitted, then admitted
    once its second chunk lands; the same stats and trace events; an
    unreadable candidate is consumed with reason 'error'."""
    _, files, gmodel, _, _ = corpus
    whole = _read(files[0])
    d = tmp_path / "in"
    d.mkdir()
    dest = d / "x.fits"
    dest.write_bytes(whole[:len(whole) // 2])
    (d / "junk.fits").mkdir()  # a candidate no probe can read
    runs = []
    for mod, tel in ((JG, JT), (TG, TT)):
        trace = str(tmp_path / f"{mod.__name__}.jsonl")
        tracer = tel.Tracer(trace, run="ingest-retry")
        server = _FakeServer()
        drv = mod.IngestDriver(server, gmodel,
                               [mod.WatchFolderSource(str(d), stable_ms=0)],
                               tim_out=str(tmp_path / f"{mod.__name__}.tim"),
                               tracer=tracer, quiet=True)
        runs.append((drv, server, tracer, trace))
    steps = []
    for step in range(4):
        if step == 2:
            with open(dest, "ab") as fh:
                fh.write(whole[len(whole) // 2:])
        steps.append([drv.run_once() for drv, *_ in runs])
        time.sleep(0.01)
    for drv, *_ in runs:
        assert drv.drain(10)
    assert [s[1] for s in steps] == [s[0] for s in steps]
    stats = [drv.stats() for drv, *_ in runs]
    assert stats[1] == stats[0]
    assert stats[1] == {"admitted": 1, "completed": 1, "deferred": 1,
                        "errors": 1, "inflight": 0}
    assert runs[1][1].submitted == runs[0][1].submitted == [str(dest)]
    kinds = []
    for (drv, server, tracer, trace), tel in zip(runs, (JT, TT)):
        tracer.close()
        events = tel.validate_trace(trace)[1]
        kinds.append([(e["type"], e.get("reason"))
                      for e in events if e["type"].startswith("ingest_")])
    assert kinds[1] == kinds[0]
    assert ("ingest_skip", "truncated") in kinds[1]
    assert ("ingest_skip", "error") in kinds[1]
    tim = open(tmp_path / f"{TG.__name__}.tim").read()
    assert f"C ppt-done {dest}" in tim


def test_driver_backpressure_queue_depth_1(corpus, tmp_path):
    """A port server with queue_depth 1: the driver's first pass admits
    one archive and defers the rest ('backpressure'); once the server
    runs, every archive is admitted and timed, and the streamed .tim is
    byte-identical to the one-shot's."""
    folder, files, gmodel, _, ref = corpus
    tim = str(tmp_path / "bp.tim")
    trace = str(tmp_path / "bp.jsonl")
    server = ToaServer(nsub_batch=NB, max_wait_ms=30, queue_depth=1,
                       telemetry=trace, device="cpu")
    try:
        drv = TG.IngestDriver(server, gmodel,
                              [TG.WatchFolderSource(folder, stable_ms=0)],
                              tim_out=tim, tracer=server.tracer, quiet=True)
        assert drv.run_once() == 1  # the queue holds one archive
        assert drv.stats()["deferred"] == 2
        server.start()
        drv.run(idle_polls=3, poll_ms=20)
    finally:
        server.stop(drain=True)
    st = drv.stats()
    assert (st["admitted"], st["completed"], st["errors"]) == (3, 3, 0)
    assert _read(tim) == ref
    skips = [e for e in TT.validate_trace(trace)[1]
             if e["type"] == "ingest_skip"]
    assert len(skips) >= 2
    assert {e["reason"] for e in skips} == {"backpressure"}


def test_ppwatch_drain_against_jax(corpus, tmp_path):
    """ppwatch --drain -p over the finished corpus: rc 0, the .tim
    byte-identical to the port's one-shot at the same nsub_batch and
    field by field equal to the JAX ppwatch's; zero alerts, at least one
    full incremental resolve, and the same summary keys as the JAX
    run's trace."""
    folder, files, gmodel, parfile, ref = corpus
    out = {}
    for name, mod, extra in (("jax", jwatch, []),
                             ("torch", twatch, ["--device", "cpu"])):
        tim = str(tmp_path / f"{name}.tim")
        trace = str(tmp_path / f"{name}.jsonl")
        rc = mod.main(["-w", folder, "-m", gmodel, "-t", tim, "-p", parfile,
                       "--drain", "--stable-ms", "0", "--poll-ms", "20",
                       "--resolve-every", "2", "--nsub-batch", str(NB),
                       "--telemetry", trace, "--quiet"] + extra)
        assert rc == 0
        out[name] = (tim, trace)
    assert _read(out["torch"][0]) == ref
    _assert_tim_parity(_tim_lines(out["jax"][0], tmp_path / "j_lines.tim"),
                       _tim_lines(out["torch"][0], tmp_path / "t_lines.tim"))
    keys = ("n_ingest_admit", "n_ingest_skip", "n_alert", "alert_fp_rate",
            "incremental_resolves")
    sums = {}
    for name, tel in (("jax", JT), ("torch", TT)):
        tel.validate_trace(out[name][1])
        sums[name] = tel.report(out[name][1], file=io.StringIO())
    assert {k: sums["torch"][k] for k in keys} == {
        k: sums["jax"][k] for k in keys}
    s = sums["torch"]
    assert s["n_ingest_admit"] == 3 and s["n_alert"] == 0
    assert s["incremental_resolves"] >= 1
    assert s["ingest_p50_s"] is not None and s["ingest_p99_s"] is not None


def test_ppwatch_listen_and_no_card(corpus, tmp_path, monkeypatch, capsys):
    """--listen without -w: a socket source whose endpoint is printed;
    the warm server is the card's unless --device cpu (without a card
    the default raises, and the listener is closed)."""
    _, _, gmodel, _, _ = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        twatch.main(["--listen", "127.0.0.1:0", "-m", gmodel, "-t",
                     str(tmp_path / "x.tim"), "--drain", "--quiet"])
    out = capsys.readouterr().out
    assert "announcements on 127.0.0.1:" in out
    with pytest.raises(TTR.TransportError):
        TG.announce(out.split("announcements on ")[1].split()[0],
                    ["/data/a.fits"])
    rc = twatch.main(["--listen", "127.0.0.1:0", "-m", gmodel, "-t",
                      str(tmp_path / "y.tim"), "--drain", "--idle-polls",
                      "1", "--poll-ms", "10", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "ppwatch: 0/0 archives timed" in text
    assert _read(tmp_path / "y.tim") == b""


@pytest.mark.parametrize("case", [
    "no_source", "watch_not_dir", "model_missing", "par_missing",
    "poll_ms", "stable_ms", "idle_polls", "resolve_every", "nsub_batch",
    "listen", "patterns"])
def test_ppwatch_refusals(corpus, tmp_path, case):
    """Every refusal of the port's ppwatch exits with the JAX ppwatch's
    message."""
    folder, _, gmodel, parfile, _ = corpus
    base = ["-w", folder, "-m", gmodel]
    argv = {
        "no_source": ["-m", gmodel],
        "watch_not_dir": ["-w", str(tmp_path / "none"), "-m", gmodel],
        "model_missing": ["-w", folder, "-m", str(tmp_path / "m.gmodel")],
        "par_missing": base + ["-p", str(tmp_path / "x.par")],
        "poll_ms": base + ["--poll-ms", "0"],
        "stable_ms": base + ["--stable-ms", "-1"],
        "idle_polls": base + ["--idle-polls", "0"],
        "resolve_every": base + ["--resolve-every", "-2"],
        "nsub_batch": base + ["--nsub-batch", "0"],
        "listen": base + ["--listen", "nowhere"],
        "patterns": base + ["--patterns", " , "],
    }[case]
    msgs = []
    for mod in (jwatch, twatch):
        with pytest.raises(SystemExit) as ei:
            mod.main(argv + ["--quiet"])
        msgs.append(str(ei.value.code))
    assert msgs[1] == msgs[0]
    assert msgs[1].strip()


# ---------------------------------------------------------------------
# the alerts


class _GofToa:
    """A TOA of the profile arm alone: no DM, a gof."""

    flags = {}

    def __init__(self, mjd):
        self.mjd_int, self.mjd_frac = int(mjd), mjd - int(mjd)
        self.dm = self.dm_err = None


def _campaign_alerts(mod, timing, toas, known, tracer=None):
    inc = timing.IncrementalGLS(FPAR, fit_binary=False, resolve_every=0)
    mon = mod.AlertMonitor("FAKE", tracer=tracer, known_events=known or None)
    result = None
    for toa in toas:
        result = inc.update(toa)
        mon.observe(result, toa)
    mon.finish()
    return mon.alerts, result


def _alerts_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key, val in r.items():
            if isinstance(val, float) and key not in ("threshold",):
                assert g[key] == pytest.approx(val, rel=1e-9, abs=1e-12), key
            else:
                assert g[key] == val, key


@pytest.mark.parametrize("case", ["clean", "glitch", "dm_step", "combined",
                                  "profile_refractory", "cusum_units"])
def test_alert_scenarios(case, tmp_path):
    """The JAX ingest suite's alert scenarios, each stream through both
    packages' incremental lane and monitor: equal alert lists (kind and
    epoch exactly, MJD, score and amplitude to 1e-9 relative), and the
    JAX suite's own expectations hold on the port's."""
    if case == "cusum_units":
        rng = np.random.default_rng(0)
        zs = [0.0] * 100 + [float(rng.normal()) + (4.0 if i >= 30 else 0.0)
                            for i in range(50)]
        dets = [m.CusumDetector(k=0.5, h=5.0) for m in (JG, TG)]
        fired = [[], []]
        for z in zs:
            for i, det in enumerate(dets):
                s = det.update(z)
                if s is not None:
                    fired[i].append((det.n, s, det.last_lag))
        assert fired[1] == fired[0] and fired[1]
        n, s, lag = fired[1][0]
        assert s > 5.0 and n - 100 - lag in (30, 31)
        for mod in (JG, TG):
            with pytest.raises(ValueError, match="h must be"):
                mod.CusumDetector(h=0.0)
        return
    if case == "profile_refractory":
        alerts = []
        for mod in (JG, TG):
            mon = mod.AlertMonitor("X", warmup=2, max_gof=1.5)
            for i in range(30):
                mon.observe(None, _GofToa(55000 + i),
                            gof=1.1 if i < 10 else 9.0)
            alerts.append(mon.alerts)
        _alerts_equal(alerts[1], alerts[0])
        assert [a["kind"] for a in alerts[1]] == ["profile_change"]
        assert alerts[1][0]["mjd"] >= 55009
        return
    kw = {"clean": dict(rng=3),
          "glitch": dict(glitch={"epoch": 9, "dphi": 218.8 * 50e-6}, rng=5),
          "dm_step": dict(dm_step={"epoch": 6, "ddm": 4e-3}, rng=7),
          "combined": dict(glitch={"epoch": 9, "dphi": 218.8 * 50e-6},
                           dm_step={"epoch": 4, "ddm": 4e-3}, rng=8)}[case]
    toas, truth = fake_timing_campaign(FPAR, n_epochs=12, toas_per_epoch=2,
                                       span_days=120.0, dmx=2e-4, **kw)
    known = []
    if "glitch" in kw:
        known.append({"kind": "glitch", "mjd": truth.glitch["mjd"]})
    if "dm_step" in kw:
        known.append({"kind": "dm_step", "mjd": truth.dm_step["mjd"]})
    trace = str(tmp_path / "alerts.jsonl")
    tracer = TT.Tracer(trace, run=case)
    ja, _ = _campaign_alerts(JG, JTM, toas, known)
    ta, result = _campaign_alerts(TG, TTM, toas, known, tracer=tracer)
    tracer.close()
    _alerts_equal(ta, ja)
    events = [e for e in TT.validate_trace(trace)[1] if e["type"] == "alert"]
    assert [e["kind"] for e in events] == [a["kind"] for a in ta]
    assert all(e["threshold"] == tcfg.alert_cusum_h for e in events)
    kinds = sorted(a["kind"] for a in ta)
    assert all(not a["fp"] for a in ta)
    if case == "clean":
        assert ta == []
    elif case == "glitch":
        assert kinds == ["glitch"]
        assert abs(ta[0]["mjd"] - truth.glitch["mjd"]) <= 120.0 / 11
    elif case == "dm_step":
        assert kinds == ["dm_step"]
        assert ta[0]["epoch"] == 6
        assert abs(ta[0]["mjd"] - truth.dm_step["mjd"]) <= 1e-6
        assert abs(ta[0]["amp"] - 4e-3) <= 3 * float(result.dmx_errs[6])
    else:
        assert kinds == ["dm_step", "glitch"]


def test_scan_fits_truncated_two_chunks(corpus, tmp_path):
    """The port's probe raises the typed TruncatedFits for a file cut in
    its header and one cut in its data, as the JAX probe does, and the
    loader never sees the short file."""
    from pulseportraiture_tpu.io import scan_fits as jscan
    from pulseportraiture_tpu_torch.io.fitsio import TruncatedFits, scan_fits
    from pulseportraiture_tpu_torch.io.psrfits import read_archive

    _, files, _, _, _ = corpus
    whole = _read(files[0])
    part = tmp_path / "partial.fits"
    for cut in (1000, len(whole) // 2):
        part.write_bytes(whole[:cut])
        with pytest.raises(TruncatedFits) as ei:
            scan_fits(str(part))
        assert ei.value.retryable and isinstance(ei.value, ValueError)
        with pytest.raises(ValueError):
            jscan(str(part))
        with pytest.raises(TruncatedFits):
            read_archive(str(part))
    shutil.copy(files[0], part)
    assert scan_fits(str(part)) == jscan(str(part)) >= 2


def test_alert_cadence_stream_matches_jax(tmp_path):
    """chip_smoke phase 19's event corpus at the JAX suite's widths: 12
    spin-coherent epochs 30 days apart with a 100 us achromatic step from
    epoch 6 and a 4e-3 DM step from epoch 8 over the DM wander, timed by
    the port's one-shot stream; the streamed TOAs through both packages'
    incremental lane and monitor (the resolve cadence and thresholds of
    ppwatch) give the same alert list, and the first alert of each kind
    lies within a day of its injected epoch with nothing before it.
    (At a 30-day cadence the refractory window does not hold back the
    persistent events' re-alerts; both packages agree on them.)"""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.timing.tim import read_tim
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    par = dict(PAR, PEPOCH=55265.0)
    gmodel = str(tmp_path / "model.gmodel")
    write_gmodel(default_test_model(1500.0), gmodel, quiet=True)
    files = []
    for i in range(12):
        path = str(tmp_path / f"ep{i:03d}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, nsub=2, nchan=16,
                         nbin=128, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.017 + (100e-6 / par["P0"] if i >= 6 else 0),
                         dDM=2e-4 * ((i % 3) - 1) + (4e-3 if i >= 8 else 0),
                         start_MJD=MJD(55100 + 30 * i, 0.2),
                         noise_stds=0.05, dedispersed=False, quiet=True,
                         rng=400 + i, spin_coherent=True, device="cpu")
        files.append(path)
    tim = str(tmp_path / "event.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=NB, tim_out=tim,
                            quiet=True, device="cpu")
    toas = read_tim(tim)
    alerts = []
    for mod, timing in ((JG, JTM), (TG, TTM)):
        inc = timing.IncrementalGLS(par, resolve_every=8)
        mon = mod.AlertMonitor(par["PSR"])
        for toa in toas:
            mon.observe(inc.update(toa), toa)
        mon.finish()
        alerts.append(mon.alerts)
    _alerts_equal(alerts[1], alerts[0])
    truth = {"glitch": 55100 + 30 * 6 + 0.2, "dm_step": 55100 + 30 * 8 + 0.2}
    first = {}
    for a in alerts[1]:
        first.setdefault(a["kind"], a)
    assert set(first) == set(truth)
    assert all(abs(first[k]["mjd"] - truth[k]) <= 1.0 for k in truth)
    assert min(a["mjd"] for a in alerts[1]) >= truth["glitch"] - 1.0
