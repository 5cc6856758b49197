"""The port's trace plane (pulseportraiture_tpu_torch/telemetry.py)
against the JAX package's.

Corpus: make_fake_pulsar at 16 channels x 256 bins, 4 subints, three
int16 archives and one NBIT=2 archive, noise 1.0 (S/N ~110: at S/N ~1000
the float32 chi^2 of either framework moves by ~1e-3 of a unit, which
the gof tolerance below would not cover).  Both packages run the
fast fit with the fused stage and an explicit harmonic window (the
stream tests' configuration), the JAX package with its Pallas kernels
off (their plain references).

What is held:
- report(): the JAX package's and the port's summary dicts are equal,
  key for key, on the same trace; a port-written trace passes the JAX
  validate_trace and renders through the JAX report();
- the stream drivers' traces: the count of every event type, the
  dispatch shapes and sizes in seq order, the archive_done order and
  the counters are equal; quality snr and gof agree within 2e-3 + 1e-4
  relative and 2e-4 + 1e-4 relative (the events round them to 3 and 4
  decimals; float32 fits of the two frameworks differ by ~1e-5);
- tracing changes no TOA (.tim identical, line for line);
- the tracer's units: log levels, the .prev rotation, the NULL
  tracer's no-ops and monotonic next_seq, schema drift rejected by
  validate_trace, the pptrace CLI (validate, report; merge refuses a
  stream trace, which carries no trace_id, as the JAX one does),
  and PPT_TELEMETRY on its own.
"""

import io
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_helpers import PAR

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu.pipeline import stream as JS
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.pipeline import stream as TS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NSUB, _NCHAN, _NBIN = 4, 16, 256


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_telemetry")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i in range(4):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=_NSUB, nchan=_NCHAN,
                         nbin=_NBIN, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.03 * i, dDM=1e-4 * (i - 1),
                         start_MJD=MJD(55100 + 10 * i, 0.1),
                         noise_stds=1.0, dedispersed=False, quiet=True,
                         rng=900 + i, nbit=2 if i == 3 else 16,
                         device="cpu")
        files.append(path)
    meta = root / "meta.txt"
    meta.write_text("\n".join(files) + "\n")
    return root, str(meta), files, gmodel


@pytest.fixture
def stream_config():
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window",
            "telemetry_path", "transport_compress")
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


def _events(path):
    return JT.load_trace(path)[1]


def _counts(path):
    """Event type -> count (log events by level)."""
    return Counter(ev["type"] for ev in _events(path))


def _quiet_report(mod, path):
    return mod.report(path, file=io.StringIO())


def _stream_pair(corpus, tmp_path, **kw):
    root, meta, files, gmodel = corpus
    jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    # one device on both sides (the JAX CPU backend has several)
    rj = JS.stream_wideband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                                 telemetry=jt, stream_devices=1, **kw)
    rt = TS.stream_wideband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                                 telemetry=tt, device="cpu", **kw)
    return jt, tt, rj, rt


def test_report_parity(corpus, stream_config, tmp_path):
    """One JAX-written trace through both report()s: equal summaries.
    The port's trace passes the JAX validate_trace and renders through
    the JAX report(); the two summaries of the two traces agree on every
    count."""
    jt, tt, rj, rt = _stream_pair(corpus, tmp_path)
    sj = _quiet_report(JT, jt)
    st = _quiet_report(TT, jt)
    assert st == sj
    JT.validate_trace(tt)
    s_port_jax = _quiet_report(JT, tt)
    s_port = _quiet_report(TT, tt)
    assert s_port == s_port_jax
    for key in ("total_dispatches", "nfit", "n_h2d", "n_quality",
                "device_counts", "n_cold", "n_skipped", "n_force_flush",
                "counters"):
        assert s_port[key] == sj[key], key
    assert s_port["nfit"] == rt.nfit == rj.nfit
    # the manifest names the port's backend
    man = JT.load_trace(tt)[0]
    assert man["backend"] == "cpu" and man["devices"] == []
    assert set(man["config"]) == set(JT.CONFIG_SNAPSHOT_KEYS)
    assert man["config"]["fit_harmonic_window"] == 128
    # a real knob since the router plane: its default, in both manifests
    assert man["config"]["serve_listen"] is None
    assert tcfg.serve_listen is None


def test_stream_trace_parity(corpus, stream_config, tmp_path):
    """Event counts, dispatch shapes/sizes in seq order, archive_done
    order, counters and fit quality against the JAX stream driver."""
    jt, tt, rj, rt = _stream_pair(corpus, tmp_path)
    assert _counts(tt) == _counts(jt)
    ej, et = _events(jt), _events(tt)

    def disp(evs):
        return [(ev["seq"], ev["shape"], ev["n"], ev["device"], ev["cold"])
                for ev in sorted((e for e in evs if e["type"] == "dispatch"),
                                 key=lambda e: e["seq"])]

    assert disp(et) == disp(ej)
    assert ([ev["datafile"] for ev in et if ev["type"] == "archive_done"]
            == [ev["datafile"] for ev in ej if ev["type"] == "archive_done"])
    assert et[-1]["type"] == "counters"
    assert et[-1]["counters"] == ej[-1]["counters"]
    # the in-flight high-water mark depends on completion timing
    assert 1 <= et[-1]["gauges"]["peak_inflight"] <= tcfg.stream_max_inflight
    # dispatch / h2d / drain pair by seq
    for typ in ("h2d_start", "h2d_done", "drain", "dispatched"):
        assert sorted(ev["seq"] for ev in et if ev["type"] == typ) == \
            sorted(ev["seq"] for ev in et if ev["type"] == "dispatch")
    qj = {ev["seq"]: ev for ev in ej if ev["type"] == "quality"}
    qt = {ev["seq"]: ev for ev in et if ev["type"] == "quality"}
    assert set(qt) == set(qj)
    for seq in qj:
        np.testing.assert_allclose(qt[seq]["snr"], qj[seq]["snr"],
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(qt[seq]["gof"], qj[seq]["gof"],
                                   rtol=1e-4, atol=2e-4)
    # the run_end rollup carries the executor's numbers
    end = [ev for ev in et if ev["type"] == "run_end"]
    assert len(end) == 1 and end[0]["nfit"] == rt.nfit
    assert end[0]["h2d_bytes"] == rt.h2d_bytes == rt.h2d_bytes_logical


def test_narrowband_stream_trace_parity(corpus, stream_config, tmp_path):
    """stream_narrowband_TOAs: the same event counts and counters."""
    root, meta, files, gmodel = corpus
    jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    JS.stream_narrowband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                              telemetry=jt, zap_inline=True,
                              stream_devices=1)
    TS.stream_narrowband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                              telemetry=tt, device="cpu", zap_inline=True)
    assert _counts(tt) == _counts(jt)
    assert _events(tt)[-1]["counters"] == _events(jt)[-1]["counters"]
    JT.validate_trace(tt)


def test_tracing_changes_nothing(corpus, stream_config, tmp_path):
    """.tim identical with telemetry on and off (port)."""
    root, meta, files, gmodel = corpus
    on, off = str(tmp_path / "on.tim"), str(tmp_path / "off.tim")
    TS.stream_wideband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                            tim_out=on, device="cpu",
                            telemetry=str(tmp_path / "t.jsonl"))
    TS.stream_wideband_TOAs(meta, gmodel, nsub_batch=4, quiet=True,
                            tim_out=off, device="cpu")
    assert open(on).read() == open(off).read()


def test_get_channels_to_zap_events(corpus, stream_config, tmp_path):
    """get_channels_to_zap(telemetry=): one zap_propose per archive with
    the JAX package's channel counts."""
    from pulseportraiture_tpu.pipeline import GetTOAs as JGetTOAs
    from pulseportraiture_tpu_torch.pipeline import GetTOAs as TGetTOAs

    root, meta, files, gmodel = corpus
    jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jg = JGetTOAs(files[:2], gmodel, quiet=True)
    jg.get_TOAs(quiet=True)
    zj = jg.get_channels_to_zap(device=False, telemetry=jt)
    tg = TGetTOAs(files[:2], gmodel, quiet=True, device="cpu")
    tg.get_TOAs(quiet=True)
    zt = tg.get_channels_to_zap(zap_device=False, telemetry=tt)
    assert zt == zj
    assert _counts(tt) == _counts(jt)

    def props(p):
        return [(ev["datafile"], ev["n_channels"], ev["device"])
                for ev in _events(p) if ev["type"] == "zap_propose"]

    assert props(tt) == props(jt) and len(props(tt)) == 2


def test_pptoas_stream_telemetry_cli(corpus, stream_config, tmp_path):
    """pptoas --stream --telemetry: the JAX CLI's event counts."""
    from pulseportraiture_tpu.cli.pptoas import main as jmain
    from pulseportraiture_tpu_torch.cli.pptoas import main as tmain

    root, meta, files, gmodel = corpus
    jt, tt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    args = ["--stream", "-d", meta, "-m", gmodel, "--quiet"]
    jmain(args + ["-o", str(tmp_path / "jax.tim"), "--telemetry", jt,
                  "--stream-devices", "1"])
    tmain(args + ["-o", str(tmp_path / "torch.tim"), "--telemetry", tt,
                  "--device", "cpu"])
    assert _counts(tt) == _counts(jt)
    assert _quiet_report(TT, tt)["nfit"] == _quiet_report(JT, jt)["nfit"]


# ---------------------------------------------------------------------------
# units


def test_log_levels(capsys, tmp_path):
    tr = TT.Tracer(str(tmp_path / "t.jsonl"))
    TT.log("hello", tracer=tr)
    TT.log("hidden", quiet=True, tracer=tr)
    TT.log("careful", quiet=True, level="warn", tracer=tr)
    tr.close()
    out, err = capsys.readouterr()
    assert out == "hello\n" and err == "careful\n"
    logs = [(ev["level"], ev["msg"]) for ev in _events(tr.path)
            if ev["type"] == "log"]
    assert logs == [("info", "hello"), ("info", "hidden"),
                    ("warn", "careful")]
    with pytest.raises(ValueError, match="level"):
        TT.log("x", level="debug")


def test_prev_rotation_and_counters_last(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with TT.Tracer(path, run="first") as tr:
        tr.emit("resume_skip", n_skipped=1)
        tr.counter("a")
        tr.counter("a", 2)
        tr.gauge_max("g", 3)
        tr.gauge_max("g", 1)
    tr2 = TT.Tracer(path, run="second")
    tr2.close()
    tr2.close()  # idempotent
    tr2.emit("resume_skip", n_skipped=2)  # dropped after close
    assert JT.load_trace(path + ".prev")[0]["run"] == "first"
    prev = _events(path + ".prev")
    assert prev[-1] == {**prev[-1], "type": "counters",
                        "counters": {"a": 3}, "gauges": {"g": 3}}
    man, evs = JT.load_trace(path)
    assert man["run"] == "second" and [e["type"] for e in evs] == [
        "counters"]


def test_null_tracer():
    nt = TT.NULL_TRACER
    assert not nt.enabled and nt.path is None
    nt.emit("dispatch", seq=0)
    nt.counter("x")
    nt.gauge_max("x", 1)
    nt.close()
    with nt as t:
        assert t is nt
    seqs = [nt.next_seq() for _ in range(5)]
    assert seqs == sorted(seqs) and len(set(seqs)) == 5
    assert TT.resolve_tracer(None) == (nt, False)
    tr, own = TT.resolve_tracer(nt)
    assert tr is nt and not own


def test_resolve_tracer_follows_config(tmp_path, monkeypatch):
    path = str(tmp_path / "cfg.jsonl")
    monkeypatch.setattr(tcfg, "telemetry_path", path)
    tr, own = TT.resolve_tracer(None, run="x")
    assert own and tr.path == path
    tr.close()
    shared, own = TT.resolve_tracer(tr)
    assert shared is tr and not own


def test_finite():
    assert TT.finite(float("nan")) is None
    assert TT.finite(float("inf")) is None
    assert TT.finite(1.23456, 2) == 1.23
    assert TT.finite(np.float32(2.0)) == 2.0


def test_validate_rejects_drift(tmp_path):
    """Unknown event types, missing fields, a wrong schema and a file
    without a manifest are refused, as by the JAX validate_trace."""
    good = str(tmp_path / "good.jsonl")
    with TT.Tracer(good) as tr:
        tr.emit("drain", seq=0, device=0, wait_s=0.0, scatter_s=0.0)
    TT.validate_trace(good)
    lines = open(good).read().splitlines()
    man = json.loads(lines[0])

    def write(name, recs):
        p = str(tmp_path / name)
        with open(p, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
        return p

    bad = {
        "unknown": [man, {"type": "warp", "t": 0.0}],
        "missing": [man, {"type": "drain", "t": 0.0, "seq": 0}],
        "no_t": [man, {"type": "resume_skip", "n_skipped": 1}],
        "schema": [{**man, "schema": 99}],
        "no_manifest": [{"type": "resume_skip", "t": 0, "n_skipped": 1}],
    }
    for name, recs in bad.items():
        p = write(name + ".jsonl", recs)
        with pytest.raises(ValueError) as et:
            TT.validate_trace(p)
        with pytest.raises(ValueError) as ej:
            JT.validate_trace(p)
        assert str(et.value) == str(ej.value)
    assert TT.EVENT_FIELDS == JT.EVENT_FIELDS
    assert TT.TRACE_SCHEMA_VERSION == JT.TRACE_SCHEMA_VERSION
    assert TT.CONFIG_SNAPSHOT_KEYS == JT.CONFIG_SNAPSHOT_KEYS


def test_pptrace_cli(corpus, stream_config, tmp_path, capsys):
    """python -m pulseportraiture_tpu_torch.cli.pptrace validate/report
    exit 0; merge refuses a trace without trace_ids with the JAX
    package's ValueError (tests/test_torch_obs_merge.py merges real
    fleets)."""
    root, meta, files, gmodel = corpus
    tt = str(tmp_path / "t.jsonl")
    TS.stream_wideband_TOAs(files[:1], gmodel, nsub_batch=4, quiet=True,
                            telemetry=tt, device="cpu")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    for cmd in ("validate", "report"):
        r = subprocess.run(
            [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.pptrace",
             cmd, tt], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, r.stderr
        assert ("ok (schema 1" in r.stdout if cmd == "validate"
                else "-- h2d link (copy stage) --" in r.stdout)
    with pytest.raises(ValueError) as et:
        TT.main(["merge", tt])
    with pytest.raises(ValueError) as ej:
        JT.main(["merge", tt])
    assert str(et.value) == str(ej.value)
    assert "predate distributed tracing" in str(et.value)
    assert TT.main(["validate", tt]) == 0
    capsys.readouterr()


def test_ppt_telemetry_env(corpus, tmp_path):
    """PPT_TELEMETRY alone traces a pptoas run (GetTOAs), with no flag."""
    root, meta, files, gmodel = corpus
    trace = str(tmp_path / "env.jsonl")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    env["PPT_TELEMETRY"] = trace
    r = subprocess.run(
        [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.pptoas",
         "-d", files[0], "-m", gmodel, "--device", "cpu", "--quiet",
         "-o", str(tmp_path / "env.tim")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    man, evs = JT.validate_trace(trace)
    ends = [ev for ev in evs if ev["type"] == "run_end"]
    assert [ev["driver"] for ev in ends] == ["GetTOAs.get_TOAs"]
    assert man["config"]["telemetry_path"] == trace
