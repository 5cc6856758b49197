"""The port's operator tools (obs/merge -> pptrace merge, cli/ppmon) on
the CPU, against the JAX package's.

Fleet: the JAX obs suite's (tests/test_obs.py), two port servers behind
TransportServers with a trace each, a router whose first host (behind a
KillableTransport) is killed with request A in flight, hedge_ms=0 (every
request hedged) and an SLO target no request meets; corpus: 3 int16
archives of 2 subints x 16 channels x 128 bins (default_test_model,
make_fake_pulsar(rng=300+i), noise 0.08).  Every server runs with
device='cpu'.

Exact: the merged structure (the port's merge_traces against the JAX
one over the same files), format_merge's text, the refusal of a trace
without trace_ids, pptrace merge's text and JSON, ppmon.render's text of
a fleet reply and of a host reply, exit codes and their messages.
"""

import contextlib
import io
import json
import os
import runpy
import socket
import subprocess
import sys

import pytest

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_helpers import PAR

from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu.cli import ppmon as jmon
from pulseportraiture_tpu.obs import merge as JM
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import obs as TO
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.cli import ppmon as tmon
from pulseportraiture_tpu_torch.obs import merge as TM
from pulseportraiture_tpu_torch.serve import (DEAD, KillableTransport,
                                              SocketTransport, ToaRouter,
                                              ToaServer, TransportServer)

NB = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ppmon(argv):
    """(exit code, stdout) of the port's ppmon.main in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tmon.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """ONE routed fleet run: while it is live, the fleet and host metrics
    replies and the port's ppmon runs against the router's monitor
    endpoint and a host; then every server and the router closed, so
    the traces are whole."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.pipeline.stream import stream_wideband_TOAs
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old = {k: getattr(tcfg, k) for k in keys}
    tcfg.use_fast_fit = tcfg.fit_fused = True
    tcfg.fit_harmonic_window = 64
    root = tmp_path_factory.mktemp("torch_obs_merge")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i in range(3):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=16,
                         nbin=128, nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.01 * i, dDM=1e-4,
                         start_MJD=MJD(55100 + i, 0.1), noise_stds=0.08,
                         dedispersed=False, quiet=True, rng=300 + i,
                         device="cpu")
        files.append(path)
    ref = str(root / "refA.tim")
    rtrace = str(root / "router.jsonl")
    straces = [str(root / "hostA.jsonl"), str(root / "hostB.jsonl")]
    out = {"traces": [rtrace] + straces}
    try:
        stream_wideband_TOAs(files[:2], gmodel, nsub_batch=NB, tim_out=ref,
                             quiet=True, device="cpu")
        with ToaServer(nsub_batch=NB, max_wait_ms=30, telemetry=straces[0],
                       device="cpu") as h0, \
                ToaServer(nsub_batch=NB, max_wait_ms=30,
                          telemetry=straces[1], device="cpu") as h1, \
                TransportServer(h0, port=0) as lis_a, \
                TransportServer(h1, port=0) as lis_b:
            k0 = KillableTransport(SocketTransport(lis_a.label))
            router = ToaRouter([k0, SocketTransport(lis_b.label)],
                               telemetry=rtrace, hedge_ms=0.0,
                               slo_targets={"*": 1e-6})
            try:
                ha = router.submit(files[:2], gmodel,
                                   tim_out=str(root / "A.tim"), name="A",
                                   tenant="interactive")
                out["first_host_killed"] = ha.host.label == k0.label
                k0.kill()  # dies with A in flight: the failover path
                hb = router.submit(files[2:3], gmodel,
                                   tim_out=str(root / "B.tim"), name="B",
                                   tenant="bulk")
                ha.result(300)
                hb.result(300)
                with TransportServer(router, port=0) as mon:
                    mt = SocketTransport(mon.label)
                    out["mon_reply"] = mt.metrics()
                    mt.close()
                    ht = SocketTransport(lis_b.label)
                    out["host_reply"] = ht.metrics()
                    ht.close()
                    out["ppmon"] = {
                        "fleet_json": _ppmon([mon.label, "--once", "--json"]),
                        "fleet_text": _ppmon([mon.label, "--once"]),
                        "host_json": _ppmon([lis_b.label, "--once",
                                             "--json"])}
            finally:
                router.close()
        with open(ref, "rb") as a, open(root / "A.tim", "rb") as b:
            out["A_identical"] = b.read() == a.read()
    finally:
        for k, v in old.items():
            setattr(tcfg, k, v)
    return out


@pytest.fixture(scope="module")
def merged(fleet):
    """Both packages' merge of the fleet's traces."""
    return TM.merge_traces(fleet["traces"]), JM.merge_traces(fleet["traces"])


def test_merge_equals_jax(merged):
    """The port's merge_traces of the fleet's traces equals the JAX
    one's; every request appears exactly once, the failover rides A, a
    hedge rides a request, and each names its critical stage."""
    mt, mj = merged
    assert mt == mj
    assert mt["n_traces"] == 3
    assert {t["role"] for t in mt["traces"]} == {"router", "host"}
    by_name = {}
    for r in mt["requests"].values():
        by_name.setdefault(r["req"], []).append(r)
    assert set(by_name) == {"A", "B"}
    assert all(len(v) == 1 for v in by_name.values())
    assert mt["n_requests"] == 2
    for r in mt["requests"].values():
        assert r["router_wall_s"] is not None and r["error"] is None
        assert r["n_host_spans"] >= 1
        assert r["critical"] in ("queue", "serve", "wire+collect")
    assert by_name["A"][0]["tenant"] == "interactive"
    assert by_name["A"][0]["failovers"]
    assert any(r["hedged"] for r in mt["requests"].values())


def test_format_merge_same_text(merged):
    mt, mj = merged
    texts = []
    for mod, m in ((TM, mt), (JM, mj)):
        buf = io.StringIO()
        mod.format_merge(m, file=buf)
        texts.append(buf.getvalue())
    assert texts[0] == texts[1]
    assert "req A" in texts[0] and "req B" in texts[0]
    assert "failover" in texts[0] and "serve" in texts[0]
    assert TO.format_merge is TM.format_merge


def test_merge_refuses_pre_tracing_traces(tmp_path):
    trace = str(tmp_path / "old.jsonl")
    tr = TT.Tracer(trace, run="old")
    tr.emit("log", level="info", msg="no ids here")
    tr.close()
    errs = []
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="no trace_id") as ei:
            mod.merge_traces([trace])
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("as_json", [False, True], ids=["text", "json"])
def test_pptrace_merge_cli(fleet, merged, as_json, capsys, monkeypatch):
    """``python -m pulseportraiture_tpu_torch.cli.pptrace merge [--json]``
    prints what the JAX pptrace merge prints."""
    args = ["merge"] + fleet["traces"] + (["--json"] if as_json else [])
    monkeypatch.setattr(sys, "argv", ["pptrace"] + args)
    with pytest.raises(SystemExit) as ei:
        runpy.run_module("pulseportraiture_tpu_torch.cli.pptrace",
                         run_name="__main__")
    assert ei.value.code == 0
    got = capsys.readouterr().out
    assert JT.main(args) == 0
    assert got == capsys.readouterr().out
    if as_json:
        assert json.loads(got) == json.loads(json.dumps(merged[0]))
    else:
        assert got.startswith("merged 3 traces: ")


def test_ppmon_render_same_text(fleet):
    """ppmon.render of the router monitor's reply (fleet view) and of a
    host's reply (single-host view) gives the JAX ppmon's text."""
    for reply, head in ((fleet["mon_reply"], "ppmon: fleet (2 host(s))"),
                        (fleet["host_reply"], "ppmon: host")):
        texts = []
        for mod in (tmon, jmon):
            buf = io.StringIO()
            mod.render(json.loads(json.dumps(reply)), file=buf)
            texts.append(buf.getvalue())
        assert texts[0] == texts[1]
        assert head in texts[0]
    assert "-- slo --" in texts[0] or fleet["host_reply"]["slo"] is None


def test_ppmon_once_json_router_monitor(fleet):
    """ppmon --once --json against the port router's monitor endpoint:
    exit 0 and the fleet-shaped schema, with the fleet p99 and the
    killed host reported DEAD; the text view and a host's --json exit 0
    too.  The routed .tim of the failed-over request is byte-identical
    to its one-shot."""
    assert fleet["first_host_killed"] and fleet["A_identical"]
    rc, text = fleet["ppmon"]["fleet_json"]
    assert rc == 0
    reply = json.loads(text)
    assert set(reply) == {"metrics_enabled", "hosts", "fleet", "router"}
    for key in ("n_hosts", "states", "queue_depth", "in_flight",
                "toas_per_s", "link_stall_frac", "p50_s", "p90_s",
                "p99_s", "metrics"):
        assert key in reply["fleet"], key
    assert reply["fleet"]["p99_s"] is not None
    assert DEAD in reply["fleet"]["states"].values()
    for ent in reply["hosts"].values():
        for key in ("state", "outstanding", "queue_len", "p50_s", "p99_s",
                    "toas_per_s", "error"):
            assert key in ent, key
    assert reply["router"]["slo"]["interactive"]["alerting"] is True
    rc, text = fleet["ppmon"]["fleet_text"]
    assert rc == 0 and "ppmon: fleet (2 host(s))" in text
    rc, text = fleet["ppmon"]["host_json"]
    host = json.loads(text)
    assert rc == 0 and host["metrics_enabled"] is True
    assert host["queue_len"] == 0


def test_ppmon_unreachable_and_refusals():
    """An unreachable endpoint exits 1 with the JAX ppmon's message (in
    a subprocess as a user runs it); a malformed endpoint and a bad
    interval refuse as the JAX CLI does."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ep = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    r = subprocess.run([sys.executable, "-m",
                        "pulseportraiture_tpu_torch.cli.ppmon", ep, "--once",
                        "--json", "--timeout", "2"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert f"ppmon: cannot reach ppserve at {ep}" in r.stderr
    for argv in ([ep, "--once", "--timeout", "2"], ["not-an-endpoint"],
                 [ep, "--interval", "0"]):
        msgs = []
        for mod in (tmon, jmon):
            with pytest.raises(SystemExit) as ei:
                mod.main(argv)
            msgs.append(str(ei.value.code))
        assert msgs[0] == msgs[1]
