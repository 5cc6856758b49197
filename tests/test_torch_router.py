"""The port's routed fleet (serve/transport, serve/fleet, serve/router,
ppserve --listen, pproute, stream_ipta_campaign(router=), the router's
result-cache hit path) on the CPU, against the JAX package's.

Corpus: the JAX router suite's (tests/test_router.py), 4 int16 archives
of 2 subints x 16 / 12 channels x 128 bins (default_test_model,
make_fake_pulsar(rng=200+i), noise 0.08): two bucket shapes.  Both
packages run the fast fit with the fused stage and a 64-harmonic window
(the JAX Pallas kernels off), the JAX package on ONE device.  Every port
server runs with device='cpu', so its kernels run their plain versions.

Tolerances:
- within the port, every routed .tim (both transports, the codec lane,
  after a failover, with hedging, through pproute and the campaign) is
  BYTE-identical to the port's one-shot stream_wideband_TOAs on the same
  archives with the same nsub_batch;
- against the JAX package, .tim files field by field (_assert_tim_parity
  of test_torch_toas: TOAs and DMs within 0.05 sigma, fit-derived flags
  to the last printed digit);
- DeltaDM_summary means within 0.1 x their errors, errors within 1e-3
  relative (float32 fits of two frameworks);
- exact: wire replies and their keys, placements, fleet state edges,
  trace event counts, content keys, cache blobs, exit codes.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_helpers import PAR
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import serve as JSV
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu.pipeline import ipta as JI
from pulseportraiture_tpu.serve import codec as JCO
from pulseportraiture_tpu.serve import fleet as JF
from pulseportraiture_tpu.serve import transport as JTR
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import serve as TSV
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.pipeline import ipta as TI
from pulseportraiture_tpu_torch.pipeline import stream as TS
from pulseportraiture_tpu_torch.serve import codec as TCO
from pulseportraiture_tpu_torch.serve import fleet as TF
from pulseportraiture_tpu_torch.serve import transport as TTR

NB = 8  # nsub_batch of every served and one-shot run here
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def serve_config():
    """Fast fit, fused stage and a 64-harmonic window in both packages
    (the JAX Pallas kernels off); restored afterwards."""
    keys = ("use_fast_fit", "fit_fused", "fit_harmonic_window")
    old_j = {k: getattr(jcfg, k) for k in keys + ("fit_pallas",)}
    old_t = {k: getattr(tcfg, k) for k in keys}
    jcfg.use_fast_fit = tcfg.use_fast_fit = True
    jcfg.fit_fused = tcfg.fit_fused = True
    jcfg.fit_harmonic_window = tcfg.fit_harmonic_window = 64
    jcfg.fit_pallas = False
    yield
    for k, v in old_j.items():
        setattr(jcfg, k, v)
    for k, v in old_t.items():
        setattr(tcfg, k, v)


@pytest.fixture(scope="module")
def campaign(tmp_path_factory, serve_config):
    """(root, archives, gmodel, {slice name: one-shot .tim bytes}): the
    JAX router suite's corpus and the port's one-shot references of the
    slices the tests route."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_router")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    for i in range(4):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2,
                         nchan=16 if i < 2 else 12, nbin=128, nu0=1500.0,
                         bw=400.0, tsub=60.0, phase=0.01 * i, dDM=1e-4,
                         start_MJD=MJD(55100 + i, 0.1), noise_stds=0.08,
                         dedispersed=False, quiet=True, rng=200 + i,
                         device="cpu")
        files.append(path)
    refs = {}
    for name, sl in (("01", files[:2]), ("23", files[2:]),
                     ("0", files[:1]), ("1", files[1:2]),
                     ("2", files[2:3]), ("3", files[3:])):
        tim = str(root / f"ref{name}.tim")
        TS.stream_wideband_TOAs(sl, gmodel, nsub_batch=NB, tim_out=tim,
                                quiet=True, device="cpu")
        refs[name] = open(tim, "rb").read()
    return root, files, gmodel, refs


@pytest.fixture(scope="module")
def hosts(serve_config):
    """Two port servers and two JAX servers, shared by the module (the
    routers are per test)."""
    t = [TSV.ToaServer(nsub_batch=NB, max_wait_ms=30, device="cpu").start()
         for _ in range(2)]
    j = [JSV.ToaServer(nsub_batch=NB, max_wait_ms=30, quiet=True,
                       stream_devices=1).start() for _ in range(2)]
    yield {"torch": t, "jax": j}
    for s in t + j:
        s.stop()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _parity(tmp_path, jax_tim, torch_tim, tag):
    _assert_tim_parity(_tim_lines(jax_tim, tmp_path / f"{tag}_j.tim"),
                       _tim_lines(torch_tim, tmp_path / f"{tag}_t.tim"))


def _events(trace):
    return TT.validate_trace(trace)[1]


# ---------------------------------------------------------------------------
# 1. two hosts, both transports
# ---------------------------------------------------------------------------

def _two_host_round(router, slices, tims):
    handles = [router.submit(sl, gm, tim_out=tims[i], name=f"R{i}")
               for i, (sl, gm) in enumerate(slices)]
    return [h.result(300) for h in handles], router.stats()


@pytest.mark.parametrize("lane", ["inproc", "socket"])
def test_two_hosts_both_transports(campaign, hosts, tmp_path, lane):
    """Case 1: a port router over two port servers, in process and over
    sockets: each routed .tim byte-identical to the port's one-shot, one
    request per host, the router trace's report; and in parity with the
    JAX router over two JAX servers on the same archives."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]
    slices = [(files[:2], gmodel), (files[2:], gmodel)]
    tims = [str(tmp_path / f"routed{i}.tim") for i in range(2)]
    trace = str(tmp_path / "route.jsonl")
    listeners = []
    if lane == "inproc":
        transports = [TSV.InProcTransport(h0, label="hostA"),
                      TSV.InProcTransport(h1, label="hostB")]
    else:
        listeners = [TSV.TransportServer(h, port=0).start()
                     for h in (h0, h1)]
        transports = [TSV.SocketTransport(f"127.0.0.1:{ls.port}")
                      for ls in listeners]
    labels = [t.label for t in transports]
    router = TSV.ToaRouter(transports, telemetry=trace)
    try:
        results, stats = _two_host_round(router, slices, tims)
    finally:
        router.close()
        for ls in listeners:
            ls.close()
    for i, name in enumerate(("01", "23")):
        assert _read(tims[i]) == refs[name], i
    assert all(len(r.TOA_list) == 4 for r in results)
    assert sorted(st["n_requests"] for st in stats.values()) == [1, 1]
    assert all(st["outstanding"] == 0 for st in stats.values())
    events = _events(trace)
    subs = [e for e in events if e["type"] == "route_submit"]
    assert {e["host"] for e in subs} == set(labels)
    done = [e for e in events if e["type"] == "route_done"]
    assert len(done) == 2 and all(e["error"] is None for e in done)
    summary = TT.report(trace, file=io.StringIO())
    assert (summary["n_route_submit"], summary["n_route_retry"],
            summary["n_route_done"]) == (2, 0, 2)
    assert summary["router_imbalance"] == pytest.approx(1.0)
    assert sum(summary["router_host_counts"].values()) == 4
    # the JAX router over the JAX fleet, same slices: the same placement
    # and the .tim in parity
    j0, j1 = hosts["jax"]
    jtims = [str(tmp_path / f"jax{i}.tim") for i in range(2)]
    jr = JSV.ToaRouter([JSV.InProcTransport(j0, label="hostA"),
                        JSV.InProcTransport(j1, label="hostB")])
    try:
        _, jstats = _two_host_round(jr, slices, jtims)
    finally:
        jr.close()
    assert sorted(st["n_requests"] for st in jstats.values()) == [1, 1]
    for i in range(2):
        _parity(tmp_path, jtims[i], tims[i], f"r{i}")


def test_socket_transport_surface(campaign, hosts, tmp_path):
    """The socket lane's surface (JAX test_router.py:111): the decoded
    result survives the wire, stat crosses it, a request's failure
    arrives as RemoteRequestError naming its exception type, drain and
    collect-once eviction, and a dead endpoint is a TransportError."""
    root, files, gmodel, refs = campaign
    one = TS.stream_wideband_TOAs(files[:2], gmodel, nsub_batch=NB,
                                  quiet=True, device="cpu")
    with TSV.TransportServer(hosts["torch"][0], port=0) as listener:
        transport = TSV.SocketTransport(f"127.0.0.1:{listener.port}")
        router = TSV.ToaRouter([transport])
        tim = str(tmp_path / "sock.tim")
        res = router.get_TOAs(files[:2], gmodel, timeout=300, tim_out=tim,
                              name="S")
        assert _read(tim) == refs["01"]
        assert res.order == one.order
        assert res.DeltaDM_means == one.DeltaDM_means
        for ta, tb in zip(one.TOA_list, res.TOA_list):
            assert (ta.MJD.day, ta.MJD.frac) == (tb.MJD.day, tb.MJD.frac)
            assert ta.flags == tb.flags
        st = transport.stat()
        assert st["pending_archives"] == 0 and st["n_live"] == 0
        assert st["capability"]["platform"] == "cpu"
        with pytest.raises(TSV.RemoteRequestError,
                           match="no_such_option") as ei:
            router.get_TOAs(files[:1], gmodel, timeout=300, name="bad",
                            no_such_option=True)
        assert ei.value.etype == "TypeError"
        assert len(router.get_TOAs(files[:1], gmodel, timeout=300,
                                   name="again").TOA_list) == 2
        assert transport.drain(30) == 0
        h = transport.submit([files[3]], gmodel, name="drainme")
        assert transport.drain(60) == 1
        assert len(transport.result(h, 60).TOA_list) == 2
        with pytest.raises(TSV.RemoteRequestError, match="unknown"):
            transport.result(h, 1)
        router.close()
    with pytest.raises(TSV.TransportError, match="cannot reach"):
        TSV.SocketTransport(f"127.0.0.1:{listener.port}")


# ---------------------------------------------------------------------------
# 2. wire compatibility with the JAX transport
# ---------------------------------------------------------------------------

def _wire_replies(transport, files, gmodel):
    """Raw replies of every op through one SocketTransport."""
    out = {}
    out["submit"] = transport._call({
        "op": "submit", "datafiles": files, "modelfile": gmodel,
        "tim_out": None, "name": "W", "tenant": None, "trace_id": None,
        "options": {}})
    h = out["submit"]["handle"]
    while True:
        r = transport._call({"op": "result", "handle": h, "wait": 0.25})
        if r.get("done"):
            break
        out["poll"] = r
    out["result"] = r
    out["stat"] = transport._call({"op": "stat"})
    out["metrics"] = transport._call({"op": "metrics"})
    out["drain"] = transport._call({"op": "drain", "timeout": 0.0})
    out["unknown_op"] = transport._call({"op": "frobnicate"})
    out["unknown_handle"] = transport._call({"op": "result",
                                             "handle": 999, "wait": 0})
    out["bad_submit"] = transport._call({
        "op": "submit", "datafiles": files, "modelfile": gmodel,
        "options": {"no_such_option": 1}})
    return out


def test_wire_compatibility(campaign, hosts, tmp_path):
    """Case 2: a port SocketTransport against a JAX TransportServer and a
    JAX SocketTransport against a port TransportServer: every op's reply
    has the same keys (protocol violations the same replies), a decoded
    result is the same on both sides, and a request routed across the
    packages writes a .tim in parity (byte-identical to the one-shot of
    the package that served it)."""
    root, files, gmodel, refs = campaign
    with JSV.TransportServer(hosts["jax"][0], port=0) as jl, \
            TSV.TransportServer(hosts["torch"][0], port=0) as tl:
        t2j = TSV.SocketTransport(f"127.0.0.1:{jl.port}")
        j2t = JSV.SocketTransport(f"127.0.0.1:{tl.port}")
        rj = _wire_replies(t2j, files[:1], gmodel)
        rt = _wire_replies(j2t, files[:1], gmodel)
        for op in rj:
            assert set(rj[op]) == set(rt[op]), op
        for op in ("unknown_op", "unknown_handle", "drain"):
            assert rj[op] == rt[op], op
        # an unknown option is accepted at submit and fails at the fit
        assert rj["bad_submit"]["ok"] == rt["bad_submit"]["ok"]
        assert rt["result"]["result"]["order"] == files[:1]
        assert set(rt["stat"]["capability"]) >= {"platform", "fingerprint"}
        # each package decodes the other's result payload alike
        for payload in (rj["result"]["result"], rt["result"]["result"]):
            a, b = JCO.decode_result(payload), TCO.decode_result(payload)
            assert JCO.encode_result(a) == TCO.encode_result(b)
        # the typed surfaces across the packages
        assert set(t2j.stat()) == set(j2t.stat())
        assert set(t2j.metrics()) == set(j2t.metrics())
        # routed across the packages: a port router over the JAX host and
        # a JAX router over the port host
        tim_j, tim_t = str(tmp_path / "on_jax.tim"), str(tmp_path /
                                                         "on_torch.tim")
        tr = TSV.ToaRouter([t2j])
        jr = JSV.ToaRouter([j2t])
        try:
            tr.get_TOAs(files[:2], gmodel, timeout=300, tim_out=tim_j,
                        name="X")
            jr.get_TOAs(files[:2], gmodel, timeout=300, tim_out=tim_t,
                        name="Y")
            with pytest.raises(JTR.RemoteRequestError, match="unknown"):
                j2t.result(12345, timeout=1)
            with pytest.raises(TTR.RemoteRequestError, match="unknown"):
                t2j.result(12345, timeout=1)
        finally:
            tr.close()
            jr.close()
    assert _read(tim_t) == refs["01"]
    _parity(tmp_path, tim_j, tim_t, "x")
    for bad in ("nohost", "h:port", "h:99999", ":123"):
        for cfg in (jcfg, tcfg):
            with pytest.raises(ValueError):
                cfg.parse_hostport(bad)
        with pytest.raises(ValueError) as ej:
            jcfg.parse_hostport(bad)
        with pytest.raises(ValueError) as et:
            tcfg.parse_hostport(bad)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="no host endpoints"):
        TSV.ToaRouter([])


@pytest.mark.parametrize("sender,receiver", [("torch", "jax"),
                                             ("jax", "torch")])
def test_compressed_frames_cross(sender, receiver):
    """A zlib-flagged frame (config.transport_compress on, a frame above
    COMPRESS_MIN_FRAME) written by one package reads back in the other;
    a plain frame is the same bytes from both."""
    mods = {"torch": (TTR, tcfg), "jax": (JTR, jcfg)}
    (smod, scfg), (rmod, _) = mods[sender], mods[receiver]
    obj = {"ok": True, "payload": ["x" * 64] * 4096}
    old = scfg.transport_compress
    a, b = socket.socketpair()
    try:
        scfg.transport_compress = True
        smod._send_frame(a, obj)
        head = b.recv(4, socket.MSG_PEEK)
        assert int.from_bytes(head, "big") & 0x80000000
        assert rmod._recv_frame(b) == obj
        scfg.transport_compress = False
        smod._send_frame(a, {"op": "stat"})
        plain = b.recv(1024)
        c, d = socket.socketpair()
        try:
            rmod._send_frame(c, {"op": "stat"})
            assert d.recv(1024) == plain
        finally:
            c.close()
            d.close()
    finally:
        scfg.transport_compress = old
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# 3. backpressure
# ---------------------------------------------------------------------------

class _FlakyTransport:
    """Rejects the first ``n_reject`` submits with a retryable
    ServeRejected, then delegates (the JAX suite's injection)."""

    def __init__(self, inner, n_reject):
        self.inner = inner
        self.label = inner.label
        self.n_reject = n_reject

    def submit(self, *a, **kw):
        if self.n_reject > 0:
            self.n_reject -= 1
            raise TSV.ServeRejected("admission queue full (injected)",
                                    retryable=True)
        return self.inner.submit(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_backpressure_retry_and_exhaustion(campaign, hosts, tmp_path):
    """Case 3: both hosts reject once, the router backs off and places on
    the second pass (.tim still byte-identical, 2 route_retry events, the
    submit on attempt 3); an always-rejecting fleet exhausts retry_max;
    a terminal rejection raises at once."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]
    trace = str(tmp_path / "retry.jsonl")
    router = TSV.ToaRouter(
        [_FlakyTransport(TSV.InProcTransport(h0, label="f0"), 1),
         _FlakyTransport(TSV.InProcTransport(h1, label="f1"), 1)],
        retry_max=8, telemetry=trace)
    tim = str(tmp_path / "retried.tim")
    res = router.submit(files[:2], gmodel, tim_out=tim,
                        name="RT").result(300)
    router.close()
    assert len(res.TOA_list) == 4 and _read(tim) == refs["01"]
    events = _events(trace)
    retries = [e for e in events if e["type"] == "route_retry"]
    assert len(retries) == 2 and all(e["backoff_s"] > 0 for e in retries)
    subs = [e for e in events if e["type"] == "route_submit"]
    assert len(subs) == 1 and subs[0]["attempt"] == 3
    assert TT.report(trace, file=io.StringIO())["n_route_retry"] == 2

    router = TSV.ToaRouter(
        [_FlakyTransport(TSV.InProcTransport(h0, label="x0"), 99)],
        retry_max=3)
    with pytest.raises(TSV.ServeRejected, match="injected"):
        router.submit(files[:1], gmodel, name="never")
    router.close()
    router = TSV.ToaRouter([TSV.InProcTransport(h0, label="t0")])
    old = h0.queue.max_pending
    h0.queue.max_pending = 1
    try:
        with pytest.raises(TSV.ServeRejected, match="split it"):
            router.submit(files[:2], gmodel, name="huge")
    finally:
        h0.queue.max_pending = old
        router.close()


# ---------------------------------------------------------------------------
# 4. affinity and the cost model
# ---------------------------------------------------------------------------

def test_affinity_sticks_under_light_traffic(campaign, hosts, tmp_path):
    """Case 4a: results collected between submits: same-template requests
    stay on one host, as the JAX router keeps them."""
    root, files, gmodel, refs = campaign
    trace = str(tmp_path / "affinity.jsonl")
    router = TSV.ToaRouter([TSV.InProcTransport(h, label=f"a{i}")
                            for i, h in enumerate(hosts["torch"])],
                           telemetry=trace)
    for i in range(3):
        tim = str(tmp_path / f"L{i}.tim")
        router.get_TOAs(files[i:i + 1], gmodel, timeout=300, tim_out=tim,
                        name=f"L{i}")
        assert _read(tim) == refs[str(i)]
    stats = router.stats()
    router.close()
    assert [lbl for lbl, st in stats.items() if st["n_requests"]] == ["a0"]
    subs = [e for e in _events(trace) if e["type"] == "route_submit"]
    assert [e["affinity"] for e in subs] == [False, True, True]


class _StatStub:
    """A host that exists only as its stat() reply."""

    def __init__(self, label, pending, toas_per_s):
        self.label = label
        self.pending = pending
        self.toas_per_s = toas_per_s

    def stat(self):
        return {"pending_archives": self.pending, "queue_len": 0,
                "n_live": 0, "toas_per_s": self.toas_per_s,
                "capability": {"platform": "cpu", "fingerprint": "stub"}}

    def close(self):
        pass


@pytest.mark.parametrize("stubs,cost_model", [
    ((("slow", 4, 2.0), ("fast", 4, 10.0)), None),
    ((("slow", 4, 2.0), ("fast", 4, 10.0)), False),
    ((("a", 2, None), ("b", 1, None)), None),
    ((("a", 0, 5.0), ("b", 3, 1.0), ("c", 1, None)), None),
])
def test_cost_model_placement_matches_jax(stubs, cost_model):
    """Case 4b: for the same stat stubs both routers rank the hosts alike
    and compute the same costs and speeds (the heterogeneous cost model,
    raw least-loaded with cost_model=False, the unmeasured fleet)."""
    out = {}
    for tag, mod in (("jax", JSV), ("torch", TSV)):
        router = mod.ToaRouter([_StatStub(*s) for s in stubs],
                               cost_model=cost_model)
        try:
            ranked, sticky = router._rank("m.gmodel", 1)
            costs, speeds = router._costs(router.fleet.probe_all())
            out[tag] = ([m.label for m in ranked], sticky,
                        {m.label: c for m, c in costs.items()},
                        {m.label: s for m, s in speeds.items()},
                        {k: v["toas_per_s"]
                         for k, v in router.stats().items()})
        finally:
            router.close()
    assert out["torch"] == out["jax"]
    if stubs[1][0] == "fast" and cost_model is None:
        assert out["torch"][0] == ["fast", "slow"]
        assert out["torch"][2]["slow"] == pytest.approx(
            5 * out["torch"][2]["fast"])


# ---------------------------------------------------------------------------
# 5. concurrent clients
# ---------------------------------------------------------------------------

def test_concurrent_clients(campaign, hosts, tmp_path):
    """Case 5: more client threads than cores through ONE router, with a
    short switch interval: every request resolves byte-identical to its
    one-shot, nothing is lost or counted twice, loads return to zero."""
    root, files, gmodel, refs = campaign
    n = min(2 * (os.cpu_count() or 4), 32)
    router = TSV.ToaRouter([TSV.InProcTransport(h, label=f"c{i}")
                            for i, h in enumerate(hosts["torch"])])
    results = {}

    def go(i):
        results[i] = router.get_TOAs(
            [files[i % 4]], gmodel, timeout=300,
            tim_out=str(tmp_path / f"T{i}.tim"), name=f"T{i}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    stats = router.stats()
    router.close()
    assert len(results) == n
    assert sum(len(r.TOA_list) for r in results.values()) == 2 * n
    for i in range(n):
        assert _read(tmp_path / f"T{i}.tim") == refs[str(i % 4)]
    assert sum(st["n_requests"] for st in stats.values()) == n
    assert sum(st["n_archives"] for st in stats.values()) == n
    assert all(st["outstanding"] == 0 for st in stats.values())


# ---------------------------------------------------------------------------
# 6. the fleet state machine
# ---------------------------------------------------------------------------

class _FakeTransport:
    """stat-only stub, scripted to succeed or raise its package's
    TransportError."""

    def __init__(self, label, error):
        self.label = label
        self.error = error
        self.fail = False

    def stat(self):
        if self.fail:
            raise self.error(f"{self.label} down")
        return {"pending_archives": 0, "queue_len": 0, "n_live": 0}

    def close(self):
        pass


def test_fleet_state_machine_matches_jax(tmp_path):
    """Case 6a: the same scripted probe and submit outcomes walk the same
    edges in the port's Fleet as in the JAX Fleet, with the DEAD callback
    once and the same placeable sets."""
    runs = {}
    for tag, fmod, tmod, telem in (("jax", JF, JTR, JT),
                                   ("torch", TF, TTR, TT)):
        trace = str(tmp_path / f"{tag}.jsonl")
        tracer = telem.Tracer(trace, run="fsm")
        deaths = []
        fleet = fmod.Fleet(tracer=tracer, probe_ms=200,
                           on_dead=deaths.append, quiet=True)
        t = _FakeTransport("h0", tmod.TransportError)
        m = fleet.add(t)
        seen = [m.state, {x.label: v for x, v in fleet.probe_all().items()},
                m.state]
        t.fail = True
        fleet.record_error(m, "submit: boom")
        seen.append(m.state)
        fleet.probe_all()
        seen += [m.state, len(deaths), fleet.probe_all()]
        t.fail = False
        runs[tag] = (fleet, m, seen, trace, tracer, deaths)
    time.sleep(1.1)  # the DEAD re-probe throttle, both fleets at once
    for tag, (fleet, m, seen, trace, tracer, deaths) in runs.items():
        fleet.probe_all()
        seen.append(m.state)
        fleet.record_ok(m)
        seen += [m.state, len(deaths)]
        fleet.close()
        tracer.close()
    sj, st = runs["jax"][2], runs["torch"][2]
    assert st == sj
    assert st == ["JOINING", {"h0": 0}, "HEALTHY", "SUSPECT", "DEAD", 1,
                  {}, "REJOINED", "HEALTHY", 1]
    assert TF.PLACEABLE_STATES == JF.PLACEABLE_STATES

    def edges(trace):
        return [(e["from_state"], e["to_state"], e["reason"])
                for e in JT.load_trace(trace)[1]
                if e["type"] == "fleet_transition"]

    assert edges(runs["torch"][3]) == edges(runs["jax"][3])


def test_probe_timeout_bounds_placement(campaign, hosts):
    """Case 6b: a host whose stat() hangs past router_probe_ms neither
    delays placement nor stays HEALTHY."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]

    class _Hung:
        def __init__(self, inner):
            self.inner = inner
            self.label = inner.label
            self.hang = threading.Event()

        def stat(self):
            if self.hang.is_set():
                self.hang.wait(5.0)
            return self.inner.stat()

        def __getattr__(self, name):
            return getattr(self.inner, name)

    hung = _Hung(TSV.InProcTransport(h0, label="p0"))
    router = TSV.ToaRouter([hung, TSV.InProcTransport(h1, label="p1")],
                           probe_ms=100)
    try:
        router.get_TOAs(files[:1], gmodel, timeout=300, name="warm")
        hung.hang.set()
        t0 = time.monotonic()
        res = router.get_TOAs(files[1:2], gmodel, timeout=300,
                              name="bounded")
        wall = time.monotonic() - t0
        states = {k: v["state"] for k, v in router.stats().items()}
    finally:
        hung.hang.clear()
        router.close()
    assert len(res.TOA_list) == 2
    assert wall < 4.0, wall
    assert states["p0"] in (TSV.SUSPECT, TSV.HEALTHY)


def test_membership_and_fleet_file(campaign, hosts, tmp_path):
    """Case 6c: add, remove and a watched fleet file reconcile the
    membership; an unreachable entry is retried, not fatal."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]
    router = TSV.ToaRouter([TSV.InProcTransport(h0, label="m0")])
    assert router.host_labels() == ["m0"]
    router.add_host(TSV.InProcTransport(h1, label="m1"))
    with pytest.raises(ValueError, match="duplicate"):
        router.add_host(TSV.InProcTransport(h1, label="m1"))
    router.get_TOAs(files[:2], gmodel, timeout=300, name="A")
    assert router.stats()["m1"]["state"] == TSV.HEALTHY
    assert router.remove_host("m0") is True
    assert router.remove_host("m0") is False
    assert router.host_labels() == ["m1"]
    tim = str(tmp_path / "B.tim")
    res = router.get_TOAs(files[2:], gmodel, timeout=300, tim_out=tim,
                          name="B")
    assert len(res.TOA_list) == 4 and _read(tim) == refs["23"]
    router.close()
    with TSV.TransportServer(h0, port=0) as la, \
            TSV.TransportServer(h0, port=0) as lb:
        ffile = tmp_path / "fleet.txt"
        ffile.write_text(f"# fleet\n127.0.0.1:{la.port}\n"
                         f"127.0.0.1:{lb.port}\n127.0.0.1:9\nnot-a-host\n")
        router = TSV.ToaRouter(fleet_file=str(ffile), probe_ms=500)
        try:
            labels = set(router.host_labels())
            assert labels == {f"127.0.0.1:{la.port}",
                              f"127.0.0.1:{lb.port}"}
            ffile.write_text(f"127.0.0.1:{la.port}\n")
            router._watcher.resync()
            assert router.host_labels() == [f"127.0.0.1:{la.port}"]
        finally:
            router.close()


class _Membership:
    """A router's membership surface alone (what FleetFileWatcher
    drives), with a yield in each edit so that racing passes interleave."""

    def __init__(self):
        self.hosts = set()
        self.lock = threading.Lock()

    def host_labels(self):
        with self.lock:
            return sorted(self.hosts)

    def add_host(self, addr):
        time.sleep(0)
        with self.lock:
            self.hosts.add(addr)

    def remove_host(self, label):
        time.sleep(0)
        with self.lock:
            self.hosts.discard(label)
        return True


def test_fleet_file_resync_serialized(tmp_path):
    """Case 6d: a caller's resync racing the watcher's own pass while the
    fleet file is saved in place (truncated, then written) ends, every
    time, with the membership equal to the file's last content: the
    passes are serialized, so one that read the truncated file cannot
    undo a later one that read the whole file.  600 rewrites."""
    rng = np.random.default_rng(7)
    pool = [f"127.0.0.1:{p}" for p in range(9001, 9007)]
    ffile = tmp_path / "fleet.txt"
    ffile.write_text("".join(h + "\n" for h in pool))
    router = _Membership()
    watcher = TSV.FleetFileWatcher(router, str(ffile), quiet=True)
    watcher.resync()
    assert router.host_labels() == sorted(pool)
    for _ in range(600):
        want = sorted(rng.choice(pool, size=int(rng.integers(1, 5)),
                                 replace=False))
        def poll():
            for _ in range(4):
                watcher.resync()

        th = threading.Thread(target=poll)
        th.start()
        ffile.write_text("".join(h + "\n" for h in want))
        watcher.resync()
        th.join(10)
        assert router.host_labels() == want


def test_fleet_file_save_within_one_mtime_tick(tmp_path):
    """ROADMAP C6: two saves within one mtime tick (the second with the
    first's mtime, set by os.utime, and another size) are both seen by
    the poll thread, with no caller's resync; comparing mtimes alone
    misses the second."""
    ffile = tmp_path / "fleet.txt"
    a, b = "127.0.0.1:9101", "127.0.0.1:9102"
    ffile.write_text(a + "\n")
    router = _Membership()
    watcher = TSV.FleetFileWatcher(router, str(ffile), poll_s=0.05,
                                   quiet=True)

    def wait_for(want):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if router.host_labels() == want:
                return True
            time.sleep(0.02)
        return False

    watcher.start()
    try:
        assert wait_for([a])
        time.sleep(0.2)  # a few passes with the first stamp
        st = os.stat(ffile)
        ffile.write_text(a + "\n" + b + "\n")
        os.utime(ffile, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert os.stat(ffile).st_mtime_ns == st.st_mtime_ns
        assert wait_for([a, b])
    finally:
        watcher.stop()
        watcher.join(10)
    assert not watcher.is_alive()


# ---------------------------------------------------------------------------
# 7. failover
# ---------------------------------------------------------------------------

def test_failover_redispatches_mid_fit(campaign, hosts, tmp_path):
    """Case 7a: a host killed with the request in flight: re-placed on the
    survivor, the .tim byte-identical with no duplicated line, one
    route_failover, the dead host DEAD."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]
    trace = str(tmp_path / "kill.jsonl")
    k0 = TSV.KillableTransport(TSV.InProcTransport(h0, label="k0"))
    router = TSV.ToaRouter([k0, TSV.InProcTransport(h1, label="k1")],
                           telemetry=trace)
    tim = str(tmp_path / "killed.tim")
    rh = router.submit(files[:2], gmodel, tim_out=tim, name="F0")
    assert rh.host.label == "k0"
    k0.kill()
    res = rh.result(300)
    stats = router.stats()
    router.close()
    # the zombie primary may still rewrite the path (with the same
    # bytes): read it once the shared server is idle, its request neither
    # live nor still queued for admission
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        st = h0.stats()
        if not (st["n_live"] or st["queue_len"]):
            break
        time.sleep(0.05)
    assert len(res.TOA_list) == 4
    assert _read(tim) == refs["01"]
    lines = [ln for ln in _read(tim).decode().splitlines() if ln.strip()]
    assert len(lines) == len(set(lines))
    assert stats["k0"]["state"] == TSV.DEAD
    assert all(st["outstanding"] == 0 for st in stats.values())
    events = _events(trace)
    fo = [e for e in events if e["type"] == "route_failover"]
    assert len(fo) == 1 and fo[0]["dead_host"] == "k0"
    assert fo[0]["action"] in ("redispatch", "collected")
    done = [e for e in events if e["type"] == "route_done"]
    assert len(done) == 1 and done[0]["error"] is None
    summary = TT.report(trace, file=io.StringIO())
    assert summary["n_failover"] == 1
    assert summary["fleet_states"]["k0"] == "DEAD"


def test_failover_collects_durable_tim(campaign, hosts, tmp_path):
    """Case 7b: a host killed after its .tim landed and before collection:
    the request is collected from the file, the survivor fits nothing,
    and the recovered result re-serializes byte-identically."""
    root, files, gmodel, refs = campaign
    h0, h1 = hosts["torch"]
    trace = str(tmp_path / "durable.jsonl")
    k0 = TSV.KillableTransport(TSV.InProcTransport(h0, label="k0"))
    router = TSV.ToaRouter([k0, TSV.InProcTransport(h1, label="k1")],
                           telemetry=trace)
    tim = str(tmp_path / "durable.tim")
    rh = router.submit(files[:2], gmodel, tim_out=tim, name="D0")
    deadline = time.monotonic() + 120
    while not TSV.tim_complete(tim, files[:2]):
        assert time.monotonic() < deadline, "the .tim never landed"
        time.sleep(0.05)
    k0.kill()
    res = rh.result(300)
    survivor = router.stats()["k1"]
    router.close()
    assert res.recovered_from_tim is True
    assert len(res.TOA_list) == 4 and res.DM0s == [None, None]
    assert all(np.isnan(v) for v in res.DeltaDM_means)
    assert _read(tim) == refs["01"]
    assert survivor["n_requests"] == 0
    tim2 = str(tmp_path / "reserialized.tim")
    TSV.write_tim_result(res, tim2)
    assert _read(tim2) == refs["01"]
    fo = [e for e in _events(trace) if e["type"] == "route_failover"]
    assert [e["action"] for e in fo] == ["collected"]
    assert TT.report(trace, file=io.StringIO())["n_failover_collected"] == 1


# ---------------------------------------------------------------------------
# 8. hedging, the codec lane, the codec round trip
# ---------------------------------------------------------------------------

def test_hedged_requests(campaign, hosts, tmp_path):
    """Case 8a: hedge_ms=0 hedges every request; the winner's .tim is
    byte-identical, no side file, loads drain, one route_hedge."""
    root, files, gmodel, refs = campaign
    trace = str(tmp_path / "hedge.jsonl")
    router = TSV.ToaRouter([TSV.InProcTransport(h, label=f"g{i}")
                            for i, h in enumerate(hosts["torch"])],
                           hedge_ms=0.0, telemetry=trace)
    tim = str(tmp_path / "hedged.tim")
    res = router.get_TOAs(files[:2], gmodel, timeout=300, tim_out=tim,
                          name="H0")
    stats = router.stats()
    deadline = time.monotonic() + 60
    while router._orphans and time.monotonic() < deadline:
        time.sleep(0.05)  # the loser reaped
    router.close()
    assert len(res.TOA_list) == 4
    assert _read(tim) == refs["01"]
    assert not os.path.exists(tim + ".tmp~")
    assert all(st["outstanding"] == 0 for st in stats.values())
    events = _events(trace)
    hedges = [e for e in events if e["type"] == "route_hedge"]
    assert len(hedges) == 1 and hedges[0]["primary"] != hedges[0]["host"]
    done = [e for e in events if e["type"] == "route_done"]
    assert done[0]["hedged"] is True and done[0]["error"] is None
    assert TT.report(trace, file=io.StringIO())["n_hedge"] == 1


def test_codec_lane_over_socket(campaign, hosts, tmp_path):
    """Case 8b: write_tim='router' over the wire: the host writes nothing,
    the router's .tim is byte-identical; a bad write_tim raises."""
    root, files, gmodel, refs = campaign
    with TSV.TransportServer(hosts["torch"][1], port=0) as listener:
        router = TSV.ToaRouter(
            [TSV.SocketTransport(f"127.0.0.1:{listener.port}")],
            write_tim="router")
        tim = str(tmp_path / "codec.tim")
        res = router.get_TOAs(files[:2], gmodel, timeout=300, tim_out=tim,
                              name="C0")
        router.close()
    assert res.tim_out == tim and _read(tim) == refs["01"]
    with pytest.raises(ValueError, match="write_tim"):
        TSV.ToaRouter([TSV.InProcTransport(object(), label="x")],
                      write_tim="nowhere")


def test_roundtrip_result_property(campaign, tmp_path):
    """Case 8c: randomized results survive roundtrip_result and encode to
    the JAX codec's JSON; the codec lane's writer reproduces the server's
    per-archive demux bytes; a real result survives recover and
    re-serialize."""
    from pulseportraiture_tpu_torch.io.tim import TOA, toa_string, \
        write_TOAs
    from pulseportraiture_tpu_torch.pipeline.stream import _DONE_PREFIX
    from pulseportraiture_tpu_torch.utils.bunch import DataBunch
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    rng = np.random.default_rng(1234)
    makers = [lambda r: int(r.integers(-5, 2000)),
              lambda r: np.int64(r.integers(0, 1 << 40)),
              lambda r: float(r.normal() * 10.0 ** int(r.integers(-6, 6))),
              lambda r: np.float32(r.normal()),
              lambda r: "GUPPI_" + str(r.integers(0, 9)),
              lambda r: bool(r.integers(0, 2)),
              lambda r: np.bool_(r.integers(0, 2))]
    for trial in range(30):
        order, toas = [], []
        for a in range(int(rng.integers(1, 4))):
            datafile = f"/data/ep{trial}_{a}.fits"
            order.append(datafile)
            for _ in range(int(rng.integers(0, 3))):
                flags = {f"f{k}": makers[int(rng.integers(0, len(makers)))](
                    rng) for k in range(int(rng.integers(0, 5)))}
                freq = (np.inf if rng.random() < 0.2
                        else float(rng.uniform(100, 3000)))
                toas.append(TOA(
                    datafile, freq,
                    MJD(int(rng.integers(40000, 60000)), float(rng.random())),
                    float(abs(rng.normal()) + 1e-3), "GBT", "1",
                    DM=None if rng.random() < 0.3
                    else float(rng.uniform(0, 300)),
                    DM_error=None if rng.random() < 0.3
                    else float(abs(rng.normal()) * 1e-2), flags=flags))
        res = DataBunch(TOA_list=toas, order=order,
                        DM0s=[None if rng.random() < 0.5
                              else float(rng.uniform(0, 300))
                              for _ in order],
                        DeltaDM_means=[float(rng.normal()) for _ in order],
                        DeltaDM_errs=[float(abs(rng.normal()))
                                      for _ in order],
                        tim_out=None, n_skipped=0)
        back = TCO.roundtrip_result(res)
        assert json.dumps(TCO.encode_result(res)) == json.dumps(
            JCO.encode_result(JCO.decode_result(TCO.encode_result(res))))
        assert back.order == order and back.DM0s == res.DM0s
        for ta, tb in zip(res.TOA_list, back.TOA_list):
            assert (ta.MJD.day, ta.MJD.frac) == (tb.MJD.day, tb.MJD.frac)
            assert tb.frequency == ta.frequency
            assert toa_string(tb) == toa_string(ta)
            for k, v in ta.flags.items():
                w = tb.flags[k]
                if isinstance(v, (bool, np.bool_)):
                    assert isinstance(w, bool)
                elif isinstance(v, (int, np.integer)):
                    assert isinstance(w, int) and w == int(v)
                elif isinstance(v, (float, np.floating)):
                    assert isinstance(w, float)
                else:
                    assert w == v
        a, b = str(tmp_path / f"srv{trial}.tim"), str(tmp_path /
                                                      f"rtr{trial}.tim")
        open(a, "w").close()
        for d in order:
            write_TOAs([t for t in toas if t.archive == d], outfile=a,
                       append=True)
            with open(a, "a") as fh:
                fh.write(_DONE_PREFIX + os.path.abspath(d) + "\n")
        TSV.write_tim_result(back, b)
        assert _read(b) == _read(a), trial
    assert TSV.read_tim_result(b).order == order
    root, files, gmodel, refs = campaign
    one = TS.stream_wideband_TOAs(files[:2], gmodel, nsub_batch=NB,
                                  quiet=True, device="cpu")
    one.tim_out = None
    tim = str(tmp_path / "real.tim")
    TSV.write_tim_result(one, tim)
    assert _read(tim) == refs["01"]
    tim2 = str(tmp_path / "real2.tim")
    TSV.write_tim_result(TCO.roundtrip_result(TSV.read_tim_result(tim)),
                         tim2)
    assert _read(tim2) == refs["01"]


# ---------------------------------------------------------------------------
# 9. tenants
# ---------------------------------------------------------------------------

def test_tenant_qos_end_to_end(campaign, serve_config, tmp_path):
    """Case 9: tenant= rides submit -> wire -> the host's lane -> the
    request events, and the report's per-tenant latency split."""
    root, files, gmodel, refs = campaign
    trace = str(tmp_path / "tenant.jsonl")
    srv = TSV.ToaServer(nsub_batch=NB, max_wait_ms=30, telemetry=trace,
                        tenant_quota={"bulk": 8}, device="cpu").start()
    try:
        with TSV.TransportServer(srv, port=0) as listener:
            router = TSV.ToaRouter(
                [TSV.SocketTransport(f"127.0.0.1:{listener.port}")])
            ha = router.submit(files[:2], gmodel, name="big",
                               tenant="bulk")
            hb = router.submit(files[2:3], gmodel, name="small",
                               tenant="interactive")
            ha.result(300)
            hb.result(300)
            router.close()
    finally:
        srv.stop()
    events = _events(trace)
    for typ in ("request_submit", "request_done"):
        assert {e["req"]: e.get("tenant") for e in events
                if e["type"] == typ} == {"big": "bulk",
                                         "small": "interactive"}
    summary = TT.report(trace, file=io.StringIO())
    assert set(summary["tenant_latency"]) == {"bulk", "interactive"}
    for rec in summary["tenant_latency"].values():
        assert rec["n"] == 1 and rec["p99_s"] >= rec["p50_s"] > 0


# ---------------------------------------------------------------------------
# 10. refit-aware routing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rfi_pair(tmp_path_factory, serve_config):
    """One contaminated and one clean archive (the JAX fleet suite's
    recipe) and the port's zap-then-fit oracle .tim."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.io.psrfits import load_data
    from pulseportraiture_tpu_torch.pipeline.zap import get_zap_channels
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  inject_rfi,
                                                  make_fake_pulsar)

    root = tmp_path_factory.mktemp("torch_router_rfi")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = []
    specs = [dict(tone_channels=[3, 11], tone_white=8.0,
                  tone_structured=60.0, bursts=[(1, [20, 21], 20.0)]), None]
    for i, spec in enumerate(specs):
        path = str(root / f"ep{i}.fits")
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=32,
                         nbin=128, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.01 * i, dDM=1e-4 * (i - 1),
                         noise_stds=0.05, dedispersed=False, quiet=True,
                         rng=300 + i, device="cpu")
        if spec:
            inject_rfi(path, rng=40 + i, **spec)
        files.append(path)
    d = load_data(files[0], dedisperse=False, dededisperse=True,
                  pscrunch=True, quiet=True)
    zl = get_zap_channels(d, zap_device=False, device="cpu")
    oracle = str(root / "oracle.tim")
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=NB, quiet=True,
                            tim_out=oracle, zap_channels={files[0]: zl},
                            device="cpu")
    return files, gmodel, _read(oracle)


def test_refit_aware_routing(rfi_pair, hosts, tmp_path):
    """Case 10: the gate-tripping archive is zapped and refit exactly once
    on the least-loaded HEALTHY host (the refit event carries the move);
    the merged .tim equals the port's zap-then-fit oracle byte for byte
    and the JAX router's refit field by field; a clean request is left
    alone.  The router's zap runs on device='cpu'; with no card and no
    device it raises."""
    files, gmodel, oracle = rfi_pair
    trace = str(tmp_path / "refit.jsonl")
    router = TSV.ToaRouter([TSV.InProcTransport(h, label=f"r{i}")
                            for i, h in enumerate(hosts["torch"])],
                           quality_refit=True, telemetry=trace,
                           device="cpu")
    tim = str(tmp_path / "routed.tim")
    clean = str(tmp_path / "clean.tim")
    try:
        res = router.get_TOAs(files, gmodel, timeout=600, tim_out=tim,
                              name="R")
        router.get_TOAs(files[1:], gmodel, timeout=600, tim_out=clean,
                        name="CL")
    finally:
        router.close()
    assert len(res.TOA_list) == 4 and _read(tim) == oracle
    ref_clean = str(tmp_path / "ref_clean.tim")
    TS.stream_wideband_TOAs(files[1:], gmodel, nsub_batch=NB, quiet=True,
                            tim_out=ref_clean, device="cpu")
    assert _read(clean) == _read(ref_clean)
    refits = [e for e in _events(trace) if e["type"] == "refit"]
    assert len(refits) == 1
    ev = refits[0]
    assert ev["datafile"] == files[0] and ev["n_channels"] > 0
    assert ev["improved"] is True and ev["gof_after"] < ev["gof_before"]
    assert {ev["host_from"], ev["host"]} <= {"r0", "r1"}
    jtim = str(tmp_path / "jax.tim")
    jr = JSV.ToaRouter([JSV.InProcTransport(h, label=f"r{i}")
                        for i, h in enumerate(hosts["jax"])],
                       quality_refit=True)
    try:
        jr.get_TOAs(files, gmodel, timeout=600, tim_out=jtim, name="R")
    finally:
        jr.close()
    _parity(tmp_path, jtim, tim, "refit")


def test_router_device_rule(monkeypatch):
    """A refitting router without a card and without device= raises; one
    that never refits needs no device."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stub = _StatStub("s", 0, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.ToaRouter([stub], quality_refit=True)
    router = TSV.ToaRouter([stub])
    assert router.device is None
    router.close()


# ---------------------------------------------------------------------------
# 11. the cache
# ---------------------------------------------------------------------------

def test_router_cache_hit_short_circuits(campaign, hosts, tmp_path):
    """Case 11a: a router-side hit never reaches a host (request counts
    frozen, no attempts), its .tim is the stored bytes, the trace shows
    one hit and one miss."""
    root, files, gmodel, refs = campaign
    trace = str(tmp_path / "route.jsonl")
    router = TSV.ToaRouter([TSV.InProcTransport(hosts["torch"][0],
                                                label="h0")],
                           telemetry=trace, result_cache=True,
                           cache_dir=str(tmp_path / "store"))
    t1, t2 = str(tmp_path / "r1.tim"), str(tmp_path / "r2.tim")
    router.submit(files[:2], gmodel, tim_out=t1, name="r1").result(300)
    placed = {lbl: st["n_requests"] for lbl, st in router.stats().items()}
    rh = router.submit(files[:2], gmodel, tim_out=t2, name="r2")
    res = rh.result(300)
    assert rh.attempts == [] and rh.host is None
    assert router.cache_hits == 1
    assert {lbl: st["n_requests"]
            for lbl, st in router.stats().items()} == placed
    assert _read(t2) == _read(t1) == refs["01"]
    assert len(res.TOA_list) == 4
    m = router.metrics()
    assert m["router"]["cache_hits"] == 1
    assert m["router"]["cache_hit_rate"] == 0.5
    router.close()
    summary = TT.report(trace, file=io.StringIO())
    assert (summary["n_cache_hit"], summary["n_cache_miss"],
            summary["n_route_done"]) == (1, 1, 2)


def test_tenant_hits_not_billed(campaign, serve_config, tmp_path):
    """Case 11b: a tenant whose quota is one archive sees its repeats as
    hits on its ledger, never billed against the quota."""
    root, files, gmodel, refs = campaign
    srv = TSV.ToaServer(nsub_batch=NB, max_wait_ms=30, result_cache=True,
                        cache_dir=str(tmp_path / "store"),
                        tenant_quota={"bulk": 1, "*": 8},
                        device="cpu").start()
    try:
        router = TSV.ToaRouter([TSV.InProcTransport(srv, label="q0")])
        router.get_TOAs([files[0]], gmodel, timeout=300, name="f1",
                        tenant="bulk")
        for i in range(3):
            router.get_TOAs([files[0]], gmodel, timeout=300, name=f"h{i}",
                            tenant="bulk")
        router.close()
        snap = srv.queue.tenant_snapshot()
        assert snap["bulk"]["cache_hits"] == 3
        assert snap["bulk"]["pending_archives"] == 0
        assert srv.stats()["cache_hits"] == 3
    finally:
        srv.stop()


def test_blob_store_semantics_match_jax(tmp_path):
    """Case 11c: the blob store's LRU order, oversize refusal and torn
    entries as in the JAX store, and a blob each package stored reads
    back in the other."""
    from pulseportraiture_tpu.serve.cache import ResultCache as JRC
    from pulseportraiture_tpu_torch.serve.cache import ResultCache as TRC

    rc = TRC(str(tmp_path / "s"), max_mb=0.003)
    for k in ("k1", "k2", "k3"):
        assert rc.put_blob(k, bytes(900)) is not None
    assert rc.get_blob("k1") is not None
    assert rc.put_blob("k4", bytes(900)) is not None
    assert rc.evictions == 1 and rc.get_blob("k2") is None
    assert rc.get_blob("k1") is not None and rc.get_blob("k3") is not None
    assert rc.put_blob("huge", bytes(4000)) is None
    with open(os.path.join(rc.dir, "k3.blob"), "r+b") as fh:
        fh.truncate(30)
    assert rc.get_blob("k3") is None
    assert not os.path.exists(os.path.join(rc.dir, "k3.blob"))
    shared = str(tmp_path / "shared")
    jc, tc = JRC(shared), TRC(shared)
    assert tc.put_blob("from_torch", b"torch bytes") == \
        jc.put_blob("from_jax", b"torch bytes")
    assert jc.get_blob("from_torch") == b"torch bytes"
    assert tc.get_blob("from_jax") == b"torch bytes"
    assert _read(os.path.join(shared, "from_torch.blob")) == \
        _read(os.path.join(shared, "from_jax.blob"))


def test_ppfactory_result_cache(campaign, tmp_path, capsys):
    """Case 11d: ppfactory --result-cache: the second run serves every
    template from the cache, byte-identical to the first; the JAX
    ppfactory keys the same archive and options alike, and a blob it
    stored serves the port.  The key holds the byte-relevant knobs, so
    the JAX package runs at its default fit_pallas, the value the port
    keys its absent Pallas knob at."""
    from pulseportraiture_tpu.cli.ppfactory import main as jfactory
    from pulseportraiture_tpu_torch.cli.ppfactory import main as tfactory

    root, files, gmodel, refs = campaign
    meta = str(tmp_path / "jobs.meta")
    with open(meta, "w") as fh:
        fh.write(files[0] + "\n" + files[2] + "\n")
    saved = [(c, k, getattr(c, k)) for c in (jcfg, tcfg)
             for k in ("result_cache", "cache_dir", "cache_max_mb")]
    saved.append((jcfg, "fit_pallas", jcfg.fit_pallas))
    jcfg.fit_pallas = "auto"
    try:
        common = ["-M", meta, "--max-ngauss", "1", "--verbose",
                  "--result-cache", "on"]
        tstore = str(tmp_path / "tstore")
        outs = []
        for run in (1, 2):
            outdir = str(tmp_path / f"t{run}")
            assert tfactory(common + ["-O", outdir, "--cache-dir", tstore,
                                      "--device", "cpu"]) == 0
            outs.append(capsys.readouterr().out)
        assert "0/2 template(s) served from the result cache" in outs[0]
        assert "2/2 template(s) served from the result cache" in outs[1]
        names = [os.path.basename(f) + ".gmodel" for f in (files[0],
                                                           files[2])]
        for n in names:
            assert _read(tmp_path / "t1" / n) == _read(tmp_path / "t2" / n)
        # the JAX ppfactory on the same archives and flags: the same keys
        jstore = str(tmp_path / "jstore")
        assert jfactory(common + ["-O", str(tmp_path / "j1"),
                                  "--cache-dir", jstore]) == 0
        capsys.readouterr()
        blobs = sorted(f for f in os.listdir(tstore) if f.endswith(".blob"))
        assert blobs == sorted(f for f in os.listdir(jstore)
                               if f.endswith(".blob")) and len(blobs) == 2
        # the port serves the JAX-stored blobs, byte for byte
        assert tfactory(common + ["-O", str(tmp_path / "t3"),
                                  "--cache-dir", jstore,
                                  "--device", "cpu"]) == 0
        assert "2/2 template(s) served" in capsys.readouterr().out
        for n in names:
            assert _read(tmp_path / "t3" / n) == _read(tmp_path / "j1" / n)
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


# ---------------------------------------------------------------------------
# 12. metrics
# ---------------------------------------------------------------------------

def test_router_metrics_aggregates_fleet(campaign, hosts, tmp_path):
    """Case 12: ToaRouter.metrics() has the JAX reply's keys at every
    level; a killed host is reported with its error, the live one with
    its latency quantiles; the router's own counters and SLO snapshot."""
    root, files, gmodel, refs = campaign
    replies = {}
    for tag, mod in (("jax", JSV), ("torch", TSV)):
        h0, h1 = hosts[tag]
        tmod = TTR if tag == "torch" else JTR
        k0 = tmod.KillableTransport(mod.InProcTransport(h0, label="m0"))
        router = mod.ToaRouter([k0, mod.InProcTransport(h1, label="m1")],
                               slo_targets={"*": 1e-6})
        try:
            router.get_TOAs(files[:2], gmodel, timeout=300, name="M0",
                            tenant="interactive")
            router.get_TOAs(files[2:], gmodel, timeout=300, name="M1",
                            tenant="interactive")
            k0.kill()
            router.fleet.probe_all()
            router.fleet.probe_all()
            replies[tag] = router.metrics()
        finally:
            router.close()
    mj, mt = replies["jax"], replies["torch"]
    assert set(mt) == set(mj)
    for key in ("fleet", "router"):
        assert set(mt[key]) == set(mj[key]), key
    assert set(mt["hosts"]) == set(mj["hosts"]) == {"m0", "m1"}
    for lb in ("m0", "m1"):
        assert set(mt["hosts"][lb]) == set(mj["hosts"][lb]), lb
    assert mt["fleet"]["states"] == mj["fleet"]["states"]
    dead = [lb for lb, st in mt["fleet"]["states"].items()
            if st == TSV.DEAD]
    assert dead and mt["hosts"][dead[0]]["error"]
    r = mt["router"]
    assert r["metrics"]["counters"]["route_submits"] == 2
    assert r["metrics"]["counters"]["route_done"] == 2
    assert r["p99_s"] is not None and mt["fleet"]["in_flight"] == 0
    assert r["slo"]["interactive"]["alerting"] is True
    assert r["slo"]["interactive"]["attainment"] == 0.0
    assert r["metrics"]["counters"] == mj["router"]["metrics"]["counters"]
    json.dumps(mt)  # what --monitor sends is pure JSON


# ---------------------------------------------------------------------------
# 13. the thin client
# ---------------------------------------------------------------------------

def test_ipta_campaign_router(campaign, hosts, tmp_path):
    """Case 13: stream_ipta_campaign(router=) gives the server= run's
    per-pulsar .tim and DeltaDM_summary, both pulsars placed on distinct
    hosts; in parity with the JAX router= run; the JAX package's
    ValueErrors."""
    root, files, gmodel, refs = campaign
    jobs = [("PSRA", files[:2], gmodel), ("PSRB", files[2:], gmodel)]
    out_s, out_r, out_j = (tmp_path / n for n in ("served", "routed", "jax"))
    h0, h1 = hosts["torch"]
    r_s = TI.stream_ipta_campaign(jobs, outdir=str(out_s), quiet=True,
                                  server=h0, device="cpu")
    router = TSV.ToaRouter([TSV.InProcTransport(h0, label="i0"),
                            TSV.InProcTransport(h1, label="i1")])
    try:
        r_r = TI.stream_ipta_campaign(jobs, outdir=str(out_r), quiet=True,
                                      router=router, device="cpu")
        with pytest.raises(ValueError, match="not both"):
            TI.stream_ipta_campaign(jobs, quiet=True, server=h0,
                                    router=router, device="cpu")
        with pytest.raises(ValueError, match="resume"):
            TI.stream_ipta_campaign(jobs, outdir=str(out_r), resume=True,
                                    quiet=True, router=router, device="cpu")
        with pytest.raises(ValueError, match="max_inflight.*ToaRouter"):
            TI.stream_ipta_campaign(jobs, quiet=True, router=router,
                                    max_inflight=8, device="cpu")
        stats = router.stats()
    finally:
        router.close()
    assert sorted(st["n_requests"] for st in stats.values()) == [1, 1]
    assert _read(out_r / "PSRA.tim") == refs["01"]
    assert _read(out_r / "PSRB.tim") == refs["23"]
    jr = JSV.ToaRouter([JSV.InProcTransport(h, label=f"i{i}")
                        for i, h in enumerate(hosts["jax"])])
    try:
        r_j = JI.stream_ipta_campaign(jobs, outdir=str(out_j), quiet=True,
                                      router=jr)
    finally:
        jr.close()
    for psr in ("PSRA", "PSRB"):
        assert _read(out_s / f"{psr}.tim") == _read(out_r / f"{psr}.tim")
        ms, es = r_s.DeltaDM_summary[psr]
        mr, er = r_r.DeltaDM_summary[psr]
        assert np.array_equal(ms, mr) and np.array_equal(es, er)
        mj, ej = r_j.DeltaDM_summary[psr]
        assert np.all(np.abs(mr - mj) <= 0.1 * ej)
        np.testing.assert_allclose(er, ej, rtol=1e-3)
        _parity(tmp_path, out_j / f"{psr}.tim", out_r / f"{psr}.tim", psr)
    assert len(r_r.TOA_list) == len(r_j.TOA_list) == 8


# ---------------------------------------------------------------------------
# 14. the CLIs
# ---------------------------------------------------------------------------

def _write_requests(path, reqs):
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return str(path)


def test_pproute_cli(campaign, hosts, tmp_path):
    """Case 14a: pproute -r over two in-process port listeners: every .tim
    byte-identical to its one-shot, both hosts placed, exit 0; a failing
    request exits 1, as the JAX pproute does over the JAX hosts."""
    from pulseportraiture_tpu.cli.pproute import main as jmain
    from pulseportraiture_tpu_torch.cli.pproute import main as tmain

    root, files, gmodel, refs = campaign
    good = [{"name": "R0", "datafiles": files[:2], "modelfile": gmodel},
            {"name": "R1", "datafiles": files[2:], "modelfile": gmodel}]
    req = _write_requests(tmp_path / "requests.jsonl", good)
    bad = _write_requests(tmp_path / "bad.jsonl", good + [
        {"name": "R2", "datafiles": files[:1], "modelfile": gmodel,
         "options": {"no_such_option": 1}}])
    trace = str(tmp_path / "pproute.jsonl")
    rcs = {}
    for tag, main in (("torch", tmain), ("jax", jmain)):
        mod = TSV if tag == "torch" else JSV
        with mod.TransportServer(hosts[tag][0], port=0) as l0, \
                mod.TransportServer(hosts[tag][1], port=0) as l1:
            fleet = f"127.0.0.1:{l0.port},127.0.0.1:{l1.port}"
            extra = ["--telemetry", trace] if tag == "torch" else []
            rcs[tag] = [main(["-r", r, "-O", str(tmp_path / f"{tag}{i}"),
                              "-H", fleet, "--quiet"]
                             + (extra if i == 0 else []))
                        for i, r in enumerate((req, bad))]
            ports = {f"127.0.0.1:{l0.port}", f"127.0.0.1:{l1.port}"}
            if tag == "torch":
                subs = [e for e in _events(trace)
                        if e["type"] == "route_submit"]
                assert {e["host"] for e in subs} == ports
    assert rcs["torch"] == rcs["jax"] == [0, 1]
    for i, name in enumerate(("01", "23")):
        assert _read(tmp_path / "torch0" / f"R{i}.tim") == refs[name]
        _parity(tmp_path, tmp_path / "jax0" / f"R{i}.tim",
                tmp_path / "torch0" / f"R{i}.tim", f"cli{i}")


def test_pproute_monitor_answers_metrics(campaign, serve_config, tmp_path,
                                         capsys):
    """Case 14b: pproute --monitor 0 prints its endpoint, whose 'metrics'
    op answers the fleet-shaped reply while the batch routes."""
    from pulseportraiture_tpu_torch.cli.pproute import main as tmain

    root, files, gmodel, refs = campaign
    # a deadline that holds the lone partial bucket long enough to ask
    srv = TSV.ToaServer(nsub_batch=NB, max_wait_ms=3000,
                        device="cpu").start()
    req = _write_requests(tmp_path / "r.jsonl", [
        {"name": "M", "datafiles": files[:1], "modelfile": gmodel}])
    got = {}
    try:
        with TSV.TransportServer(srv, port=0) as lis:
            th = threading.Thread(target=lambda: got.setdefault(
                "rc", tmain(["-r", req, "-O", str(tmp_path / "o"), "-H",
                             f"127.0.0.1:{lis.port}", "--monitor", "0",
                             "--quiet"])))
            th.start()
            deadline = time.monotonic() + 60
            label = None
            text = ""
            while label is None and time.monotonic() < deadline:
                text += capsys.readouterr().out
                for ln in text.splitlines():
                    if ln.startswith("pproute: monitor endpoint on "):
                        label = ln.split()[4]
                time.sleep(0.02)
            assert label is not None, text
            mon = TSV.SocketTransport(label)
            reply = mon.metrics()
            mon.close()
            th.join(120)
    finally:
        srv.stop()
    assert got["rc"] == 0
    assert set(reply) == {"metrics_enabled", "hosts", "fleet", "router"}
    assert reply["fleet"]["n_hosts"] == 1
    assert _read(tmp_path / "o" / "M.tim") == refs["0"]


def test_cli_validation_matches_jax(tmp_path, monkeypatch):
    """Case 14c: pproute's and ppserve's fleet-mode refusals carry the
    JAX CLIs' messages (before any network); pproute --tune-db applies a
    stored DB of its --device's fingerprint before it reaches the fleet,
    and refuses a DB the JAX package wrote with a warning."""
    from pulseportraiture_tpu.cli import ppserve as jserve
    from pulseportraiture_tpu.cli import pproute as jroute
    from pulseportraiture_tpu_torch.cli import ppserve as tserve
    from pulseportraiture_tpu_torch.cli import pproute as troute

    good = _write_requests(tmp_path / "ok.jsonl", [
        {"name": "A", "datafiles": ["a.fits"], "modelfile": "m.gmodel"}])
    bad_tenant = _write_requests(tmp_path / "tenant.jsonl", [
        {"name": "A", "datafiles": ["a.fits"], "modelfile": "m.gmodel",
         "tenant": 7}])
    cases = [
        (jserve, tserve, ["-r", good, "--listen", "127.0.0.1:0"]),
        (jserve, tserve, []),
        (jserve, tserve, ["--listen", "nowhere"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--retry-max", "0"]),
        (jroute, troute, ["-r", good]),
        (jroute, troute, ["-r", good, "-H", "nodeA"]),
        (jroute, troute, ["-r", str(tmp_path / "missing.jsonl"), "-H",
                          "nodeA:1"]),
        (jroute, troute, ["-r", good, "-H", "127.0.0.1:9", "--quiet"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--probe-ms", "0"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--hedge-ms", "-5"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--fleet-file", "f"]),
        (jroute, troute, ["-r", good, "--fleet-file",
                          str(tmp_path / "no.txt")]),
        (jroute, troute, ["-r", bad_tenant, "-H", "h:1"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--transport-compress",
                          "maybe"]),
        (jroute, troute, ["-r", good, "-H", "h:1", "--monitor", "70000"]),
    ]
    saved = jcfg.serve_listen, tcfg.serve_listen
    try:
        for jmod, tmod, argv in cases:
            with pytest.raises(SystemExit) as ej:
                jmod.main(list(argv))
            with pytest.raises(SystemExit) as et:
                tmod.main(list(argv))
            assert str(et.value) == str(ej.value), argv
        # PPT_SERVE_LISTEN is the listen mode's default only: an explicit
        # -r still runs the batch mode
        jcfg.serve_listen = tcfg.serve_listen = "0.0.0.0:9090"
        with pytest.raises(SystemExit, match="not found"):
            tserve.main(["-r", str(tmp_path / "missing.jsonl")])
    finally:
        jcfg.serve_listen, tcfg.serve_listen = saved
    from pulseportraiture_tpu.tune import TuningStore as JStore
    from pulseportraiture_tpu_torch.tune import TuningStore

    monkeypatch.setattr(tcfg, "tune_db", tcfg.tune_db)
    monkeypatch.setattr(tcfg, "stream_pipeline_depth",
                        tcfg.stream_pipeline_depth)
    db, jdb = str(tmp_path / "tune.json"), str(tmp_path / "jax.json")
    TuningStore(db, device="cpu").put("16x128", {"stream_pipeline_depth": 1})
    JStore(jdb).put("16x128", {"stream_pipeline_depth": 4})
    argv = ["-r", good, "-H", "127.0.0.1:9", "--quiet", "--device", "cpu"]
    with pytest.raises(SystemExit, match="pproute"):   # no host answers
        troute.main(argv + ["--tune-db", db])
    assert tcfg.stream_pipeline_depth == 1
    with pytest.warns(UserWarning, match="jax-"):
        with pytest.raises(SystemExit, match="pproute"):
            troute.main(argv + ["--tune-db", jdb])
    assert tcfg.stream_pipeline_depth == 1 and tcfg.tune_db == jdb


# ---------------------------------------------------------------------------
# 15. ppserve --listen in a process of its own
# ---------------------------------------------------------------------------

def test_ppserve_listen_process(campaign, tmp_path):
    """Case 15: ``python -m ...cli.ppserve --listen 127.0.0.1:0 --device
    cpu`` prints its bound address on a line of its own, serves a routed
    request byte-identical to the one-shot, and drains and exits 0 on
    SIGTERM."""
    root, files, gmodel, refs = campaign
    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-c",
         "import test_torch_helpers, runpy, sys; "
         "from pulseportraiture_tpu_torch import config as c; "
         "c.use_fast_fit = c.fit_fused = True; "
         "c.fit_harmonic_window = 64; sys.argv = sys.argv[1:]; "
         "runpy.run_module('pulseportraiture_tpu_torch.cli.ppserve', "
         "run_name='__main__')",
         "ppserve", "--listen", "127.0.0.1:0", "--device", "cpu",
         "--nsub-batch", str(NB), "--max-wait-ms", "30", "--quiet"],
        cwd=os.path.join(ROOT, "tests"), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ppserve: listening on 127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        address = line.split()[3]
        router = TSV.ToaRouter([address])
        tim = str(tmp_path / "proc.tim")
        router.get_TOAs(files[2:], gmodel, timeout=300, tim_out=tim,
                        name="P")
        assert router.stats()[address]["state"] == TSV.HEALTHY
        router.close()
        assert _read(tim) == refs["23"]
        proc.terminate()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
