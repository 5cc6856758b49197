"""The port's continuous-batching TOA server (serve/, obs/, the
executor's service mode, utils/device.warmup_from_manifest, ppserve -r,
stream_ipta_campaign(server=)) on the CPU, against the JAX package's.

Corpus: the JAX serve tests' fixture size, 4 int16 archives of 2 subints
x 16 channels x 128 bins (default_test_model, make_fake_pulsar(rng=100+i))
plus two dithered 2-bit archives of the same layout (the decode-fused
B2 bucket), noise 0.2 (S/N ~150: at S/N ~1000+ the float32 chi^2 of
either framework moves the printed -gof by units of its last digit).
Both packages run the fast fit with the fused stage and a 64-harmonic
window (the JAX Pallas kernels off: their .tim equals the plain path's,
test_pallas_interpret.py), the JAX package on ONE device.  The port runs
with device='cpu', so its kernels run their plain versions.

Tolerances:
- within the port, a served request's .tim is BYTE-identical to the
  one-shot stream_wideband_TOAs on the same archives (no row's fit
  depends on its bucket-mates);
- against the JAX package, .tim files field by field (_assert_tim_parity
  of test_torch_toas: TOAs and DMs within 0.05 sigma, fit-derived flags
  to the last printed digit);
- DeltaDM_summary means within 0.1 x their errors, errors within 1e-3
  relative (float32 fits of two frameworks);
- exact: content keys, queue admission orders, metrics exports, SLO
  burn rates, trace event counts, shape keys, exit codes.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_helpers import PAR, trace_events
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu import serve as JSV
from pulseportraiture_tpu.obs import metrics as JOM
from pulseportraiture_tpu.obs import slo as JOS
from pulseportraiture_tpu.pipeline import ipta as JI
from pulseportraiture_tpu.pipeline import stream as JS
from pulseportraiture_tpu.serve import cache as JC
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import serve as TSV
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.obs import metrics as TOM
from pulseportraiture_tpu_torch.obs import slo as TOS
from pulseportraiture_tpu_torch.pipeline import ipta as TI
from pulseportraiture_tpu_torch.pipeline import stream as TS
from pulseportraiture_tpu_torch.serve import cache as TC

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
def corpus(tmp_path_factory):
    """(root, int16 archives, 2-bit archives, gmodel)."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_serve")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files, bits = [], []
    for i in range(6):
        path = str(root / (f"ep{i}.fits" if i < 4 else f"bit{i - 4}.fits"))
        make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=16,
                         nbin=128, nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.01 * i, dDM=1e-4,
                         start_MJD=MJD(55100 + i, 0.1), noise_stds=0.2,
                         dedispersed=False, quiet=True, rng=100 + i,
                         nbit=16 if i < 4 else 2, dither=i >= 4,
                         device="cpu")
        (files if i < 4 else bits).append(path)
    return root, files, bits, gmodel


def _concurrent(server, client_cls, jobs, gmodel):
    """Submit every (tag, files, tim) job from its own thread at once;
    {tag: result}."""
    client = client_cls(server)
    out = {}

    def go(tag, fs, tim):
        out[tag] = client.get_TOAs(fs, gmodel, timeout=300, tim_out=tim,
                                   name=tag)

    threads = [threading.Thread(target=go, args=j) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def served(corpus, serve_config, tmp_path_factory):
    """Two concurrent clients (A: ep0-1, B: ep2-3) on the port's server
    and on the JAX server, traced, plus the port's one-shot runs."""
    root, files, bits, gmodel = corpus
    out = tmp_path_factory.mktemp("served")
    jobs = {"A": files[:2], "B": files[2:]}
    one = {tag: TS.stream_wideband_TOAs(
        fs, gmodel, nsub_batch=NB, tim_out=str(out / f"{tag}_one.tim"),
        quiet=True, device="cpu") for tag, fs in jobs.items()}
    res = {}
    for tag, mod, kw in (("torch", TSV, {"device": "cpu"}),
                         ("jax", JSV, {"stream_devices": 1})):
        trace = str(out / f"{tag}.jsonl")
        # a deadline far longer than admission, even on a loaded host:
        # the shared bucket spans both requests (each alone holds 4
        # subints of the 8-row bucket, and the full bucket launches at
        # once)
        srv = mod.ToaServer(nsub_batch=NB, max_wait_ms=10000,
                            telemetry=trace, **kw).start()
        try:
            got = _concurrent(srv, mod.ToaClient, [
                (t, fs, str(out / f"{t}_{tag}.tim"))
                for t, fs in jobs.items()], gmodel)
            metrics, stats = srv.metrics(), srv.stats()
        finally:
            srv.stop()
        res[tag] = dict(results=got, trace=trace, metrics=metrics,
                        stats=stats)
    return out, one, res


def test_concurrent_clients(served):
    """Case 1: each served .tim equals the port's one-shot .tim byte for
    byte and the JAX server's field by field; one bucket mixed both
    requests; the report's serve keys are present."""
    out, one, res = served
    for tag in ("A", "B"):
        tim_one = out / f"{tag}_one.tim"
        assert (out / f"{tag}_torch.tim").read_bytes() == \
            tim_one.read_bytes()
        served_t = res["torch"]["results"][tag]
        assert served_t.order == one[tag].order
        assert served_t.DeltaDM_means == one[tag].DeltaDM_means
        for ta, tb in zip(one[tag].TOA_list, served_t.TOA_list):
            assert (ta.MJD.day, ta.MJD.frac) == (tb.MJD.day, tb.MJD.frac)
            assert ta.DM == tb.DM and ta.flags == tb.flags
        _assert_tim_parity(
            _tim_lines(out / f"{tag}_jax.tim", out / f"{tag}_jl.tim"),
            _tim_lines(out / f"{tag}_torch.tim", out / f"{tag}_tl.tim"))
    _, events = TT.validate_trace(res["torch"]["trace"])
    co = [e for e in events if e["type"] == "batch_coalesce"]
    assert max(e["n_requests"] for e in co) >= 2
    done = [e for e in events if e["type"] == "request_done"]
    assert {e["req"] for e in done} == {"A", "B"}
    assert all(e["wall_s"] >= e["queue_s"] >= 0 for e in done)
    summary = TT.report(res["torch"]["trace"], file=io.StringIO())
    assert summary["n_requests"] == 2
    assert summary["req_p50_s"] is not None
    assert summary["batch_occupancy"] is not None
    # the same serve events, and coalesced dispatches, as the JAX server
    ej = JT.load_trace(res["jax"]["trace"])[1]
    types = ("serve_start", "serve_stop", "request_submit", "request_done",
             "batch_coalesce", "dispatch", "archive_done")
    for typ in types:
        assert sum(e["type"] == typ for e in events) == \
            sum(e["type"] == typ for e in ej), typ
    jco = [e for e in ej if e["type"] == "batch_coalesce"]
    assert [(e["rows"], e["pad"], e["n_requests"]) for e in co] == \
        [(e["rows"], e["pad"], e["n_requests"]) for e in jco]


def test_metrics_and_stats_replies(served):
    """Case 11 (server half): ToaServer.metrics() has the JAX reply's
    keys and counters; stats() the load keys plus the port's capability
    record."""
    _, _, res = served
    mt, mj = res["torch"]["metrics"], res["jax"]["metrics"]
    assert set(mt) == set(mj)
    ct, cj = mt["metrics"]["counters"], mj["metrics"]["counters"]
    for k in ("requests_total", "toas_total", "dispatches",
              "rows_dispatched"):
        assert ct[k] == cj[k], k
    # the copy counters are process-global (every stream run adds)
    assert ct["h2d_copies"] >= 1 and ct["h2d_bytes"] > 0
    assert set(mt["metrics"]["histograms"]) == \
        set(mj["metrics"]["histograms"])
    assert 0.0 <= mt["link_stall_frac"] <= 1.0
    st = res["torch"]["stats"]
    assert set(st) == set(res["jax"]["stats"])
    cap = st["capability"]
    assert cap["platform"] == "cpu" and cap["n_devices"] == 1
    assert {"device_kind", "sm", "torch", "cuda", "fingerprint"} <= set(cap)
    assert st["toas_per_s"] > 0 and st["n_live"] == 0


def test_deadline_and_trickle(corpus, serve_config, tmp_path):
    """Case 2: a bucket that cannot fill launches at the deadline padded
    to nsub_batch; archives trickled in one at a time are served as
    solo partial buckets whose concatenated .tim equals the one-shot
    batched run's byte for byte."""
    root, files, bits, gmodel = corpus
    ref = tmp_path / "batched.tim"
    TS.stream_wideband_TOAs(files, gmodel, nsub_batch=NB, quiet=True,
                            tim_out=str(ref), device="cpu")
    trace = str(tmp_path / "trickle.jsonl")
    tims = [tmp_path / f"t{i}.tim" for i in range(len(files))]
    with TSV.ToaServer(nsub_batch=64, max_wait_ms=30, telemetry=trace,
                       device="cpu") as srv:
        client = TSV.ToaClient(srv)
        for i, (f, tim) in enumerate(zip(files, tims)):
            res = client.get_TOAs([f], gmodel, timeout=300,
                                  tim_out=str(tim), name=f"t{i}")
            assert len(res.TOA_list) == 2
    assert b"".join(t.read_bytes() for t in tims) == ref.read_bytes()
    _, events = TT.validate_trace(trace)
    co = [e for e in events if e["type"] == "batch_coalesce"]
    assert len(co) == len(files)
    assert all(e["n_requests"] == 1 and e["rows"] == 2 and e["pad"] == 62
               for e in co)


def test_many_clients_stress(corpus, serve_config, tmp_path):
    """16 client threads (more than the cores) submit at once with a
    short interpreter switch interval: every request resolves with its
    one-shot .tim bytes, and the queue's archive credit returns to 0 (a
    lost update in the shared accounting would leave it off)."""
    import sys

    root, files, bits, gmodel = corpus
    arch = files + bits
    ref = {}
    for i, f in enumerate(arch):
        ref[f] = tmp_path / f"one{i}.tim"
        TS.stream_wideband_TOAs([f], gmodel, nsub_batch=NB, quiet=True,
                                tim_out=str(ref[f]), device="cpu")
    jobs = [(f"s{k}", [arch[k % len(arch)]], str(tmp_path / f"s{k}.tim"))
            for k in range(16)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with TSV.ToaServer(nsub_batch=NB, max_wait_ms=20,
                           device="cpu") as srv:
            got = _concurrent(srv, TSV.ToaClient, jobs, gmodel)
            assert srv.queue.load_snapshot() == (0, 0)
    finally:
        sys.setswitchinterval(old)
    for tag, fs, tim in jobs:
        assert len(got[tag].TOA_list) == 2
        with open(tim, "rb") as a:
            assert a.read() == ref[fs[0]].read_bytes(), tag


def test_backpressure_and_closed_rejection(corpus, serve_config):
    """Case 3: a request larger than the queue is a terminal rejection;
    a full queue a retryable one; a stopped server a terminal one."""
    root, files, bits, gmodel = corpus
    srv = TSV.ToaServer(nsub_batch=NB, max_wait_ms=20, queue_depth=2,
                        device="cpu")
    with pytest.raises(TSV.ServeRejected, match="split it") as ei:
        srv.submit(files[:3], gmodel, name="huge")
    assert not ei.value.retryable
    first = srv.submit(files[:2], gmodel, name="ok")
    with pytest.raises(TSV.ServeRejected, match="queue full") as ei:
        srv.submit(files[2:], gmodel, name="shed")
    assert ei.value.retryable
    srv.start()
    assert len(first.result(300).TOA_list) == 4
    srv.stop()
    with pytest.raises(TSV.ServeRejected, match="stopping") as ei:
        srv.submit(files[:1], gmodel)
    assert not ei.value.retryable


def test_graceful_drain(corpus, serve_config):
    """Case 4: stop(drain=True) right after submit resolves every
    outstanding request (a long deadline: only the drain flushes) and
    shuts the executor's workers down."""
    root, files, bits, gmodel = corpus
    srv = TSV.ToaServer(nsub_batch=64, max_wait_ms=10000,
                        device="cpu").start()
    handles = [srv.submit(files[:2], gmodel, name="G1"),
               srv.submit(bits, gmodel, name="G2")]
    srv.stop(drain=True)
    assert all(h.done() for h in handles)
    assert [len(h.result(0).TOA_list) for h in handles] == [4, 4]
    assert not srv._thread.is_alive()
    assert all(pl.copy_ex._shutdown and pl.fit_ex._shutdown
               for pl in srv._ex.pipelines)


def test_request_error_isolated(corpus, serve_config):
    """Case 5: a request with a broken option set fails its own result,
    in submit and in ToaClient.map(return_errors=True); the server keeps
    serving."""
    root, files, bits, gmodel = corpus
    with TSV.ToaServer(nsub_batch=NB, max_wait_ms=20, device="cpu") as srv:
        bad = srv.submit(files[:1], gmodel, name="bad",
                         no_such_option=True)
        good = srv.submit(files[:1], gmodel, name="good")
        with pytest.raises(TypeError, match="no_such_option"):
            bad.result(300)
        assert len(good.result(300).TOA_list) == 2
        client = TSV.ToaClient(srv)
        specs = [([files[0]], gmodel, {"name": "ok0"}),
                 ([files[1]], gmodel, {"name": "boom",
                                       "no_such_option": True}),
                 ([files[2]], gmodel, {"name": "ok1"})]
        with pytest.raises(TypeError, match="no_such_option"):
            client.map(specs, timeout=300)
        out = client.map(specs, timeout=300, return_errors=True)
        assert len(out[0].TOA_list) == 2 and len(out[2].TOA_list) == 2
        assert isinstance(out[1], TypeError)
        assert len(client.get_TOAs([files[3]], gmodel,
                                   timeout=300).TOA_list) == 2


def test_admission_queue_matches_jax():
    """Case 6: the same submissions, tenants, quotas and weights give
    the same admission order, rejections and ledgers in both queues."""
    plan = [("a", 2), ("a", 1), ("b", 3), ("c", 1), ("a", 2), ("b", 1),
            ("c", 2), ("b", 2), ("a", 1), ("c", 1)]
    logs = []
    for mod in (TSV, JSV):
        q = mod.AdmissionQueue(12, tenant_quota={"*": 5, "c": 3},
                               tenant_weight={"a": 3.0, "b": 1.0})
        log = []
        for i, (tenant, n) in enumerate(plan):
            req = mod.ServeRequest([f"f{i}_{k}.fits" for k in range(n)],
                                   "m.gmodel", name=f"r{i}", tenant=tenant)
            try:
                q.submit(req)
                log.append(("ok", req.name))
            except mod.ServeRejected as e:
                log.append(("rej", req.name, str(e), e.retryable))
        q.record_hit("c", 2)
        log.append(q.load_snapshot())
        log.append(sorted(q.tenant_snapshot().items()))
        while True:
            r = q.get(0.0)
            if r is None:
                break
            log.append(("get", r.name))
            q.release(len(r.datafiles), tenant=r.tenant)
        q.close()
        with pytest.raises(mod.ServeRejected, match="closed"):
            q.submit(mod.ServeRequest(["x.fits"], "m.gmodel"))
        logs.append(log)
    assert logs[0] == logs[1]
    assert sum(e[0] == "rej" for e in logs[0]) >= 1


def test_parse_shape_key_roundtrip(corpus, serve_config, tmp_path):
    """Case 7: every dispatch shape the port's stream emits on int16,
    NBIT=1/2/4 and codec-packed int16 buckets parses back to the
    bucket it came from, as the JAX parse does; garbage raises."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)

    root, files, bits, gmodel = corpus
    model = default_test_model(1500.0)
    gm = str(tmp_path / "m.gmodel")
    write_gmodel(model, gm, quiet=True)
    arch = []
    for nbit in (1, 2, 4):
        p = str(tmp_path / f"n{nbit}.fits")
        make_fake_pulsar(model, PAR, outfile=p, nsub=2, nchan=16, nbin=128,
                         noise_stds=0.2, quiet=True, rng=7, nbit=nbit,
                         dither=True, device="cpu")
        arch.append(p)
    shapes = set()
    old = tcfg.transport_compress
    try:
        for compress in (False, True):
            tcfg.transport_compress = compress
            res = TS.stream_wideband_TOAs(files[:1] + arch, gmodel,
                                          nsub_batch=NB, quiet=True,
                                          device="cpu")
            shapes |= set(res.dispatch_shapes)
    finally:
        tcfg.transport_compress = old
    assert {s.split(":")[2] for s in shapes} == {"i16", "p1", "p2", "p4"}
    for shape in shapes:
        spec = TS.parse_shape_key(shape)
        assert spec == JS.parse_shape_key(shape)
        b = TS._Bucket(np.linspace(1.0, 2.0, spec["nchan"]), spec["nbin"],
                       None, spec["flags"], kind=spec["kind"],
                       raw_code=spec["raw_code"], pol_sum=spec["pol_sum"],
                       col_scaled=spec["col_scaled"])
        assert TS._bucket_shape(b) == shape
    for good in ("12x128:dec:10000", "12x128:raw:u8:sum2:tz:11000",
                 "4x64:raw:f32"):
        assert TS.parse_shape_key(good) == JS.parse_shape_key(good)
    for bad in ("x128:dec", "12x128:wat", "12x128:raw:zzz",
                "12x128:dec:12"):
        with pytest.raises(ValueError):
            TS.parse_shape_key(bad)


def test_warmup_kills_cold_dispatches(corpus, serve_config, tmp_path):
    """Case 8: warmup_from_manifest on a traced one-shot run's trace
    leaves 0 cold dispatches of those shapes in the next served run,
    whose .tim still equals the one-shot's; its warmup_compile events
    match the JAX function's in count and shapes."""
    from pulseportraiture_tpu.utils.device import \
        warmup_from_manifest as jwarm
    from pulseportraiture_tpu_torch.utils.device import \
        warmup_from_manifest as twarm

    root, files, bits, gmodel = corpus
    prior = str(tmp_path / "prior.jsonl")
    tim1 = tmp_path / "one.tim"
    TS.stream_wideband_TOAs(files[:2] + bits, gmodel, nsub_batch=NB,
                            tim_out=str(tim1), quiet=True, telemetry=prior,
                            device="cpu")
    shapes = {e["shape"] for e in TT.validate_trace(prior)[1]
              if e["type"] == "dispatch"}
    assert len(shapes) == 2
    trace = str(tmp_path / "warm.jsonl")
    tim2 = tmp_path / "served.tim"
    with TSV.ToaServer(nsub_batch=NB, max_wait_ms=20, telemetry=trace,
                       warmup_manifest=prior, warmup_model=gmodel,
                       device="cpu") as srv:
        srv.submit(files[:2] + bits, gmodel, name="W",
                   tim_out=str(tim2)).result(300)
    assert tim1.read_bytes() == tim2.read_bytes()
    _, events = TT.validate_trace(trace)
    warm = [e for e in events if e["type"] == "warmup_compile"]
    disp = [e for e in events if e["type"] == "dispatch"]
    assert {e["shape"] for e in warm} == shapes
    assert disp and not any(e["cold"] for e in disp)
    summary = TT.report(trace, file=io.StringIO())
    assert summary["n_cold"] == 0 and summary["n_warmup"] == len(warm)
    # the JAX function on the same manifest (one device), and the port's
    # through temporary pipelines: the same (shape, device) list
    jt, tt = str(tmp_path / "jw.jsonl"), str(tmp_path / "tw.jsonl")
    jtr, ttr = JT.Tracer(jt), TT.Tracer(tt)
    try:
        got_j = jwarm(prior, modelfile=gmodel, devices=1, nsub_batch=NB,
                      tracer=jtr)
        got_t = twarm(prior, modelfile=gmodel, devices=["cpu"],
                      nsub_batch=NB, tracer=ttr)
    finally:
        jtr.close()
        ttr.close()
    assert sorted(got_t) == sorted(got_j) == sorted((s, 0) for s in shapes)
    ej = [(e["shape"], e["device"]) for e in JT.load_trace(jt)[1]
          if e["type"] == "warmup_compile"]
    et = [(e["shape"], e["device"]) for e in TT.load_trace(tt)[1]
          if e["type"] == "warmup_compile"]
    assert sorted(et) == sorted(ej)


@pytest.fixture(scope="module")
def rfi_archive(tmp_path_factory):
    """One 2 x 32 x 128 archive with two strong tones and a burst (the
    JAX quality tests' recipe), written and contaminated by the port."""
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  inject_rfi,
                                                  make_fake_pulsar)

    root = tmp_path_factory.mktemp("torch_serve_rfi")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    path = str(root / "rfi.fits")
    make_fake_pulsar(model, PAR, outfile=path, nsub=2, nchan=32, nbin=128,
                     nu0=1500.0, bw=800.0, tsub=60.0, phase=0.0, dDM=-1e-4,
                     noise_stds=0.2, dedispersed=False, quiet=True, rng=300,
                     device="cpu")
    inject_rfi(path, rng=40, tone_channels=[3, 11], tone_white=8.0,
               tone_structured=60.0, bursts=[(1, [20, 21], 20.0)])
    return path, gmodel


def test_quality_refit(rfi_archive, serve_config, tmp_path):
    """Case 9: an archive that trips quality_max_gof is refitted exactly
    once (channels zapped, red-chi^2 improved), and the served .tim is in
    parity with the JAX server's under the same option."""
    path, gmodel = rfi_archive
    tims = {}
    for tag, mod, kw in (("torch", TSV, {"device": "cpu"}),
                         ("jax", JSV, {"stream_devices": 1})):
        trace = str(tmp_path / f"{tag}.jsonl")
        tims[tag] = str(tmp_path / f"{tag}.tim")
        with mod.ToaServer(nsub_batch=NB, max_wait_ms=20, telemetry=trace,
                           quality_refit=True, **kw) as srv:
            res = srv.submit([path], gmodel,
                             tim_out=tims[tag]).result(300)
        assert len(res.TOA_list) == 2
        refits = [e for e in (TT if mod is TSV else JT).load_trace(
            trace)[1] if e["type"] == "refit"]
        assert len(refits) == 1, tag
        assert refits[0]["n_channels"] > 0 and refits[0]["improved"]
        if mod is TSV:
            ref_t = refits[0]
        else:
            assert refits[0]["n_channels"] == ref_t["n_channels"]
    _assert_tim_parity(_tim_lines(tims["jax"], tmp_path / "jl.tim"),
                       _tim_lines(tims["torch"], tmp_path / "tl.tim"))


def test_result_cache(corpus, serve_config, tmp_path):
    """Case 10: a second identical request is a cache hit with the same
    .tim bytes; content_key equals the JAX package's bit for bit."""
    root, files, bits, gmodel = corpus
    cdir = str(tmp_path / "cache")
    trace = str(tmp_path / "cache.jsonl")
    t1, t2 = str(tmp_path / "r1.tim"), str(tmp_path / "r2.tim")
    with TSV.ToaServer(nsub_batch=NB, max_wait_ms=20, telemetry=trace,
                       result_cache=True, cache_dir=cdir,
                       device="cpu") as srv:
        srv.submit(files[:2], gmodel, tim_out=t1, name="c1").result(300)
        h = srv.submit(files[:2], gmodel, tim_out=t2, name="c2")
        assert h.done()  # resolved at submit, never queued
        res = h.result(0)
        assert srv.stats()["cache_hits"] == 1
    assert open(t1, "rb").read() == open(t2, "rb").read()
    assert res.recovered_from_tim and len(res.TOA_list) == 4
    counts = TT.load_trace(trace)[1]
    for typ, n in (("cache_miss", 1), ("cache_store", 1), ("cache_hit", 1)):
        assert sum(e["type"] == typ for e in counts) == n, typ
    # the key: the same files, options and knob values in both packages
    # (the JAX-only knobs at the JAX package's defaults)
    old = (jcfg.fit_pallas, jcfg.use_matmul_dft)
    jcfg.fit_pallas, jcfg.use_matmul_dft = "auto", "auto"
    try:
        for opts in ({}, {"fit_DM": False, "addtnl_toa_flags": {"pta":
                                                               "X"}}):
            kt = TC.content_key(files[:2] + [gmodel], opts)
            assert kt == JC.content_key(files[:2] + [gmodel], opts)
        assert TC.content_key(files[:2] + [gmodel], {}) != kt
    finally:
        jcfg.fit_pallas, jcfg.use_matmul_dft = old


def test_metrics_and_slo_match_jax():
    """Case 11: MetricsRegistry, the histograms, merge_exports,
    quantile_from_export and SloTracker's burn rates and breach edges
    agree with the JAX package's on the same event sequence."""
    rng = np.random.default_rng(11)
    lat = rng.lognormal(-1.0, 1.5, 200)
    exports = []
    for mod in (TOM, JOM):
        regs = [mod.MetricsRegistry(), mod.MetricsRegistry()]
        for i, v in enumerate(lat):
            r = regs[i % 2]
            r.inc("requests_total")
            r.inc("toas_total", i % 5)
            r.observe("request_latency_s", float(v))
            r.set_gauge("queue_len", i % 3)
        merged = mod.merge_exports([r.export() for r in regs])
        q = [mod.quantile_from_export(
            merged["histograms"]["request_latency_s"], p)
            for p in (0.5, 0.9, 0.99)]
        exports.append((merged, q, regs[0].export(),
                        mod.link_stall_frac({"counters": {
                            "h2d_us": 1000, "h2d_stall_us": 250}})))
    assert exports[0] == exports[1]
    assert TOM.HIST_BOUNDS == JOM.HIST_BOUNDS
    runs = []
    for mod in (TOS, JOS):
        clock = [1000.0]
        s = mod.SloTracker({"interactive": 0.5, "*": 5.0},
                           clock=lambda: clock[0])
        seq = []
        for i, v in enumerate(lat):
            clock[0] += 7.0
            tenant = ("interactive", "bulk", "other")[i % 3]
            seq.append(s.observe(tenant, float(v) * (4 if i > 120 else 1)))
        seq.append([s.burn_rate("interactive", w) for w in s.windows])
        seq.append(s.snapshot())
        runs.append(seq)
    assert runs[0] == runs[1]
    assert any(b is not None for b in runs[0][:-2])


def test_ipta_thin_client(corpus, serve_config, tmp_path):
    """Case 12: stream_ipta_campaign(server=srv) gives per-pulsar .tim and
    DeltaDM_summary equal to the executor-per-pulsar run, in parity with
    the JAX stream_ipta_campaign(server=), and the same ValueErrors."""
    root, files, bits, gmodel = corpus
    jobs = [("PSRA", files[:2], gmodel), ("PSRB", files[2:] + bits, gmodel)]
    solo, out_t, out_j = (tmp_path / d for d in ("solo", "torch", "jax"))
    r1 = TI.stream_ipta_campaign(jobs, outdir=str(solo), nsub_batch=NB,
                                 quiet=True, device="cpu")
    with TSV.ToaServer(nsub_batch=NB, max_wait_ms=50, device="cpu") as srv:
        r2 = TI.stream_ipta_campaign(jobs, outdir=str(out_t), nsub_batch=NB,
                                     quiet=True, server=srv)
        with pytest.raises(ValueError, match="resume"):
            TI.stream_ipta_campaign(jobs, outdir=str(out_t), resume=True,
                                    quiet=True, server=srv)
        with pytest.raises(ValueError, match="max_inflight"):
            TI.stream_ipta_campaign(jobs, outdir=str(out_t), quiet=True,
                                    server=srv, max_inflight=8)
    with JSV.ToaServer(nsub_batch=NB, max_wait_ms=50,
                       stream_devices=1) as jsrv:
        rj = JI.stream_ipta_campaign(jobs, outdir=str(out_j), nsub_batch=NB,
                                     quiet=True, server=jsrv)
    for psr in ("PSRA", "PSRB"):
        assert (solo / f"{psr}.tim").read_bytes() == \
            (out_t / f"{psr}.tim").read_bytes()
        m1, e1 = r1.DeltaDM_summary[psr]
        m2, e2 = r2.DeltaDM_summary[psr]
        assert np.array_equal(m1, m2) and np.array_equal(e1, e2)
        mj, ej = rj.DeltaDM_summary[psr]
        np.testing.assert_allclose(m2, mj, rtol=0, atol=0.1 * np.max(ej))
        np.testing.assert_allclose(e2, ej, rtol=1e-3)
        _assert_tim_parity(
            _tim_lines(out_j / f"{psr}.tim", tmp_path / f"{psr}_j.tim"),
            _tim_lines(out_t / f"{psr}.tim", tmp_path / f"{psr}_t.tim"))
    assert len(r1.TOA_list) == len(r2.TOA_list) == len(rj.TOA_list) == 12


def test_ppserve_cli(corpus, serve_config, tmp_path, monkeypatch):
    """Case 13: ppserve -r on a JSONL file against the JAX ppserve -r:
    .tim in parity, the same exit codes (0, then 1 with a failing
    request); --listen (in this process) and PPT_SERVE_LISTEN (in a
    process of its own, stopped by SIGTERM) bind and answer stat;
    --tune-db applies a stored DB before the server starts: the winner
    set on config, its tune_apply (db_hit true) in the server's trace,
    the .tim byte-identical to the untuned run's; --compile-cache DIR
    routes the kernels' build directory there (config and
    ops.fused.BUILD_DIR), the .tim byte-identical again."""
    from pulseportraiture_tpu.cli.ppserve import main as jmain
    from pulseportraiture_tpu_torch.cli.ppserve import main as tmain

    root, files, bits, gmodel = corpus
    reqs = [{"name": "R1", "datafiles": files[:2], "modelfile": gmodel},
            {"name": "R2", "datafiles": bits, "modelfile": gmodel,
             "tenant": "bulk"}]
    path = tmp_path / "requests.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    bad = tmp_path / "bad.jsonl"
    bad.write_text(path.read_text() + json.dumps(
        {"name": "R3", "datafiles": files[2:3], "modelfile": gmodel,
         "options": {"no_such_option": 1}}) + "\n")
    common = ["--nsub-batch", str(NB), "--max-wait-ms", "200", "--quiet"]
    for req, rc in ((path, 0), (bad, 1)):
        assert tmain(["-r", str(req), "-O", str(tmp_path / "t"),
                      "--device", "cpu"] + common) == rc
        assert jmain(["-r", str(req), "-O", str(tmp_path / "j"),
                      "--stream-devices", "1"] + common) == rc
    for name in ("R1", "R2"):
        _assert_tim_parity(
            _tim_lines(tmp_path / "j" / f"{name}.tim",
                       tmp_path / f"{name}_j.tim"),
            _tim_lines(tmp_path / "t" / f"{name}.tim",
                       tmp_path / f"{name}_t.tim"))
    from pulseportraiture_tpu_torch.cli import ppserve as tppserve

    # --listen: main() in a thread, stopped through serve_listen's event
    stop = threading.Event()
    orig = tppserve.serve_listen
    monkeypatch.setattr(tppserve, "serve_listen",
                        lambda srv, listen, quiet: orig(srv, listen, quiet,
                                                        stop=stop))
    got = {}
    lines = io.StringIO()
    monkeypatch.setattr("sys.stdout", lines)
    th = threading.Thread(target=lambda: got.setdefault("rc", tmain(
        ["--listen", "127.0.0.1:0", "--device", "cpu", "--quiet"])))
    th.start()
    try:
        for _ in range(600):
            if "listening on" in lines.getvalue():
                break
            time.sleep(0.05)
        address = lines.getvalue().split()[3]
        t = TSV.SocketTransport(address)
        st = t.stat()
        t.close()
    finally:
        stop.set()
        th.join(60)
    assert got["rc"] == 0
    assert (st["pending_archives"], st["queue_len"], st["n_live"]) == \
        (0, 0, 0)
    # PPT_SERVE_LISTEN: the listen mode's default, in a fresh process
    env = {k: v for k, v in os.environ.items() if not k.startswith("PPT_")}
    env.update(PPT_SERVE_LISTEN="127.0.0.1:0", PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.ppserve",
         "--device", "cpu", "--quiet"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("ppserve: listening on 127.0.0.1:"), line
        t = TSV.SocketTransport(line.split()[3])
        assert t.stat()["n_live"] == 0
        t.close()
        proc.terminate()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    from pulseportraiture_tpu_torch.tune import TuningStore

    db, trace = str(tmp_path / "tune.json"), str(tmp_path / "tuned.jsonl")
    TuningStore(db, device="cpu").put("16x128", {"stream_pipeline_depth": 1},
                                      default_s=1.0, tuned_s=0.5)
    monkeypatch.setattr(tcfg, "tune_db", tcfg.tune_db)
    monkeypatch.setattr(tcfg, "stream_pipeline_depth",
                        tcfg.stream_pipeline_depth)
    assert tmain(["-r", str(path), "-O", str(tmp_path / "tuned"),
                  "--device", "cpu", "--tune-db", db, "--telemetry", trace]
                 + common) == 0
    assert tcfg.stream_pipeline_depth == 1 and tcfg.tune_db == db
    applied = [e for e in trace_events(trace) if e["type"] == "tune_apply"]
    assert len(applied) == 1 and applied[0]["db_hit"] is True
    assert applied[0]["knobs"] == {"stream_pipeline_depth": "1"}
    assert any(e["type"] == "request_done" for e in trace_events(trace))
    for name in ("R1", "R2"):
        assert (tmp_path / "tuned" / f"{name}.tim").read_bytes() == \
            (tmp_path / "t" / f"{name}.tim").read_bytes()
    from pulseportraiture_tpu_torch.ops import fused as F
    from pulseportraiture_tpu_torch.utils import device as UD

    monkeypatch.setattr(tcfg, "compile_cache_dir", tcfg.compile_cache_dir)
    monkeypatch.setattr(F, "BUILD_DIR", F.BUILD_DIR)
    monkeypatch.setattr(UD, "_compile_cache_dir", UD._compile_cache_dir)
    kdir = str(tmp_path / "kcache")
    assert tmain(["-r", str(path), "-O", str(tmp_path / "cc"), "--device",
                  "cpu", "--compile-cache", kdir] + common) == 0
    assert tcfg.compile_cache_dir == kdir and F.BUILD_DIR == kdir
    assert os.path.isdir(kdir)
    for name in ("R1", "R2"):
        assert (tmp_path / "cc" / f"{name}.tim").read_bytes() == \
            (tmp_path / "t" / f"{name}.tim").read_bytes()


def test_server_without_card_raises(monkeypatch):
    """With no card, a server given no device raises instead of serving
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TSV.ToaServer()
