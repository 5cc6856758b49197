"""The port's multi-pulsar campaign driver (pipeline/ipta.py) and its
world-size-1 process helpers (parallel/multihost.py) against the JAX
package's.

Corpus: two spin-coherent pulsars (make_fake_pulsar(spin_coherent=True),
written by the port), 3 epochs x 2 subints x 16 channels x 256 bins each,
noise 0.5 (S/N ~200: at S/N ~2000 the float32 chi^2 of either framework
moves the printed -gof by a few units of its last digit), with per-epoch
DM offsets.  Both packages run the fast fit
with the fused stage and an explicit 128-harmonic window (the stream
tests' configuration; the JAX Pallas kernels off), JAX on one device.

Tolerances:
- per-pulsar .tim files field by field (_assert_tim_parity of
  test_torch_toas: TOAs and DMs within 0.05 sigma, fit-derived flags to
  the last printed digit, -snr within 1e-4 relative: a float32 S/N
  summed over 16 x 256 samples in two frameworks' orders, measured
  3.7e-5 apart at S/N 216);
- DeltaDM_summary means within 0.1 x their errors, errors within 1e-3
  relative (float32 fits of two frameworks);
- timing solutions (timing_pars=): every parameter and DMX within 0.1 x
  its error of the JAX campaign's (the TOAs agree to 0.05 sigma), the
  errors within 1e-3 relative, the same dof.
"""

import os
import shutil

import numpy as np
import pytest

import test_torch_helpers  # noqa: F401  (one torch thread per worker)
from test_torch_stream import _tim_lines
from test_torch_toas import _assert_tim_parity

from pulseportraiture_tpu import config as jcfg
from pulseportraiture_tpu import telemetry as JT
from pulseportraiture_tpu.parallel import multihost as JM
from pulseportraiture_tpu.pipeline import ipta as JI
from pulseportraiture_tpu_torch import config as tcfg
from pulseportraiture_tpu_torch import telemetry as TT
from pulseportraiture_tpu_torch.parallel import multihost as TM
from pulseportraiture_tpu_torch.pipeline import ipta as TI

PARS = {
    "J1744-1134": {"PSR": "J1744-1134", "RAJ": "17:44:29.4",
                   "DECJ": "-11:34:54.6", "P0": 0.004074,
                   "PEPOCH": 55150.0, "DM": 3.139},
    "J1012+5307": {"PSR": "J1012+5307", "RAJ": "10:12:33.4",
                   "DECJ": "53:07:02.5", "P0": 0.0052557,
                   "PEPOCH": 55150.0, "DM": 9.023},
}
DDMS = [3e-4, -2e-4, 5e-4]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    from pulseportraiture_tpu_torch.io.gmodel import write_gmodel
    from pulseportraiture_tpu_torch.synth import (default_test_model,
                                                  make_fake_pulsar)
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    root = tmp_path_factory.mktemp("torch_ipta")
    model = default_test_model(1500.0)
    gmodel = str(root / "model.gmodel")
    write_gmodel(model, gmodel, quiet=True)
    files = {}
    for k, (name, par) in enumerate(PARS.items()):
        files[name] = []
        for i, dDM in enumerate(DDMS):
            path = str(root / f"{name}-ep{i}.fits")
            make_fake_pulsar(model, par, outfile=path, nsub=2, nchan=16,
                             nbin=256, nu0=1500.0, bw=800.0, tsub=120.0,
                             phase=0.02 * (k + 1), dDM=dDM,
                             start_MJD=MJD(55100 + 30 * i, 0.2 + 0.1 * k),
                             noise_stds=0.5, dedispersed=False, quiet=True,
                             rng=700 + 10 * k + i, spin_coherent=True,
                             device="cpu")
            files[name].append(path)
    return root, files, gmodel


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


def _jobs(files, gmodel, mod):
    return [mod.IPTAJob(name, files[name], gmodel) for name in PARS]


def _pair(fleet, tmp_path, **kw):
    root, files, gmodel = fleet
    rj = JI.stream_ipta_campaign(
        _jobs(files, gmodel, JI), outdir=str(tmp_path / "jax"), quiet=True,
        nsub_batch=2, stream_devices=1, **kw)
    rt = TI.stream_ipta_campaign(
        _jobs(files, gmodel, TI), outdir=str(tmp_path / "torch"),
        quiet=True, nsub_batch=2, device="cpu", **kw)
    return rj, rt


def test_campaign_parity(fleet, stream_config, tmp_path):
    rj, rt = _pair(fleet, tmp_path)
    assert rt.pulsars == rj.pulsars == list(PARS)
    assert rt.nfit == rj.nfit == 6
    assert len(rt.TOA_list) == len(rj.TOA_list) == 12
    assert rt.timing is None and rj.timing is None
    for name in PARS:
        _assert_tim_parity(
            _tim_lines(tmp_path / "jax" / f"{name}.tim",
                       tmp_path / f"jax-{name}.lines"),
            _tim_lines(tmp_path / "torch" / f"{name}.tim",
                       tmp_path / f"torch-{name}.lines"),
            rel_tol={"snr": 1e-4})
        mj, ej = rj.DeltaDM_summary[name]
        mt, et = rt.DeltaDM_summary[name]
        assert mt.shape == mj.shape == (3,)
        assert np.all(np.abs(mt - mj) <= 0.1 * ej)
        np.testing.assert_allclose(et, ej, rtol=1e-3)
        assert rt.per_pulsar[name].order == rj.per_pulsar[name].order


def test_single_trace(fleet, stream_config, tmp_path):
    """One tracer through every per-pulsar stream call: campaign and
    per-pulsar rollups and every dispatch in one valid trace, seqs
    unique across the executors and paired with their drains (the JAX
    package's test_ipta_campaign_single_trace), and the JAX package's
    event counts."""
    root, files, gmodel = fleet
    trace, jtrace = str(tmp_path / "ipta.jsonl"), str(tmp_path / "j.jsonl")
    out = TI.stream_ipta_campaign(
        _jobs(files, gmodel, TI), outdir=str(tmp_path / "tims"),
        quiet=True, nsub_batch=2, telemetry=trace, device="cpu")
    JI.stream_ipta_campaign(
        _jobs(files, gmodel, JI), outdir=str(tmp_path / "jtims"),
        quiet=True, nsub_batch=2, telemetry=jtrace, stream_devices=1)
    manifest, events = JT.validate_trace(trace)
    assert manifest["run"] == "stream_ipta_campaign"
    types = [e["type"] for e in events]
    assert types[0] == "campaign_start" and types[-1] == "counters"
    assert types.count("pulsar_done") == 2 and "campaign_end" in types
    pds = {e["pulsar"]: e for e in events if e["type"] == "pulsar_done"}
    assert set(pds) == set(PARS)
    assert sum(e["nfit"] for e in pds.values()) == out.nfit
    seqs = [e["seq"] for e in events if e["type"] == "dispatch"]
    assert len(seqs) == len(set(seqs)) == out.nfit > 1
    for typ in ("drain", "h2d_done", "dispatched"):
        assert sorted(e["seq"] for e in events if e["type"] == typ) == \
            sorted(seqs)
    end = [e for e in events if e["type"] == "campaign_end"][0]
    assert end["n_toas"] == len(out.TOA_list)
    jtypes = [e["type"] for e in JT.load_trace(jtrace)[1]]
    assert sorted(types) == sorted(jtypes)
    summary = TT.report(trace, file=open(os.devnull, "w"))
    assert summary["total_dispatches"] == summary["nfit"] == out.nfit


def test_timing_stage(fleet, stream_config, tmp_path):
    """timing_pars=: the port's fleet solutions against the JAX
    campaign's, on the campaign's own tracer."""
    pars = {name: dict(par) for name, par in PARS.items()}
    trace = str(tmp_path / "t.jsonl")
    rj, rt = _pair(fleet, tmp_path, timing_pars=pars,
                   timing_kwargs={"fit_f1": False})
    assert rt.timing is not None and rt.timing.pulsars == list(PARS)
    for name in PARS:
        ref, got = rj.timing.results[name], rt.timing.results[name]
        assert list(got.params) == list(ref.params)
        for k in ref.params:
            assert abs(got.params[k] - ref.params[k]) <= \
                0.1 * ref.param_errs[k], (name, k)
            assert got.param_errs[k] == pytest.approx(ref.param_errs[k],
                                                      rel=1e-3)
        assert np.all(np.abs(got.dmx - ref.dmx) <= 0.1 * ref.dmx_errs)
        assert got.dof == ref.dof
        assert 0.2 < got.red_chi2 < 5.0
    # on a shared trace: one timing_fit per solve, and the fleet rollup
    root, files, gmodel = fleet
    TI.stream_ipta_campaign(
        _jobs(files, gmodel, TI), outdir=str(tmp_path / "traced"),
        quiet=True, nsub_batch=2, device="cpu", telemetry=trace,
        timing_pars=pars)
    s = TT.report(trace, file=open(os.devnull, "w"))
    assert s["n_timing_pulsars"] == 2
    assert s["n_timing_fit"] == s["timing_dispatches"] >= 1


def test_resume(fleet, stream_config, tmp_path):
    """A resume from partial checkpoints (a torn tail on one pulsar, the
    other pulsar's file missing) gives the uninterrupted run's lines."""
    root, files, gmodel = fleet
    full = tmp_path / "full"
    TI.stream_ipta_campaign(_jobs(files, gmodel, TI), outdir=str(full),
                            quiet=True, nsub_batch=2, device="cpu")
    part = tmp_path / "part"
    shutil.copytree(full, part)
    a, b = list(PARS)
    lines = open(part / f"{a}.tim").readlines()
    first = next(i for i, ln in enumerate(lines) if ln.startswith("C "))
    with open(part / f"{a}.tim", "w") as f:
        f.writelines(lines[:first + 1] + [lines[first + 1][:20]])
    os.remove(part / f"{b}.tim")
    trace = str(tmp_path / "resume.jsonl")
    res = TI.stream_ipta_campaign(_jobs(files, gmodel, TI),
                                  outdir=str(part), quiet=True,
                                  nsub_batch=2, device="cpu", resume=True,
                                  telemetry=trace)
    for name in PARS:
        assert open(part / f"{name}.tim").read() == \
            open(full / f"{name}.tim").read()
    assert len(res.TOA_list) == 12 - 2
    skips = [e for e in JT.load_trace(trace)[1]
             if e["type"] == "resume_skip"]
    assert skips[0]["n_skipped"] == 1
    with pytest.raises(ValueError, match="outdir"):
        TI.stream_ipta_campaign(_jobs(files, gmodel, TI), resume=True,
                                device="cpu")


def test_shard_files_matches_jax():
    grid = [(p, f"f{i}") for p in ("A", "B", "C") for i in range(7)]
    for count in (1, 2, 3, 4, 5):
        for index in range(count):
            assert TM.shard_files(grid, index, count) == \
                JM.shard_files(grid, index, count)
    assert TM.shard_files(grid) == grid
    assert TM.process_index() == 0 and TM.process_count() == 1
    x = np.arange(3.0)
    got = TM.process_allgather(x)
    assert len(got) == 1 and np.array_equal(got[0], x)
    assert got[0].dtype == np.float64


def test_gloo_world_size_one(tmp_path):
    """A real one-process gloo group: the helpers give the one-process
    answers."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        assert TM.process_count() == 1 and TM.process_index() == 0
        assert TM.shard_files([1, 2, 3]) == [1, 2, 3]
    finally:
        dist.destroy_process_group()


def test_refusals(fleet, stream_config, monkeypatch, tmp_path):
    """router= runs: a port ToaRouter over a port server gives the
    executor-per-pulsar path's .tim files byte for byte (the JAX router
    comparison is tests/test_torch_router.py); server= runs in
    tests/test_torch_serve.py.  At a world size of 2 the helpers answer
    without a real group; the JAX package's ValueErrors (timing_pars
    under multi-process sharding, duplicate names, unknown timing
    pulsars, timing_pars with resume, server= with router=, server= or
    router= with resume or an executor-level option)."""
    import torch.distributed as dist

    from pulseportraiture_tpu_torch import serve as TSV

    root, files, gmodel = fleet
    jobs = _jobs(files, gmodel, TI)
    solo = TI.stream_ipta_campaign(jobs, outdir=str(tmp_path / "solo"),
                                   quiet=True, nsub_batch=2, device="cpu")
    with TSV.ToaServer(nsub_batch=2, max_wait_ms=30, device="cpu") as srv:
        router = TSV.ToaRouter([TSV.InProcTransport(srv, label="h0")])
        try:
            routed = TI.stream_ipta_campaign(
                jobs, outdir=str(tmp_path / "routed"), quiet=True,
                router=router, device="cpu")
            with pytest.raises(ValueError, match="not both"):
                TI.stream_ipta_campaign(jobs, device="cpu", server=srv,
                                        router=router)
            with pytest.raises(ValueError, match="resume"):
                TI.stream_ipta_campaign(jobs, outdir=str(root / "r"),
                                        resume=True, device="cpu",
                                        router=router)
        finally:
            router.close()
    for name in PARS:
        assert ((tmp_path / "routed" / f"{name}.tim").read_bytes()
                == (tmp_path / "solo" / f"{name}.tim").read_bytes())
        m1, e1 = solo.DeltaDM_summary[name]
        m2, e2 = routed.DeltaDM_summary[name]
        assert np.array_equal(m1, m2) and np.array_equal(e1, e2)
    with pytest.raises(ValueError, match="resume"):
        TI.stream_ipta_campaign(jobs, outdir=str(root / "r"), resume=True,
                                device="cpu", server=object())
    with pytest.raises(ValueError, match="max_inflight"):
        TI.stream_ipta_campaign(jobs, device="cpu", server=object(),
                                max_inflight=8)
    with pytest.raises(ValueError, match="duplicate"):
        TI.stream_ipta_campaign(jobs + jobs[:1], device="cpu")
    with pytest.raises(ValueError, match="not in jobs"):
        TI.stream_ipta_campaign(jobs, device="cpu",
                                timing_pars={"nope": PARS[jobs[0].pulsar]})
    with pytest.raises(ValueError, match="resume"):
        TI.stream_ipta_campaign(jobs, outdir=str(root / "r"), resume=True,
                                device="cpu", timing_pars=dict(PARS))
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 0)
    # the world-size-2 answers that need no real group (two real ranks:
    # test_torch_multiprocess.py), and the JAX package's refusal of
    # timing_pars under sharding, on both sides
    assert TM.process_count() == 2 and TM.process_index() == 0
    assert TM.shard_files([1, 2]) == [1]
    import pulseportraiture_tpu.parallel as JPar

    monkeypatch.setattr(JPar, "process_count", lambda: 2)
    for run in (lambda: TI.stream_ipta_campaign(jobs, device="cpu",
                                                timing_pars=dict(PARS)),
                lambda: JI.stream_ipta_campaign(
                    _jobs(files, gmodel, JI), timing_pars=dict(PARS))):
        with pytest.raises(ValueError, match="multi-process sharding"):
            run()
    # explicit index/count never consult the process group
    assert TM.shard_files([1, 2, 3], 1, 2) == [2]


def test_job_from_metafile(fleet, tmp_path):
    root, files, gmodel = fleet
    name = list(PARS)[0]
    meta = tmp_path / "m.txt"
    meta.write_text("\n".join(files[name]) + "\n")
    job = TI.IPTAJob(name, str(meta), gmodel, DM0=3.0)
    ref = JI.IPTAJob(name, str(meta), gmodel, DM0=3.0)
    assert job.datafiles == ref.datafiles == files[name]
    assert job.kwargs == ref.kwargs
    assert TI.IPTAJob(name, files[name][0], gmodel).datafiles == \
        files[name][:1]
    assert TI._shard_checkpoints(str(tmp_path), "J1") == []
